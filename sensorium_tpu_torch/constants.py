"""Dataset constants of the Sensorium 2023 competition.

A copy of ``sensorium_tpu/constants.py``: mouse identifiers, neuron counts,
data layout on disk, experiment and prediction directories, fold and split
names and the submission cut. The port imports nothing of the JAX package.

The filesystem roots come from environment variables when the module is
imported:

* ``SENSORIUM_WORK_DIR``: base working directory (default ``./``);
* ``SENSORIUM_DATA_DIR``: dataset root (default ``<work>/data``);
* ``SENSORIUM_CONFIGS_DIR``: the experiment configs that ``cli.train -e``
  loads (default: the port's own ``sensorium_tpu_torch/configs``, whose
  files import only the port).

The data, inference and CLI modules read ``sensorium_dir``,
``experiments_dir``, ``predictions_dir`` and ``configs_dir`` when they are
called, so a caller may point them elsewhere by assigning the attributes.
"""

from __future__ import annotations

import os
from pathlib import Path


def _env_path(name: str, default: Path) -> Path:
    value = os.environ.get(name)
    return Path(value) if value else default


work_dir: Path = _env_path("SENSORIUM_WORK_DIR", Path("."))
data_dir: Path = _env_path("SENSORIUM_DATA_DIR", work_dir / "data")
sensorium_dir: Path = data_dir / "sensorium_all_2023"
experiments_dir: Path = data_dir / "experiments"
predictions_dir: Path = data_dir / "predictions"
configs_dir: Path = _env_path("SENSORIUM_CONFIGS_DIR", Path(__file__).resolve().parent / "configs")

# Five mice recorded for the 2023 competition ("new") and five carried over
# from the 2022 edition ("old").  Names are the official dataset keys.
new_mice = [
    "dynamic29515-10-12-Video-9b4f6a1a067fe51e15306b9628efea20",
    "dynamic29623-4-9-Video-9b4f6a1a067fe51e15306b9628efea20",
    "dynamic29647-19-8-Video-9b4f6a1a067fe51e15306b9628efea20",
    "dynamic29712-5-9-Video-9b4f6a1a067fe51e15306b9628efea20",
    "dynamic29755-2-8-Video-9b4f6a1a067fe51e15306b9628efea20",
]
new_num_neurons = [7863, 7908, 8202, 7939, 8122]

old_mice = [
    "dynamic29156-11-10-Video-8744edeac3b4d1ce16b680916b5267ce",
    "dynamic29228-2-10-Video-8744edeac3b4d1ce16b680916b5267ce",
    "dynamic29234-6-9-Video-8744edeac3b4d1ce16b680916b5267ce",
    "dynamic29513-3-5-Video-8744edeac3b4d1ce16b680916b5267ce",
    "dynamic29514-2-9-Video-8744edeac3b4d1ce16b680916b5267ce",
]
old_num_neurons = [7440, 7928, 8285, 7671, 7495]

dataset2mice = {"new": new_mice, "old": old_mice}
mouse2dataset = {m: d for d, mc in dataset2mice.items() for m in mc}
# Where cli/download_data.py fetches each mouse's zip.
dataset2url_format = {
    "new": "https://gin.g-node.org/pollytur/sensorium_2023_dataset/raw/master/{file_name}",
    "old": "https://gin.g-node.org/pollytur/Sensorium2023Data/raw/master/{file_name}",
}

mice = new_mice + old_mice
num_neurons = new_num_neurons + old_num_neurons
num_mice = len(mice)
index2mouse: dict[int, str] = dict(enumerate(mice))
mouse2index: dict[str, int] = {mouse: index for index, mouse in enumerate(mice)}
mouse2num_neurons: dict[str, int] = dict(zip(mice, num_neurons))
mice_indexes = list(range(num_mice))
max_num_neurons = max(num_neurons)

unlabeled_splits = ["live_test_main", "live_test_bonus", "final_test_main", "final_test_bonus"]

num_folds = 7
folds = list(range(num_folds))
folds_splits = [f"fold_{fold}" for fold in folds]

# Submission responses are cut to frames [skip_first, limit_length - skip_last).
submission_limit_length = 300
submission_skip_first = 50
submission_skip_last = 1
