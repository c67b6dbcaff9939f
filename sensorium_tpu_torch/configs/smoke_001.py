"""Smoke config: the exact ``true_batch_001`` model and optimization recipe,
shrunk to a handful of steps.

With a dataset in the on-disk layout (folds by trial index), it drives the
whole train CLI (loader -> train step -> EMA checkpoint -> correlation
metric) in minutes:

    SENSORIUM_DATA_DIR=/path/to/data SENSORIUM_FOLD_ASSIGNMENT=trial \\
        python -m sensorium_tpu_torch.cli.train -e smoke_001 -f 0
"""

from importlib.machinery import SourceFileLoader
from pathlib import Path

_base = SourceFileLoader(
    "true_batch_001", str(Path(__file__).resolve().parent / "true_batch_001.py")
).load_module().config

config = dict(_base)
config["train_epoch_size"] = 64
config["num_epochs"] = [1, 1]
