"""Download the Sensorium 2023 dataset.

    python -m sensorium_tpu_torch.cli.download_data [-p PATH]

Counterpart of ``sensorium_tpu/cli/download_data.py``: streams each mouse's
zip from the public GIN repositories (``constants.dataset2url_format``) and
unpacks it under ``PATH`` (default ``constants.sensorium_dir``). For the
five "old" mice it also back-fills the test-split responses from the
deeplake hub, where the 2023 competition released them, so that every
old-mouse tier is labeled and can join the CV folds.

deeplake is optional: without it the back-fill is skipped with a message,
and a later run with deeplake installed repairs it.
"""

from __future__ import annotations

import argparse
import shutil
import zipfile
from pathlib import Path

import numpy as np

from sensorium_tpu_torch import constants


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Download the Sensorium 2023 dataset.")
    parser.add_argument("-p", "--path", default=constants.sensorium_dir, type=Path)
    return parser.parse_args(argv)


def download_file(url: str, dest: Path) -> None:
    import requests

    print(f"Download '{url}' to '{dest}'")
    dest.unlink(missing_ok=True)
    with requests.get(url, stream=True) as response:
        response.raise_for_status()
        with open(dest, "wb") as output:
            shutil.copyfileobj(response.raw, output)


def missing_backfill_trials(mouse_dir: Path) -> list[int]:
    """Trial ids of test-split tiers whose responses file is absent, so that a
    rerun finds (and repairs) a back-fill that an earlier run skipped."""
    tiers_path = mouse_dir / "meta" / "trials" / "tiers.npy"
    if not tiers_path.exists():
        return []
    tiers = np.load(str(tiers_path))
    unlabeled = set(constants.unlabeled_splits)
    return [
        trial_id
        for trial_id, tier in enumerate(tiers)
        if str(tier) in unlabeled and not (mouse_dir / "data" / "responses" / f"{trial_id}.npy").exists()
    ]


def backfill_old_mouse_responses(mouse: str, mouse_dir: Path) -> None:
    """Fetch the released test-split responses of an old mouse."""
    try:
        import deeplake
    except ImportError:
        print(f"deeplake unavailable — skipping response back-fill for {mouse}")
        return
    for split in constants.unlabeled_splits:
        dataset = deeplake.load(f"hub://sinzlab/Sensorium_2023_{mouse}_{split}")
        trial_ids = dataset.id.numpy().astype(int).ravel().tolist()
        for index, trial_id in enumerate(trial_ids):
            responses_path = mouse_dir / "data" / "responses" / f"{trial_id}.npy"
            np.save(str(responses_path), dataset.responses[index].numpy())


def download_mouse(mouse: str, sensorium_dir: Path) -> None:
    file_name = f"{mouse}.zip"
    url = constants.dataset2url_format[constants.mouse2dataset[mouse]].format(file_name=file_name)
    zip_path = sensorium_dir / file_name
    mouse_dir = sensorium_dir / mouse

    if mouse_dir.exists():
        if (mouse_dir / "meta" / "trials" / "tiers.npy").exists():
            print(f"Folder '{mouse_dir}' already exists, skip download")
            # The back-fill may still be pending (deeplake missing on the first run).
            if mouse in constants.old_mice and missing_backfill_trials(mouse_dir):
                backfill_old_mouse_responses(mouse, mouse_dir)
            return
        # An interrupted extract left a tree without trial metadata: redo it.
        print(f"Folder '{mouse_dir}' is incomplete (no meta/trials/tiers.npy), re-downloading")
        shutil.rmtree(mouse_dir)

    download_file(url, zip_path)
    print("Unzip", zip_path)
    # Extract into a staging directory and commit with one rename, so that an
    # interrupted extract never leaves a mouse directory that looks complete.
    staging = sensorium_dir / f".{mouse}.extracting"
    shutil.rmtree(staging, ignore_errors=True)
    staging.mkdir()
    with zipfile.ZipFile(zip_path, "r") as zip_file:
        zip_file.extractall(staging)
    zip_path.unlink()
    extracted = staging / mouse
    if not extracted.is_dir():
        raise RuntimeError(f"archive '{file_name}' did not contain a '{mouse}/' folder")
    extracted.rename(mouse_dir)
    shutil.rmtree(staging, ignore_errors=True)

    if mouse in constants.old_mice:
        backfill_old_mouse_responses(mouse, mouse_dir)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    sensorium_dir = args.path
    sensorium_dir.mkdir(parents=True, exist_ok=True)
    for mouse in constants.mice:
        download_mouse(mouse, sensorium_dir)


if __name__ == "__main__":
    main()
