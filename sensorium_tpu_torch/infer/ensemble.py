"""Ensembles of experiments (counterpart of ``sensorium_tpu/infer/ensemble.py``):
the mean of several experiments' saved per-trial predictions, on the host."""

from __future__ import annotations

import numpy as np

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data.mouse_data import get_mouse_data


def ensemble_experiments(experiments: list[str], split: str, dataset: str) -> str:
    """Average the saved predictions of ``experiments`` into the experiment
    named by joining them with commas; returns that name."""
    ensemble_name = ",".join(experiments)
    split_dir = "out-of-fold" if split == "folds" else split
    splits = constants.folds_splits if split == "folds" else [split]
    for mouse in constants.dataset2mice[dataset]:
        mouse_data = get_mouse_data(mouse=mouse, splits=splits)
        save_dir = constants.predictions_dir / ensemble_name / split_dir / mouse
        save_dir.mkdir(parents=True, exist_ok=True)
        for trial_data in mouse_data["trials"]:
            name = f"{trial_data['trial_id']}.npy"
            predictions = [
                np.load(str(constants.predictions_dir / experiment / split_dir / mouse / name))
                for experiment in experiments
            ]
            np.save(str(save_dir / name), np.mean(predictions, axis=0))
    return ensemble_name
