"""Out-of-fold evaluation and competition submissions.

Counterpart of ``sensorium_tpu/infer/submission.py``, numpy on the host:
the competition's response cut (frames 50 to min(T, 300) - 1), the
per-neuron precision normalization, the split naming of the evaluation
server, and the parquet file ``mouse, trial_indices, prediction,
neuron_ids`` with brotli compression. ``pandas`` and ``pyarrow`` are
imported by ``make_submission`` alone.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator

import numpy as np

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data.mouse_data import get_mouse_data
from sensorium_tpu_torch.data.responses import ResponseNormalizer
from sensorium_tpu_torch.engine.metrics import corr


def submission_cut(prediction: np.ndarray) -> np.ndarray:
    """Frames [skip_first, min(limit, T) - skip_last) of the trailing (time)
    axis: the window the evaluation server scores."""
    stop = min(prediction.shape[-1], constants.submission_limit_length)
    stop -= constants.submission_skip_last
    return prediction[..., constants.submission_skip_first : stop]


cut_responses_for_submission = submission_cut  # the reference implementation's name


def iter_saved_predictions(prediction_dir: Path, trials: list[dict]) -> Iterator[tuple[dict, np.ndarray]]:
    """(trial_data, saved prediction) for each trial of the catalog."""
    for trial_data in trials:
        yield trial_data, np.load(str(prediction_dir / f"{trial_data['trial_id']}.npy"))


def _oof_correlation(mouse: str, mouse_prediction_dir: Path) -> float:
    """Mean per-neuron correlation of a mouse's out-of-fold predictions,
    every trial cut and concatenated in time, as the server scores them."""
    mouse_data = get_mouse_data(mouse=mouse, splits=constants.folds_splits)
    pairs = [
        (submission_cut(prediction),
         submission_cut(np.load(trial_data["response_path"])[..., : trial_data["length"]]))
        for trial_data, prediction in iter_saved_predictions(mouse_prediction_dir, mouse_data["trials"])
    ]
    predictions = np.concatenate([p for p, _ in pairs], axis=1)
    targets = np.concatenate([t for _, t in pairs], axis=1)
    return float(corr(predictions, targets, axis=1).mean())


def evaluate_folds_predictions(experiment: str, dataset: str) -> dict:
    """Out-of-fold score per mouse and their mean; writes ``evaluate_{dataset}.json``."""
    prediction_dir = constants.predictions_dir / experiment / "out-of-fold"
    correlations = {mouse: _oof_correlation(mouse, prediction_dir / mouse) for mouse in constants.dataset2mice[dataset]}
    for mouse, correlation in correlations.items():
        print(f"Mouse {mouse} correlation: {correlation}")
    mean_correlation = float(np.mean(list(correlations.values())))
    print("Mean correlation:", mean_correlation)
    result = {"correlations": correlations, "mean_correlation": mean_correlation}
    with open(prediction_dir / f"evaluate_{dataset}.json", "w") as outfile:
        json.dump(result, outfile, indent=4)
    return result


def _mouse_submission_records(mouse: str, split: str, prediction_dir: Path) -> list:
    """(mouse, trial_id, normalized and cut prediction, neuron_ids) records."""
    normalize = ResponseNormalizer(mouse)
    mouse_data = get_mouse_data(mouse=mouse, splits=[split])
    neuron_ids = mouse_data["neuron_ids"].tolist()
    return [
        (mouse, trial_data["trial_id"], submission_cut(normalize(prediction)).tolist(), neuron_ids)
        for trial_data, prediction in iter_saved_predictions(prediction_dir / mouse, mouse_data["trials"])
    ]


def submission_split_name(split: str) -> str:
    """The evaluation server's name of a split (``live_test_main`` -> ``live_main``)."""
    return split.replace("_test_", "_").replace("bonus", "test_bonus_ood")


def make_submission(experiment: str, split: str) -> None:
    """Write ``predictions_{split}.parquet.brotli`` for the five new mice."""
    import pandas as pd

    prediction_dir = constants.predictions_dir / experiment / split
    records = [
        record
        for mouse in constants.new_mice
        for record in _mouse_submission_records(mouse, split, prediction_dir)
    ]
    frame = pd.DataFrame.from_records(records, columns=["mouse", "trial_indices", "prediction", "neuron_ids"])
    submission_path = prediction_dir / f"predictions_{submission_split_name(split)}.parquet.brotli"
    frame.to_parquet(submission_path, compression="brotli", engine="pyarrow", index=False)
    print(f"Submission saved to '{submission_path}'")
