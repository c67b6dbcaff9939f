"""Predict a split with an experiment's fold models.

    python -m sensorium_tpu_torch.cli.predict -e EXPERIMENT -s SPLIT [-d new|old] [--device cuda] [--chunk-size 32]

Counterpart of ``sensorium_tpu/cli/predict.py``. The best checkpoint of
each fold is read from ``constants.experiments_dir/EXPERIMENT/fold_<i>``
(the score in its name); predictions go to
``constants.predictions_dir/EXPERIMENT/<split>/<mouse>/<trial_id>.npy``.

* ``-s folds``: each fold's trials by that fold's model (out-of-fold), then
  the evaluation, ``out-of-fold/evaluate_<dataset>.json``;
* an unlabeled split: the mean of the 7 fold models for every trial, then,
  for the new mice, the submission file.

Sharding the windows over several cards (``--mesh``) and spreading the
trials over hosts (``--multihost``) come with multi-GPU (ROADMAP.md A.4).
"""

from __future__ import annotations

import argparse

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.infer.predictor import Predictor, predict_mouse_split
from sensorium_tpu_torch.infer.submission import evaluate_folds_predictions, make_submission
from sensorium_tpu_torch.utils.misc import get_best_model_path


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Predict a split with an experiment's fold models.")
    parser.add_argument("-e", "--experiment", required=True, type=str)
    parser.add_argument("-s", "--split", required=True, choices=["folds"] + constants.unlabeled_splits, type=str)
    parser.add_argument("-d", "--dataset", default="new", choices=["new", "old"], type=str)
    parser.add_argument("--device", default="cuda", type=str, help="a torch device: 'cuda', 'cuda:1' or 'cpu'")
    parser.add_argument("--chunk-size", default=32, type=int, help="sliding-window anchors per forward")
    return parser.parse_args(argv)


def _fold_model_path(experiment: str, fold_split: str):
    model_path = get_best_model_path(constants.experiments_dir / experiment / fold_split)
    if model_path is None:
        raise RuntimeError(f"No checkpoint for {experiment}/{fold_split}")
    print("Model path:", str(model_path))
    return model_path


def predict_folds(experiment: str, dataset: str, chunk_size: int = 32, device: str = "cuda") -> None:
    """Out-of-fold predictions: one Predictor a fold, for every mouse."""
    print(f"Predict folds: {experiment=}, {dataset=}")
    for fold_split in constants.folds_splits:
        predictor = Predictor(_fold_model_path(experiment, fold_split), chunk_size=chunk_size, device=device)
        for mouse in constants.dataset2mice[dataset]:
            mouse_dir = constants.predictions_dir / experiment / "out-of-fold" / mouse
            predict_mouse_split(mouse, fold_split, [predictor], mouse_dir)


def predict_unlabeled_split(experiment: str, split: str, dataset: str, chunk_size: int = 32,
                            device: str = "cuda") -> None:
    """The mean of all fold models for every trial of an unlabeled split."""
    print(f"Predict unlabeled split: {experiment=}, {split=}, {dataset=}")
    predictors = [
        Predictor(_fold_model_path(experiment, fold_split), chunk_size=chunk_size, device=device)
        for fold_split in constants.folds_splits
    ]
    for mouse in constants.dataset2mice[dataset]:
        predict_mouse_split(mouse, split, predictors, constants.predictions_dir / experiment / split / mouse)


def main(argv=None):
    args = parse_arguments(argv)
    if args.split == "folds":
        predict_folds(args.experiment, args.dataset, args.chunk_size, args.device)
        evaluate_folds_predictions(args.experiment, args.dataset)
    else:
        predict_unlabeled_split(args.experiment, args.split, args.dataset, args.chunk_size, args.device)
        if args.dataset == "new":
            make_submission(args.experiment, args.split)


if __name__ == "__main__":
    main()
