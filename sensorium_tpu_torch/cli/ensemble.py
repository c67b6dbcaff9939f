"""Ensemble the saved predictions of several experiments.

    python -m sensorium_tpu_torch.cli.ensemble -e EXP1,EXP2[,...] -s SPLIT [-d new|old]

Counterpart of ``sensorium_tpu/cli/ensemble.py``: averages the per-trial
predictions into the experiment named by the sorted, comma-joined names,
then evaluates it (``-s folds``) or writes its submission (an unlabeled
split of the new mice).
"""

from __future__ import annotations

import argparse

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.infer.ensemble import ensemble_experiments
from sensorium_tpu_torch.infer.submission import evaluate_folds_predictions, make_submission


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Ensemble the saved predictions of several experiments.")
    parser.add_argument("-e", "--experiments", required=True, type=str)
    parser.add_argument("-s", "--split", required=True, choices=["folds"] + constants.unlabeled_splits, type=str)
    parser.add_argument("-d", "--dataset", default="new", choices=["new", "old"], type=str)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    experiments = sorted(args.experiments.split(","))
    if len(experiments) < 2:
        raise SystemExit("-e expects at least two comma-separated experiments to ensemble")
    experiment_name = ensemble_experiments(experiments, args.split, args.dataset)
    if args.split == "folds":
        evaluate_folds_predictions(experiment_name, args.dataset)
    elif args.dataset == "new":
        make_submission(experiment_name, args.split)


if __name__ == "__main__":
    main()
