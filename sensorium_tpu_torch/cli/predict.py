"""Predict a split with an experiment's fold models.

    python -m sensorium_tpu_torch.cli.predict -e EXPERIMENT -s SPLIT [-d new|old] [--device cuda] [--chunk-size 32]
        [--mesh | --multihost auto|COORD,N,ID]

Counterpart of ``sensorium_tpu/cli/predict.py``. The best checkpoint of
each fold is read from ``constants.experiments_dir/EXPERIMENT/fold_<i>``
(the score in its name); predictions go to
``constants.predictions_dir/EXPERIMENT/<split>/<mouse>/<trial_id>.npy``.

* ``-s folds``: each fold's trials by that fold's model (out-of-fold), then
  the evaluation, ``out-of-fold/evaluate_<dataset>.json``;
* an unlabeled split: the mean of the 7 fold models for every trial, then,
  for the new mice, the submission file.

``--mesh`` spreads each chunk's windows over every visible card of this
process (``Predictor(mesh=)``; ``--chunk-size`` must divide over them).
``--multihost SPEC`` (``parallel/multihost.py``) spreads the trials
instead: process i of n predicts every n-th trial from the i-th, and after a
barrier the first process evaluates or writes the submission. The two
exclude each other, and ``--mesh`` excludes ``--device``.
"""

from __future__ import annotations

import argparse

import torch

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.infer.predictor import Predictor, predict_mouse_split
from sensorium_tpu_torch.infer.submission import evaluate_folds_predictions, make_submission
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel import multihost
from sensorium_tpu_torch.utils.misc import get_best_model_path


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Predict a split with an experiment's fold models.")
    parser.add_argument("-e", "--experiment", required=True, type=str)
    parser.add_argument("-s", "--split", required=True, choices=["folds"] + constants.unlabeled_splits, type=str)
    parser.add_argument("-d", "--dataset", default="new", choices=["new", "old"], type=str)
    parser.add_argument("--device", default=None, type=str,
                        help="a torch device: 'cuda' (the default), 'cuda:1' or 'cpu'")
    parser.add_argument("--chunk-size", default=32, type=int, help="sliding-window anchors per forward")
    parser.add_argument("--mesh", action="store_true", help="spread each chunk's windows over every visible card")
    parser.add_argument("--multihost", default=None, type=str, metavar="SPEC",
                        help="spread the trials over processes: 'auto' (torchrun's variables) or "
                             "'COORD_ADDR:PORT,NUM_PROCESSES,PROCESS_ID'")
    args = parser.parse_args(argv)
    if args.device is not None and args.mesh:
        parser.error("--device and --mesh are mutually exclusive")
    if args.multihost is not None and args.mesh:
        parser.error("--multihost fans trials out across processes; combine it with one device a process, "
                     "not --mesh")
    return args


def _fold_model_path(experiment: str, fold_split: str):
    model_path = get_best_model_path(constants.experiments_dir / experiment / fold_split)
    if model_path is None:
        raise RuntimeError(f"No checkpoint for {experiment}/{fold_split}")
    print("Model path:", str(model_path))
    return model_path


def predict_folds(experiment: str, dataset: str, chunk_size: int = 32, device: str = "cuda", mesh=None,
                  trial_shard=None) -> None:
    """Out-of-fold predictions: one Predictor a fold, for every mouse."""
    print(f"Predict folds: {experiment=}, {dataset=}")
    for fold_split in constants.folds_splits:
        predictor = Predictor(_fold_model_path(experiment, fold_split), chunk_size=chunk_size, device=device,
                              mesh=mesh)
        for mouse in constants.dataset2mice[dataset]:
            mouse_dir = constants.predictions_dir / experiment / "out-of-fold" / mouse
            predict_mouse_split(mouse, fold_split, [predictor], mouse_dir, trial_shard=trial_shard)


def predict_unlabeled_split(experiment: str, split: str, dataset: str, chunk_size: int = 32,
                            device: str = "cuda", mesh=None, trial_shard=None) -> None:
    """The mean of all fold models for every trial of an unlabeled split."""
    print(f"Predict unlabeled split: {experiment=}, {split=}, {dataset=}")
    predictors = [
        Predictor(_fold_model_path(experiment, fold_split), chunk_size=chunk_size, device=device, mesh=mesh)
        for fold_split in constants.folds_splits
    ]
    for mouse in constants.dataset2mice[dataset]:
        predict_mouse_split(mouse, split, predictors, constants.predictions_dir / experiment / split / mouse,
                            trial_shard=trial_shard)


def main(argv=None):
    args = parse_arguments(argv)
    device = args.device or "cuda"
    trial_shard = None
    if args.multihost is not None:
        rank = multihost.init_from_spec(args.multihost, torch.device(device).type)
        trial_shard = (rank.rank, rank.world)
        if rank.device.type == "cuda":
            device = str(rank.device)
    mesh = None
    if args.mesh:
        mesh = mesh_lib.create_mesh()
        if args.chunk_size % mesh_lib.data_extent(mesh):
            raise SystemExit(f"--chunk-size {args.chunk_size} must be a multiple of the mesh batch-sharding ways "
                             f"({mesh_lib.data_extent(mesh)} devices)")
        print("Mesh:", mesh.shape)
    primary = trial_shard is None or trial_shard[0] == 0
    try:
        if args.split == "folds":
            predict_folds(args.experiment, args.dataset, args.chunk_size, device, mesh, trial_shard)
            # Every process's trials are on (shared) disk before the evaluation reads them all.
            multihost.barrier("predict_folds_done")
            if primary:
                evaluate_folds_predictions(args.experiment, args.dataset)
        else:
            predict_unlabeled_split(args.experiment, args.split, args.dataset, args.chunk_size, device, mesh,
                                    trial_shard)
            multihost.barrier("predict_split_done")
            if args.dataset == "new" and primary:
                make_submission(args.experiment, args.split)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
