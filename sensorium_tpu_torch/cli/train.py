"""Train an experiment's CV folds.

    python -m sensorium_tpu_torch.cli.train -e EXPERIMENT [-f all|0|0,3] [--resume] [--device cuda]

Counterpart of the single-process path of ``sensorium_tpu/cli/train.py``.
The experiment config is executable Python with a module-level ``config``
(``constants.configs_dir/EXPERIMENT.py``, by default the port's own
``sensorium_tpu_torch/configs``). It is snapshotted into
``constants.experiments_dir/EXPERIMENT`` (``config.json``, the source and
this file), and each fold is trained on one device, holding that fold out:

* the lr plan (linear warmup + cosine, or a named scheduler) is one
  schedule of the update count over every stage;
* ``--resume`` continues a fold from its ``train_state.ckpt`` (weights,
  EMA, optimizer moments, generator, update count), skipping the stages
  already done;
* a SIGTERM saves the train state and exits with code 75 (EX_TEMPFAIL);
  rerun with ``--resume`` to go on;
* ``--trace DIR`` profiles the first fold, ``--debug-nans`` raises at the
  first op that produces a NaN.

Training on several cards (``--mesh`` other than ``data``,
``--fold-procs``, ``--multihost``, ``--sharded-checkpoint``) comes with
multi-GPU (ROADMAP.md A.4); those flags are refused.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import shutil
from importlib.machinery import SourceFileLoader
from pathlib import Path

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data.datasets import TrainMiceDataset, ValMiceDataset
from sensorium_tpu_torch.data.indexes import WindowIndexer
from sensorium_tpu_torch.data.inputs import get_inputs_processor
from sensorium_tpu_torch.data.loader import MiceDataLoader
from sensorium_tpu_torch.data.mixers import CutMix
from sensorium_tpu_torch.data.mouse_data import get_mouse_data
from sensorium_tpu_torch.data.responses import get_responses_processor
from sensorium_tpu_torch.engine.callbacks import Checkpoint, LoggingToCSV, LoggingToFile, LoggingToJSONL, Timer
from sensorium_tpu_torch.engine.checkpoint import flush_pending_saves
from sensorium_tpu_torch.engine.metrics import CorrelationMetric
from sensorium_tpu_torch.engine.model import MouseModel, load_model
from sensorium_tpu_torch.engine.preemption import PreemptionHandler, TrainingPreempted
from sensorium_tpu_torch.engine.schedule import build_stage_schedule
from sensorium_tpu_torch.utils.misc import get_best_model_path, get_lr
from sensorium_tpu_torch.utils.profiling import debug_nans, trace

STATE_NAME = "train_state.ckpt"
MULTI_GPU = "comes with multi-GPU training (ROADMAP.md A.4)"


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Train an experiment's CV folds.")
    parser.add_argument("-e", "--experiment", required=True, type=str)
    parser.add_argument("-f", "--folds", default="all", type=str, help="'all' or a comma list of fold numbers")
    parser.add_argument("--mesh", default="data", type=str, help="only 'data': one device a fold")
    parser.add_argument("--no-mesh", action="store_true", help="single-device mode (the only mode)")
    parser.add_argument("--resume", action="store_true", help="resume each fold from its train_state.ckpt")
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="write checkpoints in a background thread (the next epoch starts while the "
                             "previous save goes to disk)")
    parser.add_argument("--sharded-checkpoint", action="store_true", help=f"refused: {MULTI_GPU}")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--debug-nans", action="store_true",
                        help="raise at the first op that produces a NaN, with its name")
    parser.add_argument("--trace", default=None, type=str, metavar="DIR",
                        help="write a torch.profiler trace of the first trained fold into DIR (use with a "
                             "short run: traces grow with wall time)")
    parser.add_argument("--fold-procs", default="1", type=str, help=f"only 1; more {MULTI_GPU}")
    parser.add_argument("--pin-chips", action="store_true", help=f"refused: {MULTI_GPU}")
    parser.add_argument("--multihost", default=None, type=str, metavar="SPEC", help=f"refused: {MULTI_GPU}")
    parser.add_argument("--device", default="cuda", type=str, help="a torch device: 'cuda', 'cuda:1' or 'cpu'")
    args = parser.parse_args(argv)
    refused = [flag for flag, given in (
        (f"--mesh {args.mesh}", args.mesh != "data"),
        (f"--fold-procs {args.fold_procs}", args.fold_procs != "1"),
        ("--pin-chips", args.pin_chips),
        ("--multihost", args.multihost is not None),
        ("--sharded-checkpoint", args.sharded_checkpoint),
    ) if given]
    if refused:
        parser.error(f"{', '.join(refused)}: training on several devices {MULTI_GPU}")
    return args


def train_mouse(
    config: dict,
    save_dir: Path,
    train_splits: list[str],
    val_splits: list[str],
    seed: int = 0,
    resume: bool = False,
    async_checkpoint: bool = False,
    device: str = "cuda",
) -> MouseModel:
    """Train one fold: ``val_splits`` held out, checkpoints and logs in ``save_dir``."""
    config = copy.deepcopy(config)
    argus_params = config["argus_params"]

    model = MouseModel(argus_params, device=device)
    if config.get("ema_decay"):
        print("EMA decay:", config["ema_decay"])
        model.set_ema(config["ema_decay"])

    if "distill" in config:
        distill_params = config["distill"]
        teacher_dir = constants.experiments_dir / distill_params["experiment"] / val_splits[0]
        teacher_path = get_best_model_path(teacher_dir)
        if teacher_path is None:
            raise RuntimeError(f"No teacher checkpoint in '{teacher_dir}'")
        teacher = load_model(teacher_path, device=model.device)
        model.set_distill(teacher.state.model, ratio=distill_params["ratio"])
        print(f"Distillation model {teacher_path}, ratio {distill_params['ratio']}")

    indexer = WindowIndexer(**argus_params["frame_stack"])
    inputs_processor = get_inputs_processor(*argus_params["inputs_processor"])
    responses_processor = get_responses_processor(*argus_params["responses_processor"])
    cutmix = CutMix(**config["cutmix"]) if "cutmix" in config else None

    mouse_epoch_size = config["train_epoch_size"] // constants.num_mice
    train_mice_data = [get_mouse_data(mouse=m, splits=train_splits) for m in constants.mice]
    val_mice_data = [get_mouse_data(mouse=m, splits=val_splits) for m in constants.mice]
    train_dataset = TrainMiceDataset(train_mice_data, indexer, inputs_processor, responses_processor,
                                     mouse_epoch_size=mouse_epoch_size, mixer=cutmix, seed=seed)
    val_dataset = ValMiceDataset(val_mice_data, indexer, inputs_processor, responses_processor)
    print("Train dataset len:", len(train_dataset))
    print("Val dataset len:", len(val_dataset))

    num_threads = config.get("num_dataloader_workers", 8)
    train_loader = MiceDataLoader(train_dataset, batch_size=config["batch_size"], shuffle=True, seed=seed,
                                  num_threads=num_threads, drop_last=True)
    val_loader = MiceDataLoader(val_dataset, batch_size=config["batch_size"] // argus_params.get("iter_size", 1),
                                num_threads=num_threads)

    # One schedule for the whole stage plan: the cosine (or the named
    # scheduler) spans every post-warmup epoch, whatever the stages' names.
    iters_per_epoch = len(train_dataset) // config["batch_size"]
    stage_epochs = dict(zip(config["stages"], config["num_epochs"]))
    warmup_iters = iters_per_epoch * stage_epochs.get("warmup", 0)
    train_iters = iters_per_epoch * sum(epochs for stage, epochs in stage_epochs.items() if stage != "warmup")
    peak_lr = argus_params["optimizer"][1]["lr"]
    min_lr = get_lr(config["min_base_lr"], config["batch_size"])
    schedule = build_stage_schedule(peak_lr, min_lr, warmup_iters, train_iters,
                                    scheduler_spec=config.get("lr_scheduler"))

    model.build_state(seed=seed, learning_rate=schedule)
    if config.get("init_from"):
        # Warm start from a model checkpoint; the optimizer and schedule stay fresh.
        model.init_from_checkpoint(config["init_from"])
        print("Warm-start init from", config["init_from"])
    start_epoch = 0
    state_path = save_dir / STATE_NAME
    if resume and state_path.exists():
        extra = model.load_train_state(state_path)
        start_epoch = int(extra.get("epoch", -1)) + 1
        print(f"Resumed from epoch {start_epoch}")

    save_dir.mkdir(parents=True, exist_ok=True)
    # One handler spans all stages: a signal latched near a stage boundary
    # is not lost when a stage's fit ends.
    with PreemptionHandler() as preemption:
        stage_offset = 0  # the global epoch at which the current stage starts
        for num_epochs, stage in zip(config["num_epochs"], config["stages"]):
            callbacks = [
                Timer(),
                LoggingToFile(save_dir / "log.txt", append=True),
                LoggingToCSV(save_dir / "log.csv", append=True),
                LoggingToJSONL(save_dir / "log.jsonl", append=True),
            ]
            if stage != "warmup":
                callbacks.append(Checkpoint(save_dir, file_format="model-{epoch:03d}-{val_corr:.6f}.ckpt",
                                            max_saves=1, background=async_checkpoint,
                                            train_state_name=STATE_NAME))
            # Cumulative: a third stage starts after all earlier stages'
            # epochs, so its epochs keep their own numbers on resume.
            stage_start = stage_offset
            stage_offset += num_epochs
            skip = max(0, start_epoch - stage_start)
            if skip >= num_epochs:
                print(f"Stage '{stage}' already completed, skipping")
                continue
            model.fit(
                train_loader,
                val_loader=val_loader,
                num_epochs=num_epochs - skip,
                callbacks=callbacks,
                metrics=[CorrelationMetric(num_neurons=list(argus_params["nn_module"][1]["readout_outputs"]))],
                stage=stage,
                start_epoch=stage_start + skip,
                preemption=preemption,
                preemption_save_path=state_path,
            )
    # A background save still in flight lands before the fold counts as done:
    # prediction reads the best checkpoint next.
    flush_pending_saves()
    return model


def main(argv=None) -> None:
    args = parse_arguments(argv)
    print("Experiment:", args.experiment)

    config_path = constants.configs_dir / f"{args.experiment}.py"
    if not config_path.exists():
        raise RuntimeError(f"Config '{config_path}' does not exist")
    config = SourceFileLoader(args.experiment, str(config_path)).load_module().config

    experiment_dir = constants.experiments_dir / args.experiment
    experiment_dir.mkdir(parents=True, exist_ok=True)
    # What was run, beside what it made: the config resolved and as written, and this entry point.
    with open(experiment_dir / "config.json", "w") as outfile:
        json.dump(config, outfile, indent=4, default=str)
    shutil.copy(config_path, experiment_dir / config_path.name)
    shutil.copy(Path(__file__).resolve(), experiment_dir / "train.py")

    if args.folds == "all":
        folds_splits = constants.folds_splits
    else:
        folds_splits = [f"fold_{fold}" for fold in args.folds.split(",")]

    debug_nans(args.debug_nans)
    try:
        for fold_index, fold_split in enumerate(folds_splits):
            val_splits = [fold_split]
            train_splits = sorted(set(constants.folds_splits) - set(val_splits))
            print(f"Val fold: {val_splits}, train folds: {train_splits}")
            trace_ctx = trace(args.trace) if args.trace and fold_index == 0 else contextlib.nullcontext()
            try:
                with trace_ctx:
                    train_mouse(config, experiment_dir / fold_split, train_splits, val_splits, seed=args.seed,
                                resume=args.resume, async_checkpoint=args.async_checkpoint, device=args.device)
            except TrainingPreempted as preempted:
                print(f"Preempted: {preempted}. Rerun with --resume to continue.")
                raise SystemExit(75)  # EX_TEMPFAIL
    finally:
        debug_nans(False)


if __name__ == "__main__":
    main()
