"""Train an experiment's CV folds.

    python -m sensorium_tpu_torch.cli.train -e EXPERIMENT [-f all|0|0,3] [--resume] [--device cuda]
        [--mesh data|data,model|replica,data|replica,data,model | --no-mesh] [--sharded-checkpoint]
        [--multihost auto|COORD,N,ID] [--fold-procs N|auto [--pin-chips]]

Counterpart of ``sensorium_tpu/cli/train.py``. The experiment config is
executable Python with a module-level ``config``
(``constants.configs_dir/EXPERIMENT.py``, by default the port's own
``sensorium_tpu_torch/configs``). It is snapshotted into
``constants.experiments_dir/EXPERIMENT`` (``config.json``, the source and
this file) by the first process, and each fold is trained holding that
fold out:

* the lr plan (linear warmup + cosine, or a named scheduler) is one
  schedule of the update count over every stage;
* ``--resume`` continues a fold from its ``train_state.ckpt`` (weights,
  EMA, optimizer moments, generator, update count), skipping the stages
  already done; with ``--sharded-checkpoint`` the state is the directory
  ``train_state.orbax``, which every process writes its own slices into
  (``engine/checkpoint.py``). ``--resume`` reads whichever of the two it
  finds, the flag's first;
* a SIGTERM saves the train state and exits with code 75 (EX_TEMPFAIL);
  rerun with ``--resume`` to go on;
* ``--trace DIR`` profiles the first fold (and writes ``DIR/spans.json``:
  the program's spans, with BN's and the update's seconds on the card),
  ``--debug-nans`` raises at the first op that produces a NaN.

Where a fold runs:

* ``--mesh data`` (the default) or ``--mesh replica,data``: data-parallel
  over every visible card, the global batch spread over them
  (``parallel/mesh.py``). ``--mesh data,model`` and ``--mesh
  replica,data,model`` add a ``model`` axis of 2 where the card count (a
  host's, for ``replica``) is even, else 1, as the JAX CLI decides: each
  pair of adjacent ranks holds one batch shard and half of the cortex and
  readout weights (``parallel/tensor.py``). Under a model axis every
  process joins each checkpoint save (a gather; the first process writes
  the file). With one card, or ``--device`` naming one, there is no mesh,
  as JAX builds none for one device; ``--no-mesh`` asks for one card. The
  launcher starts one rank a card (``torch.multiprocessing``, spawn), makes
  no CUDA context itself, forwards SIGTERM and SIGINT to the ranks and
  exits 75 if a rank did, 1 if one failed.
* ``--multihost SPEC``: one launcher a host, each starting a rank a card;
  ``COORD,N,ID`` makes host ``ID``'s ranks global ranks ``ID * cards +
  local rank`` (``parallel/multihost.py``); ``auto`` takes torchrun's
  variables, one rank a process. The mesh path runs even at world size 1.
  The experiment directory must be on storage every host shares: the first
  process writes every file (each process its slices of a ``.orbax``
  state), and ``--resume`` checks that all read the same epoch.
* ``--fold-procs N|auto [--pin-chips]``: up to N folds at once, one
  single-card ``cli.train`` subprocess a fold; ``--pin-chips`` shows slot i
  only card i (``CUDA_VISIBLE_DEVICES``); ``auto`` is the visible card count.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from importlib.machinery import SourceFileLoader
from pathlib import Path

import torch
import torch.distributed as dist

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
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel import multihost
from sensorium_tpu_torch.utils.misc import get_best_model_path, get_lr
from sensorium_tpu_torch.utils.profiling import debug_nans, trace

STATE_NAME = "train_state.ckpt"
SHARDED_STATE_NAME = "train_state.orbax"
MESHES = ("data", "data,model", "replica,data", "replica,data,model")
PATHS = ("data_dir", "sensorium_dir", "experiments_dir", "predictions_dir", "configs_dir")


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Train an experiment's CV folds.")
    parser.add_argument("-e", "--experiment", required=True, type=str)
    parser.add_argument("-f", "--folds", default="all", type=str, help="'all' or a comma list of fold numbers")
    parser.add_argument("--mesh", default="data", type=str,
                        help="'data' (data parallel over every visible card), 'data,model' (data parallel and a "
                             "2-way model axis over adjacent cards), or 'replica,data[,model]' (hosts x cards)")
    parser.add_argument("--no-mesh", action="store_true", help="one card, no mesh")
    parser.add_argument("--resume", action="store_true", help="resume each fold from its train_state.ckpt")
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="write checkpoints in a background thread (the next epoch starts while the "
                             "previous save goes to disk)")
    parser.add_argument("--sharded-checkpoint", action="store_true",
                        help="resume state as the directory train_state.orbax: every process writes its own "
                             "slices, and the load reads them straight into place")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--debug-nans", action="store_true",
                        help="raise at the first op that produces a NaN, with its name")
    parser.add_argument("--trace", default=None, type=str, metavar="DIR",
                        help="write a torch.profiler trace of the first trained fold and its spans' totals "
                             "(spans.json) into DIR (use with a short run: traces grow with wall time)")
    parser.add_argument("--fold-procs", default="1", type=str,
                        help="train up to N folds at once, one single-card subprocess a fold; 'auto' is the "
                             "visible card count")
    parser.add_argument("--pin-chips", action="store_true", help="with --fold-procs: slot i sees only card i")
    parser.add_argument("--multihost", default=None, type=str, metavar="SPEC",
                        help="data parallel across hosts: 'auto' (torchrun's variables) or "
                             "'COORD_ADDR:PORT,NUM_PROCESSES,PROCESS_ID'; run the same command on every host")
    parser.add_argument("--device", default="cuda", type=str, help="a torch device: 'cuda', 'cuda:1' or 'cpu'")
    args = parser.parse_args(argv)
    if args.mesh not in MESHES:
        parser.error(f"--mesh {args.mesh!r}: expected 'data' or 'replica,data', either with ',model'")
    if args.fold_procs != "auto" and not args.fold_procs.isdigit():
        parser.error(f"--fold-procs {args.fold_procs!r}: expected a count or 'auto'")
    return args


def resolve_fold_procs(value: str) -> int:
    """``value`` as a count; ``auto`` is the visible card count (NVML: no CUDA context), at least 1."""
    if value == "auto":
        count = max(1, torch.cuda.device_count())
        print(f"[fold-procs] auto: {count} visible cards")
        return count
    return int(value)


def chip_pinning_env(slot: int) -> dict[str, str]:
    """The environment that shows a fold subprocess only card ``slot``."""
    return {"CUDA_VISIBLE_DEVICES": str(slot)}


def mesh_cards(args) -> int:
    """Cards a host spreads each fold over: every visible card (counted
    through NVML, so the launcher makes no CUDA context) when ``--device``
    is ``cuda`` without an index and there is a mesh, else 1."""
    if args.no_mesh or args.device != "cuda":
        return 1
    return max(1, torch.cuda.device_count())


def snapshot(config: dict, config_path: Path, experiment_dir: Path) -> None:
    """What was run, beside what it made: the config resolved and as written, and this entry point."""
    experiment_dir.mkdir(parents=True, exist_ok=True)
    with open(experiment_dir / "config.json", "w") as outfile:
        json.dump(config, outfile, indent=4, default=str)
    shutil.copy(config_path, experiment_dir / config_path.name)
    shutil.copy(Path(__file__).resolve(), experiment_dir / "train.py")


def run_parallel_folds(args, folds_splits: list[str], experiment_dir: Path, fold_procs: int) -> None:
    """Train folds concurrently, one single-card ``cli.train`` subprocess a
    fold (``sensorium_tpu/cli/train.py`` ``run_parallel_folds``): up to
    ``fold_procs`` at once, each child's output in
    ``<fold_dir>/train_proc.log``; with ``--pin-chips`` slot i sees only
    card i. The parent makes no CUDA context. A SIGTERM or SIGINT goes on to
    the children, which save their resume state; the parent then exits 75.
    Otherwise it exits 75 if a child was preempted, 1 if one failed."""
    pending = list(folds_splits)
    running: dict = {}
    exit_codes: dict[str, int] = {}
    free_slots = list(range(fold_procs))
    repo_root = Path(__file__).resolve().parents[2]
    terminated = {"signal": None}

    def on_signal(signum, frame):
        terminated["signal"] = signum
        for proc in list(running):
            proc.terminate()

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        while (pending or running) and terminated["signal"] is None:
            while pending and free_slots and terminated["signal"] is None:
                fold, slot = pending.pop(0), free_slots.pop(0)
                cmd = [sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", args.experiment,
                       "-f", fold.removeprefix("fold_"), "--seed", str(args.seed), "--no-mesh",
                       "--device", args.device]
                cmd += [flag for flag, given in (("--resume", args.resume),
                                                 ("--async-checkpoint", args.async_checkpoint),
                                                 ("--sharded-checkpoint", args.sharded_checkpoint),
                                                 ("--debug-nans", args.debug_nans)) if given]
                if args.trace and fold == folds_splits[0]:
                    cmd += ["--trace", str(Path(args.trace) / fold)]
                env = dict(os.environ)
                env["PYTHONPATH"] = os.pathsep.join([str(repo_root)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                                                         else []))
                if args.pin_chips:
                    env.update(chip_pinning_env(slot))
                fold_dir = experiment_dir / fold
                fold_dir.mkdir(parents=True, exist_ok=True)
                logfile = open(fold_dir / "train_proc.log", "a")
                proc = subprocess.Popen(cmd, env=env, stdout=logfile, stderr=subprocess.STDOUT)
                print(f"[fold-procs] started {fold} (pid {proc.pid}, slot {slot})", flush=True)
                running[proc] = (fold, slot, logfile)
            time.sleep(0.2)
            for proc in [p for p in running if p.poll() is not None]:
                fold, slot, logfile = running.pop(proc)
                logfile.close()
                free_slots.append(slot)
                exit_codes[fold] = proc.returncode
                print(f"[fold-procs] finished {fold} rc={proc.returncode}", flush=True)
        # A child started just before the signal may not have seen it.
        for proc in running:
            if terminated["signal"] is not None and proc.poll() is None:
                proc.terminate()
        for proc in list(running):
            fold, slot, logfile = running.pop(proc)
            try:
                exit_codes[fold] = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                exit_codes[fold] = proc.wait()
            logfile.close()
    finally:
        for proc, (_, _, logfile) in running.items():
            proc.kill()
            logfile.close()
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    saved = sorted(f for f, rc in exit_codes.items() if rc == 75)
    failed = sorted(f for f, rc in exit_codes.items() if rc not in (0, 75))
    if terminated["signal"] is not None:
        print(f"[fold-procs] caught signal {terminated['signal']}; resume state saved (exit 75): {saved}; "
              f"not confirmed: {failed}. Rerun with --resume.", flush=True)
        raise SystemExit(75)
    if saved:
        print(f"[fold-procs] preempted: {saved}. Rerun with --resume.")
    if failed:
        print(f"[fold-procs] FAILED: {failed} (see <fold_dir>/train_proc.log)")
        raise SystemExit(1)
    if saved:
        raise SystemExit(75)


def train_mouse(
    config: dict,
    save_dir: Path,
    train_splits: list[str],
    val_splits: list[str],
    seed: int = 0,
    resume: bool = False,
    async_checkpoint: bool = False,
    device: str = "cuda",
    mesh: mesh_lib.Mesh | None = None,
    sharded_checkpoint: bool = False,
) -> MouseModel:
    """Train one fold: ``val_splits`` held out, checkpoints and logs in
    ``save_dir``. With a ``mesh`` each process loads its rows of every
    batch and the first process writes the files; every process joins the
    saves that are collectives (under a model axis, or with
    ``sharded_checkpoint``: the resume state ``train_state.orbax``)."""
    config = copy.deepcopy(config)
    argus_params = config["argus_params"]

    model = MouseModel(argus_params, device=device, mesh=mesh)
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
    shard = None if mesh is None else (mesh.data_index, mesh_lib.data_extent(mesh))
    train_loader = MiceDataLoader(train_dataset, batch_size=config["batch_size"], shuffle=True, seed=seed,
                                  num_threads=num_threads, drop_last=True, shard=shard,
                                  microbatches=argus_params.get("iter_size", 1))
    val_loader = MiceDataLoader(val_dataset, batch_size=config["batch_size"] // argus_params.get("iter_size", 1),
                                num_threads=num_threads, shard=shard)

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
    state_name = SHARDED_STATE_NAME if sharded_checkpoint else STATE_NAME
    state_path = save_dir / state_name
    if resume:
        epoch = -2  # no train state here
        # Either format may be there: a run may switch formats between resumes.
        found = next((save_dir / name for name in (state_name, SHARDED_STATE_NAME, STATE_NAME)
                      if (save_dir / name).exists()), None)
        if found is not None:
            epoch = int(model.load_train_state(found).get("epoch", -1))
        check_same_epoch(mesh, epoch)
        if epoch >= -1:
            start_epoch = epoch + 1
            print(f"Resumed from epoch {start_epoch}")

    is_primary = model.writes_files
    # Saves that are collectives: every process joins them.
    collective_saves = model.tensor_parallel or sharded_checkpoint
    if is_primary:
        save_dir.mkdir(parents=True, exist_ok=True)
    # One handler spans all stages: a signal latched near a stage boundary
    # is not lost when a stage's fit ends.
    with PreemptionHandler() as preemption:
        stage_offset = 0  # the global epoch at which the current stage starts
        for num_epochs, stage in zip(config["num_epochs"], config["stages"]):
            callbacks = [Timer()]
            if is_primary:
                callbacks += [
                    LoggingToFile(save_dir / "log.txt", append=True),
                    LoggingToCSV(save_dir / "log.csv", append=True),
                    LoggingToJSONL(save_dir / "log.jsonl", append=True),
                ]
            if stage != "warmup" and (is_primary or collective_saves):
                callbacks.append(Checkpoint(save_dir, file_format="model-{epoch:03d}-{val_corr:.6f}.ckpt",
                                            max_saves=1, background=async_checkpoint,
                                            train_state_name=state_name))
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
                preemption_save_path=state_path if is_primary or collective_saves else None,
            )
    # A background save still in flight lands before the fold counts as done:
    # prediction reads the best checkpoint next.
    flush_pending_saves()
    return model


def check_same_epoch(mesh: mesh_lib.Mesh | None, epoch: int) -> None:
    """Over a process group, every process must have read the same train
    state (-2: none): the first process writes it, so without storage that
    every host shares the others would start afresh while it resumes."""
    if mesh is None or not mesh.distributed:
        return
    extremes = torch.tensor([epoch, -epoch], dtype=torch.float64, device=mesh.device)
    mesh_lib.all_reduce(mesh, extremes, "max", over="all")
    high, low = int(extremes[0]), -int(extremes[1])
    if high != low:
        raise RuntimeError(f"--resume sees inconsistent train_state.ckpt across processes (epochs {low} to {high}, "
                           "-2 = missing); resuming over several hosts needs the experiment dir on storage every "
                           "process shares")


def build_mesh(args) -> mesh_lib.Mesh:
    """The training mesh over the initialized process group, one card a
    process. A ``model`` axis asked for is 2 where the processes (a host's,
    for ``replica``) are even, else 1: ``sensorium_tpu/cli/train.py``'s rule."""
    world = dist.get_world_size()
    if args.mesh.startswith("replica"):
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        num_model = 2 if "model" in args.mesh and per_host % 2 == 0 else 1
        return mesh_lib.create_hybrid_mesh(num_model=num_model)
    num_model = 2 if "model" in args.mesh and world % 2 == 0 else 1
    return mesh_lib.create_mesh(num_model=num_model)


def train_folds(args, config: dict, folds_splits: list[str], mesh: mesh_lib.Mesh | None = None) -> None:
    """Train ``folds_splits`` one after another in this process (over ``mesh``, if given)."""
    experiment_dir = constants.experiments_dir / args.experiment
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
                                resume=args.resume, async_checkpoint=args.async_checkpoint, device=args.device,
                                mesh=mesh, sharded_checkpoint=args.sharded_checkpoint)
            except TrainingPreempted as preempted:
                print(f"Preempted: {preempted}. Rerun with --resume to continue.")
                raise SystemExit(75)  # EX_TEMPFAIL
    finally:
        debug_nans(False)


def run_rank(local_rank: int, args, config: dict, folds_splits: list[str], spec: str, local_size: int,
             paths: dict | None = None) -> None:
    """One rank: join the process group of ``spec``, build the mesh, train the folds."""
    if paths is not None:  # a spawned rank: the launcher's directories
        for name, value in paths.items():
            setattr(constants, name, value)
    device_type = torch.device(args.device).type
    rank = multihost.init_from_spec(spec, device_type, local_rank=local_rank, local_size=local_size)
    try:
        mesh = build_mesh(args)
        print(f"Mesh: {mesh.shape}, process {mesh.index} of {mesh.processes} on {mesh.device}", flush=True)
        if args.device != "cpu":
            args.device = str(rank.device)
        train_folds(args, config, folds_splits, mesh)
    finally:
        multihost.shutdown()


def launch_ranks(args, config: dict, folds_splits: list[str], spec: str, cards: int) -> None:
    """Start one rank a card (spawn) and wait for them. SIGTERM and SIGINT go
    on to the ranks, which agree on the signal, save and exit 75. Exits 75
    if a rank did, 1 if one failed (the others are then killed: they would
    wait in a collective for it)."""
    import torch.multiprocessing as mp

    context = mp.get_context("spawn")
    paths = {name: getattr(constants, name) for name in PATHS}
    ranks = [context.Process(target=run_rank, args=(i, args, config, folds_splits, spec, cards, paths))
             for i in range(cards)]
    signalled = {"signal": None}

    def on_signal(signum, frame):
        signalled["signal"] = signum
        for proc in ranks:
            if proc.pid is not None and proc.exitcode is None:
                os.kill(proc.pid, signal.SIGTERM)

    previous = {sig: signal.signal(sig, on_signal) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        for proc in ranks:
            proc.start()
        while any(proc.exitcode is None for proc in ranks):
            if any(proc.exitcode not in (None, 0, 75) for proc in ranks):
                break
            time.sleep(0.2)
    finally:
        for proc in ranks:
            if proc.exitcode is None and any(p.exitcode not in (None, 0, 75) for p in ranks):
                proc.kill()
            proc.join()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    codes = [proc.exitcode for proc in ranks]
    print(f"Ranks exited with {codes}", flush=True)
    if any(code not in (0, 75) for code in codes):
        raise SystemExit(1)
    if 75 in codes or signalled["signal"] is not None:
        raise SystemExit(75)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main(argv=None) -> None:
    args = parse_arguments(argv)
    print("Experiment:", args.experiment)
    if args.multihost is not None:
        if args.fold_procs != "1":
            raise SystemExit("--multihost and --fold-procs are mutually exclusive")
        if args.no_mesh:
            raise SystemExit("--multihost requires a device mesh")

    config_path = constants.configs_dir / f"{args.experiment}.py"
    if not config_path.exists():
        raise RuntimeError(f"Config '{config_path}' does not exist")
    config = SourceFileLoader(args.experiment, str(config_path)).load_module().config
    experiment_dir = constants.experiments_dir / args.experiment

    if args.folds == "all":
        folds_splits = constants.folds_splits
    else:
        folds_splits = [f"fold_{fold}" for fold in args.folds.split(",")]

    if args.multihost == "auto":
        # torchrun started this process as one rank.
        if int(os.environ.get("RANK", 0)) == 0:
            snapshot(config, config_path, experiment_dir)
        run_rank(int(os.environ.get("LOCAL_RANK", 0)), args, config, folds_splits, "auto",
                 int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        return
    host_id = 0 if args.multihost is None else multihost.parse_spec(args.multihost)[2]
    if host_id == 0:
        snapshot(config, config_path, experiment_dir)

    fold_procs = resolve_fold_procs(args.fold_procs)
    if fold_procs > 1:
        run_parallel_folds(args, folds_splits, experiment_dir, fold_procs)
        return

    cards = mesh_cards(args)
    if args.multihost is None and cards == 1:
        train_folds(args, config, folds_splits)
        return
    spec = args.multihost or f"127.0.0.1:{free_port()},1,0"
    print(f"Data parallel over {cards} cards a host ({spec})", flush=True)
    if cards == 1:
        run_rank(0, args, config, folds_splits, spec, 1)
    else:
        launch_ranks(args, config, folds_splits, spec, cards)


if __name__ == "__main__":
    main()
