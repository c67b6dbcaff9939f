"""The benchmark program: the flagship model's throughput on the card.

Port of ``bench.py``, mode for mode, with its metric names. The headline is
clips/s of the full training step (forward over all 10 readouts, the
Poisson loss, the backward, AdamW and the EMA, bf16 compute) of the
``true_batch_001`` DwiseNeuro at global batch 32: the reference's training
regime, which sustains ~35 clips/s on an RTX A6000 with AMP fp16
(``BASELINE.md``: 72,000 samples x 21 epochs / 12 h).

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"detail"}``. Every mode's ``detail`` names the card and its power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
``peak_memory_gb`` (``torch.cuda.max_memory_allocated`` over the timed
part, reset before it) and ``dw_impl``, the depthwise-conv route
(``SENSORIUM_DW_IMPL``: ``cuda``, the hand-written kernels, by default;
``cudnn``, PyTorch's grouped ``conv3d``). All device timing ends in
``torch.cuda.synchronize()`` (a host copy of the loss, or of a result).

Modes (flags):
  (none)      headline training throughput on the active depthwise route
  --ab        the headline once a route, ``cuda`` and ``cudnn``, each in a
              child process; the value is the faster one's
  --fit       the fit loop end to end: synthetic memory-mapped trials ->
              threaded loader -> staging to the card -> step, through
              MouseModel.fit; also the same loop over batches already on
              the card and the bare step
  --distill   distillation training throughput (student + frozen teacher)
  --infer     the sliding-window Predictor's window forwards/s
  --infer-mesh  Predictor over a data mesh of the visible cards (one card:
              the card twice) against one unsharded Predictor: parity and
              window forwards/s
  --loader    host input pipeline throughput (samples/s) on synthetic
              memory-mapped files, native C++ assembly on and off;
              --threads 1,2,4,8 also sweeps worker counts
  --all       every mode in a fresh child process, one combined JSON line
              (forwards --ab / --trace to the train child)
  --trace DIR also a torch.profiler trace of the timed steps
  --device    cuda (default) or cpu; the CPU only when asked for

    python -m sensorium_tpu_torch.tools.bench [--fit | --distill | --infer | --infer-mesh |
        --loader [--threads 1,2,4,8] | --ab | --all] [--trace DIR] [--device cpu]

Environment: ``SENSORIUM_REMAT=0``, ``SENSORIUM_REMAT_BLOCKS=spec`` and
``SENSORIUM_BENCH_NODROP=1`` change the flagship config
(``_flagship_params``); ``SENSORIUM_BENCH_MEM=1`` adds the train step's
memory; ``SENSORIUM_INFER_CHUNK`` sets --infer's chunk (32);
``SENSORIUM_LOADER_THREADS`` the loader's threads (8);
``SENSORIUM_BENCH_INIT_TIMEOUT`` the seconds allowed to reach the card
(300). Without a card and without ``--device cpu`` the line carries
``"value": null`` and the exit code is 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent  # the checkout: child processes run from here

BASELINE_CLIPS_PER_SEC = 35.0  # the reference's training rate (BASELINE.md)
# The reference publishes no inference rate; its eval loop runs batch-1
# single-readout forwards (predictors.py:46-51). A generous stand-in: those
# forwards as fast as an ideal batch-32 forward-only pass, a third of the
# forward + backward work, so 3 x 35 window forwards/s. Real batch-1 use of
# a GPU is far lower, so the printed ratio understates the speedup.
BASELINE_INFER_WINDOWS_PER_SEC = 3.0 * BASELINE_CLIPS_PER_SEC
BATCH = 32
FRAMES, HEIGHT, WIDTH = 16, 64, 64
WARMUP_STEPS = 3
MEASURE_STEPS = 10
VIDEO = (36, 64)  # (H, W) of a trial's frames, as in the dataset
INFER_TRIALS, INFER_LENGTH = 3, 300
LOADER_EPOCH_SIZE = 2560
FIT_EPOCH_SIZE = 960  # 30 batches of 32
DEVICE_BATCHES = 8  # --fit's batches already on the card
CHILD_TIMEOUT = 3600  # seconds
MESH_REL_TOL = 1e-5  # --infer-mesh parity, of the largest output (chip_smoke.py phase 19a)

MODES = {
    "train": ("train_clips_per_sec_per_chip_b32_fwd_bwd", "clips/s"),
    "fit": ("fit_loop_clips_per_sec_b32", "clips/s"),
    "distill": ("distill_train_clips_per_sec_b32_fwd_bwd", "clips/s"),
    "infer": ("infer_window_forwards_per_sec", "windows/s"),
    "infer_mesh": ("infer_mesh_window_forwards_per_sec", "windows/s"),
    "loader": ("loader_samples_per_sec", "samples/s"),
}


# ---------------------------------------------------------------- the workload


def _load_config(name: str) -> dict:
    from importlib.machinery import SourceFileLoader

    path = PACKAGE / "configs" / f"{name}.py"
    return SourceFileLoader(name, str(path)).load_module().config["argus_params"]


def _flagship_params() -> dict:
    """The production ``true_batch_001`` argus params from the port's config
    (the bench measures what training runs), with diagnostic overrides:

    * ``SENSORIUM_REMAT=0`` / ``SENSORIUM_REMAT_BLOCKS=spec``: which core
      blocks are recomputed in the backward. "2" is the first two blocks,
      "0,7,8" exactly those, and a trailing comma ("1,") the index-set form
      of one block (the config's ``remat_blocks=(1,)``);
    * ``SENSORIUM_BENCH_NODROP=1``: dropout and drop-path off.
    """
    params = _load_config("true_batch_001")
    nn_name, nn_kwargs = params["nn_module"]
    nn_kwargs = dict(nn_kwargs)
    nn_kwargs["remat"] = os.environ.get("SENSORIUM_REMAT", "1") != "0"
    if os.environ.get("SENSORIUM_REMAT_BLOCKS"):
        spec = os.environ["SENSORIUM_REMAT_BLOCKS"]
        nn_kwargs["remat_blocks"] = (
            tuple(int(v) for v in spec.split(",") if v.strip()) if "," in spec else int(spec)
        )
    if os.environ.get("SENSORIUM_BENCH_NODROP"):
        nn_kwargs["drop_rate"] = 0.0
        nn_kwargs["drop_path_rate"] = 0.0
    return dict(params, nn_module=(nn_name, nn_kwargs))


def _distill_params() -> tuple[dict, dict]:
    """(student, teacher): ``distillation_001`` and ``true_batch_001``, as the configs hold them."""
    return _load_config("distillation_001"), _load_config("true_batch_001")


def build(device):
    """The flagship ``MouseModel`` on ``device`` with its EMA and state."""
    from sensorium_tpu_torch.engine.model import MouseModel

    model = MouseModel(_flagship_params(), device=device)
    model.set_ema(0.999)
    model.build_state(seed=0, learning_rate=2.4e-3)
    return model


def _num_neurons(params: dict) -> int:
    return max(params["nn_module"][1]["readout_outputs"])


def synthetic_arrays(num_neurons: int | None = None):
    """One batch's (inputs, targets, weights) as numpy arrays: uniform 0-255
    video, gamma(1.5, 1) responses, one-hot mouse ``i % 10``."""
    import numpy as np

    from sensorium_tpu_torch import constants

    num_neurons = constants.max_num_neurons if num_neurons is None else num_neurons
    rng = np.random.default_rng(0)
    inputs = rng.uniform(0, 255, (BATCH, 5, FRAMES, HEIGHT, WIDTH)).astype(np.float32)
    targets = rng.gamma(1.5, 1.0, (BATCH, num_neurons, FRAMES)).astype(np.float32)
    weights = np.zeros((BATCH, constants.num_mice), np.float32)
    weights[np.arange(BATCH), np.arange(BATCH) % constants.num_mice] = 1.0
    return inputs, targets, weights


def synthetic_batch(model):
    """``synthetic_arrays`` staged once on the model's device, as its steps stage a batch."""
    from sensorium_tpu_torch.data.datasets import MiceBatch

    arrays = synthetic_arrays(_num_neurons(model.params))
    return MiceBatch(*model._stage(MiceBatch(*arrays)))


def _make_device_batch(rng, model):
    """A full-shape synthetic batch staged on the model's device (a random mouse a row)."""
    import numpy as np

    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.data.datasets import MiceBatch

    inputs = rng.uniform(0, 255, (BATCH, 5, FRAMES, HEIGHT, WIDTH)).astype(np.float32)
    targets = rng.gamma(1.5, 1.0, (BATCH, _num_neurons(model.params), FRAMES)).astype(np.float32)
    weights = np.zeros((BATCH, constants.num_mice), np.float32)
    weights[np.arange(BATCH), rng.integers(0, constants.num_mice, BATCH)] = 1.0
    return MiceBatch(*model._stage(MiceBatch(inputs, targets, weights)))


# ------------------------------------------------------------- measuring aids


def _is_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    import torch

    if _is_card(device):
        torch.cuda.synchronize()


def _reset_peak(device) -> None:
    import torch

    if _is_card(device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(device) -> float | None:
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if _is_card(device) else None


def _reset_launches() -> None:
    from sensorium_tpu_torch.ops import dw_kernels

    for key in dw_kernels.LAUNCHES:
        dw_kernels.LAUNCHES[key] = 0


def _launches_per(count: int) -> dict:
    from sensorium_tpu_torch.ops import dw_kernels

    return {key: value / count for key, value in dw_kernels.LAUNCHES.items() if value}


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def _device_detail(device) -> dict:
    """What every mode's ``detail`` names: the card, the depthwise route and the peak memory."""
    from sensorium_tpu_torch.ops.conv import _dw_implementation

    return {"card": nvidia_smi_line() if _is_card(device) else "cpu", "dw_impl": _dw_implementation(),
            "peak_memory_gb": _peak_gb(device)}


def _unbuilt_kernels() -> list[str]:
    """The ``csrc/*.cu`` sources with no up-to-date library yet: what a first launch would compile."""
    from sensorium_tpu_torch.ops import _build

    return [p.stem for p in sorted(_build.SOURCE_DIR.glob("*.cu")) if not _build.library_path(p.stem).exists()]


def _kernel_build_state(device, unbuilt_before: list[str]) -> dict:
    """``cold`` when this run compiled ``csrc/*.cu`` sources (its warm-up
    includes nvcc), ``warm`` when every library it launched was built
    already; the CPU runs no kernel."""
    if not _is_card(device):
        return {"state": "none (cpu)", "sources_compiled": []}
    compiled = sorted(set(unbuilt_before) - set(_unbuilt_kernels()))
    return {"state": "cold" if compiled else "warm", "sources_compiled": compiled}


@contextlib.contextmanager
def _stdout_to_stderr():
    """Whatever the measured code prints goes to stderr: stdout carries the
    one JSON line. The engine's log lines go to the 'sensorium' logger's
    stdout handler, which is pointed at stderr meanwhile."""
    logger = logging.getLogger("sensorium")
    moved = [h for h in logger.handlers if type(h) is logging.StreamHandler and h.stream is sys.stdout]
    for handler in moved:
        handler.setStream(sys.stderr)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            yield
    finally:
        for handler in moved:
            handler.setStream(sys.stdout)


# -------------------------------------------------------------------- train


def measure_train(device, trace_dir: str | None = None) -> dict:
    """Train-step and eval-forward clips/s on the active depthwise route."""
    import torch

    from sensorium_tpu_torch.utils.profiling import Stopwatch, trace

    unbuilt = _unbuilt_kernels()
    watch = Stopwatch()
    with watch.section("build"):
        model = build(device)
        batch = synthetic_batch(model)
    built_bytes = torch.cuda.memory_allocated() if _is_card(device) else None

    with watch.section("warmup_train"):  # the kernels' first launches, nvcc included when cold
        for _ in range(WARMUP_STEPS):
            loss = model.train_step(batch)
        float(loss)

    _reset_peak(device)
    _reset_launches()
    ctx = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    with ctx:
        with watch.section("train_steps"):
            start = time.perf_counter()
            for _ in range(MEASURE_STEPS):
                loss = model.train_step(batch)
            loss_last = float(loss)
            train_elapsed = time.perf_counter() - start
    launches = _launches_per(MEASURE_STEPS)
    detail = _device_detail(device)

    with watch.section("warmup_eval"):
        loss, _, _, _ = model.val_step(batch)
        float(loss)
    with watch.section("eval_steps"):
        start = time.perf_counter()
        for _ in range(MEASURE_STEPS):
            loss, _, _, _ = model.val_step(batch)
        float(loss)
        eval_elapsed = time.perf_counter() - start

    detail.update({
        "train_clips_per_sec": round(BATCH * MEASURE_STEPS / train_elapsed, 2),
        "eval_clips_per_sec": round(BATCH * MEASURE_STEPS / eval_elapsed, 2),
        "train_step_seconds": round(train_elapsed / MEASURE_STEPS, 5),
        "loss_last": loss_last,
        "kernel_launches_per_step": launches,
        "phase_seconds": {k: round(v, 3) for k, v in watch.summary().items()},
        "kernel_build": _kernel_build_state(device, unbuilt),
    })
    if trace_dir:
        detail["trace_dir"] = str(trace_dir)
    if os.environ.get("SENSORIUM_BENCH_MEM") and built_bytes is not None:
        # The weights, EMA, optimizer state and staged batch, then what a step adds on top at its peak.
        detail["train_step_memory_gb"] = {
            "after_build_and_staging": round(built_bytes / 1e9, 3),
            "step_peak_above_that": round(detail["peak_memory_gb"] - built_bytes / 1e9, 3),
        }
    return detail


def measure_train_subprocess(dw_impl: str, device, trace_dir: str | None = None) -> dict:
    """The headline on one depthwise route, in a fresh process."""
    env = dict(os.environ)
    env["SENSORIUM_DW_IMPL"] = dw_impl
    cmd = [sys.executable, "-m", "sensorium_tpu_torch.tools.bench", "--device", str(device)]
    if trace_dir:
        # A directory a route: two children tracing into one would interleave their files.
        cmd += ["--trace", os.path.join(trace_dir, dw_impl)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT, cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"bench child ({dw_impl}) failed:\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["detail"]


# --------------------------------------------------------------- data feed


def _write_synth_tree(root, length: int = 300, trials: int = 4) -> None:
    """Synthetic memory-mapped trials for every mouse at production geometry."""
    import numpy as np

    from sensorium_tpu_torch import constants

    rng = np.random.default_rng(0)
    for mouse in constants.mice:
        mdir = root / mouse
        for sub in ("data/videos", "data/behavior", "data/pupil_center",
                    "data/responses", "meta/trials", "meta/neurons"):
            (mdir / sub).mkdir(parents=True)
        np.save(mdir / "meta/trials/tiers.npy", np.array(["train"] * trials))
        n_neurons = constants.mouse2num_neurons[mouse]
        np.save(mdir / "meta/neurons/unit_ids.npy",
                np.arange(1, n_neurons + 1, dtype=np.int64))
        np.save(mdir / "meta/neurons/cell_motor_coordinates.npy",
                rng.uniform(0, 100, (n_neurons, 3)).astype(np.float32))
        for trial in range(trials):
            np.save(mdir / f"data/videos/{trial}.npy",
                    rng.uniform(0, 255, (36, 64, length)).astype(np.float32))
            np.save(mdir / f"data/behavior/{trial}.npy",
                    rng.uniform(0, 5, (2, length)).astype(np.float32))
            np.save(mdir / f"data/pupil_center/{trial}.npy",
                    rng.uniform(50, 200, (2, length)).astype(np.float32))
            np.save(mdir / f"data/responses/{trial}.npy",
                    rng.gamma(1.5, 1.0, (n_neurons, length)).astype(np.float32))


@contextlib.contextmanager
def _synth_data():
    """``_write_synth_tree`` in a temporary directory, as the data root
    meanwhile. Folds by trial index (``SENSORIUM_FOLD_ASSIGNMENT=trial``):
    every trial is a train trial in some fold either way, and the video hash
    would need Pillow."""
    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.data import mouse_data

    old_dir, old_assignment = constants.sensorium_dir, os.environ.get("SENSORIUM_FOLD_ASSIGNMENT")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_synth_tree(root)
        constants.sensorium_dir = root
        os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = "trial"
        mouse_data.get_folds_tiers.cache_clear()
        try:
            yield root
        finally:
            constants.sensorium_dir = old_dir
            if old_assignment is None:
                os.environ.pop("SENSORIUM_FOLD_ASSIGNMENT", None)
            else:
                os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = old_assignment
            mouse_data.get_folds_tiers.cache_clear()


def _make_train_dataset(epoch_size: int):
    """Production-geometry ``TrainMiceDataset`` (CutMix 0.5, 64x64, 31-frame
    windows) over whatever tree ``constants.sensorium_dir`` points at."""
    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.data.datasets import TrainMiceDataset
    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.data.inputs import get_inputs_processor
    from sensorium_tpu_torch.data.mixers import CutMix
    from sensorium_tpu_torch.data.mouse_data import get_mouse_data
    from sensorium_tpu_torch.data.responses import get_responses_processor

    mice_data = [get_mouse_data(m, tuple(constants.folds_splits)) for m in constants.mice]
    return TrainMiceDataset(
        mice_data,
        WindowIndexer(size=FRAMES, step=2, position="last"),
        get_inputs_processor("stack_inputs", {"size": (HEIGHT, WIDTH), "pad_fill_value": 0.0}),
        get_responses_processor("identity", {}),
        mouse_epoch_size=epoch_size // constants.num_mice,
        mixer=CutMix(alpha=1.0, prob=0.5),  # true_batch_001.py's cutmix
    )


def _loader_rate(loader, epochs: int, skip_first: bool) -> float:
    """The best samples/s of ``epochs`` passes (the first left out with ``skip_first``)."""
    best = 0.0
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        count = 0
        start = time.perf_counter()
        for batch in loader:
            count += len(batch.inputs)
        if epoch > 0 or not skip_first:
            best = max(best, count / (time.perf_counter() - start))
    return best


def measure_loader(sweep_threads: list[int] | None = None) -> dict:
    """Host input-pipeline throughput at the real training shapes.

    ``MiceDataLoader`` samples/s over synthetic memory-mapped trials (31-frame
    windows, 64x64 canvas, CutMix prob 0.5 as in true_batch_001), with the
    native C++ assembly on and off. Each path runs a warm-up epoch (the
    first pass over fresh files pays page-cache faults) and reports the best
    of two timed epochs. ``feed_budget`` gives the rate per worker thread;
    ``--all`` sets it beside the train child's clips/s, which is what one
    card consumes. ``sweep_threads`` also measures the native path at each
    worker count (``SENSORIUM_LOADER_THREADS``, which bypasses the clamp to
    the usable cores).
    """
    from sensorium_tpu_torch.data import native as native_mod
    from sensorium_tpu_torch.data.loader import MiceDataLoader, resolve_workers

    results: dict = {}
    with _synth_data():
        try:
            num_threads = int(os.environ.get("SENSORIUM_LOADER_THREADS", "8"))
            for use_native in (True, False):
                os.environ["SENSORIUM_NATIVE"] = "1" if use_native else "0"
                native_mod.reset()
                loader = MiceDataLoader(_make_train_dataset(LOADER_EPOCH_SIZE), batch_size=BATCH,
                                        num_threads=num_threads)
                key = "native_samples_per_sec" if use_native else "numpy_samples_per_sec"
                results[key] = round(_loader_rate(loader, 3, skip_first=True), 1)
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            # The rate is an aggregate over the threads the loader ran (clamped to the usable cores).
            workers_used = resolve_workers(num_threads)
            aggregate = results["native_samples_per_sec"]
            results["feed_budget"] = {
                "host_cores": cores,
                "loader_threads": workers_used,
                "aggregate_samples_per_sec": round(aggregate, 1),
                "per_core_samples_per_sec": round(aggregate / workers_used, 1),
            }
            if sweep_threads:
                # The native path (the production loader), the page cache warm from the runs above.
                os.environ["SENSORIUM_NATIVE"] = "1"
                native_mod.reset()
                sweep = {}
                old_threads = os.environ.get("SENSORIUM_LOADER_THREADS")
                try:
                    for n in sweep_threads:
                        os.environ["SENSORIUM_LOADER_THREADS"] = str(n)
                        loader = MiceDataLoader(_make_train_dataset(LOADER_EPOCH_SIZE), batch_size=BATCH,
                                                num_threads=n)
                        sweep[str(n)] = round(_loader_rate(loader, 2, skip_first=False), 1)
                finally:
                    if old_threads is None:
                        os.environ.pop("SENSORIUM_LOADER_THREADS", None)
                    else:
                        os.environ["SENSORIUM_LOADER_THREADS"] = old_threads
                results["thread_sweep"] = sweep
                results["thread_sweep_note"] = (
                    f"aggregate native-fill samples/s by worker-thread count on a {cores}-core host; "
                    "SENSORIUM_LOADER_THREADS bypasses the clamp to the usable cores, so counts beyond "
                    "them measure oversubscription, which the loader's own sizing (resolve_workers) never "
                    "reaches"
                )
        finally:
            os.environ.pop("SENSORIUM_NATIVE", None)
            native_mod.reset()
    return results


class _TimedLoader:
    """A loader whose passes record the seconds spent blocked in ``next()``
    and, once the card has finished the pass's work, the pass's seconds."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = device
        self.passes: list[dict] = []

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        record = {"batches": 0, "wait_seconds": 0.0}
        start = time.perf_counter()
        batches = iter(self.loader)
        while True:
            before = time.perf_counter()
            batch = next(batches, None)
            record["wait_seconds"] += time.perf_counter() - before
            if batch is None:
                break
            record["batches"] += 1
            yield batch
        _sync(self.device)
        record["seconds"] = time.perf_counter() - start
        self.passes.append(record)


class _DeviceLoader:
    """Batches already on the card, as a loader."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def measure_fit(device) -> dict:
    """Training throughput through the real fit loop.

    The headline times the step on a batch already on the card; this mode
    shows what the system sustains: synthetic memory-mapped trials ->
    threaded zero-copy loader -> staging to the card -> step, driven by
    ``MouseModel.fit`` as ``cli/train.py`` runs it. Epoch 0 pays the
    warm-up and the page cache; the rate is the best of epochs 1-2, and
    ``loader_wait_pct`` that epoch's seconds blocked in the loader's
    ``next()`` over its wall. ``h2d_mb_per_sec`` is one batch staged by the
    model (inputs cast to bf16 on the host, then copied). The same
    ``fit`` over ``DEVICE_BATCHES`` batches already on the card, and the
    bare step, separate the loop's own cost from the feed.
    """
    import numpy as np

    from sensorium_tpu_torch.data.loader import MiceDataLoader
    from sensorium_tpu_torch.engine.model import MouseModel

    with _synth_data():
        dataset = _make_train_dataset(FIT_EPOCH_SIZE)
        num_threads = int(os.environ.get("SENSORIUM_LOADER_THREADS", "8"))
        loader = MiceDataLoader(dataset, batch_size=BATCH, shuffle=True, num_threads=num_threads, drop_last=True)
        timed = _TimedLoader(loader, device)

        model = MouseModel(_flagship_params(), device=device)
        model.set_ema(0.999)
        model.build_state(seed=0, learning_rate=2.4e-3)

        batch_it = iter(loader)
        batch = next(batch_it)
        batch_it.close()  # stops the producer threads now
        nbytes = batch.inputs.nbytes + batch.targets.nbytes + batch.weights.nbytes
        staged_nbytes = sum(t.numel() * t.element_size() for t in model._stage(batch))

        def stage_and_drain():
            model._stage(batch)
            _sync(device)

        stage_and_drain()  # warms the copy path
        start = time.perf_counter()
        for _ in range(3):
            stage_and_drain()
        stage_s = (time.perf_counter() - start) / 3

        epochs = {}
        for epoch in range(3):  # epoch 0: the warm-up and the page cache
            if epoch == 1:
                _reset_peak(device)
                _reset_launches()
            start = time.perf_counter()
            model.fit(timed, num_epochs=1, start_epoch=epoch)
            epochs[f"epoch{epoch}_s"] = round(time.perf_counter() - start, 3)
        launches = _launches_per(2 * len(loader))
        best_epoch = 1 if epochs["epoch1_s"] <= epochs["epoch2_s"] else 2
        best = len(loader) * BATCH / epochs[f"epoch{best_epoch}_s"]
        wait = timed.passes[best_epoch]["wait_seconds"]
        detail = _device_detail(device)

        rng = np.random.default_rng(7)
        prestaged = [_make_device_batch(rng, model) for _ in range(DEVICE_BATCHES)]
        # The bare step on the first batch: the rate the fit loop must sustain.
        float(model.train_step(prestaged[0]))
        start = time.perf_counter()
        for _ in range(MEASURE_STEPS):
            loss = model.train_step(prestaged[0])
        float(loss)
        bare = BATCH * MEASURE_STEPS / (time.perf_counter() - start)

        dev_loader = _DeviceLoader(prestaged)
        dev_epochs = []
        for epoch in range(3):
            start = time.perf_counter()
            model.fit(dev_loader, num_epochs=1, start_epoch=epoch)
            dev_epochs.append(time.perf_counter() - start)
        dev_rate = len(prestaged) * BATCH / min(dev_epochs[1:])

    detail.update({
        "fit_clips_per_sec": round(best, 2),
        "batches_per_epoch": len(loader),
        "loader_wait_pct": round(100 * wait / epochs[f"epoch{best_epoch}_s"], 2),
        "loader_wait_seconds": round(wait, 3),
        "batch_mb": round(nbytes / 2**20, 2),
        "staged_batch_mb": round(staged_nbytes / 2**20, 2),
        "stage_ms": round(1e3 * stage_s, 3),
        "h2d_mb_per_sec": round(staged_nbytes / 2**20 / stage_s, 1),
        **epochs,
        "kernel_launches_per_step": launches,
        "device_fit_clips_per_sec": round(dev_rate, 2),
        "bare_step_clips_per_sec": round(bare, 2),
        "fit_loop_efficiency_pct": round(100 * dev_rate / bare, 1),
    })
    return detail


# ----------------------------------------------------------------- distill


def measure_distill(device) -> dict:
    """Distillation training throughput: the ``distillation_001`` student
    (EMA 0.999) and the frozen ``true_batch_001`` teacher (seed 1) on one
    card, the highest-memory training regime."""
    from sensorium_tpu_torch.engine.model import MouseModel

    student_cfg, teacher_cfg = _distill_params()
    teacher = MouseModel(teacher_cfg, device=device)
    teacher.build_state(seed=1, learning_rate=0.0)
    teacher_module = teacher.nn_module
    teacher.state = None  # the teacher's optimizer state is not needed
    del teacher

    student = MouseModel(student_cfg, device=device)
    student.set_ema(0.999)
    student.build_state(seed=0, learning_rate=2.4e-3)
    student.set_distill(teacher_module, 0.36)
    batch = synthetic_batch(student)
    for _ in range(WARMUP_STEPS):
        loss = student.train_step(batch)
    loss_first = float(loss)

    _reset_peak(device)
    _reset_launches()
    start = time.perf_counter()
    for _ in range(MEASURE_STEPS):
        loss = student.train_step(batch)
    loss_last = float(loss)
    elapsed = time.perf_counter() - start
    detail = _device_detail(device)
    detail.update({
        "distill_clips_per_sec": round(BATCH * MEASURE_STEPS / elapsed, 2),
        "train_step_seconds": round(elapsed / MEASURE_STEPS, 5),
        "loss_first": round(loss_first, 4),
        "loss_last": round(loss_last, 4),
        "kernel_launches_per_step": _launches_per(MEASURE_STEPS),
    })
    return detail


# ------------------------------------------------------------------- infer


def _trials(count: int, length: int):
    """``count`` trials' (videos, behaviors, pupils), distinct arrays a trial."""
    import numpy as np

    rng = np.random.default_rng(0)
    videos = [rng.uniform(0, 255, (*VIDEO, length)).astype(np.float32) for _ in range(count)]
    behaviors = [rng.uniform(0, 5, (2, length)).astype(np.float32) for _ in range(count)]
    pupils = [rng.uniform(50, 200, (2, length)).astype(np.float32) for _ in range(count)]
    return videos, behaviors, pupils


def _flagship_checkpoint(device, directory: str) -> str:
    """The flagship model from seed 0, saved as a model checkpoint."""
    from sensorium_tpu_torch.engine.model import MouseModel

    model = MouseModel(_flagship_params(), device=device)
    model.build_state(seed=0, learning_rate=0.0)
    path = f"{directory}/model-001-0.000001.ckpt"
    model.save(path)
    return path


def measure_infer(device) -> dict:
    """The sliding-window Predictor on ``INFER_TRIALS`` trials of
    ``INFER_LENGTH`` frames. The reference runs T-30 sequential batch-1
    forwards a trial (predictors.py:46-54); the Predictor gathers windows on
    the card and forwards them in chunks. Four rates: each trial's result
    copied to the host (``window_forwards_per_sec``); left on the card with
    one scalar read a trial (``device_*``); the trials back to back with one
    synchronize at the end (``pipelined_*``, the headline, the cadence of
    ``cli/predict.py``); and the same over trials staged on the card
    beforehand (``device_resident_*``: no copy to the card in the timed part).
    """
    from sensorium_tpu_torch.infer.predictor import Predictor

    chunk_size = int(os.environ.get("SENSORIUM_INFER_CHUNK", "32"))
    with tempfile.TemporaryDirectory() as tmp:
        predictor = Predictor(_flagship_checkpoint(device, tmp), chunk_size=chunk_size, device=device)

    length, trials = INFER_LENGTH, INFER_TRIALS
    videos, behaviors, pupils = _trials(trials, length)
    windows = len(predictor.indexes_generator.valid_anchors(length))
    chunk_forwards = trials * math.ceil(windows / chunk_size)

    predictor.predict_trial(videos[0], behaviors[0], pupils[0], mouse_index=0)  # the kernels' first launches
    _reset_peak(device)
    _reset_launches()
    start = time.perf_counter()
    for t in range(trials):
        out = predictor.predict_trial(videos[t], behaviors[t], pupils[t], mouse_index=0)
    elapsed = time.perf_counter() - start
    launches = _launches_per(chunk_forwards)

    start = time.perf_counter()
    for t in range(trials):
        res = predictor.predict_trial_device(videos[t], behaviors[t], pupils[t], mouse_index=0)
        float(res[0, 0])
    device_elapsed = time.perf_counter() - start

    start = time.perf_counter()
    results = [predictor.predict_trial_device(videos[t], behaviors[t], pupils[t], mouse_index=0)
               for t in range(trials)]
    _sync(device)
    pipelined_elapsed = time.perf_counter() - start

    staged = [predictor.stage_trial(videos[t], behaviors[t], pupils[t]) for t in range(trials)]
    predictor.run_staged(staged[0], 0)
    _sync(device)
    start = time.perf_counter()
    results = [predictor.run_staged(s, 0) for s in staged]
    _sync(device)
    device_resident_elapsed = time.perf_counter() - start
    del results

    detail = _device_detail(device)
    detail.update({
        "device_resident_window_forwards_per_sec": round(trials * windows / device_resident_elapsed, 1),
        "blended_frames_per_sec": round(trials * length / elapsed, 1),
        "pipelined_window_forwards_per_sec": round(trials * windows / pipelined_elapsed, 1),
        "window_forwards_per_sec": round(trials * windows / elapsed, 1),
        "trial_seconds": round(elapsed / trials, 4),
        "device_trial_seconds": round(device_elapsed / trials, 4),
        "device_window_forwards_per_sec": round(trials * windows / device_elapsed, 1),
        "chunk_size": chunk_size,
        "kernel_launches_per_chunk_forward": launches,
        "prediction_shape": list(out.shape),
    })
    return detail


def measure_infer_mesh(device) -> dict:
    """The Predictor over a data mesh of this process's devices against one
    unsharded Predictor, on the flagship model at full canvas.

    The mesh is every visible card (one card: the card twice; ``--device
    cpu``: the CPU twice), a chunk of ``n * (32 // n)`` windows split over
    the ``n`` replicas. Parity, as ``chip_smoke.py`` phase 19a holds it:
    against an unsharded Predictor whose chunk is one replica's share, on the
    frames that see only full chunks, within ``MESH_REL_TOL`` of the largest
    output (the frames of the short last chunk are reported beside). The
    rate stands beside the unsharded Predictor's at the same chunk.
    """
    import numpy as np
    import torch

    from sensorium_tpu_torch.infer.predictor import Predictor
    from sensorium_tpu_torch.parallel.mesh import create_mesh

    cards = torch.cuda.device_count() if _is_card(device) else 1
    n = max(2, cards)
    devices = [f"cuda:{i % cards}" for i in range(n)] if _is_card(device) else ["cpu"] * n
    chunk = n * (32 // n)
    mesh = create_mesh(num_data=n, devices=devices)
    videos, behaviors, pupils = _trials(INFER_TRIALS, INFER_LENGTH)

    def timed(predictor):
        predictor.predict_trial(videos[0], behaviors[0], pupils[0], mouse_index=0)
        _sync(device)
        start = time.perf_counter()
        outs = [predictor.predict_trial(videos[t], behaviors[t], pupils[t], mouse_index=0)
                for t in range(INFER_TRIALS)]
        return outs, time.perf_counter() - start

    with tempfile.TemporaryDirectory() as tmp:
        path = _flagship_checkpoint(device, tmp)
        plain = Predictor(path, chunk_size=chunk, device=device)
        share = Predictor(path, chunk_size=chunk // n, device=device)
        sharded = Predictor(path, chunk_size=chunk, mesh=mesh)
    windows = len(plain.indexes_generator.valid_anchors(INFER_LENGTH))
    _, plain_s = timed(plain)
    expected, _ = timed(share)
    _reset_peak(device)
    got, mesh_s = timed(sharded)

    same = windows // chunk * chunk  # frames [0, same) see only windows of full chunks
    scale = max(float(np.max(np.abs(e))) for e in expected) or 1.0
    diff_same = max(float(np.max(np.abs(g[:, :same] - e[:, :same]))) for g, e in zip(got, expected))
    diff_rest = max(float(np.max(np.abs(g[:, same:] - e[:, same:]))) for g, e in zip(got, expected))
    if not diff_same <= MESH_REL_TOL * scale:
        raise AssertionError(f"mesh Predictor diverged from one replica's: max |diff| {diff_same} on frames "
                             f"0-{same - 1}, tolerance {MESH_REL_TOL} x {scale}")
    detail = _device_detail(device)
    detail.update({
        "n_devices": n,
        "devices": devices,
        "mesh": dict(mesh.shape),
        "chunk_size": chunk,
        "windows": INFER_TRIALS * windows,
        "mesh_window_forwards_per_sec": round(INFER_TRIALS * windows / mesh_s, 2),
        "single_window_forwards_per_sec": round(INFER_TRIALS * windows / plain_s, 2),
        "parity_max_abs_diff": diff_same,
        "parity_max_abs_diff_last_chunk_frames": diff_rest,
        "parity_scale": scale,
        "prediction_shape": list(got[0].shape),
        "note": ("no baseline ratio: with fewer cards than devices the replicas share a card, so the rate "
                 "beside single_window_forwards_per_sec measures the mesh's cost, not a speedup"),
    })
    return detail


# -------------------------------------------------------------------- main


def _line(mode: str, value, vs_baseline, detail: dict, **extra) -> str:
    metric, unit = MODES[mode]
    return json.dumps({"metric": metric, "value": value, "unit": unit, "vs_baseline": vs_baseline,
                       **extra, "detail": detail})


def _init_backend_or_die(mode: str, timeout_s: float = 300.0) -> bool:
    """Reach the card under a watchdog. A process that cannot reach it (no
    card, or an initialization that blocks) prints the contract line with a
    null value for ``mode``; returns False for the caller to exit 1 (the
    watchdog exits the process itself when initialization blocks)."""
    import threading

    import torch

    out = sys.stdout

    def null_line(error: str) -> None:
        print(_line(mode, None, None, {"error": error}), file=out, flush=True)

    def die():
        null_line(f"CUDA initialization did not complete within {timeout_s:.0f}s")
        os._exit(1)

    timer = threading.Timer(timeout_s, die)
    timer.daemon = True
    timer.start()
    try:
        available = torch.cuda.is_available()
        if available:
            torch.zeros(1, device="cuda")
    finally:
        timer.cancel()
    if not available:
        null_line("torch.cuda.is_available() is False: the bench runs on the card (--device cpu to ask for the CPU)")
    return available


def child_mode_result(returncode: int, stdout: str, stderr: str) -> dict:
    """One ``--all`` child's outcome as its entry of the combined detail.

    Success is rc 0 with a parseable last line. A child that failed may
    still have printed its JSON line (a parity assertion exits 1 with an
    empty stderr): whichever of stderr and that line carries the detail is
    kept, so the record never holds an empty error.
    """
    lines = stdout.strip().splitlines()
    if returncode == 0:
        try:
            return json.loads(lines[-1])
        except (json.JSONDecodeError, IndexError) as exc:
            return {"error": f"unparseable output: {exc}"}
    err: dict = {"error": stderr.strip()[-500:]}
    for line in reversed(lines):
        try:
            err["child_json"] = json.loads(line)
            break
        except json.JSONDecodeError:
            continue
    if not err["error"]:
        err["error"] = f"rc={returncode}, no stderr"
    return err


def run_all(device: str, ab: bool, trace_dir: str | None) -> tuple[str, bool]:
    """Every mode in a child process; (the combined line, whether the headline was measured)."""
    train_flags = (["--ab"] if ab else []) + (["--trace", trace_dir] if trace_dir else [])
    combined: dict = {}
    for mode, flags in [
        ("train", train_flags),
        ("fit", ["--fit"]),
        ("distill", ["--distill"]),
        ("infer", ["--infer"]),
        ("infer_mesh", ["--infer-mesh"]),
        ("loader", ["--loader", "--threads", "1,2,4,8"]),
    ]:
        cmd = [sys.executable, "-m", "sensorium_tpu_torch.tools.bench", *flags, "--device", device]
        # One failed, hung or garbled mode must not lose the others.
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT, cwd=ROOT)
            combined[mode] = child_mode_result(proc.returncode, proc.stdout, proc.stderr)
        except subprocess.TimeoutExpired:
            combined[mode] = {"error": f"timeout after {CHILD_TIMEOUT}s"}
    headline = combined["train"].get("value")
    budget = combined["loader"].get("detail", {}).get("feed_budget")
    if headline and budget:
        # What one card consumes, measured by the train child of this run.
        budget["card_demand_samples_per_sec"] = headline
        budget["cards_fed_per_core"] = round(budget["per_core_samples_per_sec"] / headline, 2)
    vs = round(headline / BASELINE_CLIPS_PER_SEC, 3) if headline else None
    return _line("train", headline, vs, combined), headline is not None


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", action="store_true", help="the headline on both depthwise routes, cuda and cudnn")
    parser.add_argument("--loader", action="store_true", help="host loader throughput")
    parser.add_argument("--infer", action="store_true", help="Predictor throughput")
    parser.add_argument("--infer-mesh", action="store_true",
                        help="Predictor over a data mesh of the visible cards: parity and window forwards/s")
    parser.add_argument("--threads", default=None,
                        help="with --loader: comma-separated worker counts to sweep (e.g. 1,2,4,8)")
    parser.add_argument("--distill", action="store_true", help="distillation training throughput")
    parser.add_argument("--fit", action="store_true", help="fit-loop throughput (loader + staging + step)")
    parser.add_argument("--all", action="store_true",
                        help="every mode in a fresh child process; one combined JSON line")
    parser.add_argument("--trace", default=None, help="torch.profiler trace output directory")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    sweep = None
    if args.threads:
        try:
            sweep = [int(x) for x in args.threads.split(",") if x.strip()]
        except ValueError:
            parser.error(f"--threads must be comma-separated integers, got {args.threads!r}")

    import torch

    device = str(torch.device(args.device))
    if torch.device(device).type not in ("cuda", "cpu"):
        parser.error(f"--device must be cuda or cpu, got {args.device!r}")
    mode = ("fit" if args.fit else "distill" if args.distill else "infer" if args.infer
            else "infer_mesh" if args.infer_mesh else "loader" if args.loader else "train")

    if args.all:
        line, measured = run_all(device, args.ab, args.trace)
        print(line, flush=True)
        # The combined line is printed either way; the exit code says whether the headline was measured.
        return 0 if measured else 1

    # Reach the card first, or print the null line (--loader reads the card's name and peak memory too).
    if _is_card(device):
        timeout = float(os.environ.get("SENSORIUM_BENCH_INIT_TIMEOUT", "300"))
        if not _init_backend_or_die(mode, timeout):
            return 1

    with _stdout_to_stderr():
        if args.fit:
            detail = measure_fit(device)
            value, vs, extra = detail["fit_clips_per_sec"], detail["fit_clips_per_sec"] / BASELINE_CLIPS_PER_SEC, {}
        elif args.distill:
            detail = measure_distill(device)
            value = detail["distill_clips_per_sec"]
            vs, extra = value / BASELINE_CLIPS_PER_SEC, {}
        elif args.infer:
            detail = measure_infer(device)
            # The headline is the cadence of a back-to-back trial set; the others stay in detail.
            value = detail["pipelined_window_forwards_per_sec"]
            vs = value / BASELINE_INFER_WINDOWS_PER_SEC
            extra = {"infer_device_resident_window_forwards_per_sec":
                     detail["device_resident_window_forwards_per_sec"]}
            detail.update({
                "baseline_window_forwards_per_sec": BASELINE_INFER_WINDOWS_PER_SEC,
                "baseline_note": ("denominator = 3 x 35 clips/s: the reference's forward + backward training "
                                  "rate scaled to an ideal forward-only pass; its real batch-1 eval loop "
                                  "(predictors.py:46-51) is slower, so the true ratio is higher"),
            })
        elif args.infer_mesh:
            detail = measure_infer_mesh(device)
            value, vs, extra = detail["mesh_window_forwards_per_sec"], None, {}
        elif args.loader:
            detail = measure_loader(sweep_threads=sweep)
            detail.update(_device_detail(device))
            value = max(v for k, v in detail.items() if k.endswith("samples_per_sec"))
            vs, extra = value / BASELINE_CLIPS_PER_SEC, {}
        elif args.ab:
            routes = {impl: measure_train_subprocess(impl, device, trace_dir=args.trace)
                      for impl in ("cudnn", "cuda")}
            winner = max(routes, key=lambda i: routes[i]["train_clips_per_sec"])
            value = routes[winner]["train_clips_per_sec"]
            detail = {**routes, "winner": winner, "card": routes[winner]["card"], "dw_impl": winner,
                      "peak_memory_gb": routes[winner]["peak_memory_gb"],
                      "cuda_over_cudnn": round(routes["cuda"]["train_clips_per_sec"]
                                               / routes["cudnn"]["train_clips_per_sec"], 4)}
            vs, extra = value / BASELINE_CLIPS_PER_SEC, {}
        else:
            detail = measure_train(device, trace_dir=args.trace)
            value = detail["train_clips_per_sec"]
            vs, extra = value / BASELINE_CLIPS_PER_SEC, {}
    print(_line(mode, value, None if vs is None else round(vs, 3), detail, **extra), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
