"""Tracing, timing and the NaN sanitizer (counterpart of ``sensorium_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome / TensorBoard trace (``*.pt.trace.json``) of the host
  ops and, on the card, of the CUDA kernels, and beside it ``spans.json``
  (``span_totals()`` of the spans recorded inside it);
* ``span(name)``: a named span of the program. Off (no profiler active,
  or dynamo tracing) it is one flag check and a shared no-op context. On,
  it is a ``record_function`` (on the profiler's host timeline, with the
  thread and the stamps; under ``torch.autograd.profiler.emit_nvtx()``
  also an NVTX range), its host seconds added to its name's total, and,
  on the card, a pair of CUDA timing events on the current stream. The
  events are folded into per-name totals as the card reports them done,
  then reused: nothing waits for the card until ``span_totals()``;
* ``sync()``: waits for the card's queued work (``torch.cuda.synchronize``);
  nothing to wait for on the CPU;
* ``Stopwatch``: wall-clock section timing with a ``sync`` on both ends;
* ``debug_nans(enable)``: the first op that produces a NaN raises
  ``FloatingPointError`` with its name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed work; the trace is written to ``logdir`` on exit,
    with ``spans.json``: ``{name: {"count", "host_s", "device_s"}}`` of the
    spans recorded inside (``device_s`` null on the CPU)."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset_spans()
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield
    totals = {name: {"count": count, "host_s": host_s, "device_s": device_s}
              for name, (count, host_s, device_s) in span_totals().items()}
    (logdir / "spans.json").write_text(json.dumps(totals, indent=1, sort_keys=True))


class _Registry:
    """The spans' per-name totals and the CUDA events not yet folded (in the
    order their spans ended, which on one stream is the order the card
    completes them). Shared by the main thread and autograd's, so every
    change holds the lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.totals: dict[str, list] = {}  # name -> [count, host ns, device ms or None]
        self.pending: collections.deque = collections.deque()  # (name, start event, end event)
        self.free: list = []  # timing events to reuse

    def events(self) -> tuple:
        with self.lock:
            if len(self.free) >= 2:
                return self.free.pop(), self.free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def add(self, name: str, host_ns: int, events: tuple | None) -> None:
        with self.lock:
            totals = self.totals.setdefault(name, [0, 0, None])
            totals[0] += 1
            totals[1] += host_ns
            if events is not None:
                self.pending.append((name, *events))
            self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Add the device time of the pending spans the card has completed
        (``wait``: all of them, once the card is idle) to their totals."""
        while self.pending and (wait or self.pending[0][2].query()):
            name, start, end = self.pending.popleft()
            totals = self.totals[name]
            totals[2] = (totals[2] or 0.0) + start.elapsed_time(end)
            self.free += (start, end)

    def finished_totals(self) -> dict:
        if self.pending:
            torch.cuda.synchronize()
        with self.lock:
            self._fold(wait=True)
            timed = _cards_holding_memory() <= 1
            return {name: (count, host_ns / 1e9, None if device_ms is None or not timed else device_ms / 1e3)
                    for name, (count, host_ns, device_ms) in self.totals.items()}

    def reset(self) -> None:
        with self.lock:
            self.totals.clear()
            self.pending.clear()


def _cards_holding_memory() -> int:
    """The cards on which this process has allocated memory. A span's events
    time the current card's stream, so they time its work only where the
    process runs on one card (not a ``Predictor`` over a mesh's cards)."""
    if not _card_in_use():
        return 0
    return sum(torch.cuda.max_memory_allocated(i) > 0 for i in range(torch.cuda.device_count()))


_REGISTRY = _Registry()
_OFF = contextlib.nullcontext()


@torch.compiler.assume_constant_result
def _profiling() -> bool:
    """Whether a profiler records this thread's ops (a constant to dynamo,
    which cannot trace the call: a traced graph never holds a span)."""
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "function", "start_ns", "events")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        self.events = _REGISTRY.events() if _card_in_use() else None
        self.start_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        _REGISTRY.add(self.name, time.perf_counter_ns() - self.start_ns, self.events)
        self.function.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program named ``name`` (see the module's docstring):
    ``with span("step.ema"): ...``. Recorded only while a profiler is active."""
    if not _profiling() or torch.compiler.is_compiling():
        return _OFF
    return _Span(name)


def span_totals() -> dict:
    """``{name: (count, host_s, device_s)}`` of the spans recorded since
    ``reset_spans``; ``device_s`` (the card's time from the span's start to
    its end on the stream it ran on) is None where no span of the name ran
    on the card, and for every name once the process has used more than one
    card. Waits for the card once."""
    return _REGISTRY.finished_totals()


def reset_spans() -> None:
    """Forget every span recorded so far."""
    _REGISTRY.reset()


def sync() -> None:
    """Wait until the card has finished the work queued so far."""
    if _card_in_use():
        torch.cuda.synchronize()


class Stopwatch:
    """Accumulating section timer; each section starts and ends with ``sync``."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        sync()
        start = time.perf_counter()
        yield
        sync()
        elapsed = time.perf_counter() - start
        self.times[name] = self.times.get(name, 0.0) + elapsed
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, float]:
        """Mean seconds per section."""
        return {name: self.times[name] / max(self.counts[name], 1) for name in self.times}


class _NanCheck(TorchDispatchMode):
    """Raises at the first aten op with a NaN in a floating-point output.

    Only ops that compute a new tensor are checked. The ``empty`` family
    hands back uninitialized memory, which may hold NaN bit patterns, and a
    view of such a buffer (``dw[i] = ...`` selects one before filling it)
    or an op that writes into one in place returns memory that other code
    has not finished writing yet."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or func._schema.is_mutable or name.startswith(("empty", "new_empty")):
            return out
        outputs = out if isinstance(out, (tuple, list)) else (out,)
        for value in outputs:
            if (isinstance(value, torch.Tensor) and value.is_floating_point() and value.numel()
                    and bool(torch.isnan(value).any())):
                raise FloatingPointError(f"{func} produced a NaN (output shape {tuple(value.shape)})")
        return out


_active: _NanCheck | None = None


def debug_nans(enable: bool = True) -> None:
    """Turn the NaN sanitizer on or off for this thread.

    On: every aten op's floating-point outputs are checked as the op
    returns, and ``torch.autograd.set_detect_anomaly(True, check_nan=True)``
    makes a backward function that returns a NaN raise with its name and
    the forward's traceback. Off: both go back to PyTorch's defaults.

    The depthwise kernels (``ops/dw_kernels.py``) write their outputs
    through ctypes, outside the dispatcher, so a NaN one of them produces
    is caught at the next aten op that reads it, which names that op; so is
    a NaN that an in-place op writes.
    Each check copies one flag to the host, so the card waits at every op.
    """
    global _active
    if enable and _active is None:
        _active = _NanCheck()
        _active.__enter__()
    elif not enable and _active is not None:
        _active.__exit__(None, None, None)
        _active = None
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
