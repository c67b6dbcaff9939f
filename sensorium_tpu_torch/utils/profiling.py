"""Tracing, timing and the NaN sanitizer (counterpart of ``sensorium_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome / TensorBoard trace (``*.pt.trace.json``) of the host
  ops and, on the card, of the CUDA kernels;
* ``annotate(name)``: a named span inside an active trace
  (``record_function``), also an NVTX range on the card;
* ``sync()``: waits for the card's queued work (``torch.cuda.synchronize``);
  nothing to wait for on the CPU;
* ``Stopwatch``: wall-clock section timing with a ``sync`` on both ends;
* ``debug_nans(enable)``: the first op that produces a NaN raises
  ``FloatingPointError`` with its name.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _card_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed work; the trace is written to ``logdir`` on exit."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named span in the profiler's trace, and an NVTX range on the card."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


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
