"""The traced run's profiler and what is read from its trace.

``Tracer`` wraps the measured window in ``torch.profiler`` (host ops and
CUDA activity) and a ``bench.window`` span. ``TraceSummary`` holds, clipped
to that span: each device operation's interval and name, the union of the
intervals (the seconds the device was busy), and the host spans and ops
that name the idle gaps. Everything stays in memory; nothing is written.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "bench.window"


def span(name: str):
    """A named host span of the benchmark's own, in the trace when one is taken."""
    return torch.profiler.record_function(name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)  # device op name -> seconds
    gaps: list = field(default_factory=list)  # [(label, seconds)], longest first

    def device_seconds(self, substrings) -> float:
        """Device seconds of the ops whose names contain any of ``substrings``."""
        return sum(s for name, s in self.ops.items() if any(k in name for k in substrings))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, s] for name, s in ops], "idle_gaps": [list(g) for g in self.gaps[:top]]}


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events, chips: int = 1, top_gaps: int = 10) -> TraceSummary:
    """Read a profiler's raw events (``prof.profiler.kineto_results.events()``)
    of a run over ``chips`` cards: the busy seconds are each card's union of
    intervals, averaged over the cards; the idle gaps are those in which no
    card ran anything."""
    host, device = [], []
    window = None
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # The benchmark's spans appear on the device's timeline as well
            # (as user annotations): they are not device work.
            if not (e.is_user_annotation() or e.name().startswith("bench.")):
                device.append((start, end, e.name(), e.device_index()))
        else:
            host.append((start, end, e.name(), e.start_thread_id()))
            if e.name() == WINDOW_SPAN:
                window = (start, end, e.start_thread_id())
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1, main_thread = window
    ops: dict = {}
    clipped: dict = {}
    for start, end, name, card in device:
        start, end = max(start, w0), min(end, w1)
        if end > start:
            clipped.setdefault(card, []).append((start, end))
            ops[name] = ops.get(name, 0.0) + (end - start) / 1e9
    busy = sum(end - start for intervals in clipped.values() for start, end in _union(intervals)) / chips
    merged = _union([interval for intervals in clipped.values() for interval in intervals])
    edges = [w0] + [x for pair in merged for x in pair] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top_gaps]
    labelled = []
    host = [(s, e, n) for s, e, n, t in host if t == main_thread and n != WINDOW_SPAN]
    for length, start, end in gaps:
        middle = (start + end) // 2
        covering = [(s, e, n) for s, e, n in host if s <= middle < e]
        bench = [c for c in covering if c[2].startswith("bench.")]
        program = [c for c in covering if not c[2].startswith("bench.")]
        # The benchmark's innermost span, then the outermost op the host ran.
        parts = [min(bench, key=lambda c: c[1] - c[0])[2]] if bench else []
        parts += [max(program, key=lambda c: c[1] - c[0])[2]] if program else []
        labelled.append((" / ".join(parts) or "host: no op", length / 1e9))
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops, gaps=labelled)


class Tracer:
    """``with Tracer(chips) as t:`` profiles the block; ``t.summary`` after it."""

    def __init__(self, chips: int = 1):
        self.chips = chips
        self.summary: TraceSummary | None = None
        self._stack = contextlib.ExitStack()
        self._prof = None

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(torch.profiler.profile(activities=activities))
        self._stack.enter_context(span(WINDOW_SPAN))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events(), self.chips)
        return False


class NoTrace:
    summary = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
