"""The port's tracing, timing and NaN sanitizer (``sensorium_tpu_torch/utils/profiling.py``), on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from sensorium_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("probe_span"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {event.get("name") for event in json.loads(files[0].read_text())["traceEvents"]}
    assert "probe_span" in names and "aten::mm" in names


def test_stopwatch_counts_and_averages_its_sections():
    watch = profiling.Stopwatch()
    for _ in range(3):
        with watch.section("a"):
            pass
    with watch.section("b"):
        pass
    assert watch.counts == {"a": 3, "b": 1}
    assert set(watch.summary()) == {"a", "b"}
    assert watch.summary()["a"] == pytest.approx(watch.times["a"] / 3)
    profiling.sync()  # nothing queued on the CPU


def test_debug_nans_raises_at_the_first_nan_and_names_the_op():
    x = torch.rand(8) + 0.5
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        torch.exp(x)  # finite: no error
        torch.empty(1 << 16)  # uninitialized memory is not checked
        with pytest.raises(FloatingPointError, match=r"aten\.log\.default produced a NaN"):
            torch.log(-x)
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(FloatingPointError):  # the backward of sqrt at 0: 0 * inf
            (torch.sqrt(w) * 0.0).sum().backward()
    finally:
        profiling.debug_nans(False)


def test_debug_nans_false_restores_the_default():
    profiling.debug_nans(True)
    profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(-torch.ones(2))).all()
    profiling.debug_nans(False)  # idempotent
    assert not torch.is_anomaly_enabled()


def test_debug_nans_ignores_buffers_filled_view_by_view():
    """An uninitialized buffer filled a slice at a time (as the plain
    depthwise weight gradients fill theirs) is not a NaN; an in-place op
    that writes one is caught at the next op that reads it."""
    profiling.debug_nans(True)
    try:
        buffer = torch.empty(3, 4)
        buffer.view(-1).fill_(float("nan"))  # the garbage a buffer may hold
        for i in range(3):
            buffer[i] = torch.arange(4.0) * i
        assert torch.isfinite(buffer * 2.0).all()
        x = torch.ones(2)
        x.neg_().log_()  # log(-1): NaN, written in place
        with pytest.raises(FloatingPointError, match=r"aten\.mul\.Tensor"):
            x * 2.0
    finally:
        profiling.debug_nans(False)
