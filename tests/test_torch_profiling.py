"""The port's tracing, timing and NaN sanitizer (``sensorium_tpu_torch/utils/profiling.py``), on the CPU."""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from sensorium_tpu_torch.configs.smoke_001 import config as SMOKE
from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.data.loader import MiceDataLoader
from sensorium_tpu_torch.engine.model import MouseModel
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.models.dwiseneuro import BatchNormAct
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.ops.norm import batch_norm_train
from sensorium_tpu_torch.utils import profiling

FIT_SPANS = ("step.zero_grad", "step.optimizer", "step.ema", "fit.stage")
READERS = ("bn_device_pct.train", "bn_device_pct.predict", "update_device_pct.train", "loader_queue_wait_pct.train")
PROGRAM_SPANS = ("bn_act.", "bn.backward", "step.", "fit.", "loader.", "predict.", "probe_span")


@pytest.fixture(autouse=True)
def no_spans(monkeypatch):
    """No spans, and no card: these cases time nothing on a card, even in a
    process where an earlier test has used one."""
    monkeypatch.setattr(profiling, "_card_in_use", lambda: False)
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def span_events(prof) -> list:
    """The program's spans among a profiler's events, in the order they started."""
    return sorted((e for e in prof.events() if e.name.startswith(PROGRAM_SPANS)), key=lambda e: e.time_range.start)


def enclosing_spans(event) -> list[str]:
    """The program's spans open around ``event`` on its thread, innermost first."""
    names = []
    parent = event.cpu_parent
    while parent is not None:
        if parent.name.startswith(PROGRAM_SPANS):
            names.append(parent.name)
        parent = parent.cpu_parent
    return names


def counts_between(events, boundary: str) -> list[collections.Counter]:
    """The spans' counts in each stretch that starts at a ``boundary`` span."""
    stretches = []
    for event in events:
        if event.name == boundary:
            stretches.append(collections.Counter())
        if stretches:
            stretches[-1][event.name] += 1
    return stretches


def smoke_params(mice=(6, 9)) -> dict:
    """smoke_001's model (9 blocks, block 1 rematerialized, 3 cortex layers)
    and recipe at toy widths, on a 16x16 canvas."""
    params = SMOKE["argus_params"]
    name, nn_params = params["nn_module"]
    nn_params = {**nn_params, "readout_outputs": list(mice), "core_features": (4,) * 9, "expansion_ratio": 2,
                 "se_reduce_ratio": 2, "cortex_features": (8, 8, 8), "readout_pad_multiple": 8, "dtype": "float32"}
    return {**params, "nn_module": (name, nn_params),
            "inputs_processor": ("stack_inputs", {"size": (16, 16), "pad_fill_value": 0.0})}


class _Rows:
    """A dataset of fixed rows for ``MiceDataLoader``: random inputs, one mouse a row."""

    def __init__(self, params: dict, length: int):
        stack, mice = params["frame_stack"], params["nn_module"][1]["readout_outputs"]
        self.length, self.num_mice = length, len(mice)
        self.row_shapes = ((5, stack["size"], 16, 16), (max(mice), stack["size"]))

    def __len__(self):
        return self.length

    def fill_into(self, index, epoch, inputs, targets):
        rng = np.random.default_rng(index)
        inputs[:] = rng.normal(size=inputs.shape)
        targets[:] = rng.random(size=targets.shape)
        return index % self.num_mice


def test_trace_writes_a_chrome_trace_and_the_span_totals(tmp_path):
    with profiled():
        with profiling.span("stale_span"):
            pass
    with profiling.trace(tmp_path / "trace"):
        for _ in range(3):
            with profiling.span("probe_span"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {event.get("name") for event in json.loads(files[0].read_text())["traceEvents"]}
    assert "probe_span" in names and "aten::mm" in names
    totals = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert set(totals) == {"probe_span"}
    assert totals["probe_span"]["count"] == 3 and totals["probe_span"]["host_s"] > 0
    assert totals["probe_span"]["device_s"] is None  # no card


def _compiled_probe(x):
    with profiling.span("probe_span"):
        return x * 2


@pytest.mark.parametrize("case", ["no profiler", "dynamo tracing under a profiler"])
def test_a_span_off_is_the_shared_no_op(case):
    if case == "no profiler":
        assert profiling.span("probe_span") is profiling.span("other") is profiling._OFF
        with profiling.span("probe_span"):
            torch.ones(3).sum()
        events = []
    else:
        probe = torch.compile(_compiled_probe, backend="eager", fullgraph=True)
        with profiled() as prof:
            assert probe(torch.ones(3)).sum() == 6
        events = [e.name for e in prof.events()]
    assert "probe_span" not in events
    assert profiling.span_totals() == {} and not profiling._REGISTRY.pending


@pytest.mark.parametrize("nested", [False, True])
def test_a_span_on_is_a_profiler_event_with_its_host_seconds(nested):
    with profiled() as prof:
        outer = profiling.span("probe_span.outer") if nested else profiling._OFF
        with outer:
            with profiling.span("probe_span.inner"):
                time.sleep(0.002)
    events = {e.name: e for e in span_events(prof)}
    assert set(events) == ({"probe_span.inner", "probe_span.outer"} if nested else {"probe_span.inner"})
    inner = events["probe_span.inner"]
    assert enclosing_spans(inner) == (["probe_span.outer"] if nested else [])
    assert inner.thread == events.get("probe_span.outer", inner).thread
    count, host_s, device_s = profiling.span_totals()["probe_span.inner"]
    assert count == 1 and device_s is None
    assert 0.002 <= host_s <= (inner.time_range.elapsed_us() + 1) / 1e6  # inside its profiler event


def test_bn_backward_is_a_span_of_the_thread_that_runs_it():
    """Recorded from whichever thread the autograd engine runs the node on
    (on the CPU the caller; on the card autograd's device thread, which
    ``tests/test_torch_cuda.py`` checks), never inside another span."""
    x, scale, bias = (torch.randn(4, 3, requires_grad=True), torch.ones(3, requires_grad=True),
                      torch.zeros(3, requires_grad=True))
    with profiled() as prof:
        with profiling.span("probe_span"):
            y, _, _ = batch_norm_train(x, scale, bias, torch.zeros(3), 1e-5, torch.float32)
        y.square().sum().backward()
    main, backward = span_events(prof)
    assert (main.name, backward.name) == ("probe_span", "bn.backward")
    assert backward.thread == main.thread and enclosing_spans(backward) == []
    assert profiling.span_totals()["bn.backward"][0] == 1
    assert x.grad is not None


def _fit_spans(params: dict, steps: int, batch: int) -> tuple[MouseModel, list]:
    model = MouseModel(params, device="cpu")
    model.set_ema(0.9)
    model.build_state(seed=0)
    loader = MiceDataLoader(_Rows(params, steps * batch), batch_size=batch, num_threads=2, drop_last=True)
    with profiled() as prof:
        model.fit(loader, num_epochs=1)
    return model, span_events(prof)


def test_a_two_step_fit_of_smoke_001_records_each_span_once_a_step():
    params = smoke_params()
    model, events = _fit_spans(params, steps=2, batch=2)
    module = model.state.model
    bns = sum(isinstance(m, BatchNormAct) for m in module.modules())
    rerun = sum(isinstance(m, BatchNormAct) for i in module.remat_set for m in getattr(module, f"block_{i}").modules())
    assert (bns, rerun) == (52, 5)
    steps = counts_between(events, "fit.stage")  # a step stages its batch first
    assert len(steps) == 2
    for counts in steps:
        assert counts["bn_act.train"] == counts["bn.backward"] == bns
        assert counts["bn_act.recompute"] == rerun
        assert all(counts[name] == 1 for name in FIT_SPANS)
    assert sum(e.name == "loader.wait" for e in events) == 3  # two batches and the end of the epoch
    assert all(enclosing_spans(e) == [] for e in events)  # flat: no span encloses another
    totals = profiling.span_totals()
    assert set(totals) == {"bn_act.train", "bn_act.recompute", "bn.backward", "loader.wait", *FIT_SPANS}
    assert totals["bn_act.train"][0] == 2 * bns and totals["loader.wait"][0] == 3


def test_a_distillation_step_records_the_teachers_bn_as_eval():
    params = smoke_params()
    teacher = get_nn_module(params["nn_module"][0], params["nn_module"][1], device="cpu").eval()
    model = MouseModel(params, device="cpu")
    model.build_state(seed=0)
    model.set_distill(teacher, 0.36)
    batch = MiceBatch(*(np.asarray(a) for a in _batch(params, 2)))
    with profiled():
        model.train_step(batch)
    counts = {name: count for name, (count, _, _) in profiling.span_totals().items()}
    # The teacher's eval forward runs each block's pw_bn and spatial_bn inside its depthwise convs.
    blocks = teacher.num_blocks
    assert counts["bn_act.train"] == 52 and counts["bn_act.eval"] == 52 - 2 * blocks and "step.ema" not in counts


def _batch(params: dict, size: int):
    rows = _Rows(params, size)
    inputs = np.empty((size, *rows.row_shapes[0]), np.float32)
    targets = np.zeros((size, *rows.row_shapes[1]), np.float32)
    weights = np.zeros((size, rows.num_mice), np.float32)
    for i in range(size):
        weights[i, rows.fill_into(i, 0, inputs[i], targets[i])] = 1.0
    return inputs, targets, weights


def test_predict_trial_records_one_stage_and_one_fetch_a_trial():
    params = smoke_params()
    module = get_nn_module(params["nn_module"][0], params["nn_module"][1], device="cpu")
    predictor = Predictor.from_module(module, params, chunk_size=8, device="cpu")
    rng = np.random.default_rng(0)
    frames, trials = 40, 2
    arrays = (rng.normal(size=(12, 16, frames)), rng.normal(size=(2, frames)), rng.normal(size=(2, frames)))
    plain = predictor.predict_trial(*arrays, mouse_index=1)
    with profiled() as prof:
        answers = [predictor.predict_trial(*arrays, mouse_index=1) for _ in range(trials)]
    np.testing.assert_array_equal(answers[0], plain)
    windows = len(predictor.indexes_generator.valid_anchors(frames))
    chunks = -(-windows // 8)
    events = span_events(prof)
    trials_seen = counts_between(events, "predict.upload")  # a trial starts with its upload
    assert len(trials_seen) == trials
    for counts in trials_seen:
        assert counts == {"predict.upload": 1, "predict.stage": 1, "predict.fetch": 1, "predict.gather": chunks,
                          "predict.blend": chunks + 1, "bn_act.eval": (52 - 2 * module.num_blocks) * chunks}
    assert all(enclosing_spans(e) == [] for e in events)


def test_the_registry_keeps_its_memory_bounded():
    spans, free = 5000, len(profiling._REGISTRY.free)  # events an earlier span on a card left to reuse
    with profiled():
        for i in range(spans):
            with profiling.span(f"probe_span.{i % 3}"):
                pass
    assert len(profiling._REGISTRY.totals) == 3  # a total a name, whatever the count
    assert sum(count for count, _, _ in profiling.span_totals().values()) == spans
    assert not profiling._REGISTRY.pending and len(profiling._REGISTRY.free) == free  # no card: no events


@pytest.mark.parametrize("cards", [1, 2])
def test_device_seconds_are_left_out_once_the_process_used_more_than_one_card(monkeypatch, cards):
    """One card's stream times a span; work on another card is not in it."""
    registry = profiling._Registry()
    registry.totals = {"bn_act.eval": [4, 2_000_000, 30.0], "fit.stage": [1, 1_000, None]}
    monkeypatch.setattr(profiling, "_cards_holding_memory", lambda: cards)
    assert registry.finished_totals() == {"bn_act.eval": (4, 0.002, 0.03 if cards == 1 else None),
                                          "fit.stage": (1, 1e-6, None)}


def test_the_registry_counts_every_span_of_many_threads():
    """Spans end on the main thread and on autograd's at once: no update is lost."""
    registry = profiling._Registry()
    threads, spans = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(spans):
                registry.add(f"s{i % 2}", 1, None)

        workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        sys.setswitchinterval(switch)
    totals = registry.finished_totals()
    assert totals == {"s0": (threads // 2 * spans, threads // 2 * spans / 1e9, None),
                      "s1": (threads // 2 * spans, threads // 2 * spans / 1e9, None)}


@pytest.mark.parametrize("name", READERS)
def test_the_span_readers_read_nothing_without_a_trace_or_a_card(name):
    read = spec.metric_reader(name)
    assert read(SimpleNamespace(trace=None, window_s=1.0, counts={})) is None
    with profiled():  # spans on the CPU: no device seconds
        for span_name in ("bn_act.train", "bn.backward", "step.ema", "loader.wait"):
            with profiling.span(span_name):
                pass
    traced = SimpleNamespace(trace=SimpleNamespace(window_s=1.0), window_s=1.0, counts={})
    assert read(traced) is None
    profiling.reset_spans()
    assert read(traced) is None  # no span recorded


@pytest.mark.parametrize("name, share", [("bn_device_pct.train", 25.0), ("bn_device_pct.predict", 25.0),
                                         ("update_device_pct.train", 12.5), ("loader_queue_wait_pct.train", 5.0)])
def test_the_span_readers_divide_their_spans_seconds_by_the_window(monkeypatch, name, share):
    totals = {"bn_act.train": (52, 0.1, 0.3), "bn_act.recompute": (5, 0.0, 0.05), "bn.backward": (52, 0.1, 0.15),
              "step.optimizer": (1, 0.01, 0.2), "step.ema": (1, 0.01, 0.05), "loader.wait": (1, 0.1, 0.001),
              "fit.stage": (1, 0.5, 0.5)}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), window_s=2.1, counts={})
    assert spec.metric_reader(name)(ctx) == pytest.approx(share)


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
