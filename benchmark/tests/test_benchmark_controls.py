"""The comparison that decides ``correct`` fails what it must, at a toy size
on the CPU: the control (the reference in float8 in the program's place)
reads over the limits on every cell, and a whole run with the timed path
broken underneath comes out not correct, once for each fault a cell can
have. (One card: no exchange between cards to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests.toy import TOY_LIMITS, make_toy_bench
from benchmark.tools import calibrate

CPU = torch.device("cpu")


@pytest.fixture
def toy(tmp_path):
    bench_file = make_toy_bench(tmp_path, distill=True)
    return lambda name: spec.load_cell(name, bench_file, bench_file.parent / "benchmark")


def over(numbers: dict, limits: dict) -> list:
    return [name for name, limit in limits.items() if not numbers[name] <= limit]


@pytest.mark.parametrize("cell", ["toy.fit", "toy_distill.fit", "toy.predict"])
def test_control_fails_and_the_program_passes(toy, cell):
    loaded = toy(cell)
    readings = calibrate.readings(loaded, 2**31 + 5, True, 0.5, [CPU])
    assert over(readings["program"], loaded.limits) == []
    assert over(readings["control"], loaded.limits)
    if "half_batch" in readings:
        assert over(readings["half_batch"], loaded.limits)


def run(loaded) -> dict:
    return runner.run(loaded, 2**31 + 9, 0.5, False, [CPU], time.perf_counter())


def test_step_that_leaves_the_state_unchanged(toy, monkeypatch):
    from sensorium_tpu_torch.engine import model as model_lib

    def frozen_step(self):
        loss_fn = self.loss_fn

        def step(state, inputs, targets, weights):
            with torch.no_grad():
                return loss_fn(state.model(inputs, generator=state.generator).float(), targets, weights)

        return step

    monkeypatch.setattr(model_lib.MouseModel, "_ensure_train_step", frozen_step)
    result = run(toy("toy.fit"))
    assert result["correct"] is False
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(toy, monkeypatch):
    from sensorium_tpu_torch.engine import model as model_lib

    real = model_lib.MouseModel._ensure_train_step

    def half_step(self):
        step = real(self)

        def halved(state, inputs, targets, weights):
            keep = inputs.shape[0] // 2
            return step(state, inputs[:keep], targets[:keep], weights[:keep])

        return halved

    monkeypatch.setattr(model_lib.MouseModel, "_ensure_train_step", half_step)
    result = run(toy("toy.fit"))
    assert result["correct"] is False
    assert over({k: v["value"] for k, v in result["compared"].items()}, TOY_LIMITS["fit"])


def test_a_later_batch_of_the_epoch_altered(toy, monkeypatch):
    """Set-up's steps are one epoch of several batches through the window's
    feed: a batch other than an epoch's first, altered as the loader hands
    it over, is caught."""
    from sensorium_tpu_torch.data.loader import MiceDataLoader

    real = MiceDataLoader.__iter__

    def altered(self):
        batches = real(self)
        try:
            for i, batch in enumerate(batches):
                if i == 1:
                    batch.targets[:] *= 2.0
                yield batch
        finally:
            batches.close()

    monkeypatch.setattr(MiceDataLoader, "__iter__", altered)
    result = run(toy("toy.fit"))
    assert result["correct"] is False
    assert result["compared"]["loss_gap"]["value"] > TOY_LIMITS["fit"]["loss_gap"]


@pytest.mark.parametrize("cell", ["toy.predict"])
def test_an_answer_altered_where_it_is_produced(toy, monkeypatch, cell):
    from sensorium_tpu_torch.infer import predictor as predictor_lib

    real = predictor_lib.Predictor.run_staged

    def altered(self, staged, mouse_index):
        out = real(self, staged, mouse_index).clone()
        out[0, -1] += 1e-3 * out.abs().max()
        return out

    monkeypatch.setattr(predictor_lib.Predictor, "run_staged", altered)
    result = run(toy(cell))
    assert result["correct"] is False
