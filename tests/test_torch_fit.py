"""The port's fit loop, metrics and callbacks against the JAX package's, on the CPU.

A small fp32 DwiseNeuro (``tests/synthetic.py``'s config, drop rates 0) starts
from the same JAX weights on both sides and trains for 2 epochs of 2 AdamW
steps (warmup + cosine, EMA 0.9) on batches from each package's own data feed
over the synthetic dataset, then validates through ``ValMiceDataset`` and
``CorrelationMetric``. The per-epoch losses are held at the tolerance of the
multi-step test in ``tests/test_torch_train_step.py`` (rtol 1e-3).
"""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from sensorium_tpu import constants as jconstants
from sensorium_tpu.data import datasets as jdatasets
from sensorium_tpu.data import loader as jloader
from sensorium_tpu.data import mixers as jmixers
from sensorium_tpu.data import mouse_data as jmouse_data
from sensorium_tpu.data.indexes import WindowIndexer as JWindowIndexer
from sensorium_tpu.data.inputs import get_inputs_processor as jget_inputs_processor
from sensorium_tpu.data.responses import get_responses_processor as jget_responses_processor
from sensorium_tpu.engine import callbacks as jcallbacks
from sensorium_tpu.engine import schedule as jschedule
from sensorium_tpu.engine.metrics import CorrelationMetric as JCorrelationMetric
from sensorium_tpu.engine.metrics import batch_corr_stats as jbatch_corr_stats
from sensorium_tpu.engine.metrics import corr as jcorr
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.compat import from_jax_variables
from sensorium_tpu_torch.data import datasets, loader, mixers, mouse_data
from sensorium_tpu_torch.data.indexes import WindowIndexer
from sensorium_tpu_torch.data.inputs import get_inputs_processor
from sensorium_tpu_torch.data.responses import get_responses_processor
from sensorium_tpu_torch.engine import callbacks, schedule
from sensorium_tpu_torch.engine.metrics import CorrelationMetric, batch_corr_stats, corr
from sensorium_tpu_torch.engine.model import MouseModel
from tests.synthetic import SYNTH_NUM_NEURONS, build_synthetic_dataset, tiny_experiment_config

LOSS_RTOL = 1e-3  # tests/test_torch_train_step.py, 3 AdamW steps
METRIC_TOL = 1e-6
# val_corr after 4 AdamW steps: the weights agree to ~1e-5 relative (the
# 3-step test's bound is 5e-3), and the correlations to ~1.4e-5 absolute.
CORR_ATOL = 1e-4


def fit_params() -> dict:
    params = tiny_experiment_config()["argus_params"]
    name, nn_params = params["nn_module"]
    return {**params, "nn_module": (name, {**nn_params, "drop_rate": 0.0, "drop_path_rate": 0.0})}


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fit")
    build_synthetic_dataset(root, seed=6)
    old = (constants.sensorium_dir, jconstants.sensorium_dir)
    constants.sensorium_dir = jconstants.sensorium_dir = root
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()
    yield root
    constants.sensorium_dir, jconstants.sensorium_dir = old
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()


def loaders(port: bool, params: dict):
    """Train (CutMix 0.5, 10 samples, batch 4, drop_last: 2 steps) and val
    (fold_0, batch 16) loaders of one package over the synthetic dataset."""
    stack = params["frame_stack"]
    inputs = params["inputs_processor"]
    if port:
        mods = (mouse_data, datasets, loader, mixers, WindowIndexer, get_inputs_processor, get_responses_processor)
    else:
        mods = (jmouse_data, jdatasets, jloader, jmixers, JWindowIndexer, jget_inputs_processor,
                jget_responses_processor)
    md, ds, ld, mx, indexer_cls, get_inputs, get_responses = mods
    procs = (indexer_cls(stack["size"], stack["step"], stack["position"]), get_inputs(*inputs),
             get_responses(*params["responses_processor"]))
    train_data = [md.get_mouse_data(m, [f"fold_{i}" for i in range(1, 7)]) for m in constants.mice]
    val_data = [md.get_mouse_data(m, ["fold_0"]) for m in constants.mice]
    train = ds.TrainMiceDataset(train_data, *procs, mouse_epoch_size=1, mixer=mx.CutMix(1.0, 0.5), seed=2)
    val = ds.ValMiceDataset(val_data, *procs)
    return (ld.MiceDataLoader(train, batch_size=4, shuffle=True, seed=2, num_threads=2, drop_last=True),
            ld.MiceDataLoader(val, batch_size=16, num_threads=2))


def run_fits(tmp_path, monkeypatch):
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    params = fit_params()
    jmodel = JaxMouseModel(params)
    jmodel.set_ema(0.9)
    jstate = jmodel.build_state(seed=0, learning_rate=jschedule.warmup_cosine(1e-3, 1e-5, 2, 4))
    model = MouseModel(params, device="cpu")
    model.set_ema(0.9)
    state = model.build_state(seed=0, learning_rate=schedule.warmup_cosine(1e-3, 1e-5, 2, 4))
    weights = from_jax_variables(jstate.params, jstate.batch_stats)
    state.model.load_state_dict(weights, strict=True)
    state.ema_model.load_state_dict(weights, strict=True)

    results = {}
    for side, fit_model, cbs, metric_cls, port in (
        ("jax", jmodel, jcallbacks, JCorrelationMetric, False),
        ("port", model, callbacks, CorrelationMetric, True),
    ):
        out = tmp_path / side
        train, val = loaders(port, params)
        csv_cb, jsonl_cb = cbs.LoggingToCSV(out / "log.csv"), cbs.LoggingToJSONL(out / "log.jsonl")
        fit_model.fit(train, val_loader=val, num_epochs=2, callbacks=[cbs.Timer(), csv_cb, jsonl_cb],
                      metrics=[metric_cls(num_neurons=SYNTH_NUM_NEURONS)])
        with open(out / "log.csv", newline="") as handle:
            rows = list(csv.DictReader(handle))
        records = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
        results[side] = (rows, records)
    return results, model


@pytest.fixture(scope="module")
def fits(dataset_root, tmp_path_factory):
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield run_fits(tmp_path_factory.mktemp("fits"), monkeypatch)


def test_fit_matches_jax_per_epoch(fits):
    (jrows, _), (rows, _) = fits[0]["jax"], fits[0]["port"]
    assert len(rows) == len(jrows) == 2
    for row, jrow in zip(rows, jrows):
        assert row["epoch"] == jrow["epoch"] and row["stage"] == jrow["stage"] == "train"
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(float(row[key]), float(jrow[key]), rtol=LOSS_RTOL, err_msg=key)
        corr_keys = [k for k in jrow if k.startswith("val_corr")]
        assert len(corr_keys) == 11  # ten mice and their mean
        for key in corr_keys:
            np.testing.assert_allclose(float(row[key]), float(jrow[key]), atol=CORR_ATOL, err_msg=key)
        np.testing.assert_allclose(float(row["lr"]), float(jrow["lr"]), rtol=1e-6)
    assert fits[1].state.step == 4


def test_callbacks_write_the_jax_keys(fits):
    (jrows, jrecords), (rows, records) = fits[0]["jax"], fits[0]["port"]
    assert list(rows[0]) == list(jrows[0])
    assert [list(r) for r in records] == [list(r) for r in jrecords]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_corr"]) and r["epoch_time"] >= 0
               for r in records)


def random_stats_inputs(seed: int):
    rng = np.random.default_rng(seed)
    pred = rng.gamma(2.0, 1.0, (3, 6, 9, 5)).astype(np.float32)
    target = rng.gamma(1.5, 1.0, (6, 9, 5)).astype(np.float32)
    weights = np.zeros((6, 3), np.float32)
    weights[np.arange(6), [0, 2, 0, 2, 0, 2]] = 1.0  # mouse 1 has no sample
    return pred, target, weights


def test_correlation_metric_matches_jax():
    num_neurons = [7, 9, 8]
    port, jax_metric = CorrelationMetric(num_neurons), JCorrelationMetric(num_neurons)
    host, jax_host = CorrelationMetric(num_neurons), JCorrelationMetric(num_neurons)
    for seed in range(3):
        pred, target, weights = random_stats_inputs(seed)
        counts, sums = batch_corr_stats(*(torch.from_numpy(a) for a in (pred, target, weights)))
        jcounts, jsums = jbatch_corr_stats(pred, target, weights)
        np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-6)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        port.update_stats(counts.numpy(), sums.numpy())
        jax_metric.update_stats(np.asarray(jcounts), np.asarray(jsums))
        host.update(pred, target, weights)
        jax_host.update(pred, target, weights)
    got, want = port.epoch_metrics(), jax_metric.epoch_metrics()
    assert got.keys() == want.keys() == {"val_corr_mouse_0", "val_corr_mouse_2", "val_corr"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=METRIC_TOL, err_msg=key)
    assert host.epoch_metrics() == jax_host.epoch_metrics()
    for key, value in host.epoch_metrics().items():
        np.testing.assert_allclose(got[key], value, atol=METRIC_TOL, err_msg=key)
    port.reset()
    assert port.epoch_metrics() == {}


def test_correlation_metric_is_the_reference_correlation():
    """One mouse, all samples: the running sums give ``corr`` over (B*T)."""
    pred, target, _ = random_stats_inputs(4)
    metric = CorrelationMetric(num_neurons=[9])
    metric.update(pred[:1], target, np.ones((6, 1), np.float32))
    x = pred[0].transpose(0, 2, 1).reshape(-1, 9).astype(np.float64)
    y = target.transpose(0, 2, 1).reshape(-1, 9).astype(np.float64)
    want = corr(x, y, axis=0).mean()
    np.testing.assert_allclose(metric.compute()[0], want, atol=METRIC_TOL)
    np.testing.assert_allclose(corr(x, y, axis=0), jcorr(x, y, axis=0), rtol=1e-12)


def test_logging_callbacks_append_and_align_columns(tmp_path):
    path = tmp_path / "log.csv"
    state = callbacks.EngineState(model=None)
    state.metrics = {"train_loss": 1.0, "val_loss": 2.0}
    callbacks.LoggingToCSV(path).epoch_complete(state)
    state.global_epoch = 1
    state.metrics = {"train_loss": 0.5, "epoch_time": 3.0}
    callbacks.LoggingToCSV(path, append=True).epoch_complete(state)
    with open(path, newline="") as handle:
        rows = list(csv.DictReader(handle))
    assert list(rows[0]) == ["epoch", "stage", "train_loss", "val_loss", "epoch_time"]
    assert rows[1]["val_loss"] == "" and rows[1]["epoch_time"] == "3.0"

    log = tmp_path / "log.txt"
    file_cb = callbacks.LoggingToFile(log)
    file_cb.epoch_start(state)
    state.logger.info("epoch line")
    file_cb.fit_complete(state)
    state.logger.info("after the fit")
    assert "epoch line" in log.read_text() and "after the fit" not in log.read_text()


class FakeLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def tiny_batches():
    rng = np.random.default_rng(7)
    weights = np.zeros((4, 10), np.float32)
    weights[np.arange(4), [0, 3, 5, 9]] = 1.0
    return [datasets.MiceBatch(rng.uniform(0, 255, (4, 5, 4, 16, 16)).astype(np.float32),
                               rng.gamma(1.5, 1.0, (4, max(SYNTH_NUM_NEURONS), 4)).astype(np.float32), weights)
            for _ in range(2)]


def test_early_stopping_ends_the_fit_and_fit_complete_always_runs():
    model = MouseModel(fit_params(), device="cpu")
    model.build_state(seed=1, learning_rate=1e-3)
    seen = []

    class Probe(callbacks.Callback):
        def epoch_complete(self, state):
            state.metrics["probe"] = 1.0
            seen.append(state.global_epoch)

        def fit_complete(self, state):
            seen.append("complete")

    model.fit(FakeLoader(tiny_batches()), num_epochs=6, start_epoch=3,
              callbacks=[Probe(), callbacks.EarlyStopping(monitor="probe", patience=1)])
    assert seen == [3, 4, "complete"]
    assert model.state.step == 4

    class Exploding(callbacks.Callback):
        def epoch_start(self, state):
            raise KeyError("boom")

        def fit_complete(self, state):
            raise ValueError("cleanup failed")

    seen.clear()
    with pytest.raises(KeyError, match="boom"):
        model.fit(FakeLoader(tiny_batches()), callbacks=[Exploding(), Probe()])
    assert seen == ["complete"]
    with pytest.raises(RuntimeError, match="build_state"):
        MouseModel(fit_params(), device="cpu").fit(FakeLoader([]))
