"""The port's training chain over the lockstep trajectories of the reference engine, on the CPU.

``tests/test_train_lockstep.py`` holds the JAX train step to the PyTorch
reference engine's own loop over N steps (``tests/golden/dwiseneuro_lockstep.npz``,
batches regenerated by ``tests/golden/lockstep_common.py``). This file runs
the port's ``MouseModel`` chain (``make_train_step``: forward, masked Poisson
loss, backward, AdamW with weight decay 0.05 under the stage schedule, EMA
0.999, BN statistics carried) over the same trajectories from the same
initial weights, converted with the port's ``compat/torch_weights.py``:

* a: warmup + cosine, ``iter_size=1``;
* b: ``iter_size=2``;
* c: ``grad_clip`` 1.0 with ``CosineAnnealingWarmRestarts`` as the train stage.

The tolerances are those of ``tests/test_train_lockstep.py``. BN biases whose
output feeds another normalization have an analytically zero gradient, so
Adam turns rounding noise into a +-lr walk there on both sides: they are held
to the noise bound, and the final models are held functionally (an eval
forward of each against the reference's final weights).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from sensorium_tpu_torch.compat import convert_torch_state_dict, from_jax_variables
from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine.model import MouseModel
from sensorium_tpu_torch.engine.schedule import build_stage_schedule, warmup_cosine
from sensorium_tpu_torch.models.registry import get_nn_module

GOLDEN = Path(__file__).parent / "golden"


def _load_common():
    spec = importlib.util.spec_from_file_location("lockstep_common", GOLDEN / "lockstep_common.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lc = _load_common()

NN_MODULE = ("dwiseneuro", dict(
    readout_outputs=list(lc.READOUT_OUTPUTS),
    in_channels=5,
    core_features=(8, 12),
    spatial_strides=(2, 1),
    spatial_kernel=3,
    temporal_kernel=5,
    expansion_ratio=2,
    se_reduce_ratio=4,
    cortex_features=(16, 24),
    groups=2,
    softplus_beta=0.07,
    drop_rate=0.0,
    drop_path_rate=0.0,
    dtype="float32",
    readout_pad_multiple=8,
))
CONVERT_KWARGS = dict(readout_outputs=list(lc.READOUT_OUTPUTS), num_core_blocks=2, num_cortex_layers=2, groups=2)
BN_BIAS_ATOL = 3e-2  # tests/test_train_lockstep.py _BN_BIAS_ATOL


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The small models here run as fast on 2 threads as on all cores, and
    test workers that run side by side do not then contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "dwiseneuro_lockstep.npz")


def converted(golden, prefix: str) -> dict[str, torch.Tensor]:
    """The golden's reference state dict under ``prefix``, in the port's names."""
    module = get_nn_module(*NN_MODULE, device="cpu")
    state_dict = {key[len(prefix) + 1:]: golden[key] for key in golden.files if key.startswith(prefix + ":")}
    params, stats = convert_torch_state_dict(state_dict, padded_group_size=module.padded_group_size,
                                             **CONVERT_KWARGS)
    return from_jax_variables(params, stats)


def trajectory_schedule(spec: dict):
    if "scheduler" in spec:
        return build_stage_schedule(lc.PEAK_LR, lc.MIN_LR, spec["warmup_steps"], spec["cosine_steps"],
                                    scheduler_spec=spec["scheduler"])
    return warmup_cosine(lc.PEAK_LR, lc.MIN_LR, spec["warmup_steps"], spec["cosine_steps"])


def run_trajectory(golden, name: str):
    spec = lc.TRAJECTORIES[name]
    num_steps = spec["warmup_steps"] + spec["cosine_steps"]
    inputs, targets, weights = lc.make_batches(num_steps, seed=31 + ord(name))
    compact = lc.compact_targets(targets, weights)
    model = MouseModel({
        "nn_module": NN_MODULE,
        "loss": ("mice_poisson", {}),
        "optimizer": ("AdamW", {"lr": lc.PEAK_LR, "weight_decay": lc.WEIGHT_DECAY}),
        "iter_size": spec["iter_size"],
        "grad_clip": spec.get("grad_clip", 0.0),
    }, device="cpu")
    model.set_ema(lc.EMA_DECAY)
    state = model.build_state(seed=0, learning_rate=trajectory_schedule(spec))
    initial = converted(golden, "sd0")
    state.model.load_state_dict(initial, strict=True)
    state.ema_model.load_state_dict(initial, strict=True)
    losses = [float(model.train_step(MiceBatch(inputs[k], compact[k], weights[k]))) for k in range(num_steps)]
    return state, np.array(losses)


@pytest.fixture(scope="module", params=["a", "b", "c"])
def trajectory(request, golden):
    state, losses = run_trajectory(golden, request.param)
    return request.param, state, losses


def test_applied_lr_plan_matches_torch(golden):
    for name, spec in lc.TRAJECTORIES.items():
        expected = golden[f"{name}:lrs"]
        got = np.array([trajectory_schedule(spec)(k) for k in range(len(expected))])
        np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-12, err_msg=name)


def test_per_step_losses_track_torch(golden, trajectory):
    name, state, losses = trajectory
    expected = golden[f"{name}:losses"]
    assert losses.shape == expected.shape
    assert state.step == len(expected)
    np.testing.assert_allclose(losses, expected, rtol=1e-3, err_msg=name)
    rel = np.abs(losses - expected) / expected
    assert rel[-len(rel) // 4:].max() < 1e-3, rel


def is_bn_stat(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in ("mean", "var")


def is_bn_bias(key: str) -> bool:
    """A BN bias: ``tests/test_train_lockstep.py``'s noise population."""
    parts = key.split(".")
    return parts[-1] == "bias" and any(p in ("bn", "stem_bn", "pwl_bn", "bn_sc") for p in parts[:-1])


def assert_state_close(got: dict, expected: dict, label: str, rtol: float, atol: float, noise_atol: float,
                       stats_atol: float) -> None:
    assert set(got) == set(expected), label
    for key, value in got.items():
        value, want = value.numpy(), expected[key].numpy()
        if is_bn_stat(key):
            np.testing.assert_allclose(value, want, rtol=1e-2, atol=stats_atol, err_msg=f"{label} {key}")
        elif is_bn_bias(key):
            np.testing.assert_allclose(value, want, atol=noise_atol, err_msg=f"{label} {key}")
        else:
            np.testing.assert_allclose(value, want, rtol=rtol, atol=atol, err_msg=f"{label} {key}")


def test_final_params_match_torch(golden, trajectory):
    name, state, _ = trajectory
    assert_state_close(state.model.state_dict(), converted(golden, f"{name}:sdF"), f"{name}:params",
                       rtol=5e-3, atol=5e-3, noise_atol=BN_BIAS_ATOL, stats_atol=BN_BIAS_ATOL)


def test_final_ema_matches_torch(golden, trajectory):
    """The EMA of the parameters and BN statistics, decay 0.999."""
    name, state, _ = trajectory
    # The EMA sees only (1 - decay) of each live step's noise-walk shift.
    assert_state_close(state.ema_model.state_dict(), converted(golden, f"{name}:emaF"), f"{name}:ema",
                       rtol=5e-3, atol=1e-4, noise_atol=1e-3, stats_atol=1e-3)


@torch.inference_mode()
def test_final_models_functionally_equivalent(golden, trajectory):
    """An eval forward of the port's final models against the reference's
    final weights: BN-bias shifts that the next normalization cancels drop out."""
    name, state, _ = trajectory
    probe = torch.from_numpy(lc.make_batches(1, seed=99)[0][0])
    reference = get_nn_module(*NN_MODULE, device="cpu").eval()
    for label, got_model, prefix, atol in (("live", state.model, f"{name}:sdF", 8e-2),
                                           ("ema", state.ema_model, f"{name}:emaF", 2e-3)):
        reference.load_state_dict(converted(golden, prefix), strict=True)
        got = got_model.eval()(probe).numpy()
        np.testing.assert_allclose(got, reference(probe).numpy(), rtol=1e-2, atol=atol, err_msg=f"{name}:{label}")
