"""The port's engine pieces against the JAX package's, on the CPU: losses,
schedules, optimizers and the EMA. Inputs come from numpy with a seed."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sensorium_tpu.engine import losses as jlosses
from sensorium_tpu.engine import schedule as jschedule
from sensorium_tpu.engine.ema import ema_update as jax_ema_update
from sensorium_tpu.engine.optimizers import clip_grad_norm as jax_clip_grad_norm
from sensorium_tpu.engine.optimizers import get_optimizer as jax_get_optimizer
from sensorium_tpu.models.dwiseneuro import neuron_validity_mask as jax_neuron_mask
from sensorium_tpu_torch.engine import losses, schedule
from sensorium_tpu_torch.engine.ema import ema_update
from sensorium_tpu_torch.engine.optimizers import get_optimizer
from sensorium_tpu_torch.models.dwiseneuro import neuron_validity_mask
from sensorium_tpu_torch.utils.misc import get_lr


def mice_batch(rng, num_mice=3, batch=4, neurons=6, frames=5, active_mice=(0, 2)):
    prediction = rng.uniform(0.05, 3.0, (num_mice, batch, neurons, frames)).astype(np.float32)
    target = rng.gamma(1.5, 1.0, (batch, neurons, frames)).astype(np.float32)
    weights = np.zeros((batch, num_mice), np.float32)
    weights[np.arange(batch), np.array(active_mice)[np.arange(batch) % len(active_mice)]] = 1.0
    return prediction, target, weights


def value_and_grad_both(port_fn, jax_fn, prediction, *rest):
    p = torch.from_numpy(prediction).requires_grad_()
    loss = port_fn(p, *(torch.from_numpy(a) for a in rest))
    loss.backward()
    jloss, jgrad = jax.value_and_grad(lambda q: jax_fn(q, *(jnp.asarray(a) for a in rest)))(jnp.asarray(prediction))
    return (loss.item(), p.grad.numpy()), (float(jloss), np.asarray(jgrad))


# ------------------------------------------------------------------- losses


@pytest.mark.parametrize("kwargs", [{}, {"full": True}, {"eps": 1e-3}])
def test_mice_poisson_matches_jax(kwargs):
    rng = np.random.default_rng(0)
    prediction, target, weights = mice_batch(rng)
    target[0, 0, :2] = [0.5, 3.0]  # both sides of the Stirling mask

    def port(p, t, w):
        return losses.mice_poisson_loss(p, t, w, **kwargs)

    def jax_fn(p, t, w):
        return jlosses.mice_poisson_loss(p, t, w, **kwargs)

    (loss, grad), (jloss, jgrad) = value_and_grad_both(port, jax_fn, prediction, target, weights)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-7)
    assert np.all(grad[1] == 0.0)  # mouse 1 has weight 0 everywhere


def test_log_input_poisson_with_neuron_mask_matches_jax():
    rng = np.random.default_rng(1)
    prediction, target, weights = mice_batch(rng)
    readouts = [6, 4, 5]
    mask = neuron_validity_mask(readouts)
    np.testing.assert_array_equal(mask, jax_neuron_mask(readouts))
    port = losses.get_loss("PoissonNLLLoss", {}, neuron_mask=mask)
    jax_fn = jlosses.get_loss("PoissonNLLLoss", {}, neuron_mask=mask)
    (loss, grad), (jloss, jgrad) = value_and_grad_both(port, jax_fn, prediction, target, weights)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="neuron mask"):
        losses.get_loss("mice_poisson", {"log_input": True})


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "SmoothL1Loss", "HuberLoss"])
def test_stock_losses_match_jax(name):
    rng = np.random.default_rng(2)
    prediction, target, weights = mice_batch(rng)
    params = {"SmoothL1Loss": {"beta": 0.5}, "HuberLoss": {"delta": 0.7}}.get(name, {})
    (loss, grad), (jloss, jgrad) = value_and_grad_both(
        losses.get_loss(name, params), jlosses.get_loss(name, params), prediction, target, weights
    )
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-7)


def test_distill_injection_and_loss_match_jax():
    rng = np.random.default_rng(3)
    prediction, target, weights = mice_batch(rng)
    teacher = rng.uniform(0.05, 2.0, prediction.shape).astype(np.float32)
    full_t, full_w = losses.inject_distill_targets(
        torch.from_numpy(target), torch.from_numpy(weights), torch.from_numpy(teacher), 0.3
    )
    jfull_t, jfull_w = jlosses.inject_distill_targets(jnp.asarray(target), jnp.asarray(weights),
                                                      jnp.asarray(teacher), 0.3)
    np.testing.assert_array_equal(full_t.numpy(), np.asarray(jfull_t))
    np.testing.assert_allclose(full_w.numpy(), np.asarray(jfull_w), rtol=1e-7)

    def port(p, t, w, teach):
        return losses.mice_poisson_distill_loss(p, t, w, teach, 0.3)

    def jax_fn(p, t, w, teach):
        return jlosses.mice_poisson_distill_loss(p, t, w, teach, 0.3)

    (loss, grad), (jloss, jgrad) = value_and_grad_both(port, jax_fn, prediction, target, weights, teacher)
    np.testing.assert_allclose(loss, jloss, rtol=1e-6)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("hot_value", [np.inf, np.nan])
def test_production_poisson_is_immune_to_masked_nonfinite(hot_value):
    """A NaN or inf prediction in an unsupervised cell gives a finite loss,
    finite gradients and an exact-0 gradient there (tests/test_engine.py)."""
    prediction = np.full((2, 3, 4, 2), 0.5, np.float32)
    prediction[1] = hot_value
    weights = np.zeros((3, 2), np.float32)
    weights[:, 0] = 1.0
    target = np.ones((3, 4, 2), np.float32)
    p = torch.from_numpy(prediction).requires_grad_()
    loss = losses.mice_poisson_loss(p, torch.from_numpy(target), torch.from_numpy(weights))
    loss.backward()
    assert np.isfinite(loss.item())
    assert torch.all(torch.isfinite(p.grad))
    assert torch.all(p.grad[1] == 0.0) and torch.any(p.grad[0] != 0.0)


@pytest.mark.parametrize("name", ["L1Loss", "MSELoss", "SmoothL1Loss", "HuberLoss"])
def test_stock_losses_are_immune_to_masked_inf(name):
    prediction = np.full((2, 3, 4, 2), 0.5, np.float32)
    prediction[1] = np.inf
    weights = np.zeros((3, 2), np.float32)
    weights[:, 0] = 1.0
    p = torch.from_numpy(prediction).requires_grad_()
    loss = losses.get_loss(name, {})(p, torch.ones(3, 4, 2), torch.from_numpy(weights))
    loss.backward()
    assert np.isfinite(loss.item()) and torch.all(torch.isfinite(p.grad))


def test_loss_registry_names_and_defaults():
    with pytest.raises(KeyError):
        losses.get_loss("CrossEntropy", {})
    rng = np.random.default_rng(4)
    prediction, target, weights = mice_batch(rng)
    args = [torch.from_numpy(a) for a in (prediction, target, weights)]
    # mice_poisson takes rates, as the reference's MicePoissonLoss.
    np.testing.assert_allclose(losses.get_loss("mice_poisson", {"eps": 1e-8})(*args).item(),
                               losses.mice_poisson_loss(*args).item(), rtol=1e-7)


# ---------------------------------------------------------------- schedules


STEPS = list(range(0, 40))
# JAX evaluates the closed forms in fp32: relative 2e-6 of the value, or of
# the 1e-3 base lr where the value is far below it.
SCHEDULE_ATOL = 2e-9
SCHEDULES = [
    ("StepLR", {"step_size": 7, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [5, 12, 30], "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.93}),
    ("LinearLR", {"start_factor": 0.2, "end_factor": 0.9, "total_iters": 11}),
    ("ConstantLR", {"factor": 0.4, "total_iters": 6}),
    ("PolynomialLR", {"total_iters": 25, "power": 2.0}),
    ("CosineAnnealingLR", {"T_max": 17, "eta_min": 1e-5}),
    ("CosineAnnealingWarmRestarts", {"T_0": 5, "T_mult": 1, "eta_min": 1e-5}),
    ("CosineAnnealingWarmRestarts", {"T_0": 3, "T_mult": 2}),
    ("OneCycleLR", {"total_steps": 30, "pct_start": 0.3}),
    ("OneCycleLR", {"total_steps": 30, "anneal_strategy": "linear", "max_lr": 2e-3}),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_registry_schedules_match_jax(name, params):
    port = schedule.get_scheduler(name, 1e-3, params)
    jax_fn = jschedule.get_scheduler(name, 1e-3, params)
    got = [port(s) for s in STEPS]
    expected = [float(jax_fn(jnp.asarray(s))) for s in STEPS]
    np.testing.assert_allclose(got, expected, rtol=2e-6, atol=SCHEDULE_ATOL)


@pytest.mark.parametrize("spec", [None, ("CosineAnnealingWarmRestarts", {"T_0": "train_iters"})])
def test_stage_schedule_matches_jax(spec):
    port = schedule.build_stage_schedule(2.4e-3, 2.4e-5, 6, 20, spec)
    jax_fn = jschedule.build_stage_schedule(2.4e-3, 2.4e-5, 6, 20, spec)
    got = [port(s) for s in STEPS]
    expected = [float(jax_fn(jnp.asarray(s))) for s in STEPS]
    np.testing.assert_allclose(got, expected, rtol=2e-6, atol=SCHEDULE_ATOL)
    assert port(0) == 0.0  # LambdaLR(x / N) starts at 0


def test_warmup_cosine_matches_jax():
    port = schedule.warmup_cosine(1e-3, 1e-5, 4, 10)
    jax_fn = jschedule.warmup_cosine(1e-3, 1e-5, 4, 10)
    np.testing.assert_allclose([port(s) for s in range(20)], [float(jax_fn(s)) for s in range(20)],
                               rtol=2e-6, atol=SCHEDULE_ATOL)
    with pytest.raises(KeyError):
        schedule.get_scheduler("Plateau", 1e-3, {})


def test_get_lr_scales_linearly():
    assert get_lr(3e-4, 32) == pytest.approx(2.4e-3)


# --------------------------------------------------------------- optimizers


OPTIMIZERS = [
    ("AdamW", {"lr": 2.4e-3, "weight_decay": 0.05}),
    ("Adam", {"lr": 1e-3, "weight_decay": 0.01}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True, "weight_decay": 1e-4}),
    ("SGD", {"lr": 0.05}),
    ("RMSprop", {"lr": 0.01, "alpha": 0.99, "eps": 1e-8, "weight_decay": 1e-4, "momentum": 0.9}),
    ("RMSprop", {"lr": 0.01, "centered": True}),
    ("Adagrad", {"lr": 0.05, "weight_decay": 1e-4}),
    ("Adamax", {"lr": 2e-3, "weight_decay": 1e-4}),
    ("RAdam", {"lr": 2e-3, "weight_decay": 1e-4}),
    ("NAdam", {"lr": 2e-3, "weight_decay": 1e-4}),
]


def run_both(name, kwargs, steps=4, clip=0.0, grad_scale=1.0):
    rng = np.random.default_rng(5)
    params0 = {"w": rng.normal(size=(5, 4)).astype(np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * grad_scale).astype(np.float32) for k, v in params0.items()}
             for _ in range(steps)]
    tx = jax_get_optimizer(name, dict(kwargs))
    if clip:
        tx = optax.chain(jax_clip_grad_norm(clip), tx)
    params = jax.tree.map(jnp.asarray, params0)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    opt = get_optimizer(name, kwargs, tparams.values())
    for g in grads:
        opt.zero_grad()
        for k in tparams:
            tparams[k].grad = torch.from_numpy(g[k].copy())
        if clip:
            torch.nn.utils.clip_grad_norm_(list(tparams.values()), clip)
        opt.step()
    return {k: np.asarray(v) for k, v in params.items()}, {k: v.detach().numpy() for k, v in tparams.items()}


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS)
def test_optimizer_names_match_optax(name, kwargs):
    expected, got = run_both(name, kwargs)
    for k in expected:
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-5, atol=1e-7, err_msg=f"{name}:{k}")


@pytest.mark.parametrize("grad_scale", [0.05, 3.0])  # below and above the threshold
def test_clipping_matches_jax(grad_scale):
    expected, got = run_both("SGD", {"lr": 0.1}, clip=1.0, grad_scale=grad_scale)
    for k in expected:
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_optimizer_registry_refuses_what_jax_lacks():
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(KeyError):
        get_optimizer("LBFGS", {"lr": 1.0}, params)
    with pytest.raises(NotImplementedError, match="lr_decay"):
        get_optimizer("Adagrad", {"lr": 0.1, "lr_decay": 0.1}, params)
    with pytest.raises(TypeError, match="amsgrad"):
        get_optimizer("AdamW", {"lr": 0.1, "amsgrad": True}, params)
    with pytest.raises(ValueError, match="learning rate"):
        get_optimizer("SGD", {}, params)
    opt = get_optimizer("AdamW", {"lr": 0.1}, params, learning_rate=0.5)
    assert opt.param_groups[0]["lr"] == 0.5 and opt.param_groups[0]["weight_decay"] == 1e-2
    assert len(opt.param_groups) == 1


# ---------------------------------------------------------------------- EMA


def test_ema_update_matches_jax():
    rng = np.random.default_rng(6)
    ema = {"w": rand32(rng, 3, 4), "stats": {"mean": rand32(rng, 5)}}
    new = {"w": rand32(rng, 3, 4), "stats": {"mean": rand32(rng, 5)}}
    expected = jax_ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, new), 0.999)
    port = [torch.from_numpy(ema["w"].copy()), torch.from_numpy(ema["stats"]["mean"].copy())]
    ema_update(port, [torch.from_numpy(new["w"]), torch.from_numpy(new["stats"]["mean"])], 0.999)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(expected["w"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(expected["stats"]["mean"]), rtol=1e-6, atol=1e-7)
    simple = [torch.ones(3)]
    ema_update(simple, [torch.zeros(3)], 0.9)
    np.testing.assert_allclose(simple[0].numpy(), 0.9)
    with pytest.raises(ValueError, match="EMA holds"):
        ema_update(simple, [], 0.9)


def rand32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)
