"""The port's training step against the JAX package's ``make_train_step``, on the CPU.

A tiny fp32 DwiseNeuro with drop rates 0 (the configuration of
``tests/test_grad_parity.py``), its variables from the JAX ``init`` with
random BN statistics, moved into the port with ``from_jax_variables``. The
batches come from numpy with a seed. Tolerances are those of the JAX tests
that hold the JAX step to torch: ``tests/test_grad_parity.py`` for one step,
``tests/test_train_lockstep.py`` for several (BN biases whose output feeds
another normalization have an analytically zero gradient, so Adam turns
rounding noise into a +-lr walk there on both sides; their gradients are
held to a noise bound instead of to each other).
"""

from __future__ import annotations

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sensorium_tpu.engine import losses as jlosses
from sensorium_tpu.engine import schedule as jschedule
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu.engine.optimizers import get_optimizer as jax_get_optimizer
from sensorium_tpu.engine.state import TrainState as JaxTrainState
from sensorium_tpu.engine.steps import make_train_step as jax_make_train_step
from sensorium_tpu.models.dwiseneuro import DwiseNeuro as JaxDwiseNeuro
from sensorium_tpu_torch.compat import from_jax_state, from_jax_variables
from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine import losses, schedule
from sensorium_tpu_torch.engine.model import MouseModel
from sensorium_tpu_torch.engine.optimizers import get_optimizer
from sensorium_tpu_torch.engine.state import TrainState
from sensorium_tpu_torch.engine.steps import make_train_step
from sensorium_tpu_torch.models.dwiseneuro import DwiseNeuro
from tests.test_engine import tiny_params
from tests.test_grad_parity import MODEL_KWARGS, READOUT_OUTPUTS
from tests.test_torch_model import perturbed_variables

SHAPE = (4, 5, 8, 16, 16)
BN_BIAS_ATOL = 3e-2  # tests/test_train_lockstep.py _BN_BIAS_ATOL
# Gradient of a BN bias whose output feeds another BN: analytically 0, so
# both sides hold fp32 cancellation noise (up to ~5e-5 in XLA's backward).
GAUGE_GRAD_ATOL = 2e-4
# BN statistics of a first step: the shift (the running mean) is still far
# from the batch mean of 0-255 video, so the one-pass variance cancels
# ~(mean/std)^2 of its digits on both sides; they add in another order.
STATS_RTOL = 1e-4


def make_batch(seed: int, shape=SHAPE):
    rng = np.random.default_rng(seed)
    inputs = rng.uniform(0, 255, shape).astype(np.float32)
    n_max = max(READOUT_OUTPUTS)
    targets = rng.gamma(1.5, 1.0, (shape[0], n_max, shape[2])).astype(np.float32)
    weights = np.zeros((shape[0], len(READOUT_OUTPUTS)), np.float32)
    mice = np.arange(shape[0]) % 2 * 2  # mice 0 and 2; mouse 1 has no sample
    weights[np.arange(shape[0]), mice] = 1.0
    for b, m in enumerate(mice):
        targets[b, READOUT_OUTPUTS[m]:] = 0.0
    return inputs, targets, weights


def jax_state(variables, tx, ema: bool):
    params, stats = variables["params"], variables["batch_stats"]
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
        ema_params=jax.tree.map(jnp.copy, params) if ema else None,
        ema_batch_stats=jax.tree.map(jnp.copy, stats) if ema else None, rng=jax.random.PRNGKey(0),
    )


def port_state(variables, kwargs, optimizer_spec, learning_rate, ema: bool) -> TrainState:
    model = DwiseNeuro(**{**kwargs, "dtype": torch.float32})
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]), strict=True)
    model.train()
    name, params = optimizer_spec
    optimizer = get_optimizer(name, params, model.parameters(), learning_rate=learning_rate)
    ema_model = copy.deepcopy(model).requires_grad_(False) if ema else None
    return TrainState(step=0, model=model, optimizer=optimizer, ema_model=ema_model,
                      generator=torch.Generator().manual_seed(0))


def torch_batch(batch):
    return [torch.from_numpy(a) for a in batch]


def flat(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in from_jax_variables(tree, {}).items()}


def is_bn_bias(name: str) -> bool:
    """A BN bias whose output reaches another BN before any nonlinearity:
    the stem's, each block's projection and shortcut BNs, and the shortcut
    BNs of every cortex layer but the last (which feeds the readout)."""
    last_cortex = f"cortex_{len(MODEL_KWARGS['cortex_features']) - 1}."
    if not name.endswith(".bn.bias"):
        return False
    if name.startswith("stem_bn.") or (name.startswith("block_") and (".pwl_bn." in name or ".bn_sc." in name)):
        return True
    return name.startswith("cortex_") and ".bn_sc." in name and not name.startswith(last_cortex)


def assert_params_close(port_params: dict, jax_params: dict, rtol, atol, noise_atol, label):
    assert set(port_params) == set(jax_params), label
    for name, value in jax_params.items():
        got = port_params[name]
        if is_bn_bias(name):
            np.testing.assert_allclose(got, value, atol=noise_atol, err_msg=f"{label}{name}")
        else:
            np.testing.assert_allclose(got, value, rtol=rtol, atol=atol, err_msg=f"{label}{name}")


def assert_sgd_update_matches(state, variables, jax_params, lr=0.1):
    """JAX's SGD update read back as a gradient, ``(p0 - p1) / lr``, against
    the port's ``.grad`` (test_grad_parity.py's tolerances; the fp32
    subtraction adds at most ~2 ulp of |p| / lr)."""
    before, after = flat(variables["params"]), flat(jax_params)
    got = {k: v.grad.numpy() for k, v in state.model.named_parameters()}
    for name in before:
        expected = (before[name] - after[name]) / lr
        if is_bn_bias(name):
            assert np.abs(got[name]).max() < GAUGE_GRAD_ATOL and np.abs(expected).max() < GAUGE_GRAD_ATOL
        else:
            np.testing.assert_allclose(got[name], expected, rtol=2e-4, atol=5e-5, err_msg=name)


def named_params(model) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def named_buffers(model) -> dict[str, np.ndarray]:
    return {k: v.numpy().copy() for k, v in model.named_buffers()}


@pytest.fixture(scope="module")
def variables():
    return perturbed_variables(MODEL_KWARGS, seed=4, shape=SHAPE)


def test_one_step_matches_jax(variables):
    """Loss, every gradient (test_grad_parity.py's tolerances), the SGD
    update and the BN statistics after the step."""
    batch = make_batch(10)
    jmodel = JaxDwiseNeuro(**MODEL_KWARGS)

    def loss_fn(p):
        out, mutated = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, batch[0], train=True,
                                    mutable=["batch_stats"])
        return jlosses.mice_poisson_loss(out.astype(jnp.float32), batch[1], batch[2]), mutated["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tx = jax_get_optimizer("SGD", {"lr": 0.1})
    jstep = jax_make_train_step(jmodel, tx, jlosses.mice_poisson_loss, donate=False)
    jnew, jloss_step = jstep(jax_state(variables, tx, ema=False), *batch)

    state = port_state(variables, MODEL_KWARGS, ("SGD", {"lr": 0.1}), None, ema=False)
    loss = make_train_step(losses.mice_poisson_loss)(state, *torch_batch(batch))
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss_step), rtol=1e-5)
    expected = flat(jgrads)
    got = {k: v.grad.numpy() for k, v in state.model.named_parameters()}
    assert set(got) == set(expected)
    for name in expected:
        if is_bn_bias(name):
            assert np.abs(got[name]).max() < GAUGE_GRAD_ATOL and np.abs(expected[name]).max() < GAUGE_GRAD_ATOL
        else:
            np.testing.assert_allclose(got[name], expected[name], rtol=2e-4, atol=5e-5, err_msg=name)
    # Mouse 1 has no sample: its readout gets exactly no gradient.
    assert np.all(got["readout_kernel"][1] == 0.0) and np.all(got["readout_bias"][1] == 0.0)
    stats = named_buffers(state.model)
    for name, value in flat(jstats).items():
        np.testing.assert_allclose(stats[name], value, rtol=STATS_RTOL, atol=1e-6, err_msg=name)
    assert_sgd_update_matches(state, variables, jnew.params)


def test_three_steps_adamw_warmup_cosine_ema_match_jax(variables):
    """The composed chain (AdamW wd 0.05 under warmup + cosine, EMA 0.9, BN
    statistics carried) over 3 steps, held to test_train_lockstep.py's
    tolerances."""
    batches = [make_batch(20 + i) for i in range(3)]
    jmodel = JaxDwiseNeuro(**MODEL_KWARGS)
    jsched = jschedule.warmup_cosine(1e-3, 1e-5, 2, 10)
    tx = jax_get_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.05}, learning_rate=jsched)
    jstep = jax_make_train_step(jmodel, tx, jlosses.mice_poisson_loss, ema_decay=0.9, donate=False)
    jst = jax_state(variables, tx, ema=True)

    sched = schedule.warmup_cosine(1e-3, 1e-5, 2, 10)
    state = port_state(variables, MODEL_KWARGS, ("AdamW", {"lr": 1e-3, "weight_decay": 0.05}), sched(0), ema=True)
    step = make_train_step(losses.mice_poisson_loss, ema_decay=0.9, schedule=sched)
    for batch in batches:
        jst, jloss = jstep(jst, *batch)
        loss = step(state, *torch_batch(batch))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    assert state.step == int(jst.step) == 3
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(float(jsched(2)), rel=1e-6)
    assert_params_close(named_params(state.model), flat(jst.params), 5e-3, 5e-3, BN_BIAS_ATOL, "params:")
    assert_params_close(named_params(state.ema_model), flat(jst.ema_params), 5e-3, 1e-4, 1e-3, "ema:")
    stats = named_buffers(state.model)
    for name, value in flat(jst.batch_stats).items():
        np.testing.assert_allclose(stats[name], value, rtol=5e-3, atol=5e-3, err_msg=name)
    ema_stats = named_buffers(state.ema_model)
    for name, value in flat(jst.ema_batch_stats).items():
        np.testing.assert_allclose(ema_stats[name], value, rtol=5e-3, atol=1e-4, err_msg=name)


def test_iter_size_two_matches_jax(variables):
    """Two microbatches: BN statistics carried chunk to chunk, gradients
    averaged, loss the sum of chunk / iter_size."""
    batch = make_batch(30)
    jmodel = JaxDwiseNeuro(**MODEL_KWARGS)
    tx = jax_get_optimizer("SGD", {"lr": 0.1})
    jnew, jloss = jax_make_train_step(jmodel, tx, jlosses.mice_poisson_loss, iter_size=2, donate=False)(
        jax_state(variables, tx, ema=False), *batch
    )
    state = port_state(variables, MODEL_KWARGS, ("SGD", {"lr": 0.1}), None, ema=False)
    step = make_train_step(losses.mice_poisson_loss, iter_size=2)
    loss = step(state, *torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_sgd_update_matches(state, variables, jnew.params)
    stats = named_buffers(state.model)
    for name, value in flat(jnew.batch_stats).items():
        np.testing.assert_allclose(stats[name], value, rtol=STATS_RTOL, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="not divisible by iter_size"):
        make_train_step(losses.mice_poisson_loss, iter_size=3)(state, *torch_batch(batch))


def test_distillation_step_matches_jax(variables):
    """A frozen teacher's eval predictions fill the zero-weight cells
    (``inject_distill_targets``) before the loss, on both sides."""
    batch = make_batch(35)
    teacher_vars = perturbed_variables(MODEL_KWARGS, seed=7, shape=SHAPE)
    jmodel = JaxDwiseNeuro(**MODEL_KWARGS)
    tx = jax_get_optimizer("SGD", {"lr": 0.1})
    jstep = jax_make_train_step(jmodel, tx, jlosses.mice_poisson_loss, distill_ratio=0.3, teacher_model=jmodel,
                                donate=False)
    jnew, jloss = jstep(jax_state(variables, tx, ema=False), *batch, teacher_vars)

    teacher = port_state(teacher_vars, MODEL_KWARGS, ("SGD", {"lr": 0.1}), None, ema=False).model.eval()
    state = port_state(variables, MODEL_KWARGS, ("SGD", {"lr": 0.1}), None, ema=False)
    loss = make_train_step(losses.mice_poisson_loss, distill_ratio=0.3, teacher_model=teacher)(
        state, *torch_batch(batch)
    )
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_sgd_update_matches(state, variables, jnew.params)
    assert all(p.grad is None for p in teacher.parameters())


@pytest.mark.parametrize("spec", [(1,), -1])
def test_remat_preserves_loss_gradients_and_statistics(variables, spec):
    """Rematerialized blocks rerun in the backward pass with the same
    drop-path mask and the same BN shift, and update the running
    statistics once: loss, gradients and statistics equal those without
    remat, with drop rates above 0."""
    kwargs = {**MODEL_KWARGS, "drop_rate": 0.3, "drop_path_rate": 0.5}
    batch = torch_batch(make_batch(40))
    results = []
    for remat in (False, True):
        state = port_state(variables, {**kwargs, "remat": remat, "remat_blocks": spec}, ("SGD", {"lr": 0.1}), None,
                           ema=False)
        assert state.model.remat_set == (frozenset({0, 1} if spec == -1 else spec) if remat else frozenset())
        loss = make_train_step(losses.mice_poisson_loss)(state, *batch)
        grads = {k: v.grad.clone() for k, v in state.model.named_parameters()}
        results.append((loss, grads, dict(state.model.named_buffers())))
    (loss0, grads0, stats0), (loss1, grads1, stats1) = results
    assert torch.equal(loss0, loss1)
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in stats0:
        assert torch.equal(stats0[name], stats1[name]), name


def test_resume_from_a_jax_state_matches_jax(variables):
    """Two JAX steps, then the state moves into the port through
    ``from_jax_state`` (parameters, BN statistics, EMA, Adam moments and
    count); one more step on each side agrees."""
    batches = [make_batch(50 + i) for i in range(3)]
    jmodel = JaxDwiseNeuro(**MODEL_KWARGS)
    jsched = jschedule.warmup_cosine(1e-3, 1e-5, 1, 10)
    tx = jax_get_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.05}, learning_rate=jsched)
    jstep = jax_make_train_step(jmodel, tx, jlosses.mice_poisson_loss, ema_decay=0.9, donate=False)
    jst = jax_state(variables, tx, ema=True)
    for batch in batches[:2]:
        jst, _ = jstep(jst, *batch)

    sched = schedule.warmup_cosine(1e-3, 1e-5, 1, 10)
    other = perturbed_variables(MODEL_KWARGS, seed=5, shape=SHAPE)  # overwritten by the resume
    state = port_state(other, MODEL_KWARGS, ("AdamW", {"lr": 1e-3, "weight_decay": 0.05}), sched(0), ema=True)
    from_jax_state(jst, state)
    assert state.step == 2
    moments = state.optimizer.state[state.model.readout_kernel]
    np.testing.assert_array_equal(moments["exp_avg"].numpy(), np.asarray(jst.opt_state[0].mu["readout_kernel"]))
    assert moments["step"].item() == 2.0

    jst, jloss = jstep(jst, *batches[2])
    loss = make_train_step(losses.mice_poisson_loss, ema_decay=0.9, schedule=sched)(state, *torch_batch(batches[2]))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_params_close(named_params(state.model), flat(jst.params), 5e-3, 5e-3, BN_BIAS_ATOL, "params:")
    assert_params_close(named_params(state.ema_model), flat(jst.ema_params), 5e-3, 1e-4, 1e-3, "ema:")
    with pytest.raises(TypeError, match="Adam"):
        sgd = port_state(other, MODEL_KWARGS, ("SGD", {"lr": 0.1}), None, ema=True)
        from_jax_state(jst, sgd)


def test_mouse_model_builds_trains_and_validates_on_the_cpu():
    params = tiny_params()
    model = MouseModel(params, device="cpu")
    np.testing.assert_array_equal(model.example_input(2), JaxMouseModel(params).example_input(2))
    model.set_ema(0.999)
    state = model.build_state(seed=0, learning_rate=3e-3)
    assert state.ema_model is not None and state.model.training
    assert state.model.remat_set == frozenset({0, 1})  # the DwiseNeuro default remats every block
    rng = np.random.default_rng(60)
    inputs = rng.uniform(0, 255, (4, 5, 4, 16, 16)).astype(np.float32)
    targets = rng.uniform(0, 2, (4, 7, 4)).astype(np.float32)
    weights = np.zeros((4, 2), np.float32)
    weights[np.arange(4), [0, 1, 0, 1]] = 1.0
    batch = MiceBatch(inputs=inputs, targets=targets, weights=weights)
    losses_seen = [model.train_step(batch).item() for _ in range(8)]
    assert all(np.isfinite(losses_seen)) and losses_seen[-1] < losses_seen[0]
    assert state.step == 8
    loss, prediction, staged_targets, _ = model.val_step(batch)
    assert np.isfinite(loss.item()) and prediction.shape == (2, 4, 7, 4) and prediction.dtype == torch.float32
    assert torch.equal(staged_targets, torch.from_numpy(targets))
    assert torch.equal(state.eval_state_dict()["stem_kernel"], state.ema_model.stem_kernel)
    assert model.predict(inputs[0], mouse_index=1).shape == (7, 4)
    assert model.predict(inputs).shape == (2, 4, 7, 4)
    model.set_ema(0.0)
    assert state.ema_model is None
    model.set_ema(0.5)
    assert torch.equal(state.ema_model.stem_kernel, state.model.stem_kernel)


def test_mouse_model_refuses_uneven_microbatches_and_a_missing_state():
    model = MouseModel(tiny_params(iter_size=3), device="cpu")
    batch = MiceBatch(np.zeros((4, 5, 4, 16, 16), np.float32), np.zeros((4, 7, 4), np.float32),
                      np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    with pytest.raises(RuntimeError, match="build_state"):
        model.train_step(batch)
    model.build_state(seed=1, learning_rate=1e-3)
    with pytest.raises(ValueError, match="not divisible"):
        model.train_step(batch)


def test_mouse_model_stages_bf16_inputs_on_the_host():
    params = tiny_params()
    name, nn_params = params["nn_module"]
    model = MouseModel({**params, "nn_module": (name, {**nn_params, "dtype": "bfloat16"})}, device="cpu")
    model.build_state(seed=0, learning_rate=1e-3)
    x = np.random.default_rng(0).uniform(0, 255, (2, 5, 4, 16, 16)).astype(np.float32)
    staged = model._stage_inputs(x)
    assert staged.dtype == torch.bfloat16
    assert torch.equal(staged, torch.from_numpy(x).to(torch.bfloat16))


class _Teacher(torch.nn.Module):
    """A stand-in distillation teacher, with a ``dtype`` attribute or without."""

    def __init__(self, dtype=None):
        super().__init__()
        if dtype is not None:
            self.dtype = dtype

    def forward(self, x):
        return x


@pytest.mark.parametrize("teacher_dtype, env", [("none", None), ("bfloat16", None), ("float32", None),
                                                (None, "0"), ("bfloat16", "0")])
def test_mouse_model_stages_inputs_as_jax_does_for_a_distillation_teacher(teacher_dtype, env, monkeypatch):
    """A bf16 student stages bf16 only with no teacher or a bf16 one, and not
    under ``SENSORIUM_STAGE_BF16=0``, as JAX's ``MouseModel._stage_inputs``
    (``_is_bf16``) rules: a teacher without ``dtype`` counts as not bf16, and
    then gets the float32 batch as it is."""
    if env is None:
        monkeypatch.delenv("SENSORIUM_STAGE_BF16", raising=False)
    else:
        monkeypatch.setenv("SENSORIUM_STAGE_BF16", env)
    params = tiny_params()
    name, nn_params = params["nn_module"]
    model = MouseModel({**params, "nn_module": (name, {**nn_params, "dtype": "bfloat16"})}, device="cpu")
    model.build_state(seed=0, learning_rate=1e-3)
    torch_dtypes = {"none": None, "bfloat16": torch.bfloat16, "float32": torch.float32}
    jax_dtypes = {"none": None, "bfloat16": jnp.bfloat16, "float32": jnp.float32}
    jax_teacher = None
    if teacher_dtype is not None:
        model.set_distill(_Teacher(torch_dtypes[teacher_dtype]), 0.3)
        jax_teacher = object() if teacher_dtype == "none" else types.SimpleNamespace(dtype=jax_dtypes[teacher_dtype])
    x = np.random.default_rng(1).uniform(0, 255, (2, 5, 4, 16, 16)).astype(np.float32)
    staged = model._stage_inputs(x)
    jax_staged = np.asarray(JaxMouseModel._stage_inputs(
        types.SimpleNamespace(nn_module=types.SimpleNamespace(dtype=jnp.bfloat16), teacher_module=jax_teacher), x))
    bf16 = jax_staged.dtype == jnp.bfloat16
    assert bf16 == (teacher_dtype in (None, "bfloat16") and env != "0")
    assert staged.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(staged.float().numpy(), jax_staged.astype(np.float32))
    if not bf16:
        assert torch.equal(staged, torch.from_numpy(x))


def test_training_forward_needs_a_generator_when_it_drops():
    model = DwiseNeuro(**{**MODEL_KWARGS, "dtype": torch.float32, "drop_rate": 0.2}).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(2, 5, 8, 16, 16))
    out = model(torch.zeros(2, 5, 8, 16, 16), generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 2, 11, 8)
