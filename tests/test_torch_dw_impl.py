"""The port's depthwise-backend switch (``ops/conv.py`` ``_dw_implementation``)
on the CPU.

``SENSORIUM_DW_IMPL`` unset or ``cuda`` is the hand-written kernels' route
(their plain versions for CPU tensors), ``cudnn`` PyTorch's grouped
``conv3d``. Under ``cudnn`` the spatial conv (stride 1 and 2) and the
temporal conv, forward and both gradients, are held to the default route
and to the JAX package's ``SENSORIUM_DW_IMPL=xla`` route in fp32 at
``tests/test_pallas_dw.py``'s tolerances (forward atol 1e-5, gradients
atol 1e-4); an eval forward of the tiny model under ``cudnn`` to JAX's at
``tests/test_torch_model.py``'s (rtol 1e-4, atol 1e-5). An unknown value
raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sensorium_tpu.models.dwiseneuro import DwiseNeuro as JaxDwiseNeuro
from sensorium_tpu.ops import conv as jconv
from sensorium_tpu_torch.ops import conv
from tests.test_model_parity import MODEL_KWARGS
from tests.test_torch_model import perturbed_variables, port_model

FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5


def loss_and_grads(fn, x: np.ndarray, w: np.ndarray):
    """``fn(x, w)``, and the gradients of sum(y * cos(y)) in x and w."""
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad((y * torch.cos(y)).sum(), (xt, wt))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


def jax_loss_and_grads(fn, x: np.ndarray, w: np.ndarray):
    def loss(a, b):
        y = fn(a, b)
        return jnp.sum(y * jnp.cos(y))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w))), np.asarray(gx), np.asarray(gw)


CASES = {
    "spatial_s1": (lambda x, w: conv.depthwise_conv_spatial(x, w, 1),
                   lambda x, w: jconv.depthwise_conv_spatial(x, w, 1), (2, 3, 9, 11, 8), (3, 3, 8)),
    "spatial_s2": (lambda x, w: conv.depthwise_conv_spatial(x, w, 2),
                   lambda x, w: jconv.depthwise_conv_spatial(x, w, 2), (2, 3, 9, 11, 8), (3, 3, 8)),
    "spatial_k5_s2": (lambda x, w: conv.depthwise_conv_spatial(x, w, 2),
                      lambda x, w: jconv.depthwise_conv_spatial(x, w, 2), (2, 2, 8, 8, 16), (5, 5, 16)),
    "temporal": (conv.depthwise_conv_temporal, jconv.depthwise_conv_temporal, (2, 7, 4, 5, 8), (5, 8)),
}


@pytest.mark.parametrize("case", CASES)
def test_cudnn_route_matches_the_kernels_route_and_jax_xla(monkeypatch, case):
    port_fn, jax_fn, x_shape, w_shape = CASES[case]
    rng = np.random.default_rng(0)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=w_shape).astype(np.float32)
    monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)
    default = loss_and_grads(port_fn, x, w)
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "xla")  # the JAX package's library lowering
    reference = jax_loss_and_grads(jax_fn, x, w)
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "cudnn")
    got = loss_and_grads(port_fn, x, w)
    for label, expected in (("default route", default), ("jax xla", reference)):
        assert got[0].shape == expected[0].shape, label
        np.testing.assert_allclose(got[0], expected[0], atol=FWD_ATOL, err_msg=f"{label} forward")
        np.testing.assert_allclose(got[1], expected[1], atol=GRAD_ATOL, err_msg=f"{label} dx")
        np.testing.assert_allclose(got[2], expected[2], atol=GRAD_ATOL, err_msg=f"{label} dw")


@pytest.mark.parametrize("impl", ["cuda", "cudnn"])
def test_routes_keep_the_contract_in_bf16(monkeypatch, impl):
    """Channels-last and contiguous out, x's dtype, the stride-2 size, and the
    weight gradient rounded to x's dtype before the cast to the parameter's."""
    monkeypatch.setenv("SENSORIUM_DW_IMPL", impl)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, 11, 8, generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn(3, 3, 8, generator=gen, requires_grad=True)
    y = conv.depthwise_conv_spatial(x, w, 2)
    assert y.shape == (2, 3, 5, 6, 8) and y.dtype == torch.bfloat16 and y.is_contiguous()
    y.float().square().sum().backward()
    assert w.grad.dtype == torch.float32
    assert torch.equal(w.grad, w.grad.to(torch.bfloat16).float())
    wt = torch.randn(5, 8, generator=gen, requires_grad=True)
    yt = conv.depthwise_conv_temporal(x.detach(), wt)
    assert yt.shape == x.shape and yt.dtype == torch.bfloat16 and yt.is_contiguous()
    yt.float().square().sum().backward()
    assert torch.equal(wt.grad, wt.grad.to(torch.bfloat16).float())


def test_cudnn_route_bf16_weight_gradient_is_finite_over_reused_memory(monkeypatch):
    """PyTorch's CPU conv3d reads uninitialized memory in the bf16 weight
    gradient of the temporal conv when its input is channels-last; with the
    allocator's free blocks full of NaN, that gradient came back NaN in about
    half of the calls. The route hands the CPU a contiguous input."""
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "cudnn")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, 11, 8, generator=gen).to(torch.bfloat16)
    expected = None
    for _ in range(40):
        w = torch.randn(5, 8, generator=torch.Generator().manual_seed(1), requires_grad=True)
        conv.depthwise_conv_temporal(x, w).float().square().sum().backward()
        assert torch.isfinite(w.grad).all()
        expected = w.grad if expected is None else expected
        assert torch.equal(w.grad, expected)
        del w
        torch.full((1 << 16,), float("nan"), dtype=torch.bfloat16)  # freed at once: NaN in the free blocks
        torch.full((1 << 14,), float("nan"))


def test_eval_forward_under_cudnn_matches_jax(monkeypatch):
    shape = (2, 5, 8, 16, 16)
    variables = perturbed_variables(MODEL_KWARGS, seed=0, shape=shape)
    x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "xla")
    expected = np.asarray(JaxDwiseNeuro(**MODEL_KWARGS).apply(variables, x, train=False))
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "cudnn")
    model = port_model(MODEL_KWARGS, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape
    for mouse, num in enumerate(MODEL_KWARGS["readout_outputs"]):
        np.testing.assert_allclose(got[mouse][:, :num], expected[mouse][:, :num], rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_eval_bn_runs_in_the_convs_only_on_the_kernels_route(monkeypatch):
    """The prologue convs are the hand-written kernels' (``eval_bn_runs_in_dw``):
    under ``cudnn``, or for a kernel size they are not compiled for, an eval
    block keeps the BN passes and the library's convs."""
    k3, k5, k7 = torch.zeros(3, 3, 8), torch.zeros(5, 8), torch.zeros(7, 7, 8)
    monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)
    assert conv.eval_bn_runs_in_dw(k3, k5) and not conv.eval_bn_runs_in_dw(k7, k5)
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "cudnn")
    assert not conv.eval_bn_runs_in_dw(k3, k5)
    called = []
    monkeypatch.setattr(conv, "dw_spatial_fwd_bn", lambda *args: called.append(args))
    monkeypatch.setattr(conv, "dw_temporal_fwd_bn", lambda *args: called.append(args))
    model = port_model(MODEL_KWARGS, perturbed_variables(MODEL_KWARGS, seed=0))
    with torch.no_grad():
        out = model(torch.zeros(1, 5, 8, 16, 16))
    assert not called and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("value", ["xla", "pallas", "CUDA", "triton"])
def test_unknown_value_raises(monkeypatch, value):
    monkeypatch.setenv("SENSORIUM_DW_IMPL", value)
    x, w = torch.zeros(1, 1, 4, 4, 8), torch.zeros(3, 3, 8)
    with pytest.raises(ValueError, match="SENSORIUM_DW_IMPL"):
        conv._dw_implementation()
    with pytest.raises(ValueError, match="SENSORIUM_DW_IMPL"):
        conv.depthwise_conv_spatial(x, w)
    with pytest.raises(ValueError, match="SENSORIUM_DW_IMPL"):
        conv.depthwise_conv_temporal(x, torch.zeros(5, 8))


@pytest.mark.parametrize("value", [None, "", "cuda"])
def test_default_is_the_kernels(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)
    else:
        monkeypatch.setenv("SENSORIUM_DW_IMPL", value)
    assert conv._dw_implementation() == "cuda"
