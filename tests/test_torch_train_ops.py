"""The port's training ops against the JAX package's, on the CPU.

BatchNorm in training mode, drop-path and channel dropout, and the backward
of the depthwise convs. Inputs come from numpy with a seed and go through
both. The JAX depthwise convs run as the JAX tests run them: the Pallas
kernels in interpret mode, and the XLA lowering. The port's CUDA kernels run
only on a card (``tests/test_torch_cuda.py``); here the autograd Functions
use the plain versions.
"""

from __future__ import annotations

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sensorium_tpu.ops import conv as jconv
from sensorium_tpu.ops import pallas_dw
from sensorium_tpu.ops.norm import BatchNorm as JaxBatchNorm
from sensorium_tpu.ops.stochastic import channel_dropout as jax_channel_dropout
from sensorium_tpu.ops.stochastic import drop_path as jax_drop_path
from sensorium_tpu_torch.ops import dw_kernels
from sensorium_tpu_torch.ops import bn_kernels
from sensorium_tpu_torch.ops.norm import BatchNorm, batch_norm_train
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.ops.stochastic import channel_dropout, drop_path, drop_path_mask

BF16_RTOL = 2.0**-8


@pytest.fixture(autouse=True)
def jax_dw_paths(monkeypatch):
    monkeypatch.setattr(pallas_dw, "INTERPRET", True)
    # Both packages on their default depthwise routes: jconv on XLA, the port on its kernels.
    monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------ BatchNorm


def bn_variables(rng, c):
    return {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32), "bias": rand(rng, c)},
        "batch_stats": {"mean": rand(rng, c) * 0.3, "var": rng.uniform(0.5, 2.0, c).astype(np.float32)},
    }


def port_bn(variables, c, dtype):
    bn = BatchNorm(c, dtype=dtype).train()
    flat = {**variables["params"], **variables["batch_stats"]}
    bn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})
    return bn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_train_matches_jax(dtype):
    """Output and running statistics (var unbiased) after one training
    forward; bf16 output within one bf16 rounding of JAX's."""
    rng = np.random.default_rng(20)
    c = 6
    x32 = rand(rng, 2, 3, 4, 5, c) * 2 + 1.5
    x = torch.from_numpy(x32).to(dtype)
    variables = bn_variables(rng, c)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    expected, mutated = JaxBatchNorm(c, dtype=jdtype).apply(
        variables, jnp.asarray(x.float().numpy()).astype(jdtype), True, mutable=["batch_stats"]
    )
    bn = port_bn(variables, c, dtype)
    got = bn(x)
    assert got.dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(expected, np.float32), rtol=rtol, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(), np.asarray(mutated["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_batchnorm_variance_survives_large_mean():
    """The shifted one-pass variance keeps ~1e-7 relative accuracy at
    mean/std = 80, as the JAX module does (tests/test_ops.py)."""
    rng = np.random.default_rng(21)
    c = 4
    x = (rng.normal(size=(8, 50, c)) * 0.5 + 40).astype(np.float32)
    truth = x.astype(np.float64).reshape(-1, c).var(axis=0, ddof=1)
    bn = BatchNorm(c).train()
    bn.mean.copy_(torch.from_numpy(x.reshape(-1, c).mean(axis=0) + rng.normal(size=c).astype(np.float32) * 0.05))
    bn(torch.from_numpy(x))
    got = (bn.var.numpy() - 0.9) / 0.1
    rel = np.abs(got - truth) / truth
    assert rel.max() < 1e-5, f"shifted variance lost precision: rel={rel.max():.2e}"


def plain_bn_train(x, scale, bias, shift, eps=1e-5):
    """The training BN formula, for autograd to differentiate."""
    dims = tuple(range(x.ndim - 1))
    x32 = x.double() if x.dtype == torch.float64 else x.float()
    mean = x32.mean(dims)
    var = (x32 - shift).square().mean(dims) - (mean - shift).square()
    inv = torch.rsqrt(var + eps) * scale
    return x32 * inv + (bias - mean * inv)


def test_batchnorm_function_gradient_matches_autograd_and_jax():
    rng = np.random.default_rng(22)
    c = 5
    x = rand(rng, 3, 4, 6, c) * 3 + 2
    r = rand(rng, 3, 4, 6, c)
    variables = bn_variables(rng, c)
    scale, bias = variables["params"]["scale"], variables["params"]["bias"]
    shift = variables["batch_stats"]["mean"]

    def port_grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.from_numpy(scale).requires_grad_()
        bt = torch.from_numpy(bias).requires_grad_()
        y = fn(xt, st, bt)
        (y * torch.from_numpy(r)).sum().backward()
        return [t.grad.numpy() for t in (xt, st, bt)]

    got = port_grads(lambda xt, st, bt: batch_norm_train(xt, st, bt, torch.from_numpy(shift), 1e-5,
                                                         torch.float32)[0])
    plain = port_grads(lambda xt, st, bt: plain_bn_train(xt, st, bt, torch.from_numpy(shift)))

    def jax_loss(xj, sj, bj):
        v = {"params": {"scale": sj, "bias": bj}, "batch_stats": variables["batch_stats"]}
        y, _ = JaxBatchNorm(c).apply(v, xj, True, mutable=["batch_stats"])
        return jnp.sum(y * r)

    expected = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    for name, g, p, e in zip(("x", "scale", "bias"), got, plain, expected):
        np.testing.assert_allclose(g, p, rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-4, atol=1e-5, err_msg=name)


def test_batchnorm_function_gradcheck():
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=(3, 4, 3)) * 2 + 1).requires_grad_()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 3)).requires_grad_()
    bias = torch.from_numpy(rng.normal(size=3)).requires_grad_()
    shift = torch.from_numpy(rng.normal(size=3))
    assert torch.autograd.gradcheck(
        lambda a, s, b: batch_norm_train(a, s, b, shift, 1e-5, torch.float64)[0], (x, scale, bias)
    )


def test_batchnorm_recompute_keeps_the_shift_and_the_statistics():
    rng = np.random.default_rng(24)
    bn = BatchNorm(4).train()
    x = torch.from_numpy(rand(rng, 5, 7, 4) * 2 + 3)
    first = bn(x)
    stats = (bn.mean.clone(), bn.var.clone())
    again = bn(x, recompute=True)
    assert torch.equal(first, again)
    assert torch.equal(bn.mean, stats[0]) and torch.equal(bn.var, stats[1])
    with pytest.raises(RuntimeError, match="recompute"):
        BatchNorm(4).train()(x, recompute=True)


def bn_act_grads(x, scale, bias, r, fn):
    """y and the gradients of sum(y * r) by x, scale and bias, in fp32."""
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    y = fn(*leaves)
    (y.float() * r).sum().backward()
    return [y.detach().float()] + [t.grad.float() for t in leaves]


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_function_matches_the_eager_chain_and_jax(dtype, act):
    """The fused BN(+SiLU) Function (its plain version here) against BN's
    formula followed by ``F.silu`` under autograd, rounded to the compute
    dtype where the model rounds, and against JAX's ``BatchNorm`` +
    ``nn.silu``: values and the gradients of x, scale and bias. bf16 within
    a few bf16 roundings of the largest value (the chains round the BN output
    and SiLU's gradient in bf16, at elements where fp32 orders may differ)."""
    rng = np.random.default_rng(26)
    c = 6
    x32 = rand(rng, 3, 4, 5, c) * 2 + 1.5
    r = rand(rng, 3, 4, 5, c)
    variables = bn_variables(rng, c)
    x = torch.from_numpy(x32).to(dtype)
    scale, bias = (torch.from_numpy(variables["params"][k]) for k in ("scale", "bias"))
    shift = torch.from_numpy(variables["batch_stats"]["mean"])

    def chain(xt, st, bt):
        y = plain_bn_train(xt, st, bt, shift).to(dtype)
        return F.silu(y) if act else y

    fused = bn_act_grads(x, scale, bias, torch.from_numpy(r),
                         lambda xt, st, bt: batch_norm_train(xt, st, bt, shift, 1e-5, dtype, act=act)[0])
    eager = bn_act_grads(x, scale, bias, torch.from_numpy(r), chain)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jax_forward(xj, sj, bj):
        v = {"params": {"scale": sj, "bias": bj}, "batch_stats": variables["batch_stats"]}
        y, _ = JaxBatchNorm(c, dtype=jdtype).apply(v, xj, True, mutable=["batch_stats"])
        return jax.nn.silu(y) if act else y

    xj = jnp.asarray(x.float().numpy()).astype(jdtype)
    sj, bj = jnp.asarray(variables["params"]["scale"]), jnp.asarray(variables["params"]["bias"])
    grads = jax.grad(lambda *a: jnp.sum(jax_forward(*a).astype(jnp.float32) * r), argnums=(0, 1, 2))(xj, sj, bj)
    expected = [np.asarray(jax_forward(xj, sj, bj), np.float32)] + [np.asarray(g, np.float32) for g in grads]
    rel = 4 * BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    for name, got, ref, jref in zip(("y", "x", "scale", "bias"), fused, eager, expected):
        bound = rel * float(ref.abs().max()) + 1e-6
        assert (got - ref).abs().max().item() <= bound, f"{name} vs the eager chain"
        assert np.abs(got.numpy() - jref).max() <= bound, f"{name} vs JAX"


@pytest.mark.parametrize("act", [False, True])
def test_bn_act_recompute_keeps_the_shift_and_the_statistics(act):
    """A rematerialized rerun with SiLU gives the first forward's output bit
    for bit and leaves the running statistics as the first forward moved them."""
    rng = np.random.default_rng(27)
    bn = BatchNorm(4, dtype=torch.bfloat16).train()
    bn.mean.copy_(torch.from_numpy(rand(rng, 4)))
    x = torch.from_numpy(rand(rng, 5, 7, 4) * 2 + 3).to(torch.bfloat16)
    first = bn(x, act=act)
    stats = (bn.mean.clone(), bn.var.clone())
    shift = bn._shift
    again = bn(x, recompute=True, act=act)
    assert torch.equal(first, again) and bn._shift is shift
    assert torch.equal(bn.mean, stats[0]) and torch.equal(bn.var, stats[1])
    assert not torch.equal(stats[0], torch.zeros(4))


@pytest.fixture
def bn_group_of_one():
    """A gloo group of this process alone: the mesh path's collectives run,
    and a sum over one process changes nothing."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield mesh_lib.create_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_module_over_a_group_of_one_is_bitwise_the_module_without_a_mesh(bn_group_of_one, dtype):
    """BatchNorm with SiLU, training: over a mesh the moments are all-reduced
    between the partial sums and the finalize step and [Σg, Σg·x̂] before dx;
    at one process the output, the gradients and the running statistics
    equal the no-mesh arithmetic bit for bit."""
    rng = np.random.default_rng(28)
    x = torch.from_numpy(rand(rng, 4, 3, 6, 5, 16) * 3 + 2).to(dtype)
    dy = torch.from_numpy(rand(rng, *x.shape)).to(dtype)
    running_mean = torch.from_numpy(rand(rng, 16))
    results = []
    for mesh in (None, bn_group_of_one):
        bn = BatchNorm(16, dtype=dtype).train()
        bn.mean.copy_(running_mean)
        xt = x.clone().requires_grad_(True)
        with mesh_lib.active(mesh):
            y = bn(xt, act=True)
            y.backward(dy)
        results.append([y, xt.grad, bn.scale.grad, bn.bias.grad, bn.var, bn.mean])
    for name, without, over in zip(("y", "dx", "dscale", "dbias", "var", "mean"), results[0], results[1]):
        assert torch.equal(without, over), name


def test_bn_kernel_wrappers_refuse_empty_inputs():
    c = torch.ones(3)
    for call in (lambda x: bn_kernels.bn_act_eval(x, c, c, c, c, 1e-5, True),
                 lambda x: bn_kernels.bn_stats(x, c, c, c), lambda x: bn_kernels.bn_moments(x, c)):
        with pytest.raises(ValueError, match="at least one row"):
            call(torch.ones(0, 3))
        with pytest.raises(ValueError, match="at least one row"):
            call(torch.ones(3))


@pytest.mark.parametrize(
    "rows, c, itemsize",
    [(2_097_152, 64, 2), (2_097_152, 448, 2), (524_288, 1792, 2), (131_072, 1536, 2), (512, 4096, 2),
     (512, 1024, 4), (120, 6, 2), (7, 3, 4), (1, 1, 2)],
)
def test_bn_launch_geometry_covers_every_row_and_channel_once(rows, c, itemsize):
    """The row kernels' tiling: whole channel tiles of at most 32 vectors and
    256 threads, slabs that cover the rows once, one wave of blocks where
    there are rows enough; the core's shapes split over slabs, the cortex's
    over channel tiles."""
    sms = 132
    for kind, per_sm in (("stats", 4), ("grad", 2)):
        geo = bn_kernels.launch_geometry(rows, c, itemsize, sms, per_sm)
        vectors = -(-c // (16 // itemsize))
        assert 1 <= geo["tile_vecs"] <= 32 and geo["tile_vecs"] * geo["lanes"] <= 256
        assert geo["tiles"] * geo["tile_vecs"] >= vectors > (geo["tiles"] - 1) * geo["tile_vecs"]
        assert geo["slabs"] * geo["rows_per_slab"] >= rows > (geo["slabs"] - 1) * geo["rows_per_slab"]
        blocks = geo["slabs"] * geo["tiles"]
        assert blocks <= per_sm * sms + geo["tiles"] or geo["slabs"] == 1, kind
        if rows >= 256 * per_sm * sms:
            assert blocks >= per_sm * sms - geo["tiles"], kind


# ------------------------------------------------------- drop-path, dropout


def test_drop_path_mask_shape_scale_and_rate():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 2, 3, 1, 4, dtype=torch.bfloat16)
    keep = 0.7
    mask = drop_path_mask(x, 1 - keep, gen)
    assert mask.shape == (20000, 1, 1, 1, 1) and mask.dtype == torch.bfloat16
    scaled = torch.tensor(1.0 / keep, dtype=torch.bfloat16)
    assert set(mask.unique().tolist()) == {0.0, scaled.item()}
    y = drop_path(x, 1 - keep, gen)
    # Whole samples are kept or dropped.
    per_sample = y.float().reshape(20000, -1)
    assert torch.all((per_sample == 0).all(1) | (per_sample == scaled.item()).all(1))
    frac = (per_sample[:, 0] != 0).float().mean().item()
    jax_y = jax_drop_path(jnp.ones((20000, 2, 3, 1, 4), jnp.bfloat16), 1 - keep, jax.random.PRNGKey(0))
    jax_frac = float(jnp.mean(jax_y.reshape(20000, -1)[:, 0] != 0))
    sigma = (keep * (1 - keep) / 20000) ** 0.5
    assert abs(frac - keep) < 5 * sigma and abs(jax_frac - keep) < 5 * sigma
    assert float(jax_y.max()) == scaled.item()
    assert drop_path(x, 0.0, gen) is x


def test_channel_dropout_mask_shape_scale_and_rate():
    gen = torch.Generator().manual_seed(1)
    b, t, c = 400, 6, 50
    x = torch.ones(b, t, c)
    rate = 0.4
    y = channel_dropout(x, rate, gen)
    # One draw per (sample, channel), shared across T.
    assert torch.equal(y, y[:, :1].expand_as(y))
    values = y.unique()
    assert len(values) == 2 and values[0] == 0.0
    np.testing.assert_allclose(values[1].item(), 1 / 0.6, rtol=1e-6)
    frac = (y[:, 0] != 0).float().mean().item()
    jax_y = jax_channel_dropout(jnp.ones((b, t, c)), rate, jax.random.PRNGKey(1))
    jax_frac = float(jnp.mean(jax_y[:, 0] != 0))
    sigma = (0.6 * 0.4 / (b * c)) ** 0.5
    assert abs(frac - 0.6) < 5 * sigma and abs(jax_frac - 0.6) < 5 * sigma
    np.testing.assert_allclose(float(jax_y.max()), y.max().item(), rtol=1e-6)
    assert channel_dropout(x, 0.0, gen) is x


# ------------------------------------------------------ depthwise backward


def jax_spatial_vjp(fn, x, w, dy, stride):
    _, vjp = jax.vjp(lambda a, b: fn(a, b, stride), jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("hw", [(8, 8), (9, 11), (10, 12)])
@pytest.mark.parametrize("stride", [1, 2])
def test_dw_spatial_backward_plain_matches_jax(stride, hw, k):
    rng = np.random.default_rng(30)
    x = rand(rng, 2, 3, *hw, 8)
    w = rand(rng, k, k, 8)
    oh, ow = (dw_kernels.spatial_out_size(s, k, stride) for s in hw)
    dy = rand(rng, 2, 3, oh, ow, 8)
    dx = dw_kernels.dw_spatial_dx_plain(torch.from_numpy(dy), torch.from_numpy(w), stride, hw).numpy()
    dw = dw_kernels.dw_spatial_dw_plain(torch.from_numpy(x), torch.from_numpy(dy), k, stride).numpy()
    assert dw.dtype == np.float32
    for fn in (pallas_dw.dw_spatial, jconv.depthwise_conv_spatial):
        jdx, jdw = jax_spatial_vjp(fn, x, w, dy, stride)
        np.testing.assert_allclose(dx, jdx, atol=1e-4)
        np.testing.assert_allclose(dw, jdw, atol=1e-4)
    # The autograd Function (plain versions on the CPU) gives the same.
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dw_kernels.dw_spatial(xt, wt, stride).backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), dx)
    np.testing.assert_array_equal(wt.grad.numpy(), dw)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_temporal_backward_plain_matches_jax(k):
    rng = np.random.default_rng(31)
    x = rand(rng, 2, 6, 4, 5, 8)
    w = rand(rng, k, 8)
    dy = rand(rng, 2, 6, 4, 5, 8)
    dx = dw_kernels.dw_temporal_plain(torch.from_numpy(dy), torch.from_numpy(w).flip(0)).numpy()
    dw = dw_kernels.dw_temporal_dw_plain(torch.from_numpy(x), torch.from_numpy(dy), k).numpy()
    for fn in (pallas_dw.dw_temporal, jconv.depthwise_conv_temporal):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
        np.testing.assert_allclose(dx, jdx, atol=1e-4)
        np.testing.assert_allclose(dw, jdw, atol=1e-4)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dw_kernels.dw_temporal(xt, wt).backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), dx)
    np.testing.assert_array_equal(wt.grad.numpy(), dw)


@pytest.mark.parametrize("stride", [1, 2])
def test_dw_spatial_function_gradcheck(stride):
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(1, 2, 5, 6, 3))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: dw_kernels.dw_spatial(a, b, stride), (x, w))


def test_dw_temporal_function_gradcheck():
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.normal(size=(1, 5, 2, 3, 3))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(dw_kernels.dw_temporal, (x, w))


def test_dw_backward_rounds_once_in_bf16():
    """bf16 dx rounds once from the fp32 sum; dw comes back in fp32 and the
    Function rounds it to w's dtype."""
    rng = np.random.default_rng(34)
    dy = torch.from_numpy(rand(rng, 2, 3, 5, 6, 16)).to(torch.bfloat16)
    x = torch.from_numpy(rand(rng, 2, 3, 9, 11, 16)).to(torch.bfloat16)
    w = torch.from_numpy(rand(rng, 3, 3, 16)).to(torch.bfloat16)
    low = dw_kernels.dw_spatial_dx_plain(dy, w, 2, (9, 11))
    ref = dw_kernels.dw_spatial_dx_plain(dy.float(), w.float(), 2, (9, 11))
    assert low.dtype == torch.bfloat16
    torch.testing.assert_close(low.float(), ref, rtol=BF16_RTOL, atol=1e-6)
    assert dw_kernels.dw_spatial_dw_plain(x, dy, 3, 2).dtype == torch.float32
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    dw_kernels.dw_spatial(xt, wt, 2).backward(dy)
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.bfloat16


def test_backward_wrappers_refuse_mismatched_shapes():
    x = torch.zeros(1, 2, 6, 6, 8)
    with pytest.raises(ValueError, match="output of"):
        dw_kernels.dw_spatial_dx(torch.zeros(1, 2, 4, 4, 8), torch.zeros(3, 3, 8), 2, (6, 6))
    with pytest.raises(ValueError, match="output of"):
        dw_kernels.dw_spatial_dw(x, torch.zeros(1, 2, 6, 6, 8), 3, 2)
    with pytest.raises(ValueError, match="differ"):
        dw_kernels.dw_temporal_dw(x, torch.zeros(1, 3, 6, 6, 8), 3)


# (n, h, w, c, k, stride) of dx: the flagship step's 6 shapes (batch 32 x 16
# frames), then ragged ones and tile edges.
FLAGSHIP_DX = [(512, 64, 64, 448, 3, 2), (512, 32, 32, 448, 3, 1), (512, 32, 32, 896, 3, 2),
               (512, 16, 16, 896, 3, 1), (512, 16, 16, 1792, 3, 2), (512, 8, 8, 1792, 3, 1)]
RAGGED_DX = [(6, h, w, c, k, s) for (h, w), c in (((9, 11), 24), ((10, 12), 24), ((33, 17), 24), ((7, 5), 24),
                                                  ((9, 11), 20), ((9, 11), 22), ((10, 12), 264))
             for k in (3, 5) for s in (1, 2)] + [(1, 1, 1, 8, 3, 1), (2, 70, 3, 16, 5, 2), (1, 200, 1, 8, 3, 1)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP_DX + RAGGED_DX, ids=str)
def test_dx_launch_geometry_fits_the_card_and_covers_dx_once(shape, itemsize):
    """What ``dw_spatial_dx`` passes to its kernel, on a card of 132 SMs:
    shared memory within the 232,448 bytes a block may use, a grid within
    CUDA's limits, at least 2 blocks per SM at the flagship shapes, a ring
    that holds every dy row a band reads while the next band's rows arrive,
    and tiles that write every dx element exactly once."""
    n, h, w, c, k, s = shape
    geo = dw_kernels.dx_launch_geometry(n, h, w, c, k, s, itemsize, sms=132)
    assert geo["smem_bytes"] <= 232_448
    gx, gy, gz = geo["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if shape in FLAGSHIP_DX:
        assert gx * gy * gz >= 2 * 132
    band, lo, hi = geo["band"], geo["lo"], geo["hi"]
    assert geo["ring"] >= band + lo + hi + (band if geo["bands_per_block"] > 1 else 0)
    rows, cols = (dw_kernels.spatial_out_size(size, k, s) for size in (h, w))  # row and column steps
    assert (rows, cols) == (-(-h // s), -(-w // s))
    # The (row group, channel tile, column tile) of every block of one frame,
    # as the kernel walks them: row steps [g * per_block, (g + 1) * per_block),
    # each step s dx rows.
    per_block = geo["bands_per_block"] * band
    assert gx == n * geo["groups"] and (geo["groups"] - 1) * per_block < rows <= geo["groups"] * per_block
    count = np.zeros((h, w, gy * 8), np.int32)
    for group in range(geo["groups"]):
        row_slice = slice(group * per_block * s, min((group + 1) * per_block, rows) * s)
        for z in range(gz):
            col_slice = slice(z * geo["col_tile"] * s, min((z + 1) * geo["col_tile"], cols) * s)
            for y in range(gy):
                count[row_slice, col_slice, y * 8:(y + 1) * 8] += 1
    assert (count[:, :, : -(-c // (16 // itemsize))] == 1).all()  # vectors past C in the last tile are masked


def test_dw_spatial_dx_plain_serves_any_odd_k_on_the_cpu():
    """The kernel is compiled for k = 3 and 5; on the CPU the plain version
    answers for any odd k (k = 7 here), as the JAX function does."""
    rng = np.random.default_rng(35)
    dy, w = torch.from_numpy(rand(rng, 1, 2, 6, 7, 8)), torch.from_numpy(rand(rng, 7, 7, 8))
    dx = dw_kernels.dw_spatial_dx(dy, w, 1, (6, 7))
    torch.testing.assert_close(dx, dw_kernels.dw_spatial_dx_plain(dy, w, 1, (6, 7)), rtol=0, atol=0)
    jdx, _ = jax_spatial_vjp(pallas_dw.dw_spatial, rand(rng, 1, 2, 6, 7, 8), w.numpy(), dy.numpy(), 1)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-4)


def test_backward_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises instead of taking the plain path."""
    x = torch.zeros(1, 2, 4, 4, 8, device="meta")
    w = torch.zeros(3, 3, 8, device="meta")
    for call in (lambda: dw_kernels.dw_spatial_dx(x, w, 1, (4, 4)),
                 lambda: dw_kernels.dw_spatial_dw(x, x, 3, 1),
                 lambda: dw_kernels.dw_temporal_dw(x, x, 3)):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            call()


# (n, h, w, c, k, stride) of dw_spatial_dw: the flagship step's 6 shapes, then
# the edges of its tiling: H and W that are not multiples of the bands and
# column tiles, frames wider or taller than one tile, a 1x1 frame, channel
# tails, C wider than one channel tile; last, many small frames, so that a
# block walks several.
FLAGSHIP_DW = FLAGSHIP_DX
EDGE_DW = ([(3, h, w, 24, k, s) for h, w in ((9, 11), (33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
           + [(3, h, w, c, 3, s) for h, w, c in ((2, 70, 24), (70, 3, 24), (1, 1, 24), (9, 11, 20), (9, 11, 22),
                                                 (10, 12, 264)) for s in (1, 2)])
WALK_DW = [(99, 7, 5, 24, 3, 1), (99, 4, 4, 22, 3, 2), (50, 1, 1, 8, 5, 1), (40, 6, 9, 16, 5, 2)]


def dw_blocks(geo: dict):
    """Every block as the kernel walks it: (slab, channel tile, column tile,
    and its (frame, first output row) items in order)."""
    gx, gy, gz = geo["grid"]
    bands, band, per_block = geo["bands"], geo["band"], geo["per_block"]
    for tz in range(gz):
        for bx in range(gx):
            items = range(bx * per_block, min((bx + 1) * per_block, geo["items"]))
            for ty in range(gy):
                yield bx + gx * tz, ty, tz, [(it // bands, it % bands * band) for it in items]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP_DW + EDGE_DW + WALK_DW, ids=str)
def test_dw_launch_geometry_fits_the_card_and_covers_dy_once(shape, itemsize):
    """What ``dw_spatial_dw`` passes to its kernel, on a card of 132 SMs:
    shared memory within the 232,448 bytes a block may use (and within half
    an SM's, less 1 KB per block, at the flagship shapes, for the 2 blocks an
    SM its registers are capped for), a grid within CUDA's limits that fills
    every SM in one wave of at most 2 blocks each at the flagship shapes, a
    ring that holds a band's x rows while the next bands' arrive, room for
    the lanes' partial sums, and runs of items that take every dy position
    exactly once."""
    n, h, w, c, k, s = shape
    geo = dw_kernels.dw_launch_geometry(n, h, w, c, k, s, itemsize, sms=132)
    assert geo["smem_bytes"] <= 232_448
    gx, gy, gz = geo["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if shape in FLAGSHIP_DW:
        assert geo["smem_bytes"] <= 233_472 // 2 - 1024
        assert 132 <= gx * gy * gz <= 2 * 132
    band, cols, vec = geo["band"], geo["cols"], 16 // itemsize
    oh, ow = (dw_kernels.spatial_out_size(size, k, s) for size in (h, w))
    assert cols in ((2, 4) if s == 1 else (2,)) and geo["col_tile"] % cols == 0
    frame_rows = s * (band - 1) + k
    assert geo["frame_rows"] == frame_rows and geo["ring"] >= frame_rows + max(s * band, frame_rows)
    assert geo["tile_cols"] == s * (geo["col_tile"] - 1) + k
    assert geo["tap_groups"] * geo["lanes"] <= 32 and k % geo["tap_groups"] == 0
    ring_bytes = (geo["ring"] * geo["tile_cols"] + 2 * band * geo["col_tile"]) * 8 * 16
    assert geo["smem_bytes"] == max(ring_bytes, geo["lanes"] * k * k * 8 * vec * 4)
    assert (gy - 1) * 8 < -(-c // vec) <= gy * 8  # vectors past C in the last channel tile are masked
    assert geo["slabs"] == gx * gz and (gx - 1) * geo["per_block"] < geo["items"] == n * geo["bands"]
    count = np.zeros((n, oh, ow), np.int32)
    for _, ty, tz, items in dw_blocks(geo):
        if ty > 0:
            continue
        for f, r0 in items:
            c0 = tz * geo["col_tile"]
            count[f, r0 : r0 + band, c0 : c0 + geo["col_tile"]] += 1
    assert (count == 1).all()


def emulate_dw_kernel(x: np.ndarray, dy: np.ndarray, k: int, stride: int, geo: dict, vec: int) -> np.ndarray:
    """``dw_spatial_dw_kernel``'s loops in numpy, then ``sum_slabs``: each
    block stages its run of items, x rows into a ring of
    ``geo["ring"]`` slots (row r0 + i of an item in slot (vfirst + i) %
    ring, vfirst growing by stride * band within a frame and by the band's
    rows at a new frame, which stages all of them) and dy rows into slot j %
    2, one item ahead; zeros outside x, dy and C. Every copy lands as soon as
    it is issued, so the next item's rows overwrite their slots before this
    item computes.
    Each lane of a tap-row group takes its units in turn and adds, per tap
    row, x[s*o + dj] * dy[o] over the unit's ``cols`` outputs; the block adds
    its lanes in order into its slab, and the slabs are added in order. Slots
    never staged hold NaN, so reading one shows."""
    n, h, wd, c = x.shape
    p, s = k // 2, stride
    oh, ow = dy.shape[1], dy.shape[2]
    cols, band, col_tile, ring_rows, tile_cols, frame_rows = (
        geo[key] for key in ("cols", "band", "col_tile", "ring", "tile_cols", "frame_rows"))
    groups, lanes = geo["tap_groups"], geo["lanes"]
    rows_per_group = k // groups
    chans = 8 * vec
    ws = np.full((geo["slabs"], k * k, c), np.nan, np.float32)
    for slab, ty, tz, items in dw_blocks(geo):
        ch0, col0 = ty * chans, tz * col_tile
        ring = np.full((ring_rows, tile_cols, chans), np.nan, np.float32)
        dy_slots = np.full((2, band, col_tile, chans), np.nan, np.float32)

        def stage(j, vfirst, fresh):
            f, s0 = items[j]
            r0 = s0 * s - p
            for r in range(r0 if fresh else r0 + frame_rows - s * band, r0 + frame_rows):
                for cc in range(tile_cols):
                    col = col0 * s - p + cc
                    tile = np.zeros(chans, np.float32)
                    if 0 <= r < h and 0 <= col < wd:
                        part = x[f, r, col, ch0 : ch0 + chans]
                        tile[: part.shape[0]] = part
                    ring[(vfirst + r - r0) % ring_rows, cc] = tile
            for rr in range(band):
                for cc in range(col_tile):
                    tile = np.zeros(chans, np.float32)
                    if s0 + rr < oh and col0 + cc < ow:
                        part = dy[f, s0 + rr, col0 + cc, ch0 : ch0 + chans]
                        tile[: part.shape[0]] = part
                    dy_slots[j % 2, rr, cc] = tile

        acc = np.zeros((lanes, k, k, chans), np.float32)  # per lane: every tap row of its groups
        step = [0] + [frame_rows if s0 == 0 else s * band for _, s0 in items[1:]]  # vfirst(j) - vfirst(j - 1)
        vfirsts = np.cumsum(step)
        stage(0, 0, True)
        units_per_row = col_tile // cols
        for j, (f, s0) in enumerate(items):
            vfirst = vfirsts[j]
            if j + 1 < len(items):
                stage(j + 1, vfirsts[j + 1], items[j + 1][1] == 0)
            for u in range(min(band, oh - s0) * units_per_row):
                rs, cu = divmod(u, units_per_row)
                if col0 + cu * cols >= ow:
                    continue
                lane = u % lanes
                for group in range(groups):
                    for di in range(group * rows_per_group, (group + 1) * rows_per_group):
                        row = ring[(vfirst + rs * s + di) % ring_rows, cu * cols * s :]
                        for o in range(cols):
                            d = dy_slots[j % 2, rs, cu * cols + o]
                            for dj in range(k):
                                acc[lane, di, dj] += row[s * o + dj] * d
        total = np.zeros((k, k, chans), np.float32)
        for lane in range(lanes):
            total += acc[lane]
        width = min(chans, c - ch0)
        ws[slab, :, ch0 : ch0 + width] = total.reshape(k * k, chans)[:, :width]
    out = np.zeros((k * k, c), np.float32)
    for slab in range(geo["slabs"]):
        out += ws[slab]
    return out.reshape(k, k, c)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGE_DW + WALK_DW, ids=str)
def test_dw_kernel_loops_emulated_match_the_plain_version(shape, itemsize, sms):
    """The kernel's runs of items, ring slots across bands and frames, dy
    slots, zero halo, register window, tap-row groups, channel tail, per-lane
    partials and the fixed-order slab sum, emulated in numpy from
    ``dw_launch_geometry``, give ``dw_spatial_dw_plain``. One SM makes each
    block walk many bands and frames; 132 SMs give most blocks one item."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(36)
    oh, ow = (dw_kernels.spatial_out_size(size, k, s) for size in (h, w))
    x, dy = rand(rng, n, h, w, c), rand(rng, n, oh, ow, c)
    geo = dw_kernels.dw_launch_geometry(n, h, w, c, k, s, itemsize, sms=sms)
    got = emulate_dw_kernel(x, dy, k, s, geo, 16 // itemsize)
    ref = dw_kernels.dw_spatial_dw_plain(torch.from_numpy(x)[None], torch.from_numpy(dy)[None], k, s).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_dw_spatial_dw_plain_serves_any_odd_k_on_the_cpu():
    """The kernel is compiled for k = 3 and 5; on the CPU the plain version
    answers for any odd k (k = 7 here), as the JAX function does."""
    rng = np.random.default_rng(37)
    x, w, dy = rand(rng, 1, 2, 6, 7, 8), rand(rng, 7, 7, 8), rand(rng, 1, 2, 6, 7, 8)
    dw = dw_kernels.dw_spatial_dw(torch.from_numpy(x), torch.from_numpy(dy), 7, 1)
    torch.testing.assert_close(dw, dw_kernels.dw_spatial_dw_plain(torch.from_numpy(x), torch.from_numpy(dy), 7, 1),
                               rtol=0, atol=0)
    _, jdw = jax_spatial_vjp(pallas_dw.dw_spatial, x, w, dy, 1)
    np.testing.assert_allclose(dw.numpy(), jdw, atol=1e-4)
