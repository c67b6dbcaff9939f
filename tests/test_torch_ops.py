"""The port's ops (sensorium_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both. The JAX depthwise
convs run as the JAX tests run them: the Pallas kernels in interpret mode,
and the default XLA lowering. The port's CUDA kernels run only on a card
(``tests/test_torch_cuda.py``); here their wrappers compute the plain
versions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sensorium_tpu.ops import conv as jconv
from sensorium_tpu.ops import pallas_dw
from sensorium_tpu.ops.norm import BatchNorm as JaxBatchNorm
from sensorium_tpu.ops.pe import position_encoding_3d as jax_pe
from sensorium_tpu.ops.shuffle import channel_shuffle as jax_shuffle
from sensorium_tpu_torch.ops import _build, dw_kernels
from sensorium_tpu_torch.ops.conv import (
    depthwise_conv_spatial,
    depthwise_conv_temporal,
    einsum_f32,
    grouped_pointwise,
    pointwise,
)
from sensorium_tpu_torch.ops.norm import BatchNorm
from sensorium_tpu_torch.ops.pe import position_encoding_3d
from sensorium_tpu_torch.ops.shuffle import channel_shuffle

# One bf16 ulp of relative error: bf16 keeps 8 significant bits, so a value
# rounded once from fp32 is within 2**-8 of it relative to its magnitude.
BF16_RTOL = 2.0**-8


@pytest.fixture(autouse=True)
def jax_dw_paths(monkeypatch):
    monkeypatch.setattr(pallas_dw, "INTERPRET", True)
    monkeypatch.setenv("SENSORIUM_DW_IMPL", "xla")  # jconv stays on XLA


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ depthwise convs


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("hw", [(8, 8), (9, 11)])
@pytest.mark.parametrize("stride", [1, 2])
def test_dw_spatial_plain_matches_jax(stride, hw, k):
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 3, *hw, 8)
    w = rand(rng, k, k, 8)
    got = dw_kernels.dw_spatial_plain(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    pallas = np.asarray(pallas_dw.dw_spatial(jnp.asarray(x), jnp.asarray(w), stride))
    xla = np.asarray(jconv.depthwise_conv_spatial(jnp.asarray(x), jnp.asarray(w), stride))
    assert got.shape == pallas.shape == xla.shape
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)


@pytest.mark.parametrize("k", [3, 5])
def test_dw_temporal_plain_matches_jax(k):
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 6, 4, 5, 8)
    w = rand(rng, k, 8)
    got = dw_kernels.dw_temporal_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    pallas = np.asarray(pallas_dw.dw_temporal(jnp.asarray(x), jnp.asarray(w)))
    xla = np.asarray(jconv.depthwise_conv_temporal(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, xla, atol=1e-5)


def test_dw_temporal_refuses_even_k_like_pallas():
    rng = np.random.default_rng(3)
    x = rand(rng, 1, 6, 2, 2, 4)
    w = rand(rng, 4, 4)
    with pytest.raises(NotImplementedError, match="odd"):
        pallas_dw.dw_temporal(jnp.asarray(x), jnp.asarray(w))
    for fn in (dw_kernels.dw_temporal_plain, dw_kernels.dw_temporal_fwd):
        with pytest.raises(NotImplementedError, match="odd"):
            fn(torch.from_numpy(x), torch.from_numpy(w))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_dispatch_matches_jax_and_casts_weights(stride):
    """ops.conv casts the weights to x's dtype and reaches the kernel wrappers."""
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 5, 9, 11, 8)
    ws, wt = rand(rng, 3, 3, 8), rand(rng, 5, 8)
    before = dict(dw_kernels.LAUNCHES)
    got_s = depthwise_conv_spatial(torch.from_numpy(x), torch.from_numpy(ws), stride)
    got_t = depthwise_conv_temporal(torch.from_numpy(x), torch.from_numpy(wt))
    # The CPU path computes the plain versions: no kernel launch is counted.
    assert dw_kernels.LAUNCHES == before
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(jconv.depthwise_conv_spatial(jnp.asarray(x), jnp.asarray(ws), stride)), atol=1e-5
    )
    np.testing.assert_allclose(
        got_t.numpy(), np.asarray(jconv.depthwise_conv_temporal(jnp.asarray(x), jnp.asarray(wt))), atol=1e-5
    )
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert depthwise_conv_spatial(xb, torch.from_numpy(ws), stride).dtype == torch.bfloat16
    assert depthwise_conv_temporal(xb, torch.from_numpy(wt)).dtype == torch.bfloat16


@pytest.mark.parametrize("stride", [1, 2])
def test_dw_plain_bf16_rounds_once_from_fp32(stride):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rand(rng, 2, 4, 9, 11, 16)).to(torch.bfloat16)
    ws = torch.from_numpy(rand(rng, 3, 3, 16)).to(torch.bfloat16)
    wt = torch.from_numpy(rand(rng, 5, 16)).to(torch.bfloat16)
    pairs = [
        (dw_kernels.dw_spatial_plain(x, ws, stride), dw_kernels.dw_spatial_plain(x.float(), ws.float(), stride)),
        (dw_kernels.dw_temporal_plain(x, wt), dw_kernels.dw_temporal_plain(x.float(), wt.float())),
    ]
    for low, ref in pairs:
        assert low.dtype == torch.bfloat16
        torch.testing.assert_close(low.float(), ref, rtol=BF16_RTOL, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 2, 4, 4, 8)
    with pytest.raises(ValueError, match="k, k, C"):
        dw_kernels.dw_spatial_fwd(x, torch.zeros(3, 3, 7))
    with pytest.raises(NotImplementedError, match="stride"):
        dw_kernels.dw_spatial_fwd(x, torch.zeros(3, 3, 8), stride=3)
    with pytest.raises(ValueError, match="B, T, H, W, C"):
        dw_kernels.dw_temporal_fwd(x[0], torch.zeros(3, 8))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises instead of taking the plain path."""
    x = torch.zeros(1, 2, 4, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dw_kernels.dw_spatial_fwd(x, torch.zeros(3, 3, 8, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dw_kernels.dw_temporal_fwd(x, torch.zeros(5, 8, device="meta"))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "")
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/bin/false")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build_all(["dw_conv"])
    assert not list(tmp_path.iterdir())


def test_library_name_follows_the_source():
    path = _build.library_path("dw_conv")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("dw_conv-")
    assert path == _build.library_path("dw_conv")


# ------------------------------------------------------- products, norm, misc


def test_pointwise_matches_jax():
    rng = np.random.default_rng(6)
    x, w = rand(rng, 2, 3, 4, 4, 5), rand(rng, 5, 7)
    got = pointwise(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jconv.pointwise(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)


def test_grouped_pointwise_matches_jax():
    rng = np.random.default_rng(7)
    x, w = rand(rng, 2, 3, 12), rand(rng, 2, 6, 5)
    got = grouped_pointwise(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    expected = np.asarray(jconv.grouped_pointwise(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == (2, 3, 10)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


def test_einsum_f32_matches_jax_from_bf16_operands():
    rng = np.random.default_rng(8)
    x, w = rand(rng, 2, 3, 2, 6), rand(rng, 2, 6, 4)
    xb, wb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    got = einsum_f32("btgc,gcp->btgp", xb, wb)
    assert got.dtype == torch.float32
    expected = jconv.einsum_f32(
        "btgc,gcp->btgp", jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    )
    assert expected.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(6, 4, 5, 5), (64, 2, 3, 4), (7, 3, 1, 2)])
def test_position_encoding_matches_jax(shape):
    np.testing.assert_array_equal(position_encoding_3d(*shape), jax_pe(*shape))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_channel_shuffle_matches_jax(groups):
    x = rand(np.random.default_rng(9), 2, 3, 8)
    got = channel_shuffle(torch.from_numpy(x), groups).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_shuffle(jnp.asarray(x), groups)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_eval_matches_jax(dtype):
    """fp32 against the JAX module; bf16 against the JAX module's fp32 result on
    the same bf16 inputs, within the one rounding to bf16 at the end."""
    rng = np.random.default_rng(10)
    c = 6
    x = torch.from_numpy(rand(rng, 2, 3, 4, c) * 3 + 1).to(dtype)
    scale, bias, mean = rand(rng, c), rand(rng, c), rand(rng, c)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    expected = JaxBatchNorm(c, dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x.float().numpy()),
        False,
    )
    bn = BatchNorm(c, dtype=dtype).eval()
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in dict(scale=scale, bias=bias, mean=mean, var=var).items()})
    with torch.no_grad():
        got = bn(x)
    assert got.dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), torch.from_numpy(np.array(expected)), rtol=rtol, atol=1e-6)
