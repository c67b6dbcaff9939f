"""The port's fused BN-apply + SiLU + depthwise conv (row 7 of the kernel
table) against ``sensorium_tpu.ops.pallas_fused.fused_bn_silu_dw_spatial``,
which runs here in interpret mode, and the port's ``dwbench`` on the CPU.

The inputs are those of ``tests/test_pallas_fused.py`` (seeded numpy, fp32),
held at its tolerance, rtol/atol 1e-5. The port's plain version follows the
kernel (an fp32 prologue, never rounded), so it is compared with the Pallas
kernel itself and not with the eager chain.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sensorium_tpu.ops.pallas_fused as jfused
from sensorium_tpu_torch.ops import dw_kernels
from sensorium_tpu_torch.tools import dwbench


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfused, "INTERPRET", True)


def jax_fused(x, scale, shift, kernel, stride):
    return np.asarray(jfused.fused_bn_silu_dw_spatial(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(kernel), stride))


def port_both(x, scale, shift, kernel, stride):
    """The plain version and the wrapper on CPU tensors (which must be the plain version)."""
    args = [torch.from_numpy(a) for a in (x, scale, shift, kernel)]
    before = dict(dw_kernels.LAUNCHES)
    plain = dw_kernels.fused_bn_silu_dw_spatial_plain(*args, stride).numpy()
    wrapped = dw_kernels.fused_bn_silu_dw_spatial(*args, stride).numpy()
    assert dw_kernels.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_array_equal(wrapped, plain)
    return plain


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 16), (1, 2, 9, 7, 8)])
def test_plain_matches_pallas(stride, shape):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.normal(1, 0.2, (c,)).astype(np.float32)
    shift = rng.normal(0, 0.2, (c,)).astype(np.float32)
    kernel = rng.normal(0, 0.5, (3, 3, c)).astype(np.float32)
    want = jax_fused(x, scale, shift, kernel, stride)
    got = port_both(x, scale, shift, kernel, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_padding_is_zero_after_the_prologue(stride):
    """silu(0 * 2 + 3) != 0: a border that padded x instead of the activation would differ."""
    rng = np.random.default_rng(1)
    c = 8
    x = rng.normal(0, 1, (1, 1, 5, 5, c)).astype(np.float32)
    scale = np.full((c,), 2.0, np.float32)
    shift = np.full((c,), 3.0, np.float32)
    kernel = rng.normal(0, 0.5, (3, 3, c)).astype(np.float32)
    got = port_both(x, scale, shift, kernel, stride)
    np.testing.assert_allclose(got, jax_fused(x, scale, shift, kernel, stride), rtol=1e-5, atol=1e-5)
    # The constant activation silu(3) everywhere: a corner sums 4 of the 9 taps.
    flat = np.full_like(x, 0.0)
    corner = port_both(flat, scale, shift, kernel, 1)[0, 0, 0, 0]
    act = 3.0 / (1.0 + np.exp(-3.0))
    np.testing.assert_allclose(corner, act * kernel[1:, 1:].sum(axis=(0, 1)), rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_dead_channels(stride):
    """Half the channels have scale == 0 and shift != 0 (a dead BN)."""
    rng = np.random.default_rng(2)
    c = 8
    x = rng.normal(0, 1, (1, 2, 6, 7, c)).astype(np.float32)
    scale = np.zeros((c,), np.float32)
    scale[: c // 2] = 1.5
    shift = np.full((c,), 1.0, np.float32)
    kernel = rng.normal(0, 0.5, (3, 3, c)).astype(np.float32)
    got = port_both(x, scale, shift, kernel, stride)
    np.testing.assert_allclose(got, jax_fused(x, scale, shift, kernel, stride), rtol=1e-5, atol=1e-5)


def test_bf16_rounds_once_at_the_output():
    """bf16 x: the plain version is the fp32 computation on the same bf16
    inputs, rounded once to bf16 (the chain that rounds the activation first
    is not)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 2, 7, 9, 8)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.normal(1, 0.2, 8).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.2, 8).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.5, (3, 3, 8)).astype(np.float32)).to(torch.bfloat16)
    got = dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2, 4, 5, 8)
    want = dw_kernels.fused_bn_silu_dw_spatial_plain(x.float(), scale, shift, w.float(), 2).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_wrapper_refuses_bad_operands():
    x = torch.zeros(1, 2, 4, 4, 8)
    w = torch.zeros(3, 3, 8)
    with pytest.raises(ValueError, match="scale and shift"):
        dw_kernels.fused_bn_silu_dw_spatial(x, torch.zeros(4), torch.zeros(8), w)
    with pytest.raises(NotImplementedError, match="stride 3"):
        dw_kernels.fused_bn_silu_dw_spatial(x, torch.zeros(8), torch.zeros(8), w, 3)


def test_dwbench_runs_every_impl_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(dwbench, "SHAPES", [("tiny-s2", (1, 2, 9, 7, 8, 2)), ("tiny-s1", (2, 1, 6, 6, 16, 1))])
    monkeypatch.setattr(dwbench, "TEMPORAL_SHAPES", [("t-tiny", (1, 6, 4, 4, 8))])
    assert dwbench.main(["--device", "cpu", "--iters", "1"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["shape"], r["impl"]) for r in records] == [("t-tiny", "chain"), ("t-tiny", "pallas")] + [
        (name, impl) for name in ("tiny-s2", "tiny-s1") for impl in dwbench.SPATIAL_IMPLS
    ]
    assert all(r["ms"] >= 0 and r["device"] == "cpu" for r in records)
    fused = [r for r in records if r["impl"] == "fused"]
    assert all(r["within_one_rounding_of_pallas"] for r in fused)


def test_dwbench_impls_agree_and_a_failure_exits_non_zero(monkeypatch, capsys):
    """Every spatial impl computes the same function (fp32 inputs: within
    summation order); an impl that raises is reported and fails the run."""
    inputs = dwbench.make_inputs(torch.Generator().manual_seed(0), (1, 2, 9, 7, 8), (3, 3, 8), torch.float32, "cpu")
    outs = {name: fn(*inputs, stride=2) for name, fn in dwbench.SPATIAL_IMPLS.items()}
    for name, out in outs.items():
        torch.testing.assert_close(out, outs["fused"], rtol=1e-5, atol=1e-5, msg=name)

    def broken(*args, **kwargs):
        raise RuntimeError("no such lowering")

    monkeypatch.setattr(dwbench, "SHAPES", [("tiny", (1, 1, 4, 4, 8, 1))])
    monkeypatch.setattr(dwbench, "TEMPORAL_SHAPES", [])
    monkeypatch.setitem(dwbench.SPATIAL_IMPLS, "chain2d", broken)
    assert dwbench.main(["--device", "cpu", "--iters", "1"]) == 1
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r for r in records if "error" in r] == [{"shape": "tiny", "impl": "chain2d", "device": "cpu",
                                                     "error": "RuntimeError: no such lowering"}]
