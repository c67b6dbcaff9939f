"""The port's CUDA kernels against their plain versions, and the port on the
card against the port on the CPU.

This file imports no JAX, so that it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX). Without
a card every test skips. fp32 runs with TF32 off; bf16 is held to the plain
version computed in fp32 from the same bf16 inputs, within one rounding to
bf16 (rtol 2**-8).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine.model import MouseModel
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.ops import bn_kernels, dw_kernels

BF16_RTOL = 2.0**-8

TINY = {
    "readout_outputs": [5, 7],
    "core_features": (8, 16),
    "spatial_strides": (2, 1),
    "spatial_kernel": 3,
    "temporal_kernel": 5,
    "expansion_ratio": 2,
    "se_reduce_ratio": 4,
    "cortex_features": (16, 32),
    "groups": 2,
    "dtype": "float32",
    "readout_pad_multiple": 8,
}
ARGUS = {
    "frame_stack": {"size": 4, "step": 2, "position": "last"},
    "inputs_processor": ("stack_inputs", {"size": (16, 16), "pad_fill_value": 0.0}),
    "responses_processor": ("identity", {}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rand(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_kernels_match_plain(cuda, k, stride, dtype):
    rng = np.random.default_rng(11)
    x = rand(rng, 2, 4, 9, 11, 24).to(cuda, dtype)
    ws = (rand(rng, k, k, 24) / k).to(cuda, dtype)
    wt = (rand(rng, k, 24) / k**0.5).to(cuda, dtype)
    before = dict(dw_kernels.LAUNCHES)
    got_s = dw_kernels.dw_spatial_fwd(x, ws, stride)
    got_t = dw_kernels.dw_temporal_fwd(x, wt)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["dw_spatial_fwd"] == before["dw_spatial_fwd"] + 1
    assert dw_kernels.LAUNCHES["dw_temporal_fwd"] == before["dw_temporal_fwd"] + 1
    ref_s = dw_kernels.dw_spatial_plain(x.float(), ws.float(), stride)
    ref_t = dw_kernels.dw_temporal_plain(x.float(), wt.float())
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got_s.float(), ref_s, rtol=rtol, atol=1e-5)
    torch.testing.assert_close(got_t.float(), ref_t, rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hw, c, k, stride",
    [(hw, 24, k, s) for hw in ((33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
    + [(hw, c, 3, s) for hw, c in (((2, 70), 24), ((70, 3), 24), ((1, 1), 24), ((9, 11), 20), ((9, 11), 22),
                                   ((10, 12), 264)) for s in (1, 2)],
)
def test_fwd_kernel_matches_plain_at_tile_edges(cuda, hw, c, k, stride, dtype):
    """The edges of dw_spatial_fwd's tiling: H and W that are not multiples of
    its bands and column tiles, frames wider or taller than one tile, a 1x1
    frame, a channel tail (c=20 in bf16, c=22 in both: element-by-element
    copies), k = 5 at both strides, and C wider than one tile of 8 channel
    vectors (c=264). Held as test_kernels_match_plain holds the forward."""
    rng = np.random.default_rng(20)
    x = rand(rng, 2, 3, *hw, c).to(cuda, dtype)
    w = (rand(rng, k, k, c) / k).to(cuda, dtype)
    before = dw_kernels.LAUNCHES["dw_spatial_fwd"]
    y = dw_kernels.dw_spatial_fwd(x, w, stride)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["dw_spatial_fwd"] == before + 1
    assert y.dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), dw_kernels.dw_spatial_plain(x.float(), w.float(), stride),
                               rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, c, k, stride", [((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)])
def test_fwd_kernel_matches_plain_when_blocks_walk_frames(cuda, hw, c, k, stride, dtype):
    """8192 small frames: each block walks several, staging the next frame
    while it computes this one (the last block walks fewer when the count
    does not divide). Held as test_kernels_match_plain holds the forward."""
    rng = np.random.default_rng(23)
    x = rand(rng, 64, 128, *hw, c).to(cuda, dtype)
    w = (rand(rng, k, k, c) / k).to(cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dw_kernels.fwd_launch_geometry(64 * 128, *hw, c, k, stride, x.element_size(), sms)["frames"] > 1
    y = dw_kernels.dw_spatial_fwd(x, w, stride)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), dw_kernels.dw_spatial_plain(x.float(), w.float(), stride),
                               rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_fwd_kernel_is_the_same_from_run_to_run(cuda, stride):
    """At a flagship width (448 channels, a 32x32 frame of block 1 or 64x64 of
    block 0), three reruns are bitwise equal: one pass, no atomics."""
    rng = np.random.default_rng(21)
    h = 32 * stride
    x = rand(rng, 2, 8, h, h, 448).to(cuda, torch.bfloat16)
    w = (rand(rng, 3, 3, 448) / 3).to(cuda, torch.bfloat16)
    first = dw_kernels.dw_spatial_fwd(x, w, stride)
    assert all(torch.equal(first, dw_kernels.dw_spatial_fwd(x, w, stride)) for _ in range(3))


@pytest.mark.cuda
def test_fwd_kernel_refuses_other_kernel_sizes_on_the_card(cuda):
    """k = 7 is not compiled: the wrapper raises before launching on the card,
    while the CPU path still answers through the plain version."""
    rng = np.random.default_rng(22)
    x, w = rand(rng, 1, 2, 9, 8, 8), rand(rng, 7, 7, 8)
    before = dw_kernels.LAUNCHES["dw_spatial_fwd"]
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_spatial_fwd(x.to(cuda), w.to(cuda), 1)
    assert dw_kernels.LAUNCHES["dw_spatial_fwd"] == before
    assert dw_kernels.dw_spatial_fwd(x, w, 1).shape == (1, 2, 9, 8, 8)


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands_on_the_card(cuda):
    x = torch.zeros(1, 2, 4, 4, 8, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dw_kernels.dw_spatial_fwd(x, torch.zeros(3, 3, 8, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        dw_kernels.dw_temporal_fwd(x.transpose(2, 3), torch.zeros(3, 8, device=cuda))
    with pytest.raises(RuntimeError, match="w on cpu"):
        dw_kernels.dw_spatial_fwd(x, torch.zeros(3, 3, 8))


@pytest.mark.cuda
def test_predictor_on_the_card_matches_the_cpu(cuda):
    """A tiny fp32 model: the card (kernels, cuBLAS, index_add_) against the CPU."""
    rng = np.random.default_rng(0)
    video = rng.uniform(0, 255, (12, 14, 40)).astype(np.float32)
    behavior = rng.uniform(0, 5, (2, 40)).astype(np.float32)
    pupil = rng.uniform(0, 50, (2, 40)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        model = get_nn_module("dwiseneuro", TINY, device=device, generator=torch.Generator().manual_seed(3))
        out[device] = Predictor.from_module(model, ARGUS, chunk_size=8, device=device).predict_trial(video, behavior, pupil, 1)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_predictor_over_every_card_matches_one_card(cuda, tmp_path):
    """``Predictor(mesh=create_mesh())``: a replica on each visible card, the
    kernels launched on each replica's card, the chunk's windows split over
    them; the one-card trial within fp32 rounding."""
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more")
    model = MouseModel({**ARGUS, "nn_module": ("dwiseneuro", TINY)}, device="cuda")
    model.build_state(seed=0, learning_rate=0.0)
    model.save(tmp_path / "model-000-0.100000.ckpt")
    rng = np.random.default_rng(21)
    trial = (rng.uniform(0, 255, (12, 14, 40)).astype(np.float32), rng.uniform(0, 5, (2, 40)).astype(np.float32),
             rng.uniform(0, 50, (2, 40)).astype(np.float32))
    mesh = mesh_lib.create_mesh()
    chunk = 4 * mesh_lib.data_extent(mesh)
    one = Predictor(tmp_path / "model-000-0.100000.ckpt", chunk_size=chunk, device="cuda")
    every = Predictor(tmp_path / "model-000-0.100000.ckpt", chunk_size=chunk, mesh=mesh)
    assert [device.index for _, device in every.replicas] == list(range(torch.cuda.device_count()))
    np.testing.assert_allclose(every.predict_trial(*trial, 1), one.predict_trial(*trial, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("hw", [(9, 11), (10, 12)])
def test_backward_kernels_match_plain(cuda, hw, k, stride, dtype):
    """dx within one bf16 rounding (fp32: atol 1e-5) of the plain version in
    fp32; dw within 1e-5 of its largest value (+1e-5) of the plain version in
    float64 from the same inputs."""
    rng = np.random.default_rng(12)
    x = rand(rng, 2, 3, *hw, 24).to(cuda, dtype)
    w = (rand(rng, k, k, 24) / k).to(cuda, dtype)
    oh, ow = (dw_kernels.spatial_out_size(s, k, stride) for s in hw)
    dy = rand(rng, 2, 3, oh, ow, 24).to(cuda, dtype)
    dyt = rand(rng, 2, 3, *hw, 24).to(cuda, dtype)
    before = dict(dw_kernels.LAUNCHES)
    dx = dw_kernels.dw_spatial_dx(dy, w, stride, hw)
    dw = dw_kernels.dw_spatial_dw(x, dy, k, stride)
    dwt = dw_kernels.dw_temporal_dw(x, dyt, k)
    torch.cuda.synchronize()
    for name in ("dw_spatial_dx", "dw_spatial_dw", "dw_temporal_dw"):
        assert dw_kernels.LAUNCHES[name] == before[name] + 1, name
    assert dx.dtype == dtype and dw.dtype == dwt.dtype == torch.float32
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(dx.float(), dw_kernels.dw_spatial_dx_plain(dy.float(), w.float(), stride, hw),
                               rtol=rtol, atol=1e-5)
    for got, ref in ((dw, dw_kernels.dw_spatial_dw_plain(x.double(), dy.double(), k, stride)),
                     (dwt, dw_kernels.dw_temporal_dw_plain(x.double(), dyt.double(), k))):
        bound = 1e-5 * ref.abs().max().item() + 1e-5
        assert (got.double() - ref).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hw, c, k, stride",
    [(hw, 24, k, s) for hw in ((33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
    + [((9, 11), c, 3, s) for c in (20, 22) for s in (1, 2)]
    + [((10, 12), 264, 3, s) for s in (1, 2)],
)
def test_dx_kernel_matches_plain_at_tile_edges(cuda, hw, c, k, stride, dtype):
    """The edges of dw_spatial_dx's tiling: H and W that are not multiples of
    its bands and micro-tiles, a channel tail (c=20 in bf16, c=22 in both:
    element-by-element copies), k = 5 at both strides, and C wider than one
    tile of 8 channel vectors (c=264). Held as test_backward_kernels_match_plain
    holds dx."""
    rng = np.random.default_rng(17)
    w = (rand(rng, k, k, c) / k).to(cuda, dtype)
    oh, ow = (dw_kernels.spatial_out_size(s, k, stride) for s in hw)
    dy = rand(rng, 2, 3, oh, ow, c).to(cuda, dtype)
    before = dw_kernels.LAUNCHES["dw_spatial_dx"]
    dx = dw_kernels.dw_spatial_dx(dy, w, stride, hw)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["dw_spatial_dx"] == before + 1
    assert dx.dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(dx.float(), dw_kernels.dw_spatial_dx_plain(dy.float(), w.float(), stride, hw),
                               rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dx_kernel_is_the_same_from_run_to_run(cuda, stride):
    """At a flagship width (448 channels, a 32x32 dx of block 1 or 64x64 of
    block 0), three reruns are bitwise equal: one pass, no atomics."""
    rng = np.random.default_rng(18)
    h = 32 * stride
    oh = dw_kernels.spatial_out_size(h, 3, stride)
    dy = rand(rng, 2, 8, oh, oh, 448).to(cuda, torch.bfloat16)
    w = (rand(rng, 3, 3, 448) / 3).to(cuda, torch.bfloat16)
    first = dw_kernels.dw_spatial_dx(dy, w, stride, (h, h))
    assert all(torch.equal(first, dw_kernels.dw_spatial_dx(dy, w, stride, (h, h))) for _ in range(3))


@pytest.mark.cuda
def test_dx_kernel_refuses_other_kernel_sizes_on_the_card(cuda):
    """k = 7 is not compiled: the wrapper raises before launching on the card,
    while the CPU path still answers through the plain version."""
    rng = np.random.default_rng(19)
    dy, w = rand(rng, 1, 2, 6, 7, 8), rand(rng, 7, 7, 8)
    before = dw_kernels.LAUNCHES["dw_spatial_dx"]
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_spatial_dx(dy.to(cuda), w.to(cuda), 1, (6, 7))
    assert dw_kernels.LAUNCHES["dw_spatial_dx"] == before
    assert dw_kernels.dw_spatial_dx(dy, w, 1, (6, 7)).shape == (1, 2, 6, 7, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hw, c, k, stride",
    [(hw, 24, k, s) for hw in ((33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
    + [(hw, c, 3, s) for hw, c in (((2, 70), 24), ((70, 3), 24), ((1, 1), 24), ((9, 11), 20), ((9, 11), 22),
                                   ((10, 12), 264)) for s in (1, 2)],
)
def test_dw_kernel_matches_plain_at_tile_edges(cuda, hw, c, k, stride, dtype):
    """The edges of dw_spatial_dw's tiling: H and W that are not multiples of
    its bands and column tiles, frames wider or taller than one tile, a 1x1
    frame, a channel tail (c=20 in bf16, c=22 in both: element-by-element
    copies), k = 5 at both strides (tap-row groups), and C wider than one tile
    of 8 channel vectors (c=264). Held as test_backward_kernels_match_plain
    holds dw."""
    rng = np.random.default_rng(24)
    x = rand(rng, 2, 3, *hw, c).to(cuda, dtype)
    oh, ow = (dw_kernels.spatial_out_size(s, k, stride) for s in hw)
    dy = rand(rng, 2, 3, oh, ow, c).to(cuda, dtype)
    before = dw_kernels.LAUNCHES["dw_spatial_dw"]
    dw = dw_kernels.dw_spatial_dw(x, dy, k, stride)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["dw_spatial_dw"] == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (k, k, c)
    ref = dw_kernels.dw_spatial_dw_plain(x.double(), dy.double(), k, stride)
    assert (dw.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, c, k, stride", [((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)])
def test_dw_kernel_matches_plain_when_blocks_walk_frames(cuda, hw, c, k, stride, dtype):
    """8192 small frames: each block walks a run of many frames, staging the
    next one while it computes this one (the last run is shorter when the
    count does not divide). Held as test_backward_kernels_match_plain holds dw."""
    rng = np.random.default_rng(25)
    x = rand(rng, 64, 128, *hw, c).to(cuda, dtype)
    oh, ow = (dw_kernels.spatial_out_size(s, k, stride) for s in hw)
    dy = rand(rng, 64, 128, oh, ow, c).to(cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    geo = dw_kernels.dw_launch_geometry(64 * 128, *hw, c, k, stride, x.element_size(), sms)
    assert geo["per_block"] > geo["bands"]
    dw = dw_kernels.dw_spatial_dw(x, dy, k, stride)
    ref = dw_kernels.dw_spatial_dw_plain(x.double(), dy.double(), k, stride)
    assert (dw.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dw_kernel_is_the_same_from_run_to_run(cuda, stride):
    """At a flagship width (448 channels, a 32x32 frame of block 1 or 64x64 of
    block 0), three reruns are bitwise equal: fixed-order sums, no atomics."""
    rng = np.random.default_rng(26)
    h = 32 * stride
    oh = dw_kernels.spatial_out_size(h, 3, stride)
    x = rand(rng, 2, 8, h, h, 448).to(cuda, torch.bfloat16)
    dy = rand(rng, 2, 8, oh, oh, 448).to(cuda, torch.bfloat16)
    first = dw_kernels.dw_spatial_dw(x, dy, 3, stride)
    assert all(torch.equal(first, dw_kernels.dw_spatial_dw(x, dy, 3, stride)) for _ in range(3))


@pytest.mark.cuda
def test_dw_kernel_refuses_other_kernel_sizes_on_the_card(cuda):
    """k = 7 is not compiled: the wrapper raises before launching on the card,
    while the CPU path still answers through the plain version."""
    rng = np.random.default_rng(27)
    x, dy = rand(rng, 1, 2, 6, 7, 8), rand(rng, 1, 2, 6, 7, 8)
    before = dw_kernels.LAUNCHES["dw_spatial_dw"]
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_spatial_dw(x.to(cuda), dy.to(cuda), 7, 1)
    assert dw_kernels.LAUNCHES["dw_spatial_dw"] == before
    assert dw_kernels.dw_spatial_dw(x, dy, 7, 1).shape == (7, 7, 8)


@pytest.mark.cuda
def test_weight_gradients_are_the_same_from_run_to_run(cuda):
    rng = np.random.default_rng(13)
    x = rand(rng, 4, 8, 32, 32, 64).to(cuda, torch.bfloat16)
    dy = rand(rng, 4, 8, 16, 16, 64).to(cuda, torch.bfloat16)
    first = dw_kernels.dw_spatial_dw(x, dy, 3, 2)
    assert all(torch.equal(first, dw_kernels.dw_spatial_dw(x, dy, 3, 2)) for _ in range(3))


def assert_dw_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    """A weight gradient within 1e-5 of its largest value (+1e-5) of the plain
    version in float64."""
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item() + 1e-5


def check_temporal_kernels(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> None:
    """dw_temporal_fwd (held as test_kernels_match_plain holds it) and
    dw_temporal_dw (held as test_backward_kernels_match_plain holds dw), one
    launch each."""
    k = w.shape[0]
    before = dict(dw_kernels.LAUNCHES)
    y = dw_kernels.dw_temporal_fwd(x, w)
    dw = dw_kernels.dw_temporal_dw(x, dy, k)
    torch.cuda.synchronize()
    for name in ("dw_temporal_fwd", "dw_temporal_dw"):
        assert dw_kernels.LAUNCHES[name] == before[name] + 1, name
    assert y.dtype == x.dtype and y.shape == x.shape
    rtol = BF16_RTOL if x.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), dw_kernels.dw_temporal_plain(x.float(), w.float()), rtol=rtol, atol=1e-5)
    assert_dw_close(dw, dw_kernels.dw_temporal_dw_plain(x.double(), dy.double(), k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, c", [(32, 448), (16, 896), (8, 1792)])
def test_temporal_kernels_match_plain_at_flagship_shapes(cuda, hw, c, dtype):
    """The temporal convs of the 9 blocks of a flagship step (32 x 16 frames, k = 5)."""
    rng = np.random.default_rng(40)
    x = rand(rng, 32, 16, hw, hw, c).to(cuda, dtype)
    dy = rand(rng, 32, 16, hw, hw, c).to(cuda, dtype)
    w = (rand(rng, 5, c) / 5**0.5).to(cuda, dtype)
    check_temporal_kernels(x, w, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("t, c", [(1, 24), (2, 24), (37, 24), (7, 20), (7, 22), (7, 264)])
def test_temporal_kernels_match_plain_at_walk_edges(cuda, t, c, k, dtype):
    """The edges of the column walk: T below k (1, 2), T not a multiple of the
    frame tile (37), channel tails (c=20 in bf16, c=22 in both: element by
    element) and C wider than dw's tile of 8 channel vectors (c=264)."""
    rng = np.random.default_rng(41)
    x = rand(rng, 2, t, 9, 11, c).to(cuda, dtype)
    dy = rand(rng, 2, t, 9, 11, c).to(cuda, dtype)
    w = (rand(rng, k, c) / k**0.5).to(cuda, dtype)
    check_temporal_kernels(x, w, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temporal_kernels_take_unaligned_pointers(cuda, dtype):
    """Contiguous operands whose storage starts one element past a 16-byte
    boundary: the kernels load and store element by element."""
    rng = np.random.default_rng(42)
    shape = (2, 7, 5, 6, 32)

    def unaligned(values: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(values.numel() + 1, device=cuda, dtype=dtype)
        out = buf[1:].view(values.shape)
        out.copy_(values)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    x = unaligned(rand(rng, *shape).to(cuda, dtype))
    dy = unaligned(rand(rng, *shape).to(cuda, dtype))
    w = unaligned((rand(rng, 5, 32) / 5**0.5).to(cuda, dtype))
    check_temporal_kernels(x, w, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
def test_temporal_function_backward_matches_plain(cuda, k, dtype):
    """DwTemporal.backward: dx is the forward kernel with the taps reversed,
    held as the forward is against the plain version of the same; dw its own
    kernel. One launch of each."""
    rng = np.random.default_rng(43)
    x = rand(rng, 2, 37, 6, 7, 24).to(cuda, dtype).requires_grad_()
    w = (rand(rng, k, 24) / k**0.5).to(cuda, dtype).requires_grad_()
    dy = rand(rng, 2, 37, 6, 7, 24).to(cuda, dtype)
    y = dw_kernels.dw_temporal(x, w)
    before = dict(dw_kernels.LAUNCHES)
    y.backward(dy)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["dw_temporal_fwd"] == before["dw_temporal_fwd"] + 1
    assert dw_kernels.LAUNCHES["dw_temporal_dw"] == before["dw_temporal_dw"] + 1
    assert x.grad.dtype == dtype and w.grad.dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    ref_dx = dw_kernels.dw_temporal_plain(dy.float(), w.detach().float().flip(0))
    torch.testing.assert_close(x.grad.float(), ref_dx, rtol=rtol, atol=1e-5)
    ref_dw = dw_kernels.dw_temporal_dw_plain(x.detach().double(), dy.double(), k)
    bound = 1e-5 * ref_dw.abs().max().item() + 1e-5
    if dtype == torch.bfloat16:  # dw rounded once to w's dtype
        bound += BF16_RTOL * ref_dw.abs().max().item()
    assert (w.grad.double() - ref_dw).abs().max().item() <= bound


@pytest.mark.cuda
def test_temporal_dw_kernel_is_the_same_from_run_to_run(cuda):
    """At block 0-3's width (448 channels, 32x32 frames), three reruns are
    bitwise equal: fixed-order sums, no atomics."""
    rng = np.random.default_rng(44)
    x = rand(rng, 4, 16, 32, 32, 448).to(cuda, torch.bfloat16)
    dy = rand(rng, 4, 16, 32, 32, 448).to(cuda, torch.bfloat16)
    first = dw_kernels.dw_temporal_dw(x, dy, 5)
    assert all(torch.equal(first, dw_kernels.dw_temporal_dw(x, dy, 5)) for _ in range(3))


@pytest.mark.cuda
def test_temporal_kernels_refuse_other_kernel_sizes_on_the_card(cuda):
    """k = 7 is not compiled: the wrappers raise before launching on the card,
    while the CPU path still answers through the plain versions."""
    rng = np.random.default_rng(45)
    x, w = rand(rng, 1, 9, 3, 4, 8), rand(rng, 7, 8)
    before = dict(dw_kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_temporal_fwd(x.to(cuda), w.to(cuda))
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_temporal_dw(x.to(cuda), x.to(cuda), 7)
    assert dw_kernels.LAUNCHES == before
    assert dw_kernels.dw_temporal_fwd(x, w).shape == x.shape
    assert dw_kernels.dw_temporal_dw(x, x, 7).shape == (7, 8)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """A tiny fp32 model, drop rates 0, block 1 rematerialized: one step on the
    card (kernels) against the CPU (plain versions)."""
    params = {
        "nn_module": ("dwiseneuro", {**TINY, "drop_rate": 0.0, "drop_path_rate": 0.0, "remat_blocks": (1,)}),
        "loss": ("mice_poisson", {"log_input": False}),
        "optimizer": ("SGD", {"lr": 0.1}),
        **ARGUS,
    }
    rng = np.random.default_rng(14)
    weights = np.zeros((4, 2), np.float32)
    weights[np.arange(4), [0, 1, 0, 1]] = 1.0
    batch = MiceBatch(rng.uniform(0, 255, (4, 5, 4, 16, 16)).astype(np.float32),
                      rng.gamma(1.5, 1.0, (4, 7, 4)).astype(np.float32), weights)
    out = {}
    for device in ("cpu", "cuda"):
        model = MouseModel(params, device=device)
        model.build_state(seed=3)
        before = dict(dw_kernels.LAUNCHES)
        loss = model.train_step(batch).item()
        launches = {k: dw_kernels.LAUNCHES[k] - before[k] for k in before}
        out[device] = (loss, {k: p.grad.cpu() for k, p in model.state.model.named_parameters()}, launches)
    (loss_cpu, grads_cpu, none), (loss_cuda, grads_cuda, launches) = out["cpu"], out["cuda"]
    assert set(none.values()) == {0}
    assert launches == {"dw_spatial_fwd": 3, "dw_temporal_fwd": 5, "dw_spatial_dx": 2, "dw_spatial_dw": 2,
                        "dw_temporal_dw": 2, "fused_bn_silu_dw_spatial": 0, "dw_spatial_fwd_bn": 0,
                        "dw_temporal_fwd_bn": 0}
    np.testing.assert_allclose(loss_cuda, loss_cpu, rtol=1e-4)
    largest = max(g.abs().max().item() for g in grads_cpu.values())
    for name, g in grads_cpu.items():
        bound = max(1e-3 * g.abs().max().item(), 1e-6 * largest)
        assert (grads_cuda[name] - g).abs().max().item() <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_fused_kernel_matches_plain(cuda, k, stride, dtype):
    """BN-apply + SiLU + depthwise at a ragged shape, half the channels dead
    (scale 0, shift 1: the padding must be zero after the prologue); reruns
    are bitwise equal."""
    rng = np.random.default_rng(15)
    x = rand(rng, 2, 3, 9, 11, 24).to(cuda, dtype)
    scale = (1.0 + 0.2 * rand(rng, 24)).to(cuda)
    shift = (0.2 * rand(rng, 24)).to(cuda)
    scale[12:], shift[12:] = 0.0, 1.0
    w = (rand(rng, k, k, 24) / k).to(cuda, dtype)
    before = dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"]
    got = dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, stride)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"] == before + 1
    assert got.dtype == dtype
    ref = dw_kernels.fused_bn_silu_dw_spatial_plain(x.float(), scale, shift, w.float(), stride)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=1e-5)
    assert all(torch.equal(got, dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, stride))
               for _ in range(2))


def check_fused_kernel(x, scale, shift, w, stride: int) -> torch.Tensor:
    """One launch of the fused kernel, held to its plain version computed in
    fp32 from the same inputs, as test_fused_kernel_matches_plain holds it."""
    before = dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"]
    got = dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, stride)
    torch.cuda.synchronize()
    assert dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"] == before + 1
    assert got.dtype == x.dtype
    ref = dw_kernels.fused_bn_silu_dw_spatial_plain(x.float(), scale, shift, w.float(), stride)
    rtol = BF16_RTOL if x.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=1e-5)
    return got


def fused_operands(rng, shape, k: int, device, dtype):
    """x, scale and shift with half the channels dead (scale 0, shift 1), w."""
    c = shape[-1]
    x = rand(rng, *shape).to(device, dtype)
    scale = (1.0 + 0.2 * rand(rng, c)).to(device)
    shift = (0.2 * rand(rng, c)).to(device)
    scale[c // 2 :], shift[c // 2 :] = 0.0, 1.0
    return x, scale, shift, (rand(rng, k, k, c) / k).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "hw, c, k, stride",
    [(hw, 24, k, s) for hw in ((33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
    + [(hw, c, 3, s) for hw, c in (((2, 70), 24), ((70, 3), 24), ((1, 1), 24), ((9, 11), 20), ((9, 11), 22),
                                   ((10, 12), 264)) for s in (1, 2)],
)
def test_fused_kernel_matches_plain_at_tile_edges(cuda, hw, c, k, stride, dtype):
    """The edges of the fused kernel's tiling, with half the channels dead: H
    and W that are not multiples of its bands and column tiles, frames wider
    or taller than one tile, a 1x1 frame, channel tails (c=20 in bf16, c=22 in
    both: element-by-element copies), k = 5 at both strides, and C wider than
    one tile of 8 channel vectors (c=264)."""
    check_fused_kernel(*fused_operands(np.random.default_rng(50), (2, 3, *hw, c), k, cuda, dtype), stride)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw, c, k, stride", [((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)])
def test_fused_kernel_matches_plain_when_blocks_walk_frames(cuda, hw, c, k, stride, dtype):
    """8192 small frames: each block walks two, the next frame's rows landing
    while this one computes."""
    x, scale, shift, w = fused_operands(np.random.default_rng(51), (64, 128, *hw, c), k, cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert dw_kernels.fused_launch_geometry(64 * 128, *hw, c, k, stride, x.element_size(), sms)["frames"] > 1
    check_fused_kernel(x, scale, shift, w, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_kernel_takes_unaligned_pointers(cuda, stride, dtype):
    """Contiguous operands whose storage starts one element past a 16-byte
    boundary (x, w, scale and shift): the kernel stages and stores element by
    element."""
    rng = np.random.default_rng(52)

    def unaligned(values: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(values.numel() + 1, device=cuda, dtype=values.dtype)
        out = buf[1:].view(values.shape)
        out.copy_(values)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    operands = fused_operands(rng, (2, 3, 9, 11, 32), 3, cuda, dtype)
    check_fused_kernel(*(unaligned(t) for t in operands), stride)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_kernel_is_the_same_from_run_to_run(cuda, stride):
    """At a flagship width (448 channels, a 32x32 frame of block 1 or 64x64 of
    block 0), three reruns are bitwise equal: one pass, no atomics."""
    h = 32 * stride
    x, scale, shift, w = fused_operands(np.random.default_rng(53), (2, 8, h, h, 448), 3, cuda, torch.bfloat16)
    first = check_fused_kernel(x, scale, shift, w, stride)
    assert all(torch.equal(first, dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, stride)) for _ in range(3))


@pytest.mark.cuda
def test_fused_kernel_refuses_other_kernel_sizes_on_the_card(cuda):
    """k = 7 is not compiled: the wrapper raises before launching on the card,
    while the CPU path still answers through the plain version."""
    x, scale, shift, w = fused_operands(np.random.default_rng(54), (1, 2, 9, 8, 8), 7, "cpu", torch.float32)
    before = dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"]
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.fused_bn_silu_dw_spatial(x.to(cuda), scale.to(cuda), shift.to(cuda), w.to(cuda), 1)
    assert dw_kernels.LAUNCHES["fused_bn_silu_dw_spatial"] == before
    assert dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, w, 1).shape == (1, 2, 9, 8, 8)


@pytest.mark.cuda
def test_fused_wrapper_refuses_bad_operands_on_the_card(cuda):
    x = torch.zeros(1, 2, 4, 4, 8, device=cuda)
    w = torch.zeros(3, 3, 8, device=cuda)
    with pytest.raises(TypeError, match="scale must be a contiguous float32"):
        dw_kernels.fused_bn_silu_dw_spatial(x, torch.zeros(8, device=cuda, dtype=torch.float64),
                                            torch.zeros(8, device=cuda), w)
    with pytest.raises(TypeError, match="shift must be"):
        dw_kernels.fused_bn_silu_dw_spatial(x, torch.zeros(8, device=cuda), torch.zeros(8), w)


@pytest.mark.cuda
def test_dwbench_runs_on_the_card(cuda, monkeypatch, capsys):
    from sensorium_tpu_torch.tools import dwbench

    monkeypatch.setattr(dwbench, "SHAPES", [("tiny-s2", (2, 3, 9, 11, 24, 2))])
    monkeypatch.setattr(dwbench, "TEMPORAL_SHAPES", [("t-tiny", (2, 6, 4, 4, 24))])
    assert dwbench.main(["--iters", "2"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 2 + len(dwbench.SPATIAL_IMPLS)


@pytest.mark.cuda
def test_native_host_library_builds_on_the_card_machine(cuda, tmp_path, monkeypatch):
    """The data feed's C++ library compiles with this machine's g++ and gathers as NumPy does."""
    from sensorium_tpu_torch.data import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_host")
    monkeypatch.delenv("SENSORIUM_NATIVE", raising=False)
    native.reset()
    try:
        assert native.available() and native.library_path().exists()
        src = (rand(np.random.default_rng(16), 7, 50) - 0.3).numpy()
        idx = np.arange(2, 40, 3)
        out = np.empty((7, idx.size), np.float32)
        assert native.gather_rows_relu_into(src, idx, out)
        np.testing.assert_array_equal(out, np.maximum(src[:, idx], 0.0))
    finally:
        native.reset()


def write_unlabeled_trials(root, mouse: str, lengths) -> None:
    """One mouse in the on-disk layout, with unlabeled live_test_main trials only."""
    rng = np.random.default_rng(17)
    mdir = root / mouse
    for sub in ("data/videos", "data/behavior", "data/pupil_center", "meta/trials", "meta/neurons"):
        (mdir / sub).mkdir(parents=True, exist_ok=True)
    np.save(mdir / "meta/trials/tiers.npy", np.array(["live_test_main"] * len(lengths)))
    np.save(mdir / "meta/neurons/unit_ids.npy", np.arange(1, 6, dtype=np.int64))
    np.save(mdir / "meta/neurons/cell_motor_coordinates.npy", np.zeros((5, 3), np.float32))
    for trial, length in enumerate(lengths):
        np.save(mdir / f"data/videos/{trial}.npy", rng.uniform(0, 255, (12, 14, length)).astype(np.float32))
        np.save(mdir / f"data/behavior/{trial}.npy", rng.uniform(0, 5, (2, length)).astype(np.float32))
        np.save(mdir / f"data/pupil_center/{trial}.npy", rng.uniform(0, 50, (2, length)).astype(np.float32))


@pytest.fixture
def unlabeled_split(tmp_path, monkeypatch):
    """Four trials of one new mouse (mouse index 0: TINY's 5 neurons), one shorter than a window."""
    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.data import mouse_data

    mouse = constants.new_mice[0]
    write_unlabeled_trials(tmp_path / "data", mouse, [40, 33, 6, 52])
    monkeypatch.setattr(constants, "sensorium_dir", tmp_path / "data")
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    mouse_data.get_folds_tiers.cache_clear()
    yield mouse, tmp_path
    mouse_data.get_folds_tiers.cache_clear()


def fold_predictors(device, count: int = 7) -> list[Predictor]:
    return [
        Predictor.from_module(
            get_nn_module("dwiseneuro", TINY, device=device, generator=torch.Generator().manual_seed(fold)),
            ARGUS, chunk_size=8, device=device)
        for fold in range(count)
    ]


@pytest.mark.cuda
def test_predict_mouse_split_on_the_card_matches_the_cpu(cuda, unlabeled_split):
    """The fold blend with the deferred fetch (pinned copy, event, save one trial later) against the CPU."""
    from sensorium_tpu_torch.infer.predictor import predict_mouse_split

    mouse, root = unlabeled_split
    for device in ("cpu", "cuda"):
        predict_mouse_split(mouse, "live_test_main", fold_predictors(device), root / device)
    for trial, length in enumerate([40, 33, 6, 52]):
        got, expected = np.load(root / "cuda" / f"{trial}.npy"), np.load(root / "cpu" / f"{trial}.npy")
        assert got.shape == expected.shape == (5, length) and got.dtype == np.float32
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_predict_mouse_split_on_the_card_is_the_mean_of_seven(cuda, unlabeled_split):
    from sensorium_tpu_torch.infer.predictor import _load_trial_arrays, predict_mouse_split
    from sensorium_tpu_torch.data.mouse_data import get_mouse_data

    mouse, root = unlabeled_split
    predictors = fold_predictors("cuda")
    predict_mouse_split(mouse, "live_test_main", predictors, root / "blend")
    for trial_data in get_mouse_data(mouse, ["live_test_main"])["trials"]:
        arrays = _load_trial_arrays(trial_data)
        each = [p.predict_trial(*arrays, mouse_index=0) for p in predictors]
        # index_add_ on the card sums overlapping windows in an order that may vary: fp32 rounding.
        np.testing.assert_allclose(np.load(root / "blend" / f"{trial_data['trial_id']}.npy"), np.mean(each, axis=0),
                                   rtol=1e-5, atol=1e-6)


def tiny_batch(rng) -> MiceBatch:
    weights = np.zeros((4, 2), np.float32)
    weights[np.arange(4), [0, 1, 0, 1]] = 1.0
    return MiceBatch(rng.uniform(0, 255, (4, 5, 4, 16, 16)).astype(np.float32),
                     rng.gamma(1.5, 1.0, (4, 7, 4)).astype(np.float32), weights)


@pytest.mark.cuda
def test_background_save_on_the_card_is_bitwise_a_sync_save(cuda, tmp_path):
    """The copy to the host happens before save() returns: the next step's in-place updates cannot reach it."""
    from sensorium_tpu_torch.engine.checkpoint import flush_pending_saves
    from sensorium_tpu_torch.engine.model import load_model

    model = MouseModel({**ARGUS, "nn_module": ("dwiseneuro", TINY)}, device="cuda")
    model.set_ema(0.9)
    model.build_state(seed=0, learning_rate=1e-3)
    batch = tiny_batch(np.random.default_rng(18))
    model.train_step(batch)
    model.save(tmp_path / "sync.ckpt")
    model.save_train_state(tmp_path / "sync_state.ckpt")
    model.save(tmp_path / "async.ckpt", background=True)
    model.save_train_state(tmp_path / "async_state.ckpt", background=True)
    model.train_step(batch)
    flush_pending_saves()
    assert (tmp_path / "async.ckpt").read_bytes() == (tmp_path / "sync.ckpt").read_bytes()
    assert (tmp_path / "async_state.ckpt").read_bytes() == (tmp_path / "sync_state.ckpt").read_bytes()
    restored = load_model(tmp_path / "async.ckpt", device="cuda")
    resumed = MouseModel({**ARGUS, "nn_module": ("dwiseneuro", TINY)}, device="cuda")
    resumed.set_ema(0.9)
    resumed.build_state(seed=1, learning_rate=1e-3)
    resumed.load_train_state(tmp_path / "async_state.ckpt")
    assert next(restored.state.model.parameters()).device.type == "cuda"
    assert float(resumed.train_step(batch)) > 0


@pytest.fixture
def card_group_of_one(cuda):
    """A gloo group of one process over the card: the mesh path runs every
    collective on CUDA tensors, and a sum over one process changes nothing."""
    import socket

    import torch.distributed as dist

    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield mesh_lib.create_mesh(devices=["cuda"])
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_function_over_a_group_of_one_is_bitwise_the_function_without_a_mesh(card_group_of_one, dtype):
    from sensorium_tpu_torch.ops.norm import batch_norm_train

    rng = np.random.default_rng(19)
    x = (rand(rng, 4, 3, 6, 5, 24) * 7 + 40).to("cuda", dtype)
    scale, bias = rand(rng, 24).cuda(), rand(rng, 24).cuda()
    shift, dy = (rand(rng, 24) * 5 + 38).cuda(), rand(rng, *x.shape).to("cuda", dtype)
    results = []
    for mesh in (None, card_group_of_one):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        y, mean, var = batch_norm_train(*leaves, shift, 1e-5, dtype, mesh)
        y.backward(dy)
        results.append([y, mean, var] + [t.grad for t in leaves])
    for without, over in zip(*results):
        assert torch.equal(without, over)


@pytest.mark.cuda
def test_train_step_over_a_group_of_one_is_bitwise_the_single_card_step(card_group_of_one):
    params = {**ARGUS, "nn_module": ("dwiseneuro", {**TINY, "drop_rate": 0.2, "drop_path_rate": 0.1})}
    batch = tiny_batch(np.random.default_rng(20))
    models = []
    for mesh in (None, card_group_of_one):
        model = MouseModel(params, device="cuda", mesh=mesh)
        model.set_ema(0.9)
        model.build_state(seed=0, learning_rate=1e-3)
        losses = [float(model.train_step(batch)) for _ in range(2)]
        models.append((losses, model.state.ema_model.state_dict(), model.state.model.state_dict()))
    (losses, ema, live), (mesh_losses, mesh_ema, mesh_live) = models
    assert losses == mesh_losses
    for name in live:
        assert torch.equal(live[name], mesh_live[name]), name
        assert torch.equal(ema[name], mesh_ema[name]), name


@pytest.fixture
def card_model_group_of_one(card_group_of_one):
    """The group of one as a ``model`` group too: the tensor-parallel
    Functions run their collectives (gloo on CUDA tensors) over one process."""
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    group = card_group_of_one.group
    return mesh_lib.Mesh({"data": 1, "model": 1}, card_group_of_one.devices, 0, 1, group, group, group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_parallel_functions_over_a_card_group_of_one(card_model_group_of_one, dtype):
    """``copy_to_model`` (an all_reduce in the backward) and
    ``gather_from_model`` (an all_gather, a slice in the backward) on CUDA
    tensors: over one process, the identity forward and backward, bitwise."""
    from sensorium_tpu_torch.parallel.tensor import copy_to_model, gather, gather_from_model

    mesh = card_model_group_of_one
    rng = np.random.default_rng(21)
    x = rand(rng, 3, 4, 2, 6).to("cuda", dtype).requires_grad_(True)
    dy = rand(rng, 3, 4, 2, 6).to("cuda", dtype)
    y = gather_from_model(copy_to_model(x, mesh) * 2, -1, mesh)
    y.backward(dy)
    assert y.is_cuda and y.dtype == dtype and torch.equal(y, x.detach() * 2)
    assert torch.equal(x.grad, dy * 2)
    assert torch.equal(gather(x, 1, mesh), x.detach())


@pytest.mark.cuda
def test_sharded_clip_over_a_card_group_of_one_is_torchs(card_model_group_of_one):
    """The global-norm clip's model-group sum on the card: over one process,
    ``clip_grad_norm_``'s scale."""
    from sensorium_tpu_torch.engine.steps import clip_sharded_grad_norm_

    modules = []
    for _ in range(2):
        module = get_nn_module("dwiseneuro", TINY, device="cuda", generator=torch.Generator().manual_seed(0))
        rng = np.random.default_rng(22)
        for p in module.parameters():
            p.grad = rand(rng, *p.shape).cuda()
        modules.append(module)
    expected = torch.nn.utils.clip_grad_norm_(modules[0].parameters(), 0.5)
    got = clip_sharded_grad_norm_(modules[1], 0.5, card_model_group_of_one)
    torch.testing.assert_close(got, expected, rtol=1e-6, atol=0)
    for a, b in zip(modules[0].parameters(), modules[1].parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_sharded_train_state_on_the_card_over_a_group_of_one(card_group_of_one, tmp_path):
    """A ``.orbax`` state of a card model (torch.distributed.checkpoint from
    CUDA tensors, gloo) restores bitwise and continues bitwise."""
    params = {**ARGUS, "nn_module": ("dwiseneuro", {**TINY, "drop_rate": 0.2, "drop_path_rate": 0.1}),
              "optimizer": ("AdamW", {"lr": 1e-3, "weight_decay": 0.05})}
    batch = tiny_batch(np.random.default_rng(23))
    models = []
    for seed in (0, 1):
        model = MouseModel(params, device="cuda", mesh=card_group_of_one)
        model.set_ema(0.9)
        model.build_state(seed=seed, learning_rate=1e-3)
        models.append(model)
    models[0].train_step(batch)
    models[0].save_train_state(tmp_path / "train_state.orbax", extra={"epoch": 1})
    assert models[1].load_train_state(tmp_path / "train_state.orbax") == {"epoch": 1}
    assert float(models[0].train_step(batch)) == float(models[1].train_step(batch))
    for a, b in zip(models[0].state.ema_model.state_dict().values(), models[1].state.ema_model.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b)


@pytest.fixture
def card_model(cuda, tmp_path):
    """A tiny fp32 model on the card, and its checkpoint."""
    model = MouseModel({**ARGUS, "nn_module": ("dwiseneuro", TINY)}, device="cuda")
    model.build_state(seed=0, learning_rate=0.0)
    path = tmp_path / "model-000-0.100000.ckpt"
    model.save(path)
    return model, path


@pytest.mark.cuda
def test_window_artifact_traced_on_the_card_matches_the_live_model(card_model, tmp_path):
    """``infer/export.py`` on the card: the artifact launches the kernels
    through the ``sensorium::`` ops and gives the live model's numbers, at
    two batch sizes from one artifact."""
    from sensorium_tpu_torch.infer.export import export_forward, load_exported, save_exported

    model, _ = card_model
    artifact = load_exported(save_exported(tmp_path / "m1.pt2", export_forward(model, mouse_index=1)), device="cuda")
    rng = np.random.default_rng(30)
    for batch in (1, 3):
        x = rng.uniform(0, 255, (batch, 5, 4, 16, 16)).astype(np.float32)
        before = dict(dw_kernels.LAUNCHES)
        with torch.inference_mode():
            got = artifact(torch.from_numpy(x).cuda())
        blocks = len(TINY["core_features"])
        assert dw_kernels.LAUNCHES["dw_spatial_fwd_bn"] == before["dw_spatial_fwd_bn"] + blocks
        assert dw_kernels.LAUNCHES["dw_temporal_fwd_bn"] == before["dw_temporal_fwd_bn"] + blocks
        torch.testing.assert_close(got, model.predict(x, mouse_index=1), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_card_traced_artifacts_run_on_the_cpu(card_model, tmp_path):
    """The window and trial artifacts traced on the card, moved to the CPU
    (plain versions), against the card within the card-vs-CPU tolerance."""
    from sensorium_tpu_torch.infer.export import export_model_file, load_exported

    _, path = card_model
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 5, 4, 16, 16)).astype(np.float32))
    window = export_model_file(path, tmp_path / "window.pt2", device="cuda")["artifact"]
    with torch.inference_mode():
        card = load_exported(window, device="cuda")(x.cuda()).cpu()
        cpu = load_exported(window, device="cpu")(x)
    torch.testing.assert_close(cpu, card, rtol=1e-4, atol=1e-4)

    trial = export_model_file(path, tmp_path / "trial.pt2", mouse_index=1, trial=True, src_hw=(12, 14),
                              chunk_size=8, length_bucket=16, device="cuda")["artifact"]
    args = (torch.from_numpy(rng.uniform(0, 255, (32, 12, 14)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 5, (2, 32)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 50, (2, 32)).astype(np.float32)), torch.tensor(29, dtype=torch.int32))
    with torch.inference_mode():
        card = load_exported(trial, device="cuda")(*(a.cuda() for a in args)).cpu()
        cpu = load_exported(trial, device="cpu")(*args)
    torch.testing.assert_close(cpu, card, rtol=1e-4, atol=1e-4)


def card_trial(seed: int, length: int = 40) -> tuple:
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (12, 14, length)).astype(np.float32),
            rng.uniform(0, 5, (2, length)).astype(np.float32), rng.uniform(0, 50, (2, length)).astype(np.float32))


def card_devices(count: int) -> list[str]:
    """``count`` devices of a mesh on this host: cards 0, 1, ... where there
    are enough, else card 0 repeated."""
    cards = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(count)] if cards >= count else ["cuda:0"] * count


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_predictor_over_a_model_axis_on_the_card_matches_one_card(card_model, shape):
    """``Predictor`` over a (data, model) mesh of this host's cards (card 0
    repeated where there are fewer): each replica's cortex and readout sliced
    over its group's cards, 4 + 4 kernel launches a replica's chunk forward,
    the one-card trial within fp32 rounding."""
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    _, path = card_model
    num_data, num_model = shape
    mesh = mesh_lib.create_mesh(num_data, num_model, devices=card_devices(num_data * num_model))
    trial = card_trial(22)
    one = Predictor(path, chunk_size=8, device="cuda")
    sharded = Predictor(path, chunk_size=8, mesh=mesh)
    before = dict(dw_kernels.LAUNCHES)
    got = sharded.predict_trial(*trial, 1)
    windows = 40 - (ARGUS["frame_stack"]["size"] - 1) * ARGUS["frame_stack"]["step"]
    forwards = sum(min(num_data, windows - start, 8) for start in range(0, windows, 8))
    assert dw_kernels.LAUNCHES["dw_spatial_fwd_bn"] - before["dw_spatial_fwd_bn"] == 2 * forwards
    np.testing.assert_allclose(got, one.predict_trial(*trial, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_a_multi_device_artifact_names_each_card_it_uses(card_model, tmp_path):
    """The trial program of a (data 2, model 2) ``Predictor`` traced on the
    card(s): every device its graph names is one of its mesh's cards and each
    of them is named; loaded back onto the host's cards it gives the live
    sharded Predictor's trial."""
    from sensorium_tpu_torch.infer.export import export_trial, load_exported, save_exported
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    _, path = card_model
    mesh = mesh_lib.create_mesh(2, 2, devices=card_devices(4))
    sharded = Predictor(path, chunk_size=8, length_bucket=16, mesh=mesh)
    exported = export_trial(sharded, mouse_index=1, src_hw=(12, 14))
    named = set()
    for module in exported.program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                named.update(str(v) for v in [*node.args, *node.kwargs.values()] if isinstance(v, torch.device))
    assert named == {str(d) for d in mesh.devices}
    artifact = load_exported(save_exported(tmp_path / "mesh.pt2", exported), device="cuda")
    assert artifact.nr_devices == 4
    video, behavior, pupil = card_trial(23, 32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (video.transpose(2, 0, 1), behavior, pupil)]
    with torch.inference_mode():
        got = artifact(*args, torch.tensor(32, dtype=torch.int32, device="cuda")).cpu().numpy()
    np.testing.assert_allclose(got, sharded.predict_trial(video, behavior, pupil, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_dryrun_refuses_fewer_cards_than_ranks(cuda):
    from sensorium_tpu_torch.tools.dryrun import dryrun_multichip

    count = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {count + 1} cards, one a rank; {count} visible"):
        dryrun_multichip(count + 1, flagship=False)


@pytest.mark.cuda
def test_cudnn_route_matches_the_kernels_on_the_card(cuda, monkeypatch):
    """``SENSORIUM_DW_IMPL=cudnn`` (grouped conv3d) against the default
    route (the kernels) in fp32: forward and both gradients."""
    from sensorium_tpu_torch.ops import conv

    rng = np.random.default_rng(0)
    cases = [(lambda x, w: conv.depthwise_conv_spatial(x, w, s), (4, 3, 17, 19, 40), (3, 3, 40)) for s in (1, 2)]
    cases.append((conv.depthwise_conv_temporal, (4, 9, 6, 7, 40), (5, 40)))
    for fn, x_shape, w_shape in cases:
        x0, w0 = rand(rng, *x_shape).to(cuda), rand(rng, *w_shape).to(cuda)
        results = []
        for impl in ("cuda", "cudnn"):
            monkeypatch.setenv("SENSORIUM_DW_IMPL", impl)
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            y = fn(x, w)
            gx, gw = torch.autograd.grad((y * torch.cos(y)).sum(), (x, w))
            results.append((y, gx, gw))
        for got, expected in zip(results[1], results[0]):
            torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_bench_headline_on_the_card(cuda):
    """``python -m sensorium_tpu_torch.tools.bench``: the flagship training
    headline, one contract line on the kernels' route with their launches."""
    import json
    import math
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "sensorium_tpu_torch.tools.bench"],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "train_clips_per_sec_per_chip_b32_fwd_bwd" and line["unit"] == "clips/s"
    assert math.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["dw_impl"] == "cuda" and detail["peak_memory_gb"] > 0 and detail["card"]
    assert detail["kernel_launches_per_step"] == {"dw_spatial_fwd": 10, "dw_temporal_fwd": 19, "dw_spatial_dx": 9,
                                                  "dw_spatial_dw": 9, "dw_temporal_dw": 9}


@pytest.mark.cuda
def test_spans_on_the_card_are_timed_by_events_without_a_wait(cuda):
    """Under a profiler, a training step's and a trial's spans carry CUDA-event
    seconds; ``bn.backward`` is recorded on autograd's device thread; the
    flat spans' seconds fit in the traced window; ``span_totals`` leaves no
    event unfolded."""
    import collections
    import time

    from sensorium_tpu_torch.models.dwiseneuro import BatchNormAct
    from sensorium_tpu_torch.utils import profiling

    params = {
        "nn_module": ("dwiseneuro", {**TINY, "remat_blocks": (1,)}),
        "loss": ("mice_poisson", {"log_input": False}),
        "optimizer": ("AdamW", {"lr": 1e-3, "weight_decay": 0.05}),
        **ARGUS,
    }
    rng = np.random.default_rng(19)
    weights = np.zeros((4, 2), np.float32)
    weights[np.arange(4), [0, 1, 0, 1]] = 1.0
    batch = MiceBatch(rng.uniform(0, 255, (4, 5, 4, 16, 16)).astype(np.float32),
                      rng.gamma(1.5, 1.0, (4, 7, 4)).astype(np.float32), weights)
    model = MouseModel(params, device="cuda")
    model.set_ema(0.9)
    model.build_state(seed=0)
    predictor = Predictor.from_module(get_nn_module("dwiseneuro", TINY, device="cuda"), ARGUS, chunk_size=8,
                                      device="cuda")
    trial = (rng.uniform(0, 255, (12, 14, 40)).astype(np.float32), rng.uniform(0, 5, (2, 40)).astype(np.float32),
             rng.uniform(0, 50, (2, 40)).astype(np.float32))
    model.train_step(batch)
    predictor.predict_trial(*trial, 1)
    torch.cuda.synchronize()
    profiling.reset_spans()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(3):
            model.train_step(batch)
        predictor.predict_trial(*trial, 1)
        torch.cuda.synchronize()
        window = time.perf_counter() - start
    threads = collections.defaultdict(set)  # host threads: the card's timeline repeats each span
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CPU:
            threads[event.name].add(event.thread)
    assert threads["bn.backward"] and not threads["bn.backward"] & threads["step.zero_grad"]
    totals = profiling.span_totals()
    assert not profiling._REGISTRY.pending
    assert {"bn_act.train", "bn_act.recompute", "bn_act.eval", "bn.backward", "step.zero_grad", "step.optimizer",
            "step.ema", "fit.stage", "predict.upload", "predict.stage", "predict.gather", "predict.blend",
            "predict.fetch"} <= set(totals)
    assert all(device_s is not None and device_s > 0 for _, _, device_s in totals.values())
    bns = sum(isinstance(m, BatchNormAct) for m in model.state.model.modules())
    assert totals["bn_act.train"][0] == totals["bn.backward"][0] == 3 * bns
    assert sum(device_s for _, _, device_s in totals.values()) <= window
    profiling.reset_spans()


# ------------------------------------------------------------------- batch norm
#
# The BN kernels against their plain versions on the same card. The kernels
# and the plain versions compute one fp32 formula from the same inputs in
# other orders, then round to the compute dtype where the model rounds (the
# BN output before SiLU, SiLU's output, SiLU's gradient, dx): two fp32 values
# a few units apart may round to neighbouring bf16 values, one step (at most
# 2**-7 of the value, BF16_STEP) apart, and that difference carries on
# through what follows it (|silu'| <= 1.1, |silu''| <= 0.5). fp32
# differences of order alone are held at 1e-5 of the terms; sums over rows at
# BN_SUM_RTOL of the sum of the terms' magnitudes (fp32 sums of up to 2e6
# terms in other orders; a bf16 step at a rare element is far below that).

BF16_STEP = 2 * BF16_RTOL

BN_STATS_RTOL = 1e-4  # fp32 statistics: sums of up to 2e6 terms, the shifted variance's cancellation
BN_SUM_RTOL = 2e-5
BN_CHUNK = 1 << 26  # elements a comparison holds in fp32 at once


def bn_call_shapes(config_name: str, device) -> set:
    """(x shape, act) of every BN call of one chunk forward (32 windows) of
    the configuration's model on the card, read by hooks. The forward runs
    in training mode without a gradient: in eval, pw_bn and spatial_bn run
    inside the depthwise convs, and the kernels still serve them in training."""
    import importlib

    from sensorium_tpu_torch.models.dwiseneuro import BatchNormAct

    config = importlib.import_module(f"sensorium_tpu_torch.configs.{config_name}").config
    name, params = config["argus_params"]["nn_module"]
    model = get_nn_module(name, params, device=device)
    calls = set()
    for module in model.modules():
        if isinstance(module, BatchNormAct):
            module.register_forward_pre_hook(lambda m, args: calls.add((tuple(args[0].shape), m.act)))
    frames = config["argus_params"]["frame_stack"]["size"]
    inputs = torch.zeros(32, params["in_channels"], frames, *config["image_size"], device=device)
    with torch.no_grad():
        model.train()(inputs, generator=torch.Generator(device=device).manual_seed(0))
    del model
    torch.cuda.empty_cache()
    return calls


def bn_operands(shape, dtype, gen, device) -> dict:
    """x with per-channel means of a few units and spreads of 0.5-1.5, dy,
    and the per-channel parameters and running statistics."""
    c = shape[-1]

    def randn(*size):
        return torch.randn(*size, generator=gen, device=device)

    spread, offset = 0.5 + torch.rand(c, generator=gen, device=device), 2 * randn(c)
    return {"x": (randn(*shape) * spread + offset).to(dtype), "dy": randn(*shape).to(dtype),
            "shift": offset + 0.3 * randn(c), "scale": 1 + 0.1 * randn(c), "bias": 0.1 * randn(c),
            "mean": offset + 0.1 * randn(c), "var": (spread * (1 + 0.1 * randn(c))).square()}


def bn_rows(t: torch.Tensor):
    """(rows, C) chunks of t, each at most BN_CHUNK elements."""
    flat = t.reshape(-1, t.shape[-1])
    step = max(1, BN_CHUNK // flat.shape[1])
    return [flat[i : i + step] for i in range(0, flat.shape[0], step)]


def assert_bn_apply_close(got, x, dtype, act, a, b, label):
    """got = round(silu(round(x*a + b))) (or its BN part) of the kernels,
    against the same fp32 formula in PyTorch: a step of each rounding."""
    rel = BF16_STEP if dtype == torch.bfloat16 else 1e-5
    for got_rows, x_rows in zip(bn_rows(got), bn_rows(x)):
        z = torch.addcmul(b, x_rows.float(), a).to(dtype)
        ref = torch.nn.functional.silu(z) if act else z
        bound = rel * (ref.float().abs() + (1.1 * z.float().abs() if act else 0)) + 1e-6
        excess = ((got_rows.float() - ref.float()).abs() - bound).max().item()
        assert excess <= 0, f"{label}: beyond one rounding by {excess:.3g}"


def check_bn_kernels(shape, dtype, act, gen, device) -> None:
    """bn_stats, bn_act_apply, bn_act_eval, bn_act_grad and bn_act_dx at one
    shape against the plain versions, each given the kernels' own inputs."""
    ops = bn_operands(shape, dtype, gen, device)
    x, dy, shift, scale, bias = (ops[k] for k in ("x", "dy", "shift", "scale", "bias"))
    label = f"{tuple(shape)} {dtype} act={act}"
    running = [ops["mean"].clone(), ops["var"].clone()]
    plain_running = [ops["mean"].clone(), ops["var"].clone()]
    before = dict(bn_kernels.LAUNCHES)
    stats = bn_kernels.bn_stats(x, shift, scale, bias, *running, 1e-5)
    ref = bn_kernels.bn_stats_plain(x, shift, scale, bias, *plain_running, 1e-5)
    mean = stats[0]
    std = ref[1].sqrt()
    # The shifted variance E[(x-c)^2] - (E[x]-c)^2 loses what the first term
    # exceeds the variance by: its rounding is relative to E[(x-c)^2].
    cancel = (ref[1] + (ref[0] - shift).square()) / ref[1]
    assert ((mean - ref[0]).abs() <= BN_STATS_RTOL * (ref[0].abs() + std)).all(), f"{label}: mean"
    for row, name in ((1, "var"), (2, "inv_std"), (3, "a")):
        assert ((stats[row] - ref[row]).abs() <= BN_STATS_RTOL * cancel * ref[row].abs()).all(), f"{label}: {name}"
    b_bound = BN_STATS_RTOL * (ref[4].abs() + stats[3].abs() * (cancel * ref[0].abs() + std))  # b = bias - mean * a
    assert ((stats[4] - ref[4]).abs() <= b_bound).all(), f"{label}: b"
    n = x.numel() // x.shape[-1]
    torch.testing.assert_close(running[0], plain_running[0], rtol=1e-5, atol=BN_STATS_RTOL * std.max().item())
    var_bound = BN_STATS_RTOL * (plain_running[1].abs() + cancel * ref[1] * n / max(n - 1, 1))
    assert ((running[1] - plain_running[1]).abs() <= var_bound).all(), f"{label}: running var"

    assert_bn_apply_close(bn_kernels.bn_act_apply(x, stats, act), x, dtype, act, stats[3], stats[4], label)
    inv = torch.rsqrt(ops["var"] + 1e-5) * scale
    assert_bn_apply_close(bn_kernels.bn_act_eval(x, ops["mean"], ops["var"], scale, bias, 1e-5, act), x, dtype,
                          act, inv, bias - ops["mean"] * inv, f"{label} eval")

    sums = bn_kernels.bn_act_grad(x, dy, stats, act)
    terms = torch.zeros_like(sums)
    rel = BF16_STEP if dtype == torch.bfloat16 else 1e-5
    for x_rows, dy_rows, dx_rows in zip(bn_rows(x), bn_rows(dy), bn_rows(bn_kernels.bn_act_dx(
            x, dy, stats, sums, scale, x.numel() // x.shape[-1], act))):
        z = torch.addcmul(stats[4], x_rows.float(), stats[3]).to(dtype)
        g = (torch.ops.aten.silu_backward(dy_rows, z) if act else dy_rows).float()
        xhat = (x_rows.float() - stats[0]) * stats[2]
        terms += torch.stack([g.abs().sum(0), (g * xhat).abs().sum(0)])
        n = x.numel() // x.shape[-1]
        mg, mgx, k = sums[0] / n, sums[1] / n, stats[2] * scale
        ref_dx = (((g - mg) - xhat * mgx) * k).to(dtype).float()
        flips = 0.5 * rel * dy_rows.float().abs() * z.float().abs() if act else 0  # a step of z, through silu''
        order = 1e-5 * k.abs() * (g.abs() + mg.abs() + (xhat * mgx).abs())
        bound = rel * (ref_dx.abs() + k.abs() * g.abs()) + k.abs() * flips + order + 1e-6
        excess = ((dx_rows.float() - ref_dx).abs() - bound).max().item()
        assert excess <= 0, f"{label}: dx beyond one rounding by {excess:.3g}"
    plain_sums = bn_kernels.bn_act_grad_plain(x, dy, stats, act)
    assert ((sums - plain_sums).abs() <= BN_SUM_RTOL * terms + 1e-6).all(), f"{label}: backward sums"
    torch.cuda.synchronize()
    launched = {k: bn_kernels.LAUNCHES[k] - before[k] for k in before}
    silu = "silu_" if act else ""
    assert launched == {"bn_stats": 1, "bn_finalize": 1, "bn_apply": 0, "bn_silu_apply": 0, "bn_grad": 0,
                        "bn_silu_grad": 0, "bn_grad_sum": 1, "bn_dx": 0, "bn_silu_dx": 0,
                        f"bn_{silu}apply": 2, f"bn_{silu}grad": 1, f"bn_{silu}dx": 1}, label


@pytest.mark.cuda
def test_bn_kernels_match_plain_at_every_bn_shape_of_both_configurations(cuda):
    """Every (x shape) of the 52 BNs of a chunk forward of true_batch_001 and
    distillation_001 (stem, each block's five, the cortex's six), in bf16 and
    fp32, with SiLU and without; then channel tails (C not a multiple of the
    vector width), two rows and a few wide rows."""
    shapes = {shape for shape, _ in bn_call_shapes("true_batch_001", cuda) | bn_call_shapes("distillation_001", cuda)}
    widths = {shape[-1] for shape in shapes}
    assert {64, 128, 256, 448, 896, 1792, 384, 768, 1536, 1024, 2048, 4096} <= widths
    gen = torch.Generator(device=cuda).manual_seed(41)
    edges = {(3, 5, 20), (2, 7, 22), (2, 9), (7, 3), (64, 5000), (300, 11)}
    for shape in sorted(shapes, key=lambda s: -np.prod(s)) + sorted(edges):
        for dtype in (torch.bfloat16, torch.float32):
            for act in (True, False):
                check_bn_kernels(shape, dtype, act, gen, cuda)
        torch.cuda.empty_cache()


# The BN kernels' bf16 apply with SiLU, silu(round(x*a + b)) rounded to bf16,
# with SiLU as __fdividef(z, 1 + __expf(-z)): the hardware exponential and fast
# division that bn_act.cuh's silu<bf16> takes as ex2.approx.ftz and
# rcp.approx.ftz directly. a and b arrive at run time, so that x*a + b is
# computed as the kernels compute it (fmaf(-0, 1, 0) is +0).
SILU_EXPF_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

__global__ void silu_expf_kernel(const __nv_bfloat16* x, __nv_bfloat16* y, int n, float a, float b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const float z = __bfloat162float(__float2bfloat16(fmaf(__bfloat162float(x[i]), a, b)));
    y[i] = __float2bfloat16(__fdividef(z, 1.0f + __expf(-z)));
  }
}

extern "C" int silu_expf(const void* x, void* y, int n, float a, float b, cudaStream_t stream) {
  silu_expf_kernel<<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                        static_cast<__nv_bfloat16*>(y), n, a, b);
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.mark.cuda
def test_bf16_silu_of_the_bn_kernels_is_bitwise_the_expf_form_on_every_bf16_value(cuda, tmp_path):
    """bn_act_apply with SiLU at a = 1, b = 0 on all 65,536 bf16 values
    gives the bits of the same apply with __fdividef(z, 1 + __expf(-z)),
    compiled here with the kernels' own nvcc flags; NaN where that is NaN."""
    import ctypes
    import subprocess

    from sensorium_tpu_torch.ops import _build

    source, library = tmp_path / "silu_expf.cu", tmp_path / "silu_expf.so"
    source.write_text(SILU_EXPF_SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(library), str(source)], check=True,
                   capture_output=True)
    silu_expf = ctypes.CDLL(str(library)).silu_expf
    silu_expf.restype = ctypes.c_int
    silu_expf.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_void_p]

    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).to(cuda).reshape(1024, 64)
    stats = torch.zeros(5, 64, device=cuda)
    stats[3] = 1.0  # a = 1, b = 0: z = x (-0 as +0), so SiLU sees every bf16 value
    got = bn_kernels.bn_act_apply(x, stats, True)
    want = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert silu_expf(x.data_ptr(), want.data_ptr(), x.numel(), 1.0, 0.0, stream) == 0
    torch.cuda.synchronize()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    differ = (got.view(torch.int16) != want.view(torch.int16)) & ~nan
    assert not differ.any(), f"{int(differ.sum())} inputs differ, e.g. {x[differ][:8].tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_function_takes_a_strided_shortcut_and_reruns_bitwise(cuda, dtype):
    """The strided shortcut of a stride-2 block (x[:, :, ::2, ::2]) gives what
    its contiguous copy gives; two runs of the statistics, the output and
    the gradients are bitwise equal (fixed-order sums, no atomics)."""
    from sensorium_tpu_torch.ops.norm import batch_norm_train

    gen = torch.Generator(device=cuda).manual_seed(42)
    ops = bn_operands((8, 16, 32, 32, 64), dtype, gen, cuda)
    full, shift = ops["x"], ops["shift"]
    dy = ops["dy"][:, :, ::2, ::2]
    results = []
    for x in (full[:, :, ::2, ::2], full[:, :, ::2, ::2].contiguous(), full[:, :, ::2, ::2]):
        assert x.is_contiguous() == (len(results) == 1)
        leaves = [t.clone().requires_grad_(True) for t in (x, ops["scale"], ops["bias"])]
        y, mean, var = batch_norm_train(*leaves, shift, 1e-5, dtype, act=True)
        y.backward(dy)
        results.append([y, mean, var] + [t.grad for t in leaves])
    for first, *others in zip(*results):
        assert all(torch.equal(first, other) for other in others)


def bn_counts(module) -> tuple[int, int, int, int]:
    """BNs of the model and those with SiLU; those of its rematerialized blocks, and those with SiLU."""
    from sensorium_tpu_torch.models.dwiseneuro import BatchNormAct

    bns = [m for m in module.modules() if isinstance(m, BatchNormAct)]
    rerun = [m for i in module.remat_set for m in getattr(module, f"block_{i}").modules()
             if isinstance(m, BatchNormAct)]
    return len(bns), sum(m.act for m in bns), len(rerun), sum(m.act for m in rerun)


@pytest.mark.cuda
def test_a_flagship_step_and_chunk_forward_run_bn_through_the_kernels_alone(cuda):
    """One train step of true_batch_001 and one chunk forward launch the BN
    kernels as the config says (52 BNs, 30 with SiLU; block 1's 5 rerun), and
    the eager chain is gone: no ``addcmul``, and SiLU's own ops only for
    the squeeze-excite gates. The chunk forward runs each block's pw_bn and
    spatial_bn inside its depthwise convs (9 + 9 prologue launches, 34 BN
    launches); the step launches no prologue conv."""
    from torch.profiler import ProfilerActivity, profile

    from sensorium_tpu_torch.configs.true_batch_001 import config
    from sensorium_tpu_torch.models.dwiseneuro import SqueezeExcite

    argus = config["argus_params"]
    model = MouseModel(argus, device="cuda")
    model.build_state(seed=0, learning_rate=1e-4)
    module = model.state.model
    bns, act, rerun, rerun_act = bn_counts(module)
    assert (bns, act, rerun, rerun_act) == (52, 30, 5, 3)
    gates = sum(isinstance(m, SqueezeExcite) for m in module.modules())
    rng = np.random.default_rng(43)
    size, frames = config["image_size"], argus["frame_stack"]["size"]
    weights = np.zeros((32, 10), np.float32)
    weights[np.arange(32), np.arange(32) % 10] = 1.0
    batch = MiceBatch(rng.uniform(0, 255, (32, 5, frames, *size)).astype(np.float32),
                      rng.gamma(1.5, 1.0, (32, max(argus["nn_module"][1]["readout_outputs"]), frames)).astype(
                          np.float32), weights)
    model.train_step(batch)
    torch.cuda.synchronize()
    counts, convs = {}, {}
    for phase in ("train", "forward"):
        before, dw_before = dict(bn_kernels.LAUNCHES), dict(dw_kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if phase == "train":
                model.train_step(batch)
            else:
                with torch.inference_mode():
                    module.eval()(torch.from_numpy(batch.inputs).cuda())
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages()}
        counts[phase] = ({k: bn_kernels.LAUNCHES[k] - before[k] for k in before},
                         {k: ops.get(k, 0) for k in ("aten::addcmul", "aten::silu", "aten::silu_backward")})
        convs[phase] = {k: dw_kernels.LAUNCHES[k] - dw_before[k] for k in ("dw_spatial_fwd", "dw_temporal_fwd",
                                                                          "dw_spatial_fwd_bn", "dw_temporal_fwd_bn")}
    plain, silu = bns - act, act
    blocks = module.num_blocks
    assert counts["train"] == (
        {"bn_stats": bns + rerun, "bn_finalize": bns + rerun, "bn_apply": plain + rerun - rerun_act,
         "bn_silu_apply": silu + rerun_act, "bn_grad": plain, "bn_silu_grad": silu, "bn_grad_sum": bns,
         "bn_dx": plain, "bn_silu_dx": silu},
        {"aten::addcmul": 0, "aten::silu": gates + len(module.remat_set), "aten::silu_backward": gates})
    assert counts["forward"] == (
        {**{k: 0 for k in bn_kernels.LAUNCHES}, "bn_apply": plain, "bn_silu_apply": silu - 2 * blocks},
        {"aten::addcmul": 0, "aten::silu": gates, "aten::silu_backward": 0})
    assert plain + silu - 2 * blocks == 34
    remat = len(module.remat_set)
    assert convs == {"train": {"dw_spatial_fwd": blocks + remat, "dw_temporal_fwd": 2 * blocks + remat,
                               "dw_spatial_fwd_bn": 0, "dw_temporal_fwd_bn": 0},
                     "forward": {"dw_spatial_fwd": 0, "dw_temporal_fwd": 0, "dw_spatial_fwd_bn": blocks,
                                 "dw_temporal_fwd_bn": blocks}}
    del model, module
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_trial_artifact_traces_and_serves_through_the_bn_ops(card_model, tmp_path):
    """The trial artifact traced on the card holds each BN as one
    ``sensorium::bn_act_eval`` node but each block's pw_bn and spatial_bn,
    which its ``sensorium::dw_*_fwd_bn`` nodes hold (SiLU nodes only for the
    squeeze-excite gates), and serves through the kernels: the BN launches
    come in chunk forwards of the model's other BNs (with and without SiLU),
    and nothing of the training path."""
    from sensorium_tpu_torch.infer.export import export_model_file, load_exported

    model, path = card_model
    bns, act, _, _ = bn_counts(model.state.model)
    trial = export_model_file(path, tmp_path / "trial.pt2", mouse_index=1, trial=True, src_hw=(12, 14),
                              chunk_size=8, length_bucket=16, device="cuda")["artifact"]
    program = torch.export.load(trial)
    nodes = [node for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
             for node in gm.graph.nodes if node.op == "call_function"]
    blocks = len(TINY["core_features"])
    served, served_act = bns - 2 * blocks, act - 2 * blocks  # pw_bn and spatial_bn run inside the convs
    traced = sum("sensorium.bn_act_eval" in str(node.target) for node in nodes)
    folded = sum("sensorium.dw_spatial_fwd_bn" in str(node.target) for node in nodes)
    gates = sum(str(node.target) == "aten.silu.default" for node in nodes)
    assert traced > 0 and traced % served == 0 and gates == blocks * traced // served
    assert folded == blocks * traced // served
    rng = np.random.default_rng(44)
    args = (torch.from_numpy(rng.uniform(0, 255, (32, 12, 14)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 5, (2, 32)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 50, (2, 32)).astype(np.float32)), torch.tensor(29, dtype=torch.int32))
    before = dict(bn_kernels.LAUNCHES)
    with torch.inference_mode():
        out = load_exported(trial, device="cuda")(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    launched = {k: bn_kernels.LAUNCHES[k] - before[k] for k in before}
    forwards = launched["bn_silu_apply"] // served_act
    assert forwards >= 1 and bool(torch.isfinite(out).all())
    assert launched == {**{k: 0 for k in before}, "bn_apply": (served - served_act) * forwards,
                        "bn_silu_apply": served_act * forwards}


# ------------------------------------------------------ eval BN prologue convs
#
# dw_spatial_fwd_bn and dw_temporal_fwd_bn run an eval BN with its SiLU inside
# the depthwise conv that reads it, by bn_act.cu's own arithmetic: each must
# be bitwise the chain bn_act_eval -> dw_*_fwd on the same card.

EPS = 1e-5


def prologue_bn(c: int, gen, device) -> tuple:
    """An eval BN's (mean, var, scale, bias) whose b = bias - mean * a lies
    well away from 0, so that silu(b) (what a zero of the padding would
    become if the prologue ran on it) is not 0."""

    def randn(*size):
        return torch.randn(*size, generator=gen, device=device)

    mean = 1.5 + randn(c)
    return mean, 0.5 + torch.rand(c, generator=gen, device=device), 1 + 0.2 * randn(c), 0.2 * randn(c)


def check_prologue_conv(x, w, bn, stride=None) -> None:
    """The prologue conv (spatial with a ``stride``, else temporal) against
    ``dw_*_fwd(bn_act_eval(x))``, bitwise, with one launch of its own."""
    chain_act = bn_kernels.bn_act_eval(x, *bn, EPS, True)
    name = "dw_temporal_fwd_bn" if stride is None else "dw_spatial_fwd_bn"
    before = dict(dw_kernels.LAUNCHES)
    if stride is None:
        got, chain = dw_kernels.dw_temporal_fwd_bn(x, w, *bn, EPS), dw_kernels.dw_temporal_fwd(chain_act, w)
    else:
        got, chain = dw_kernels.dw_spatial_fwd_bn(x, w, *bn, EPS, stride), dw_kernels.dw_spatial_fwd(chain_act, w,
                                                                                                       stride)
    torch.cuda.synchronize()
    launched = {k: dw_kernels.LAUNCHES[k] - before[k] for k in before}
    assert launched == {**{k: 0 for k in before}, name: 1, name.removesuffix("_bn"): 1}
    assert got.dtype == x.dtype and got.shape == chain.shape
    assert torch.equal(got, chain), f"{name} {tuple(x.shape)} {x.dtype} stride={stride}"


def block_conv_shapes(config_name: str) -> set:
    """(h, w, c, stride, k, temporal k) of every block's depthwise convs of the
    configuration's model: the spatial conv's input, and the temporal conv's
    (the spatial output) follows from it."""
    import importlib

    config = importlib.import_module(f"sensorium_tpu_torch.configs.{config_name}").config
    params = config["argus_params"]["nn_module"][1]
    h, w = config["image_size"]
    k, kt = params["spatial_kernel"], params["temporal_kernel"]
    shapes = set()
    for f, s in zip(params["core_features"], params["spatial_strides"]):
        shapes.add((h, w, f * params["expansion_ratio"], s, k, kt))
        h, w = dw_kernels.spatial_out_size(h, k, s), dw_kernels.spatial_out_size(w, k, s)
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prologue_convs_are_the_chain_at_every_block_shape_of_both_configurations(cuda, dtype):
    """Every block's spatial and temporal conv of true_batch_001 and
    distillation_001 at a served chunk (32 windows x 16 frames), strides 1
    and 2, k = 3 and 5: bitwise the chain."""
    shapes = block_conv_shapes("true_batch_001") | block_conv_shapes("distillation_001")
    assert {s[2] for s in shapes} == {448, 896, 1792, 384, 768, 1536} and {s[3] for s in shapes} == {1, 2}
    gen = torch.Generator(device=cuda).manual_seed(50)
    for h, w, c, stride, k, kt in sorted(shapes, key=lambda s: -s[0] * s[1] * s[2]):
        bn = prologue_bn(c, gen, cuda)
        x = torch.randn(32, 16, h, w, c, generator=gen, device=cuda).to(dtype)
        check_prologue_conv(x, (torch.randn(k, k, c, generator=gen, device=cuda) / k).to(dtype), bn, stride)
        oh, ow = dw_kernels.spatial_out_size(h, k, stride), dw_kernels.spatial_out_size(w, k, stride)
        x = torch.randn(32, 16, oh, ow, c, generator=gen, device=cuda).to(dtype)
        check_prologue_conv(x, (torch.randn(kt, c, generator=gen, device=cuda) / kt**0.5).to(dtype), bn)
        del x
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "batch, hw, c, k, stride",
    [((2, 3), hw, 24, k, s) for hw in ((33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
    + [((2, 3), hw, c, 3, s) for hw, c in (((2, 70), 24), ((70, 3), 24), ((1, 1), 24), ((9, 11), 20),
                                           ((9, 11), 22), ((10, 12), 264)) for s in (1, 2)]
    + [((64, 128), hw, c, k, s) for hw, c, k, s in (((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1))],
)
def test_spatial_prologue_conv_is_the_chain_at_tile_edges(cuda, batch, hw, c, k, stride, dtype):
    """The spatial forward's tile edges (as test_fwd_kernel_matches_plain_at_tile_edges
    gives them) and blocks that walk several frames: each band's new rows
    take the prologue once, the padding none."""
    gen = torch.Generator(device=cuda).manual_seed(51)
    x = torch.randn(*batch, *hw, c, generator=gen, device=cuda).to(dtype)
    check_prologue_conv(x, (torch.randn(k, k, c, generator=gen, device=cuda) / k).to(dtype),
                        prologue_bn(c, gen, cuda), stride)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("t, c", [(1, 24), (2, 24), (37, 24), (7, 20), (7, 22), (7, 264)])
def test_temporal_prologue_conv_is_the_chain_at_walk_edges(cuda, t, c, k, dtype):
    """The column walk's edges: T below k, T not a multiple of the frame
    tile, channel tails and C wider than a tile; frames past the column stay
    zero."""
    gen = torch.Generator(device=cuda).manual_seed(52)
    x = torch.randn(2, t, 9, 11, c, generator=gen, device=cuda).to(dtype)
    check_prologue_conv(x, (torch.randn(k, c, generator=gen, device=cuda) / k**0.5).to(dtype),
                        prologue_bn(c, gen, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [None, 1, 2])
def test_prologue_convs_take_unaligned_pointers(cuda, stride, dtype):
    """x one element past a 16-byte boundary: staged and loaded element by element."""
    gen = torch.Generator(device=cuda).manual_seed(53)
    values = torch.randn(2, 7, 9, 10, 32, generator=gen, device=cuda).to(dtype)
    x = torch.empty(values.numel() + 1, device=cuda, dtype=dtype)[1:].view(values.shape)
    x.copy_(values)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.randn(*((3, 3) if stride else (5,)), 32, generator=gen, device=cuda).to(dtype) / 3
    check_prologue_conv(x, w, prologue_bn(32, gen, cuda), stride)


@pytest.mark.cuda
def test_prologue_convs_refuse_bad_operands_on_the_card(cuda):
    """k = 7 is not compiled (the CPU still answers through the chain); the
    BN's vectors must be float32 on x's card."""
    x = torch.randn(1, 2, 9, 8, 8)
    bn = (torch.zeros(8), torch.ones(8), torch.ones(8), torch.zeros(8))
    before = dict(dw_kernels.LAUNCHES)
    with pytest.raises(NotImplementedError, match="k=7"):
        dw_kernels.dw_spatial_fwd_bn(x.to(cuda), torch.zeros(7, 7, 8, device=cuda), *(t.to(cuda) for t in bn), EPS)
    with pytest.raises(TypeError, match="mean must be a contiguous float32"):
        dw_kernels.dw_temporal_fwd_bn(x.to(cuda), torch.zeros(3, 8, device=cuda), bn[0].double().to(cuda),
                                      *(t.to(cuda) for t in bn[1:]), EPS)
    with pytest.raises(TypeError, match="var must be a contiguous float32"):
        dw_kernels.dw_spatial_fwd_bn(x.to(cuda), torch.zeros(3, 3, 8, device=cuda), bn[0].to(cuda), bn[1],
                                     *(t.to(cuda) for t in bn[2:]), EPS)
    assert dw_kernels.LAUNCHES == before
    assert dw_kernels.dw_spatial_fwd_bn(x, torch.zeros(7, 7, 8), *bn, EPS).shape == (1, 2, 9, 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_eval_forward_with_the_prologue_convs_is_bitwise_the_chain(cuda, dtype, monkeypatch):
    """DwiseNeuro at the flagship's widths, its BNs' running statistics
    fitted to the batch and then moved (so every BN shifts and scales, and
    b != 0 on the border): the eval forward with pw_bn and spatial_bn inside
    the depthwise convs is bitwise the forward through the same modules'
    BatchNormAct and conv calls."""
    from sensorium_tpu_torch.configs.true_batch_001 import config
    from sensorium_tpu_torch.models import dwiseneuro
    from sensorium_tpu_torch.ops.norm import BatchNorm

    name, params = config["argus_params"]["nn_module"]
    model = get_nn_module(name, {**params, "dtype": dtype}, device=cuda)
    frames = config["argus_params"]["frame_stack"]["size"]
    gen = torch.Generator(device=cuda).manual_seed(54)
    inputs = 255 * torch.rand(4, params["in_channels"], frames, *config["image_size"], generator=gen, device=cuda)

    def fit(module, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        c = x.shape[1]
        module.mean.copy_(x.mean(0) + 0.2 * x.std(0) * torch.randn(c, generator=gen, device=cuda))
        module.var.copy_(x.var(0) * (0.8 + 0.4 * torch.rand(c, generator=gen, device=cuda)) + 1e-3)
        module.scale.data.copy_(1 + 0.2 * torch.randn(c, generator=gen, device=cuda))
        module.bias.data.copy_(0.2 * torch.randn(c, generator=gen, device=cuda))

    with monkeypatch.context() as patch, torch.inference_mode():
        patch.setattr(dwiseneuro, "eval_bn_runs_in_dw", lambda *kernels: False)
        hooks = [m.register_forward_pre_hook(fit) for m in model.modules() if isinstance(m, BatchNorm)]
        model(inputs)  # every BN's statistics fitted, in the order the forward meets them
        for hook in hooks:
            hook.remove()
        before = dict(dw_kernels.LAUNCHES)
        chain = model(inputs)
        chain_launches = {k: dw_kernels.LAUNCHES[k] - before[k] for k in before}
    with torch.inference_mode():
        before = dict(dw_kernels.LAUNCHES)
        folded = model(inputs)
        launches = {k: dw_kernels.LAUNCHES[k] - before[k] for k in before}
    blocks = model.num_blocks
    zero = {k: 0 for k in before}
    assert chain_launches == {**zero, "dw_spatial_fwd": blocks, "dw_temporal_fwd": blocks}
    assert launches == {**zero, "dw_spatial_fwd_bn": blocks, "dw_temporal_fwd_bn": blocks}
    assert bool(torch.isfinite(chain).all()) and chain.abs().max() > 0
    assert torch.equal(folded, chain)
