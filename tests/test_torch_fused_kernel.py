"""The tiling and the loops of the fused BN-apply + SiLU + depthwise kernel
(``csrc/fused_bn_silu_dw.cu``, row 7 of the kernel table), on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py``). Here
``fused_launch_geometry``, the one source of its tiling, is held to the
card's limits and to covering every output once, and a numpy emulation of the
kernel's loops, driven by that geometry, is held against the plain version
and against ``sensorium_tpu.ops.pallas_fused.fused_bn_silu_dw_spatial`` in
interpret mode (fp32, rtol/atol 1e-5, the tolerance of
``tests/test_pallas_fused.py``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sensorium_tpu.ops.pallas_fused as jfused
from sensorium_tpu_torch.ops import dw_kernels
from tests.test_torch_ops import EDGE_FWD, FLAGSHIP_FWD, WALK_FWD, fwd_blocks

# (n, h, w, c, k, stride): the two shapes of dwbench that the model does not
# run (its blocks 4 and 7 at half the model's channels).
DWBENCH_ONLY = [(512, 32, 32, 448, 3, 2), (512, 16, 16, 896, 3, 2)]
SMEM_PER_BLOCK = 232_448


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jfused, "INTERPRET", True)


def affine(rng, c: int, dead: bool):
    scale = rng.normal(1, 0.2, c).astype(np.float32)
    shift = rng.normal(0, 0.2, c).astype(np.float32)
    if dead:  # a dead BN: scale 0, shift != 0, whose activation silu(1) is not 0 at the padding
        scale[c // 2 :] = 0.0
        shift[c // 2 :] = 1.0
    return scale, shift


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP_FWD + DWBENCH_ONLY + EDGE_FWD + WALK_FWD, ids=str)
def test_fused_launch_geometry_fits_the_card_and_covers_y_once(shape, itemsize):
    """What ``fused_bn_silu_dw_spatial`` passes to its kernel, on a card of
    132 SMs: shared memory within the 232,448 bytes a block may use, and
    within an SM's share for the blocks per SM its registers are capped for
    (3, but 2 for bf16 at stride 2 and at k = 5), counted as the launcher
    counts it; a grid within CUDA's limits, with that many blocks per SM at
    the flagship and dwbench shapes; rings that hold every x row a band
    reads; and tiles that write every output element exactly once."""
    n, h, w, c, k, s = shape
    geo = dw_kernels.fused_launch_geometry(n, h, w, c, k, s, itemsize, sms=132)
    vec = 16 // itemsize
    assert geo["smem_bytes"] <= SMEM_PER_BLOCK
    blocks = 2 if k == 5 or (itemsize == 2 and s == 2) else 3
    assert geo["smem_bytes"] <= 233_472 // blocks - 1024
    assert geo["smem_bytes"] == geo["ring"] * geo["tile_cols"] * 8 * (vec * 4 + 16) + (k * k + 2) * 8 * vec * 4
    gx, gy, gz = geo["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if shape in FLAGSHIP_FWD + DWBENCH_ONLY:
        assert gx * gy * gz >= blocks * 132
    band, cols, frames = geo["band"], geo["cols"], geo["frames"]
    oh, ow = (dw_kernels.spatial_out_size(size, k, s) for size in (h, w))
    assert cols in ((2, 4) if s == 1 else (2,)) and geo["col_tile"] % cols == 0
    assert geo["ring"] == s * (band - 1) + k  # the x rows of one band; the next band adds s * band of them
    assert geo["tile_cols"] == s * (geo["col_tile"] - 1) + k
    if frames > 1:
        assert geo["groups"] == geo["bands_per_block"] == 1 and band >= oh
    assert (gy - 1) * 8 < -(-c // vec) <= gy * 8
    count = np.zeros((n if frames > 1 else 1, oh, ow), np.int32)
    units_per_row = geo["col_tile"] // cols
    for ty, tz, bands in fwd_blocks(geo, n, oh):
        for f, r0, r1 in bands:
            if ty > 0 or f >= len(count):
                continue
            for u in range((r1 - r0) * units_per_row):
                a, b0 = r0 + u // units_per_row, tz * geo["col_tile"] + u % units_per_row * cols
                count[f, a, b0 : min(b0 + cols, ow)] += 1
    assert (count == 1).all()
    assert gx == (-(-n // frames)) * geo["groups"]


def emulate_fused_kernel(x, scale, shift, w, stride: int, geo: dict, vec: int) -> np.ndarray:
    """``fused_bn_silu_dw_kernel``'s loops in numpy. Each block holds two
    rings of the ``ring`` x rows a band reads, raw and fp32 activations, with
    row r in slot (r + k//2) % ring of both. At the top of a band it turns
    the band's new rows, landed in the raw ring, into activations, once per
    element, with zeros outside the frame (and past C, where scale, shift and
    x are 0); the rows a band shares with the last one stay in the activation
    ring. Then it copies the next band's new rows raw into the raw ring
    (zeros outside x and past C) and computes this band: each unit of
    ``cols`` outputs takes its taps from the activation ring through the
    register window. Slots never written hold NaN, and a raw slot is NaN
    again once it has been turned into activations, so reading a slot twice,
    or one never staged, shows."""
    n, h, wd, c = x.shape
    k = w.shape[0]
    p, s = k // 2, stride
    oh, ow = dw_kernels.spatial_out_size(h, k, s), dw_kernels.spatial_out_size(wd, k, s)
    cols, band, col_tile, ring_rows, tile_cols = (geo[key] for key in ("cols", "band", "col_tile", "ring", "tile_cols"))
    walks = geo["frames"] > 1
    chans = 8 * vec  # channels of a channel tile
    y = np.full((n, oh, ow, c), np.nan, np.float32)
    for ty, tz, bands in fwd_blocks(geo, n, oh):
        ch0, col0 = ty * chans, tz * col_tile
        valid = min(chans, c - ch0)
        landing = np.full((ring_rows, tile_cols, chans), np.nan, np.float32)
        act = np.full((ring_rows, tile_cols, chans), np.nan, np.float32)
        a, b, wt = np.zeros(chans, np.float32), np.zeros(chans, np.float32), np.zeros((k, k, chans), np.float32)
        a[:valid], b[:valid] = scale[ch0 : ch0 + chans], shift[ch0 : ch0 + chans]
        wt[:, :, :valid] = w[:, :, ch0 : ch0 + chans]

        def new_rows(i):
            _, r0, _ = bands[i]
            first = r0 * s - p if walks or i == 0 else (r0 - 1) * s + k - p
            return range(first, (r0 + band - 1) * s + k - p)

        def stage(i):
            if i >= len(bands):
                return
            f = bands[i][0]
            for r in new_rows(i):
                for cc in range(tile_cols):
                    col = col0 * s - p + cc
                    tile = np.zeros(chans, np.float32)
                    if 0 <= r < h and 0 <= col < wd:
                        tile[:valid] = x[f, r, col, ch0 : ch0 + chans]
                    landing[(r + p) % ring_rows, cc] = tile

        def turn(i):
            if i >= len(bands):
                return
            for r in new_rows(i):
                slot = (r + p) % ring_rows
                for cc in range(tile_cols):
                    col = col0 * s - p + cc
                    raw = landing[slot, cc].copy()
                    assert not np.isnan(raw).any(), "a landing slot read before it was staged, or twice"
                    landing[slot, cc] = np.nan
                    if 0 <= r < h and 0 <= col < wd:
                        v = raw * a + b
                        with np.errstate(over="ignore"):
                            act[slot, cc] = v / (np.float32(1) + np.exp(-v))
                    else:
                        act[slot, cc] = 0.0

        stage(0)
        units_per_row = col_tile // cols
        for i, (f, r0, r1) in enumerate(bands):
            turn(i)
            stage(i + 1)
            for u in range((r1 - r0) * units_per_row):
                row, cu = r0 + u // units_per_row, u % units_per_row
                b0 = col0 + cu * cols
                if b0 >= ow:
                    continue
                acc = np.zeros((cols, chans), np.float32)
                for di in range(k):
                    window = act[(row * s + di) % ring_rows]
                    for j in range(s * (cols - 1) + k):
                        xv = window[cu * cols * s + j]
                        for o in range(cols):
                            if 0 <= j - s * o < k:
                                acc[o] += xv * wt[di, j - s * o]
                for o in range(min(cols, ow - b0)):
                    y[f, row, b0 + o, ch0 : ch0 + chans] = acc[o][:valid]
    return y


def jax_fused(x, scale, shift, w, stride):
    return np.asarray(jfused.fused_bn_silu_dw_spatial(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(w), stride))


def plain(x, scale, shift, w, stride):
    return dw_kernels.fused_bn_silu_dw_spatial_plain(
        *(torch.from_numpy(a) for a in (x[None], scale, shift, w)), stride)[0].numpy()


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGE_FWD + WALK_FWD, ids=str)
def test_fused_kernel_loops_emulated_match_the_plain_version(shape, itemsize, sms):
    """The kernel's bands, both rings and their slots, the prologue once per
    staged element, the carried halo rows, frame walking, the in-frame mask
    and the channel tail, emulated from ``fused_launch_geometry``, give
    ``fused_bn_silu_dw_spatial_plain``, with half the channels dead. One SM
    makes each block walk all its frame's bands, or several small frames;
    132 SMs split small frames into row groups."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(31)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    scale, shift = affine(rng, c, dead=True)
    wt = rng.normal(0, 0.5, (k, k, c)).astype(np.float32)
    geo = dw_kernels.fused_launch_geometry(n, h, w, c, k, s, itemsize, sms=sms)
    got = emulate_fused_kernel(x, scale, shift, wt, s, geo, 16 // itemsize)
    np.testing.assert_allclose(got, plain(x, scale, shift, wt, s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("shape", [(3, 9, 11, 24, k, s) for k in (3, 5) for s in (1, 2)]
                         + [(3, 7, 5, 20, 3, 1), (6, 4, 4, 22, 3, 2)], ids=str)
def test_fused_kernel_loops_emulated_match_pallas(shape, dead):
    """The same emulation against the JAX package's Pallas kernel in
    interpret mode, k = 3 and 5 at both strides, channel tails, with and
    without dead channels (scale 0, shift 1)."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(32)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    scale, shift = affine(rng, c, dead)
    wt = rng.normal(0, 0.5, (k, k, c)).astype(np.float32)
    geo = dw_kernels.fused_launch_geometry(n, h, w, c, k, s, 2, sms=1)
    got = emulate_fused_kernel(x, scale, shift, wt, s, geo, 8)
    np.testing.assert_allclose(got, jax_fused(x[None], scale, shift, wt, s)[0], rtol=1e-5, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(2, 32, 32, 448, 3, 1), (2, 64, 64, 448, 3, 2), (2, 8, 8, 1792, 3, 1)], ids=str)
def test_fused_kernel_loops_emulated_at_flagship_frames(shape):
    """Two frames at a flagship block's size and width, tiled as for the
    flagship batch's 512 frames on 132 SMs, emulated against the plain version."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(33)
    x = rng.normal(0, 1, (n, h, w, c)).astype(np.float32)
    scale, shift = affine(rng, c, dead=True)
    wt = rng.normal(0, 0.5, (k, k, c)).astype(np.float32)
    flagship = dw_kernels.fused_launch_geometry(512, h, w, c, k, s, 2, sms=132)
    geo = dict(flagship, grid=(-(-n // flagship["frames"]) * flagship["groups"], *flagship["grid"][1:]))
    got = emulate_fused_kernel(x, scale, shift, wt, s, geo, 8)
    np.testing.assert_allclose(got, plain(x, scale, shift, wt, s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_wrapper_serves_any_odd_k_on_the_cpu(stride):
    """The kernel is compiled for k = 3 and 5; on the CPU the wrapper answers
    for k = 7 through the plain version, as the Pallas kernel does."""
    rng = np.random.default_rng(34)
    x = rng.normal(0, 1, (1, 2, 9, 8, 8)).astype(np.float32)
    scale, shift = affine(rng, 8, dead=True)
    wt = rng.normal(0, 0.5, (7, 7, 8)).astype(np.float32)
    before = dict(dw_kernels.LAUNCHES)
    got = dw_kernels.fused_bn_silu_dw_spatial(*(torch.from_numpy(a) for a in (x, scale, shift, wt)), stride).numpy()
    assert dw_kernels.LAUNCHES == before
    want = jax_fused(x, scale, shift, wt, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
