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
    # Both packages on their default depthwise routes: jconv on XLA, the port on its kernels.
    monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)


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


def test_dw_spatial_fwd_serves_any_odd_k_on_the_cpu():
    """The kernel is compiled for k = 3 and 5; on the CPU the wrapper answers
    for any odd k (k = 7 here) through the plain version, as the JAX function does."""
    rng = np.random.default_rng(6)
    x, w = rand(rng, 1, 2, 9, 8, 8), rand(rng, 7, 7, 8)
    for stride in (1, 2):
        got = dw_kernels.dw_spatial_fwd(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
        pallas = np.asarray(pallas_dw.dw_spatial(jnp.asarray(x), jnp.asarray(w), stride))
        assert got.shape == pallas.shape
        np.testing.assert_allclose(got, pallas, atol=1e-5)


# (n, h, w, c, k, stride) of the spatial forward: the 6 shapes of a flagship
# chunk forward or training step (32 x 16 frames), then ragged ones and the
# edges of the kernel's tiling: H and W that are not multiples of the tiles,
# frames wider or taller than one tile, a 1x1 frame, channel tails and C wider
# than one channel tile; last, enough small frames that a block walks several.
FLAGSHIP_FWD = [(512, 64, 64, 448, 3, 2), (512, 32, 32, 448, 3, 1), (512, 32, 32, 896, 3, 2),
                (512, 16, 16, 896, 3, 1), (512, 16, 16, 1792, 3, 2), (512, 8, 8, 1792, 3, 1)]
EDGE_FWD = ([(3, h, w, 24, k, s) for h, w in ((9, 11), (33, 17), (7, 5)) for k in (3, 5) for s in (1, 2)]
            + [(3, h, w, c, 3, s) for h, w, c in ((2, 70, 24), (70, 3, 24), (1, 1, 24), (9, 11, 20), (9, 11, 22),
                                                  (10, 12, 264)) for s in (1, 2)])
WALK_FWD = [(99, 7, 5, 24, 3, 1), (99, 4, 4, 22, 3, 2), (50, 1, 1, 8, 5, 1)]


def fwd_blocks(geo: dict, n: int, oh: int):
    """Every block as the kernel walks it: (channel tile, column tile, and the
    (frame, first output row, end row) of each of its bands in order)."""
    gx, gy, gz = geo["grid"]
    band, frames, groups = geo["band"], geo["frames"], geo["groups"]
    for bx in range(gx):
        group, n0 = bx % groups, bx // groups * frames
        if frames > 1:
            bands = [(f, 0, oh) for f in range(n0, min(n0 + frames, n))]
        else:
            row0 = group * geo["bands_per_block"] * band
            row_end = min(row0 + geo["bands_per_block"] * band, oh)
            bands = [(n0, r, min(r + band, row_end)) for r in range(row0, row_end, band)]
        for ty in range(gy):
            for tz in range(gz):
                yield ty, tz, bands


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP_FWD + EDGE_FWD + WALK_FWD, ids=str)
def test_fwd_launch_geometry_fits_the_card_and_covers_y_once(shape, itemsize):
    """What ``dw_spatial_fwd`` passes to its kernel, on a card of 132 SMs:
    shared memory within the 232,448 bytes a block may use (and within a
    third of an SM's, less 1 KB per block, at the flagship shapes), a grid
    within CUDA's limits, at least 3 blocks per SM at the flagship shapes, a
    ring that holds every x row a band reads while the next band's rows
    arrive, and tiles that write every output element exactly once."""
    n, h, w, c, k, s = shape
    geo = dw_kernels.fwd_launch_geometry(n, h, w, c, k, s, itemsize, sms=132)
    assert geo["smem_bytes"] <= 232_448
    gx, gy, gz = geo["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and 1 <= gz <= 65535
    if shape in FLAGSHIP_FWD:
        assert geo["smem_bytes"] <= 233_472 // 3 - 1024
        assert gx * gy * gz >= 3 * 132
    band, cols, frames = geo["band"], geo["cols"], geo["frames"]
    oh, ow = (dw_kernels.spatial_out_size(size, k, s) for size in (h, w))
    assert cols in ((2, 4) if s == 1 else (2,)) and geo["col_tile"] % cols == 0
    frame_rows = s * (band - 1) + k  # the x rows of one band
    if frames > 1:  # one band a frame, each staged whole, the next while this one computes
        assert geo["groups"] == geo["bands_per_block"] == 1 and band >= oh
        assert geo["ring"] >= 2 * frame_rows
    else:  # the next band of the frame adds s * band rows
        assert geo["ring"] >= frame_rows + (s * band if geo["bands_per_block"] > 1 else 0)
    assert geo["tile_cols"] == s * (geo["col_tile"] - 1) + k
    vec = 16 // itemsize
    assert geo["smem_bytes"] == geo["ring"] * geo["tile_cols"] * 8 * 16 + k * k * 8 * vec * 4
    assert (gy - 1) * 8 < -(-c // vec) <= gy * 8  # vectors past C in the last channel tile are masked
    # The blocks of one channel tile (and, where a block stays in one frame,
    # of frame 0, which stand for every frame's).
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


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP_FWD + EDGE_FWD + WALK_FWD, ids=str)
def test_fwd_launch_geometry_with_the_bn_prologue_adds_a_and_b_alone(shape, itemsize):
    """With the eval BN prologue the kernel holds its channel tile's a and b
    beside the weights (two more vectors of 8 * vec floats), and the tiling
    is the plain kernel's: within a third of an SM at the flagship shapes."""
    n, h, w, c, k, s = shape
    plain = dw_kernels.fwd_launch_geometry(n, h, w, c, k, s, itemsize, sms=132)
    geo = dw_kernels.fwd_launch_geometry(n, h, w, c, k, s, itemsize, sms=132, bn=True)
    vec = 16 // itemsize
    assert geo["smem_bytes"] == geo["ring"] * geo["tile_cols"] * 8 * 16 + (k * k + 2) * 8 * vec * 4
    if shape in FLAGSHIP_FWD:
        assert geo["smem_bytes"] <= 233_472 // 3 - 1024
        assert {key: v for key, v in geo.items() if key != "smem_bytes"} == {
            key: v for key, v in plain.items() if key != "smem_bytes"}


def emulate_fwd_kernel(x: np.ndarray, w: np.ndarray, stride: int, geo: dict, vec: int, prologue=None) -> np.ndarray:
    """``dw_spatial_fwd_kernel``'s loops in numpy: each block stages the x
    rows of its bands, one band ahead, into a ring of ``geo["ring"]`` slots
    (row r of band i in slot (i * frame_rows + r + k//2) % ring when the
    block walks frames, (r + k//2) % ring otherwise; zeros outside x and past
    C). Every copy lands as soon as it is issued, so the next band's rows
    overwrite their slots before this band computes. Each unit of ``cols``
    outputs then takes its taps from the ring through the register window.
    Slots never staged hold NaN, so reading one shows. ``prologue`` (the
    eval BN prologue, elementwise): band i's new rows turn in place after
    band i + 1's are staged and before band i computes, in-frame cells only,
    as the kernel's threads turn the cells they copied."""
    n, h, wd, c = x.shape
    k = w.shape[0]
    p, s = k // 2, stride
    oh, ow = dw_kernels.spatial_out_size(h, k, s), dw_kernels.spatial_out_size(wd, k, s)
    cols, band, col_tile, ring_rows, tile_cols = (geo[key] for key in ("cols", "band", "col_tile", "ring", "tile_cols"))
    walks = geo["frames"] > 1
    base_step = s * (band - 1) + k if walks else 0
    chans = 8 * vec  # channels of a channel tile
    y = np.full((n, oh, ow, c), np.nan, np.float32)
    for ty, tz, bands in fwd_blocks(geo, n, oh):
        ch0, col0 = ty * chans, tz * col_tile
        ring = np.full((ring_rows, tile_cols, chans), np.nan, np.float32)

        def new_cells(i):
            """Band i's cells the ring does not hold yet: (x row, column, whether in the frame)."""
            f, r0, _ = bands[i]
            first = r0 * s - p if walks or i == 0 else (r0 - 1) * s + k - p
            for r in range(first, (r0 + band - 1) * s + k - p):
                for cc in range(tile_cols):
                    col = col0 * s - p + cc
                    yield r, cc, col, 0 <= r < h and 0 <= col < wd

        def stage(i):
            if i >= len(bands):
                return
            for r, cc, col, inside in new_cells(i):
                tile = np.zeros(chans, np.float32)
                if inside:
                    part = x[bands[i][0], r, col, ch0 : ch0 + chans]
                    tile[: part.shape[0]] = part
                ring[(i * base_step + r + p) % ring_rows, cc] = tile

        wt = np.zeros((k, k, chans), np.float32)
        wt[:, :, : min(chans, c - ch0)] = w[:, :, ch0 : ch0 + chans]
        stage(0)
        units_per_row = col_tile // cols
        for i, (f, r0, r1) in enumerate(bands):
            stage(i + 1)
            if prologue is not None:
                for r, cc, _, inside in new_cells(i):
                    if inside:
                        slot = (i * base_step + r + p) % ring_rows
                        ring[slot, cc] = prologue(ring[slot, cc], ch0)
            for u in range((r1 - r0) * units_per_row):
                a, cu = r0 + u // units_per_row, u % units_per_row
                b0 = col0 + cu * cols
                if b0 >= ow:
                    continue
                acc = np.zeros((cols, chans), np.float32)
                for di in range(k):
                    row = ring[(i * base_step + a * s + di) % ring_rows]
                    for j in range(s * (cols - 1) + k):
                        xv = row[cu * cols * s + j]
                        for o in range(cols):
                            if 0 <= j - s * o < k:
                                acc[o] += xv * wt[di, j - s * o]
                for o in range(min(cols, ow - b0)):
                    y[f, a, b0 + o, ch0 : ch0 + chans] = acc[o][: min(chans, c - ch0)]
    return y


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGE_FWD + WALK_FWD, ids=str)
def test_fwd_kernel_loops_emulated_match_the_plain_version(shape, itemsize, sms):
    """The kernel's bands, ring slots, double buffering, frame walking, zero halo,
    register window and channel tail, emulated in numpy from
    ``fwd_launch_geometry``, give ``dw_spatial_plain``. One SM makes each
    block walk all its frame's bands, or several small frames; 132 SMs split
    small frames into row groups."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(7)
    x, wt = rand(rng, n, h, w, c), rand(rng, k, k, c)
    geo = dw_kernels.fwd_launch_geometry(n, h, w, c, k, s, itemsize, sms=sms)
    got = emulate_fwd_kernel(x, wt, s, geo, 16 // itemsize)
    ref = dw_kernels.dw_spatial_plain(torch.from_numpy(x)[None], torch.from_numpy(wt), s)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGE_FWD + WALK_FWD, ids=str)
def test_fwd_kernel_loops_with_the_bn_prologue_emulated_match_the_chain(shape, itemsize, sms):
    """The kernel's loops with the eval BN prologue turning each band's new
    rows in place (emulated, as above, from the prologue's geometry) give
    the plain conv of the prologue's output: every in-frame x element turned
    exactly once, the halo rows a band shares with the last not again, and
    the zero padding never (the prologue maps 0 to silu(b) != 0)."""
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(8)
    x, wt = rand(rng, n, h, w, c), rand(rng, k, k, c)
    chans = 8 * (16 // itemsize)  # channels of a channel tile
    a, b = np.zeros((2, c + chans), np.float32)  # zero past C, as the kernel's a and b
    a[:c], b[:c] = 1 + 0.2 * rand(rng, c), 1.0 + 0.3 * rand(rng, c)

    def silu(z: np.ndarray) -> np.ndarray:
        return z / (1 + np.exp(-z))

    geo = dw_kernels.fwd_launch_geometry(n, h, w, c, k, s, itemsize, sms=sms, bn=True)
    got = emulate_fwd_kernel(x, wt, s, geo, 16 // itemsize,
                             lambda v, ch0: silu(v * a[ch0 : ch0 + chans] + b[ch0 : ch0 + chans]))
    act = silu(x * a[:c] + b[:c])
    ref = dw_kernels.dw_spatial_plain(torch.from_numpy(act)[None], torch.from_numpy(wt), s)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


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


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` names a new library for every source, so no
    stale build of a source that includes it is loaded."""
    for source in _build.SOURCE_DIR.iterdir():
        (tmp_path / source.name).write_bytes(source.read_bytes())
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    before = {name: _build.library_path(name) for name in ("dw_conv", "dw_conv_bwd")}
    header = tmp_path / "dw_vec.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in before}
    assert all(after[name] != before[name] for name in before)


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
