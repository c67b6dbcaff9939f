"""The temporal depthwise kernels' tiling and loops, on the CPU.

``dw_temporal_fwd`` (which with the taps reversed is also the temporal input
gradient) and ``dw_temporal_dw`` walk columns: a thread owns one 16-byte
channel vector of one (b, pixel) column and walks its T frames.
``temporal_launch_geometry`` is the one source of their tiling; here it is
checked against the card's limits, and each kernel's loops are emulated in
numpy from it and held against the plain versions and the JAX functions (the
Pallas kernels in interpret mode). The kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sensorium_tpu.ops import pallas_dw
from sensorium_tpu_torch.ops import dw_kernels

THREADS = 256  # threads a block of either kernel
MAX_SMEM_STATIC = 48 * 1024  # dynamic shared memory a block gets without an opt-in
SM_SMEM = 233_472  # shared memory of an SM, of which 1 KB a block is reserved


@pytest.fixture(autouse=True)
def jax_dw_paths(monkeypatch):
    monkeypatch.setattr(pallas_dw, "INTERPRET", True)


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# (b, t, hw, c, k): the 9 blocks' temporal convs of a flagship chunk forward
# or training step (32 x 16 frames), then the edges of the walk: T below k,
# T not a multiple of the frame tile, channel tails, C wider than a channel
# tile, and more columns than a block's lanes.
FLAGSHIP = [(32, 16, 1024, 448, 5), (32, 16, 256, 896, 5), (32, 16, 64, 1792, 5)]
EDGES = ([(2, t, 12, 24, k) for t in (1, 2, 16, 37) for k in (3, 5)]
         + [(2, 7, 12, 20, 3), (2, 7, 12, 22, 5), (2, 7, 6, 264, 3), (4, 9, 30, 16, 5)])
KERNELS = ("dw_temporal_fwd", "dw_temporal_dw")


def pad_channels(a: np.ndarray, width: int) -> np.ndarray:
    """``a`` with its last axis zero-padded to ``width``: the channels past C
    that a vector or a tile reads as zeros."""
    out = np.zeros((*a.shape[:-1], width), np.float32)
    out[..., : a.shape[-1]] = a
    return out


def fwd_threads(geo: dict, hw: int):
    """Every thread of the forward's grid that has a vector: its (batch,
    pixel, channel vector)."""
    ids = np.arange(geo["grid"][0] * THREADS)
    ids = ids[ids < geo["threads"]]
    column, cv = np.divmod(ids, geo["cvecs"])
    b, pixel = np.divmod(column, hw)
    return b, pixel, cv


def dw_blocks(geo: dict):
    """Every block of dw's grid: (slab, channel tile, and for each column lane
    the columns it walks, in order)."""
    gx, gy, _ = geo["grid"]
    for bx in range(gx):
        col0 = bx * geo["per_block"]
        col_end = min(col0 + geo["per_block"], geo["columns"])
        lanes = [range(col0 + lane, col_end, geo["lanes"]) for lane in range(geo["lanes"])]
        for ty in range(gy):
            yield bx, ty, lanes


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", FLAGSHIP + EDGES, ids=str)
@pytest.mark.parametrize("kernel", KERNELS)
def test_temporal_launch_geometry_fits_the_card_and_covers_once(kernel, shape, itemsize):
    """What the temporal wrappers pass to their kernels, on a card of 132 SMs:
    a grid within CUDA's limits; the forward one thread per (column, channel
    vector), so every output vector is written exactly once, with at least 2
    blocks per SM at the flagship shapes; dw's shared memory within what a
    block gets without an opt-in and 2 blocks an SM, runs that fill every SM
    in one wave of at most 2 blocks at the flagship shapes, one slab per run,
    and lanes that take every column exactly once."""
    b, t, hw, c, k = shape
    geo = dw_kernels.temporal_launch_geometry(kernel, b, t, hw, c, k, itemsize, sms=132)
    vec = 16 // itemsize
    assert geo["vec"] == vec and geo["cvecs"] == -(-c // vec) and geo["columns"] == b * hw
    gx, gy, gz = geo["grid"]
    assert 1 <= gx <= 2**31 - 1 and 1 <= gy <= 65535 and gz == 1
    if kernel == "dw_temporal_fwd":
        assert geo["frame_tile"] == 4 and geo["smem_bytes"] == 0 and gy == 1
        assert geo["threads"] == b * hw * geo["cvecs"] and (gx - 1) * THREADS < geo["threads"] <= gx * THREADS
        if shape in FLAGSHIP:
            assert gx >= 2 * 132
        count = np.zeros((b, hw, geo["cvecs"]), np.int32)
        np.add.at(count, fwd_threads(geo, hw), 1)
        assert (count == 1).all()
        return
    assert geo["frame_tile"] == 4 and geo["tile_vecs"] * geo["lanes"] == THREADS
    assert geo["smem_bytes"] == geo["lanes"] * k * geo["tile_vecs"] * vec * 4
    assert geo["smem_bytes"] <= MAX_SMEM_STATIC and 2 * (geo["smem_bytes"] + 1024) <= SM_SMEM
    assert (gy - 1) * geo["tile_vecs"] < geo["cvecs"] <= gy * geo["tile_vecs"]  # vectors past C are masked
    assert geo["slabs"] == gx and (gx - 1) * geo["per_block"] < geo["columns"] <= gx * geo["per_block"]
    if shape in FLAGSHIP:
        assert 132 <= gx * gy <= 2 * 132
    count = np.zeros(b * hw, np.int32)
    for _, ty, lanes in dw_blocks(geo):
        if ty == 0:
            for columns in lanes:
                count[list(columns)] += 1
    assert (count == 1).all()


def test_temporal_launch_geometry_names_its_kernel():
    with pytest.raises(ValueError, match="no temporal kernel"):
        dw_kernels.temporal_launch_geometry("dw_spatial_fwd", 1, 2, 3, 8, 3, 2, sms=132)


def walk_column(frames: np.ndarray, k: int, frame_tile: int, step) -> None:
    """The walk of a column of ``frames`` (t, ...) as both kernels take it: a
    window of the frames t-P .. t+P-1 that starts with zeros before frame 0
    and frames 0 .. P-1, frame tiles of ``frame_tile`` whose frames t+P are
    all loaded first (zeros from frame T on), then ``step(t, window, x[t+P])``
    for each frame of the tile below T, the window sliding one frame on."""
    t_len, p = frames.shape[0], k // 2
    zero = np.zeros(frames.shape[1:], np.float32)

    def load(t):
        return frames[t] if t < t_len else zero

    window = [zero] * p + [load(j) for j in range(p)]
    for t0 in range(0, t_len, frame_tile):
        raw = [load(t0 + p + j) for j in range(frame_tile)]
        for o in range(frame_tile):
            if t0 + o >= t_len:
                break
            step(t0 + o, window, raw[o])
            window = window[1:] + [raw[o]]


def emulate_temporal_fwd_kernel(x: np.ndarray, w: np.ndarray, geo: dict) -> np.ndarray:
    """``dw_temporal_fwd_walk``'s loops in numpy, all threads at once: each
    thread takes its (batch, pixel, channel vector) from its id and walks its
    column (``walk_column``); each output is the window's taps in order, then
    the entering frame's, and is written into its place once. Outputs never
    written hold NaN, so a gap shows."""
    b, t, hw, c = x.shape
    k, vec, cvecs = w.shape[0], geo["vec"], geo["cvecs"]
    bi, pixel, cv = fwd_threads(geo, hw)
    columns = pad_channels(x, cvecs * vec).reshape(b, t, hw, cvecs, vec)[bi, :, pixel, cv]  # (threads, t, vec)
    taps = pad_channels(w, cvecs * vec).reshape(k, cvecs, vec)[:, cv]  # (k, threads, vec)
    y = np.full((len(cv), t, vec), np.nan, np.float32)

    def step(tt, window, entering):
        acc = np.zeros(entering.shape, np.float32)
        for dt in range(k - 1):
            acc += window[dt] * taps[dt]
        acc += entering * taps[k - 1]
        y[:, tt] = acc

    walk_column(columns.transpose(1, 0, 2), k, geo["frame_tile"], step)
    out = np.full((b, t, hw, cvecs, vec), np.nan, np.float32)
    out[bi, :, pixel, cv] = y
    return out.reshape(b, t, hw, cvecs * vec)[..., :c]


def emulate_temporal_dw_kernel(x: np.ndarray, dy: np.ndarray, k: int, geo: dict) -> np.ndarray:
    """``dw_temporal_dw_walk``'s loops in numpy, then ``sum_slabs``: each lane
    of a block walks its columns in turn (``walk_column``), adding
    x[t+dt-P] * dy[t] into its k sums over the block's channel tile; the block
    adds its lanes in order into its slab, and the slabs are added in order.
    Workspace entries never written hold NaN, so a gap shows."""
    b, t, hw, c = x.shape
    chans = geo["tile_vecs"] * geo["vec"]
    width = geo["grid"][1] * chans
    xs = pad_channels(x, width).reshape(b * t, hw, width)
    dys = pad_channels(dy, width).reshape(b * t, hw, width)
    ws = np.full((geo["slabs"], k, c), np.nan, np.float32)
    for slab, ty, lanes in dw_blocks(geo):
        ch0 = ty * chans
        part = np.zeros((geo["lanes"], k, chans), np.float32)
        for lane, columns in enumerate(lanes):
            for column in columns:
                bi, pixel = divmod(column, hw)
                frames = slice(bi * t, (bi + 1) * t)
                dyc = dys[frames, pixel, ch0 : ch0 + chans]

                def step(tt, window, entering, dyc=dyc, acc=part[lane]):
                    for dt in range(k - 1):
                        acc[dt] += window[dt] * dyc[tt]
                    acc[k - 1] += entering * dyc[tt]

                walk_column(xs[frames, pixel, ch0 : ch0 + chans], k, geo["frame_tile"], step)
        total = np.zeros((k, chans), np.float32)
        for lane in range(geo["lanes"]):
            total += part[lane]
        valid = min(chans, c - ch0)
        ws[slab, :, ch0 : ch0 + valid] = total[:, :valid]
    out = np.zeros((k, c), np.float32)
    for slab in range(geo["slabs"]):
        out += ws[slab]
    return out


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGES, ids=str)
def test_temporal_fwd_kernel_loops_emulated_match_the_plain_version(shape, itemsize, sms):
    """The forward's thread layout, frame tiles, window, zero ends and channel
    tails, emulated in numpy from ``temporal_launch_geometry``, give
    ``dw_temporal_plain``; with the taps reversed, the plain input gradient."""
    b, t, hw, c, k = shape
    rng = np.random.default_rng(80)
    x, w, dy = rand(rng, b, t, hw, c), rand(rng, k, c), rand(rng, b, t, hw, c)
    geo = dw_kernels.temporal_launch_geometry("dw_temporal_fwd", b, t, hw, c, k, itemsize, sms=sms)
    got = emulate_temporal_fwd_kernel(x, w, geo)
    ref = dw_kernels.dw_temporal_plain(torch.from_numpy(x)[:, :, None], torch.from_numpy(w))[:, :, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    got_dx = emulate_temporal_fwd_kernel(dy, np.ascontiguousarray(w[::-1]), geo)
    xt = torch.from_numpy(x)[:, :, None].requires_grad_()
    dw_kernels.dw_temporal(xt, torch.from_numpy(w)).backward(torch.from_numpy(dy)[:, :, None])
    np.testing.assert_allclose(got_dx, xt.grad[:, :, 0].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", EDGES, ids=str)
def test_temporal_dw_kernel_loops_emulated_match_the_plain_version(shape, itemsize, sms):
    """dw's runs of columns, lanes, frame tiles, window, zero ends, channel
    tails, per-lane sums and the fixed-order slab sum, emulated in numpy from
    ``temporal_launch_geometry``, give ``dw_temporal_dw_plain``. One SM gives
    a block many columns, which its lanes walk in turn; 132 SMs give most
    blocks one column."""
    b, t, hw, c, k = shape
    rng = np.random.default_rng(81)
    x, dy = rand(rng, b, t, hw, c), rand(rng, b, t, hw, c)
    geo = dw_kernels.temporal_launch_geometry("dw_temporal_dw", b, t, hw, c, k, itemsize, sms=sms)
    got = emulate_temporal_dw_kernel(x, dy, k, geo)
    ref = dw_kernels.dw_temporal_dw_plain(torch.from_numpy(x)[:, :, None], torch.from_numpy(dy)[:, :, None], k)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [3, 5])
def test_temporal_kernel_loops_emulated_match_jax(k):
    """T not a multiple of the frame tile and a channel tail: the emulated
    forward, input gradient (the forward with the taps reversed) and weight
    gradient against ``pallas_dw.dw_temporal`` and its VJP, the Pallas kernels
    in interpret mode."""
    rng = np.random.default_rng(82)
    b, t, h, wd, c = 2, 11, 3, 4, 20
    x, w, dy = rand(rng, b, t, h, wd, c), rand(rng, k, c), rand(rng, b, t, h, wd, c)
    y, vjp = jax.vjp(pallas_dw.dw_temporal, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    flat = (b, t, h * wd, c)
    fwd = dw_kernels.temporal_launch_geometry("dw_temporal_fwd", b, t, h * wd, c, k, 2, sms=132)
    dwg = dw_kernels.temporal_launch_geometry("dw_temporal_dw", b, t, h * wd, c, k, 2, sms=132)
    got_y = emulate_temporal_fwd_kernel(x.reshape(flat), w, fwd).reshape(x.shape)
    got_dx = emulate_temporal_fwd_kernel(dy.reshape(flat), np.ascontiguousarray(w[::-1]), fwd).reshape(x.shape)
    got_dw = emulate_temporal_dw_kernel(x.reshape(flat), dy.reshape(flat), k, dwg)
    np.testing.assert_allclose(got_y, np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(got_dx, jdx, atol=1e-4)
    np.testing.assert_allclose(got_dw, jdw, atol=1e-4)


def test_temporal_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor, which no kernel takes, raises instead of taking the plain path."""
    x = torch.zeros(1, 2, 4, 4, 8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dw_kernels.dw_temporal_fwd(x, torch.zeros(3, 8, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        dw_kernels.dw_temporal_dw(x, x, 5)
