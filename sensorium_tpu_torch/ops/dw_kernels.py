"""Depthwise-conv kernels (CUDA, ``csrc/dw_conv.cu``, ``csrc/dw_conv_bwd.cu`` and
``csrc/fused_bn_silu_dw.cu``), their plain versions, and the autograd
Functions that join them.

Counterpart of ``sensorium_tpu/ops/pallas_dw.py`` and
``sensorium_tpu/ops/pallas_fused.py``. Layout is channels-last:

* ``dw_spatial_fwd(x, w, stride)``: x (B, T, H, W, C), w (k, k, C), stride 1
  or 2, torch "same" padding k // 2, output (B, T, OH, OW, C) with
  OH = (H + 2 * (k // 2) - k) // stride + 1;
* ``dw_temporal_fwd(x, w)``: x (B, T, H, W, C), w (k, C) with k odd, "same"
  padding over T;
* ``dw_spatial_fwd_bn(x, w, mean, var, scale, bias, eps, stride)`` and
  ``dw_temporal_fwd_bn(x, w, mean, var, scale, bias, eps)``: the same convs of
  an eval BN with its SiLU (``bn_kernels.bn_act_eval`` of x with the running
  statistics and parameters, fp32 (C,)), bitwise that chain, with the BN run
  inside the conv's kernel as its input prologue, so that its output is never
  written. The served forward's ``pw_bn`` and ``spatial_bn`` run so
  (``models/dwiseneuro.py``). Forward only, like the eval BN;
* ``dw_spatial_dx(dy, w, stride, hw)``: the input gradient of the spatial
  conv, (B, T, H, W, C) in dy's dtype;
* ``dw_spatial_dw(x, dy, k, stride)`` and ``dw_temporal_dw(x, dy, k)``: the
  weight gradients, (k, k, C) and (k, C) in fp32. The temporal input
  gradient is ``dw_temporal_fwd(dy, w.flip(0))`` (odd k);
* ``fused_bn_silu_dw_spatial(x, scale, shift, w, stride)``: the spatial conv
  of ``silu(x * scale + shift)``, with scale and shift (C,) fp32, the folded
  BN affine (``scale = gamma * rsqrt(var + eps)``, ``shift = beta - mean *
  scale``). The padding is zero *after* the prologue, and the prologue stays
  in fp32: only the conv output is rounded to x's dtype, once. (An eager
  chain that casts ``silu(...)`` back to bf16 before the conv differs from it
  by that one rounding.) Forward only, with no autograd Function, as in JAX.

``DwSpatial`` and ``DwTemporal`` are the autograd Functions: each saves
``(x, w)`` as the JAX custom VJPs do, and returns dx in x's dtype and dw
rounded to w's dtype.

Each kernel is also the ``torch.library`` custom op ``sensorium::<name>``
(``dw_spatial_dx`` takes ``h`` and ``wd`` for ``hw``), with a CUDA
implementation that launches the kernel, a CPU one that is the plain version
and a fake one that gives the output's shape and dtype, so that a traced
graph (``torch.export``) holds it; importing this module registers them. A
wrapper checks its operands and calls its op: given CPU tensors it computes
the plain version; given CUDA tensors it launches the kernel on the current
stream or raises; it never falls back. ``LAUNCHES`` counts the launches of
the kernels, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sensorium_tpu_torch.ops import _build, bn_kernels

LAUNCHES = {name: 0 for name in ("dw_spatial_fwd", "dw_temporal_fwd", "dw_spatial_dx", "dw_spatial_dw",
                                 "dw_temporal_dw", "fused_bn_silu_dw_spatial", "dw_spatial_fwd_bn",
                                 "dw_temporal_fwd_bn")}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT32_MAX = 2**31 - 1
_ENTRIES: dict[str, ctypes._CFuncPtr] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_BN = (_P, _P, _P, _P, ctypes.c_double)  # the prologue's mean, var, scale and bias, then eps
# Entry point -> (library, its arguments before the stream).
_SIGNATURES = {
    "dw_spatial_fwd": ("dw_conv", (_P,) * 3 + (_I,) * 12),
    "dw_temporal_fwd": ("dw_conv", (_P,) * 3 + (_I,) * 6),
    "dw_spatial_dx": ("dw_conv_bwd", (_P,) * 3 + (_I,) * 10),
    "dw_spatial_dw": ("dw_conv_bwd", (_P,) * 4 + (_I,) * 12),
    "dw_temporal_dw": ("dw_conv_bwd", (_P,) * 4 + (_I,) * 9),
    "fused_bn_silu_dw_spatial": ("fused_bn_silu_dw", (_P,) * 5 + (_I,) * 12),
    "dw_spatial_fwd_bn": ("dw_conv", (_P,) * 3 + _BN + (_I,) * 12),
    "dw_temporal_fwd_bn": ("dw_conv", (_P,) * 3 + _BN + (_I,) * 6),
}
# Kernel sizes the spatial and temporal kernels are compiled for.
COMPILED_KS = (3, 5)
# The temporal column walks (dw_conv.cu dw_temporal_fwd_walk, dw_conv_bwd.cu
# dw_temporal_dw_walk): threads per block, one 16-byte channel vector of one
# column each; the frames whose loads a thread starts together (dw_vec.cuh
# kTemporalFrameTile); dw's channel vectors per block and column lanes, and
# the blocks per SM its registers are capped for, which its runs fill in one
# wave.
_TEMPORAL_THREADS = 256
_TEMPORAL_FRAME_TILE = 4
_TEMPORAL_DW_TILE_VECS, _TEMPORAL_DW_LANES = 8, 32
_TEMPORAL_DW_BLOCKS_PER_SM = 2
# dw_spatial_dx_kernel (dw_conv_bwd.cu, 256 threads a block): 16-byte channel
# vectors per block; output steps per band (four for each of the block's 32
# position lanes) and column steps per block; blocks per SM that the row
# groups aim for.
_DX_TILE_VECS = 8
_DX_POSITIONS, _DX_MAX_COL_TILE = 128, 32
_DX_BLOCKS_PER_SM = 4
# dw_spatial_fwd_kernel (dw_conv.cu, 256 threads a block): 16-byte channel
# vectors per block and position lanes; output columns per block at most; the
# blocks per SM its tiles and registers are sized for (k = 3), and the shared
# memory that leaves a block: an SM's 233,472 bytes, less 1 KB reserved per block.
_FWD_TILE_VECS, _FWD_LANES = 8, 32
_FWD_MAX_COL_TILE = 32
_FWD_BLOCKS_PER_SM = 3
_FWD_SMEM_BUDGET = 233_472 // _FWD_BLOCKS_PER_SM - 1024
# Where a band holds a whole frame, a block walks 2 frames if that leaves at
# least this many blocks per SM.
_FWD_WALK_MIN_BLOCKS = 24
# dw_spatial_dw_kernel (dw_conv_bwd.cu): 16-byte channel vectors per block;
# tap-row groups by k (k = 3: a thread holds all 9 taps' accumulators; k = 5:
# 5 groups of lanes, one tap row each), each group of 32 / groups position
# lanes; units (W adjacent outputs of one row) per band, about; the units of
# 4 outputs a frame must have for W = 4 at stride 1 (the 8x8 frames of block
# 8 take it, half the lanes idle, for fewer conversions); output columns per
# block at most; the blocks per SM its registers are capped for, and the
# shared memory that leaves a block.
_DW_TILE_VECS = 8
_DW_TAP_GROUPS = {3: 1, 5: 5}
_DW_UNITS = 32
_DW_W4_UNITS = 16
_DW_MAX_COL_TILE = 32
_DW_BLOCKS_PER_SM = 2
_DW_SMEM_BUDGET = 233_472 // _DW_BLOCKS_PER_SM - 1024
# Shared memory a block can use on Hopper, and CUDA's grid limits.
_MAX_SMEM_BYTES = 232_448
_MAX_GRID = (_INT32_MAX, 65535, 65535)


def spatial_out_size(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dx_launch_geometry(n: int, h: int, wd: int, c: int, k: int, stride: int, itemsize: int, sms: int) -> dict:
    """The tiling of ``dw_spatial_dx_kernel`` for ``n`` frames of dx (h, wd, c).

    A step is one dx row (column) at stride 1 and two at stride 2, fed by dy
    row (column) a and its halo; there are as many steps as dy has rows
    (columns). A block owns a group of one frame's row steps, 8 channel
    vectors of 16 bytes and ``col_tile`` column steps; it walks its row steps
    ``band`` at a time and holds the dy rows they read in a ring of ``ring``
    rows in shared memory.
    Row groups split a frame only where the frames alone give fewer than
    ``_DX_BLOCKS_PER_SM`` blocks per SM. The kernel takes ``band``,
    ``col_tile``, ``bands_per_block`` and ``smem_bytes`` and derives the rest.
    """
    vec = 16 // itemsize
    pad = k // 2
    lo, hi = pad // stride, _cdiv(pad, stride)
    rows, cols = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    col_tile = min(cols, _DX_MAX_COL_TILE)
    band = max(1, min(rows, _cdiv(_DX_POSITIONS, col_tile)))
    bands = _cdiv(rows, band)
    channel_tiles, col_tiles = _cdiv(_cdiv(c, vec), _DX_TILE_VECS), _cdiv(cols, col_tile)
    groups = min(bands, max(1, _cdiv(_DX_BLOCKS_PER_SM * sms, n * channel_tiles * col_tiles)))
    bands_per_block = _cdiv(bands, groups)
    groups = _cdiv(bands, bands_per_block)
    ring = (2 * band if bands_per_block > 1 else band) + lo + hi
    return {
        "lo": lo,
        "hi": hi,
        "band": band,
        "col_tile": col_tile,
        "bands_per_block": bands_per_block,
        "groups": groups,
        "ring": ring,
        "grid": (n * groups, channel_tiles, col_tiles),
        "smem_bytes": ring * (col_tile + lo + hi) * _DX_TILE_VECS * 16,
    }


def _fit_tiles(rows: int, out_cols: int, cols: int, units: int, max_col_tile: int, budget: int, tiling) -> dict:
    """``tiling(col_tile, band)`` of the widest column tile (at most
    ``max_col_tile``, a multiple of ``cols``) and a band of about ``units``
    units of ``cols`` outputs whose shared memory fits ``budget`` bytes: the
    column tile halves first, then the band. The forward and the weight
    gradient stage the same x rows for their bands and tile them alike."""
    col_tile = min(_cdiv(out_cols, cols) * cols, max_col_tile)
    band = max(1, min(rows, _cdiv(units, col_tile // cols)))
    geo = tiling(col_tile, band)
    while geo["smem_bytes"] > budget and (col_tile > cols or band > 1):
        if col_tile > cols:
            col_tile = _cdiv(col_tile // 2, cols) * cols
            band = max(1, min(rows, _cdiv(units, col_tile // cols)))
        else:
            band = _cdiv(band, 2)
        geo = tiling(col_tile, band)
    return geo


def _band_walk(n: int, rows: int, band: int, channel_tiles: int, col_tiles: int, blocks_per_sm: int,
               sms: int) -> dict:
    """How the blocks of ``dw_spatial_fwd`` and ``fused_bn_silu_dw_spatial``
    walk their bands of ``band`` output rows: where a band holds a whole frame
    and the frames give enough blocks, one band in each of ``frames`` (2)
    frames; otherwise the bands of a group of one frame's rows, with row
    groups only where the frames alone give fewer than ``blocks_per_sm``
    blocks per SM."""
    bands = _cdiv(rows, band)
    walk = bands == 1 and _cdiv(n, 2) * channel_tiles * col_tiles >= _FWD_WALK_MIN_BLOCKS * sms
    frames = 2 if walk else 1
    groups = min(bands, max(1, _cdiv(blocks_per_sm * sms, n * channel_tiles * col_tiles)))
    bands_per_block = _cdiv(bands, groups)
    groups = _cdiv(bands, bands_per_block)
    return {"frames": frames, "bands_per_block": bands_per_block, "groups": groups,
            "grid": (_cdiv(n, frames) * groups, channel_tiles, col_tiles)}


def _fwd_cols(stride: int, rows: int, out_cols: int) -> int:
    """Outputs a thread computes along a row: 2 at stride 2, 4 at stride 1
    unless a frame then has fewer units than a block has lanes."""
    return 4 if stride == 1 and rows * _cdiv(out_cols, 4) >= _FWD_LANES else 2


def fwd_launch_geometry(n: int, h: int, wd: int, c: int, k: int, stride: int, itemsize: int, sms: int,
                        bn: bool = False) -> dict:
    """The tiling of ``dw_spatial_fwd_kernel`` for ``n`` frames of x (h, wd, c).

    A thread computes ``cols`` adjacent outputs of one row (a unit): 2 at
    stride 2, 4 at stride 1 unless a frame then has fewer units than a block
    has lanes. A block owns 8 channel vectors of 16 bytes and ``col_tile``
    output columns, and walks a sequence of bands of ``band`` output rows,
    about one unit per lane a band: the bands of a group of one frame's rows,
    or, where a band holds a whole frame and the frames give enough blocks,
    one band in each of ``frames`` (2) frames. It stages the x rows of a band
    (``stride * (band - 1) + k`` of them; the next band of the same frame
    adds ``stride * band``) while the last band computes, in a ring of
    ``ring`` rows of ``stride * (col_tile - 1) + k`` columns in shared
    memory, beside the block's weights in fp32 (and, with the eval BN
    prologue, ``bn``, its channels' a and b). The column tile, then the
    band, shrink until 3 blocks fit an SM's shared memory. Row groups split
    a frame only where the frames alone give fewer than 3 blocks per SM. The
    kernel takes ``band``, ``col_tile``, ``cols``, ``frames``,
    ``bands_per_block`` and ``smem_bytes`` and derives the rest.
    """
    vec = 16 // itemsize
    rows, out_cols = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    cols = _fwd_cols(stride, rows, out_cols)
    weight_bytes = (k * k + (2 if bn else 0)) * _FWD_TILE_VECS * vec * 4
    channel_tiles = _cdiv(_cdiv(c, vec), _FWD_TILE_VECS)

    def tiling(col_tile: int, band: int) -> dict:
        walk = _band_walk(n, rows, band, channel_tiles, _cdiv(out_cols, col_tile), _FWD_BLOCKS_PER_SM, sms)
        frame_rows = stride * (band - 1) + k
        # A band, and the next one if the block walks on.
        held = 2 if max(walk["frames"], walk["bands_per_block"]) > 1 else 1
        ring = held * frame_rows if walk["frames"] > 1 else stride * (held * band - 1) + k
        tile_cols = stride * (col_tile - 1) + k
        return {
            "cols": cols,
            "band": band,
            "col_tile": col_tile,
            **walk,
            "ring": ring,
            "tile_cols": tile_cols,
            "smem_bytes": ring * tile_cols * _FWD_TILE_VECS * 16 + weight_bytes,
        }

    return _fit_tiles(rows, out_cols, cols, _FWD_LANES, _FWD_MAX_COL_TILE, _FWD_SMEM_BUDGET, tiling)


def _fused_blocks_per_sm(k: int, stride: int, itemsize: int) -> int:
    """The blocks per SM that ``fused_bn_silu_dw_kernel``'s registers are
    capped for (its launch bounds): 3, but 2 at k = 5 and for bf16 at stride
    2, whose prologue pass is the longest."""
    return 2 if k == 5 or (itemsize == 2 and stride == 2) else 3


def fused_launch_geometry(n: int, h: int, wd: int, c: int, k: int, stride: int, itemsize: int, sms: int) -> dict:
    """The tiling of ``fused_bn_silu_dw_kernel`` for ``n`` frames of x (h, wd, c).

    Units, bands, column and channel tiles, frame walking and row groups are
    the forward's (``fwd_launch_geometry``). The block holds the ``ring =
    stride * (band - 1) + k`` x rows a band reads, of ``tile_cols = stride *
    (col_tile - 1) + k`` columns, twice in shared memory: raw, where the next
    band's new rows land while this band computes, and as fp32 activations
    (``silu(x * scale + shift)``, made once per element at the top of the
    band), beside its weights, scale and shift in fp32. The column tile, then
    the band, shrink until ``_fused_blocks_per_sm`` blocks (``blocks``) fit
    an SM's shared memory. The kernel takes ``band``, ``col_tile``,
    ``cols``, ``frames``, ``bands_per_block`` and ``smem_bytes`` and derives
    the rest.
    """
    vec = 16 // itemsize
    blocks = _fused_blocks_per_sm(k, stride, itemsize)
    rows, out_cols = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    cols = _fwd_cols(stride, rows, out_cols)
    fixed_bytes = (k * k + 2) * _FWD_TILE_VECS * vec * 4  # weights, scale and shift
    channel_tiles = _cdiv(_cdiv(c, vec), _FWD_TILE_VECS)

    def tiling(col_tile: int, band: int) -> dict:
        walk = _band_walk(n, rows, band, channel_tiles, _cdiv(out_cols, col_tile), blocks, sms)
        ring = stride * (band - 1) + k
        tile_cols = stride * (col_tile - 1) + k
        return {
            "cols": cols,
            "band": band,
            "col_tile": col_tile,
            **walk,
            "ring": ring,
            "tile_cols": tile_cols,
            "smem_bytes": ring * tile_cols * _FWD_TILE_VECS * (vec * 4 + 16) + fixed_bytes,
        }

    budget = 233_472 // blocks - 1024  # an SM's shared memory, less 1 KB reserved per block
    return _fit_tiles(rows, out_cols, cols, _FWD_LANES, _FWD_MAX_COL_TILE, budget, tiling)


def dw_launch_geometry(n: int, h: int, wd: int, c: int, k: int, stride: int, itemsize: int, sms: int) -> dict:
    """The tiling of ``dw_spatial_dw_kernel`` for ``n`` frames of x (h, wd, c)
    and their dy.

    A unit is ``cols`` adjacent outputs of one row: 2 at stride 2, 4 at
    stride 1 unless a frame then has fewer than 16 units. The (frame, band)
    items, a band being ``band`` output rows of one frame, are cut into runs
    of ``per_block`` consecutive items; a block owns one run, 8 channel
    vectors of 16 bytes and ``col_tile`` output columns, and writes one
    partial sum (a slab of the workspace) at its end. The runs are as many as
    fill ``_DW_BLOCKS_PER_SM`` blocks on every SM in one wave beside the
    channel and column tiles. For each band the block stages the x rows it
    reads (``stride * (band - 1) + k``, of which the next band of the same
    frame keeps ``k - stride``) in a ring of ``ring`` rows of ``stride *
    (col_tile - 1) + k`` columns, and the band's dy rows in one of two slots,
    in shared memory; the lanes' partial sums reuse it at the end. The column
    tile and the band are fitted as the forward's are (``_fit_tiles``), to
    2 blocks an SM. The kernel takes ``band``, ``col_tile``, ``cols``,
    ``per_block``, ``slabs`` and ``smem_bytes`` and derives the rest.
    """
    vec = 16 // itemsize
    rows, out_cols = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    cols = 4 if stride == 1 and rows * _cdiv(out_cols, 4) >= _DW_W4_UNITS else 2
    tap_groups = _DW_TAP_GROUPS[k]
    lanes = 32 // tap_groups
    channel_tiles = _cdiv(_cdiv(c, vec), _DW_TILE_VECS)
    part_bytes = lanes * k * k * _DW_TILE_VECS * vec * 4

    def tiling(col_tile: int, band: int) -> dict:
        bands, col_tiles = _cdiv(rows, band), _cdiv(out_cols, col_tile)
        items = n * bands
        runs = max(1, min(items, _DW_BLOCKS_PER_SM * sms // (channel_tiles * col_tiles)))
        per_block = max(1, _cdiv(items, runs))
        blocks = _cdiv(items, per_block)
        frame_rows = stride * (band - 1) + k
        ring = 2 * frame_rows  # a band, and the next one's new rows (a new frame's all)
        tile_cols = stride * (col_tile - 1) + k
        return {
            "cols": cols,
            "band": band,
            "col_tile": col_tile,
            "tap_groups": tap_groups,
            "lanes": lanes,
            "bands": bands,
            "items": items,
            "per_block": per_block,
            "frame_rows": frame_rows,
            "ring": ring,
            "tile_cols": tile_cols,
            "grid": (blocks, channel_tiles, col_tiles),
            "slabs": blocks * col_tiles,
            "smem_bytes": max((ring * tile_cols + 2 * band * col_tile) * _DW_TILE_VECS * 16, part_bytes),
        }

    return _fit_tiles(rows, out_cols, cols, _DW_UNITS, _DW_MAX_COL_TILE, _DW_SMEM_BUDGET, tiling)


def temporal_launch_geometry(kernel: str, b: int, t: int, hw: int, c: int, k: int, itemsize: int,
                             sms: int) -> dict:
    """The tiling of ``dw_temporal_fwd`` or ``dw_temporal_dw`` (``kernel``) for x
    (b, t, hw, c), and dy of the same shape.

    Both walk columns: a thread owns one 16-byte channel vector (``vec``
    channels; ``cvecs`` a pixel) of one of the ``b * hw`` (b, pixel) columns
    and walks its ``t`` frames, ``frame_tile`` at a time. The forward runs
    one thread per (column, channel vector), 256 a block. dw's block owns
    ``tile_vecs`` channel vectors and a run of ``per_block`` consecutive
    columns, which its ``lanes`` column lanes take in turn; the runs, one
    slab of the workspace each, are as many as fill ``_TEMPORAL_DW_BLOCKS_PER_SM``
    blocks on every SM in one wave beside the channel tiles, and the block
    adds its lanes' sums through ``smem_bytes`` of shared memory. The kernels
    take ``frame_tile`` (dw also ``per_block``, ``slabs`` and ``smem_bytes``)
    and derive the rest.
    """
    vec = 16 // itemsize
    cvecs = _cdiv(c, vec)
    columns = b * hw
    if kernel == "dw_temporal_fwd":
        threads = columns * cvecs
        return {
            "vec": vec,
            "cvecs": cvecs,
            "columns": columns,
            "frame_tile": _TEMPORAL_FRAME_TILE,
            "threads": threads,
            "grid": (_cdiv(threads, _TEMPORAL_THREADS), 1, 1),
            "smem_bytes": 0,
        }
    if kernel != "dw_temporal_dw":
        raise ValueError(f"temporal_launch_geometry: no temporal kernel {kernel!r}")
    channel_tiles = _cdiv(cvecs, _TEMPORAL_DW_TILE_VECS)
    runs = max(1, min(columns, _TEMPORAL_DW_BLOCKS_PER_SM * sms // max(1, channel_tiles)))
    per_block = max(1, _cdiv(columns, runs))
    runs = _cdiv(columns, per_block)
    return {
        "vec": vec,
        "cvecs": cvecs,
        "columns": columns,
        "frame_tile": _TEMPORAL_FRAME_TILE,
        "tile_vecs": _TEMPORAL_DW_TILE_VECS,
        "lanes": _TEMPORAL_DW_LANES,
        "per_block": per_block,
        "slabs": runs,
        "grid": (runs, channel_tiles, 1),
        "smem_bytes": _TEMPORAL_DW_LANES * k * _TEMPORAL_DW_TILE_VECS * vec * 4,
    }


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16 and fp32 data, float64 for float64 (gradcheck)."""
    return torch.promote_types(torch.float32, dtype)


def _check_spatial(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    if x.ndim != 5:
        raise ValueError(f"dw_spatial: x must be (B, T, H, W, C), got {tuple(x.shape)}")
    k = w.shape[0]
    if w.ndim != 3 or w.shape[1] != k or w.shape[2] != x.shape[-1] or k % 2 == 0:
        raise ValueError(
            f"dw_spatial: w must be (k, k, C) with odd k and C={x.shape[-1]}, got {tuple(w.shape)}"
        )
    if stride not in (1, 2):
        raise NotImplementedError(f"dw_spatial: stride {stride} not supported (1 or 2)")


def _check_temporal(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 5:
        raise ValueError(f"dw_temporal: x must be (B, T, H, W, C), got {tuple(x.shape)}")
    if w.ndim != 2 or w.shape[1] != x.shape[-1]:
        raise ValueError(f"dw_temporal: w must be (k, C) with C={x.shape[-1]}, got {tuple(w.shape)}")
    if w.shape[0] % 2 == 0:
        # Even k with (k//2, k//2) padding would give T + 1 frames; the
        # TPU kernel refuses it too (pallas_dw.py _dw_temporal_fwd).
        raise NotImplementedError(f"dw_temporal_fwd supports odd temporal kernels only, got k={w.shape[0]}")


def _check_bn(name: str, x: torch.Tensor, bn: tuple) -> None:
    """The prologue's mean, var, scale and bias: (C,) each."""
    c = x.shape[-1]
    if any(t.shape != (c,) for t in bn):
        raise ValueError(f"{name}: mean, var, scale and bias must be (C,) with C={c}, "
                         f"got {[tuple(t.shape) for t in bn]}")


def _check_cuda_bn(name: str, x: torch.Tensor, bn: tuple) -> None:
    for key, t in zip(("mean", "var", "scale", "bias"), bn):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: {key} must be a contiguous float32 tensor on {x.device}, "
                            f"got {t.dtype} on {t.device}")


def _check_cuda_operands(name: str, **operands: torch.Tensor) -> None:
    (first_name, first), *rest = operands.items()
    if first.device.type != "cuda":
        raise RuntimeError(
            f"{name}: {first_name} on {first.device}; the kernel takes CUDA tensors, the plain version CPU ones"
        )
    for other_name, t in rest:
        if t.device != first.device:
            raise RuntimeError(f"{name}: {other_name} on {t.device}, {first_name} on {first.device}")
    dtypes = [t.dtype for t in operands.values()]
    if first.dtype not in _SUFFIX or any(d != first.dtype for d in dtypes):
        raise TypeError(f"{name}: operands must be float32 or bfloat16, all the same, got {dtypes}")
    if not all(t.is_contiguous() for t in operands.values()):
        raise ValueError(f"{name}: operands must be contiguous")


def _check_temporal_offsets(name: str, x: torch.Tensor, geo: dict) -> None:
    """The temporal kernels step along T with 32-bit offsets, up to a frame
    tile and k frames past the last."""
    _, t, h, wd, c = x.shape
    if (t + geo["frame_tile"] + COMPILED_KS[-1]) * h * wd * c > _INT32_MAX:
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the kernel's 32-bit frame offsets")


def _check_grid(name: str, shape: tuple, geo: dict, frame_in: int, frame_out: int) -> None:
    """The spatial kernels' 32-bit offsets inside a frame of ``frame_in``
    and ``frame_out`` elements, CUDA's grid limits and a block's shared memory."""
    if (frame_in > _INT32_MAX or frame_out > _INT32_MAX
            or any(g > m for g, m in zip(geo["grid"], _MAX_GRID)) or geo["smem_bytes"] > _MAX_SMEM_BYTES):
        raise ValueError(f"{name}: shape {shape} exceeds the kernel's grid")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _entry(name: str, dtype: torch.dtype):
    """The C entry point ``<name>_<f32|bf16>`` with its signature declared:
    ``_SIGNATURES[name]``, then the stream."""
    symbol = f"{name}_{_SUFFIX[dtype]}"
    if symbol not in _ENTRIES:
        library, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(library), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        _ENTRIES[symbol] = fn
    return _ENTRIES[symbol]


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    # A launch goes to the current device's stream: make it the operands' card
    # (a Predictor over a mesh runs replicas on every card from one thread).
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _entry(name, dtype)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
    LAUNCHES[name] += 1


# ----------------------------------------------------------------- plain versions


def _spatial_valid(xp: torch.Tensor, w: torch.Tensor, stride: int, oh: int, ow: int) -> torch.Tensor:
    """Shifted multiply-adds of an already padded input, in the accumulation dtype."""
    k = w.shape[0]
    acc_dtype = _acc_dtype(xp.dtype)
    xp, wf = xp.to(acc_dtype), w.to(acc_dtype)
    acc = torch.zeros((*xp.shape[:2], oh, ow, xp.shape[-1]), dtype=acc_dtype, device=xp.device)
    for di in range(k):
        for dj in range(k):
            tap = xp[:, :, di : di + stride * (oh - 1) + 1 : stride, dj : dj + stride * (ow - 1) + 1 : stride]
            acc += tap * wf[di, dj]
    return acc


def dw_spatial_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Shifted multiply-adds over a zero-padded copy, accumulated in fp32."""
    _check_spatial(x, w, stride)
    k = w.shape[0]
    pad = k // 2
    oh, ow = spatial_out_size(x.shape[2], k, stride), spatial_out_size(x.shape[3], k, stride)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    return _spatial_valid(xp, w, stride, oh, ow).to(x.dtype)


def dw_spatial_fwd_bn_plain(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor, eps: float, stride: int) -> torch.Tensor:
    """The chain the prologue kernel folds: ``dw_spatial_plain`` of
    ``bn_act_eval_plain`` with SiLU."""
    _check_bn("dw_spatial_fwd_bn", x, (mean, var, scale, bias))
    return dw_spatial_plain(bn_kernels.bn_act_eval_plain(x, mean, var, scale, bias, eps, True), w, stride)


def _check_fused(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    _check_spatial(x, w, stride)
    c = x.shape[-1]
    if scale.shape != (c,) or shift.shape != (c,):
        raise ValueError(
            f"fused_bn_silu_dw_spatial: scale and shift must be (C,) with C={c}, "
            f"got {tuple(scale.shape)} and {tuple(shift.shape)}"
        )


def fused_bn_silu_dw_spatial_plain(
    x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """The fp32 prologue, zero padding after it, then the tap sum of
    ``dw_spatial_plain``, rounded once to x's dtype."""
    _check_fused(x, scale, shift, w, stride)
    k = w.shape[0]
    pad = k // 2
    acc_dtype = _acc_dtype(x.dtype)
    act = F.silu(x.to(acc_dtype) * scale.to(acc_dtype) + shift.to(acc_dtype))
    oh, ow = spatial_out_size(x.shape[2], k, stride), spatial_out_size(x.shape[3], k, stride)
    padded = F.pad(act, (0, 0, pad, pad, pad, pad))
    return _spatial_valid(padded, w, stride, oh, ow).to(x.dtype)


def dw_spatial_dx_plain(dy: torch.Tensor, w: torch.Tensor, stride: int, hw: tuple[int, int]) -> torch.Tensor:
    """The JAX construction (``pallas_dw._dw_spatial_vjp_bwd``): dilate the
    cotangent by the stride, pad it with ``k-1-pad`` on the left and so that
    the output is exactly ``hw`` on the right, and run a stride-1 valid conv
    with the taps flipped."""
    k = w.shape[0]
    pad = k // 2
    h, wd = hw
    if stride > 1:
        b, t, oh, ow, c = dy.shape
        dyd = dy.new_zeros((b, t, (oh - 1) * stride + 1, (ow - 1) * stride + 1, c))
        dyd[:, :, ::stride, ::stride] = dy
    else:
        dyd = dy
    left = k - 1 - pad
    right_h = h + k - 1 - dyd.shape[2] - left
    right_w = wd + k - 1 - dyd.shape[3] - left
    dyp = F.pad(dyd, (0, 0, left, right_w, left, right_h))
    return _spatial_valid(dyp, w.flip(0, 1), 1, h, wd).to(dy.dtype)


def dw_spatial_dw_plain(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Tap-by-tap sums of x_pad * dy, accumulated in fp32 (float64 for float64)."""
    pad = k // 2
    oh, ow = dy.shape[2], dy.shape[3]
    acc_dtype = _acc_dtype(x.dtype)
    xp = F.pad(x.to(acc_dtype), (0, 0, pad, pad, pad, pad))
    g = dy.to(acc_dtype)
    dw = torch.empty((k, k, x.shape[-1]), dtype=acc_dtype, device=x.device)
    for di in range(k):
        for dj in range(k):
            tap = xp[:, :, di : di + stride * (oh - 1) + 1 : stride, dj : dj + stride * (ow - 1) + 1 : stride]
            dw[di, dj] = (tap * g).sum(dim=(0, 1, 2, 3))
    return dw


def dw_temporal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shifted multiply-adds over T, zero-padded, accumulated in fp32."""
    _check_temporal(x, w)
    k = w.shape[0]
    pad = k // 2
    t = x.shape[1]
    acc_dtype = _acc_dtype(x.dtype)
    xp = F.pad(x.to(acc_dtype), (0, 0, 0, 0, 0, 0, pad, pad))
    wf = w.to(acc_dtype)
    acc = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for dt in range(k):
        acc += xp[:, dt : dt + t] * wf[dt]
    return acc.to(x.dtype)


def dw_temporal_fwd_bn_plain(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The chain the prologue kernel folds: ``dw_temporal_plain`` of
    ``bn_act_eval_plain`` with SiLU."""
    _check_bn("dw_temporal_fwd_bn", x, (mean, var, scale, bias))
    return dw_temporal_plain(bn_kernels.bn_act_eval_plain(x, mean, var, scale, bias, eps, True), w)


def dw_temporal_dw_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Tap-by-tap sums of x_pad * dy over (B, T, H, W), accumulated in fp32."""
    pad = k // 2
    t = x.shape[1]
    acc_dtype = _acc_dtype(x.dtype)
    xp = F.pad(x.to(acc_dtype), (0, 0, 0, 0, 0, 0, pad, pad))
    g = dy.to(acc_dtype)
    dw = torch.empty((k, x.shape[-1]), dtype=acc_dtype, device=x.device)
    for dt in range(k):
        dw[dt] = (xp[:, dt : dt + t] * g).sum(dim=(0, 1, 2, 3))
    return dw


# -------------------------------------------------------------------- custom ops
#
# Each kernel is the custom op ``sensorium::<name>``, so that a traced graph
# (``torch.export``, ``infer/export.py``) holds it as one node: its CUDA
# implementation launches the kernel, its CPU one is the plain version, and
# its fake one gives the output's shape and dtype only. The CUDA
# implementations check their operands themselves, since a loaded artifact
# calls them without the wrappers.


def _custom_op(name: str, cpu_impl, fake_impl):
    """Register the decorated CUDA implementation as ``sensorium::<name>``,
    with ``cpu_impl`` and ``fake_impl`` beside it."""

    def register(cuda_impl):
        op = torch.library.custom_op(f"sensorium::{name}", cuda_impl, mutates_args=(), device_types="cuda")
        op.register_kernel("cpu")(cpu_impl)
        op.register_fake(fake_impl)
        return op

    return register


def _spatial_fwd_fake(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    _check_spatial(x, w, stride)
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    return x.new_empty((b, t, spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride), c))


def _launch_spatial_fwd(name: str, x: torch.Tensor, w: torch.Tensor, stride: int, bn: tuple = (),
                        eps: float = 0.0) -> torch.Tensor:
    """``dw_spatial_fwd_kernel`` on CUDA operands, with the eval BN prologue
    of ``bn`` (mean, var, scale, bias) where given."""
    _check_cuda_operands(name, x=x, w=w)
    if bn:
        _check_cuda_bn(name, x, bn)
    k = w.shape[0]
    if k not in COMPILED_KS:
        raise NotImplementedError(f"{name}: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    b, t, h, wd, c = x.shape
    oh, ow = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = fwd_launch_geometry(b * t, h, wd, c, k, stride, x.element_size(), sms, bn=bool(bn))
    _check_grid(name, tuple(x.shape), geo, h * wd * c, oh * ow * c)
    y = torch.empty((b, t, oh, ow, c), dtype=x.dtype, device=x.device)
    prologue = (*(p.data_ptr() for p in bn), eps) if bn else ()
    _launch(name, x.dtype, x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(), *prologue, b * t, h, wd, c, k, stride,
            geo["band"], geo["col_tile"], geo["cols"], geo["frames"], geo["bands_per_block"], geo["smem_bytes"])
    return y


@_custom_op("dw_spatial_fwd", dw_spatial_plain, _spatial_fwd_fake)
def _dw_spatial_fwd_op(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    _check_spatial(x, w, stride)
    return _launch_spatial_fwd("dw_spatial_fwd", x, w, stride)


def _spatial_fwd_bn_fake(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor, eps: float, stride: int) -> torch.Tensor:
    _check_bn("dw_spatial_fwd_bn", x, (mean, var, scale, bias))
    return _spatial_fwd_fake(x, w, stride)


@_custom_op("dw_spatial_fwd_bn", dw_spatial_fwd_bn_plain, _spatial_fwd_bn_fake)
def _dw_spatial_fwd_bn_op(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, eps: float, stride: int) -> torch.Tensor:
    _check_spatial(x, w, stride)
    _check_bn("dw_spatial_fwd_bn", x, (mean, var, scale, bias))
    return _launch_spatial_fwd("dw_spatial_fwd_bn", x, w, stride, (mean, var, scale, bias), eps)


def _fused_fake(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w: torch.Tensor,
                stride: int) -> torch.Tensor:
    _check_fused(x, scale, shift, w, stride)
    return _spatial_fwd_fake(x, w, stride)


@_custom_op("fused_bn_silu_dw_spatial", fused_bn_silu_dw_spatial_plain, _fused_fake)
def _fused_bn_silu_dw_spatial_op(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w: torch.Tensor,
                                 stride: int) -> torch.Tensor:
    _check_fused(x, scale, shift, w, stride)
    _check_cuda_operands("fused_bn_silu_dw_spatial", x=x, w=w)
    for name, t in (("scale", scale), ("shift", shift)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"fused_bn_silu_dw_spatial: {name} must be a contiguous float32 tensor on {x.device}, "
                            f"got {t.dtype} on {t.device}")
    k = w.shape[0]
    if k not in COMPILED_KS:
        raise NotImplementedError(
            f"fused_bn_silu_dw_spatial: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    b, t, h, wd, c = x.shape
    oh, ow = spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = fused_launch_geometry(b * t, h, wd, c, k, stride, x.element_size(), sms)
    _check_grid("fused_bn_silu_dw_spatial", tuple(x.shape), geo, h * wd * c, oh * ow * c)
    y = torch.empty((b, t, oh, ow, c), dtype=x.dtype, device=x.device)
    _launch("fused_bn_silu_dw_spatial", x.dtype, x.device, x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            w.data_ptr(), y.data_ptr(), b * t, h, wd, c, k, stride, geo["band"], geo["col_tile"], geo["cols"],
            geo["frames"], geo["bands_per_block"], geo["smem_bytes"])
    return y


def _temporal_fwd_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_temporal(x, w)
    return torch.empty_like(x)


def _launch_temporal_fwd(name: str, x: torch.Tensor, w: torch.Tensor, bn: tuple = (),
                         eps: float = 0.0) -> torch.Tensor:
    """``dw_temporal_fwd_walk`` on CUDA operands, with the eval BN prologue of
    ``bn`` (mean, var, scale, bias) where given."""
    _check_cuda_operands(name, x=x, w=w)
    if bn:
        _check_cuda_bn(name, x, bn)
    k = w.shape[0]
    if k not in COMPILED_KS:
        raise NotImplementedError(f"{name}: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    b, t, h, wd, c = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = temporal_launch_geometry("dw_temporal_fwd", b, t, h * wd, c, k, x.element_size(), sms)
    _check_temporal_offsets(name, x, geo)
    if geo["threads"] + _TEMPORAL_THREADS > _INT32_MAX:
        raise ValueError(f"{name}: shape {tuple(x.shape)} exceeds the kernel's grid")
    y = torch.empty_like(x)
    prologue = (*(p.data_ptr() for p in bn), eps) if bn else ()
    _launch(name, x.dtype, x.device, x.data_ptr(), w.data_ptr(), y.data_ptr(), *prologue,
            b, t, h * wd, c, k, geo["frame_tile"])
    return y


@_custom_op("dw_temporal_fwd", dw_temporal_plain, _temporal_fwd_fake)
def _dw_temporal_fwd_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_temporal(x, w)
    return _launch_temporal_fwd("dw_temporal_fwd", x, w)


def _temporal_fwd_bn_fake(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    _check_bn("dw_temporal_fwd_bn", x, (mean, var, scale, bias))
    return _temporal_fwd_fake(x, w)


@_custom_op("dw_temporal_fwd_bn", dw_temporal_fwd_bn_plain, _temporal_fwd_bn_fake)
def _dw_temporal_fwd_bn_op(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    _check_temporal(x, w)
    _check_bn("dw_temporal_fwd_bn", x, (mean, var, scale, bias))
    return _launch_temporal_fwd("dw_temporal_fwd_bn", x, w, (mean, var, scale, bias), eps)


def _check_dx(dy: torch.Tensor, w: torch.Tensor, stride: int, h: int, wd: int) -> None:
    k = w.shape[0]
    if tuple(dy.shape[2:4]) != (spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride)):
        raise ValueError(f"dw_spatial_dx: dy {tuple(dy.shape)} is not the output of an input of size {(h, wd)}")
    _check_spatial(dy, w, stride)


def _spatial_dx_cpu(dy: torch.Tensor, w: torch.Tensor, stride: int, h: int, wd: int) -> torch.Tensor:
    _check_dx(dy, w, stride, h, wd)
    return dw_spatial_dx_plain(dy, w, stride, (h, wd))


def _spatial_dx_fake(dy: torch.Tensor, w: torch.Tensor, stride: int, h: int, wd: int) -> torch.Tensor:
    _check_dx(dy, w, stride, h, wd)
    return dy.new_empty((dy.shape[0], dy.shape[1], h, wd, dy.shape[4]))


@_custom_op("dw_spatial_dx", _spatial_dx_cpu, _spatial_dx_fake)
def _dw_spatial_dx_op(dy: torch.Tensor, w: torch.Tensor, stride: int, h: int, wd: int) -> torch.Tensor:
    _check_dx(dy, w, stride, h, wd)
    _check_cuda_operands("dw_spatial_dx", dy=dy, w=w)
    k = w.shape[0]
    if k not in COMPILED_KS:
        raise NotImplementedError(f"dw_spatial_dx: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    b, t, oh, ow, c = dy.shape
    sms = torch.cuda.get_device_properties(dy.device).multi_processor_count
    geo = dx_launch_geometry(b * t, h, wd, c, k, stride, dy.element_size(), sms)
    _check_grid("dw_spatial_dx", tuple(dy.shape), geo, h * wd * c, oh * ow * c)
    dx = torch.empty((b, t, h, wd, c), dtype=dy.dtype, device=dy.device)
    _launch("dw_spatial_dx", dy.dtype, dy.device, dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            b * t, h, wd, c, k, stride, geo["band"], geo["col_tile"], geo["bands_per_block"], geo["smem_bytes"])
    return dx


def _check_spatial_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> None:
    b, t, h, wd, c = x.shape
    if tuple(dy.shape) != (b, t, spatial_out_size(h, k, stride), spatial_out_size(wd, k, stride), c):
        raise ValueError(f"dw_spatial_dw: dy {tuple(dy.shape)} is not the output of x {tuple(x.shape)}")


def _spatial_dw_cpu(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    _check_spatial_dw(x, dy, k, stride)
    return dw_spatial_dw_plain(x, dy, k, stride)


def _spatial_dw_fake(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    _check_spatial_dw(x, dy, k, stride)
    return x.new_empty((k, k, x.shape[-1]), dtype=_acc_dtype(x.dtype))


@_custom_op("dw_spatial_dw", _spatial_dw_cpu, _spatial_dw_fake)
def _dw_spatial_dw_op(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    _check_spatial_dw(x, dy, k, stride)
    _check_cuda_operands("dw_spatial_dw", x=x, dy=dy)
    if k not in COMPILED_KS:
        raise NotImplementedError(f"dw_spatial_dw: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    if stride not in (1, 2):
        raise NotImplementedError(f"dw_spatial_dw: stride {stride} not supported (1 or 2)")
    b, t, h, wd, c = x.shape
    oh, ow = dy.shape[2], dy.shape[3]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = dw_launch_geometry(b * t, h, wd, c, k, stride, x.element_size(), sms)
    if (h * wd * c > _INT32_MAX or oh * ow * c > _INT32_MAX or geo["items"] > _INT32_MAX
            or (geo["per_block"] + 1) * geo["frame_rows"] > _INT32_MAX or geo["slabs"] * k * k * c > _INT32_MAX
            or any(g > m for g, m in zip(geo["grid"], _MAX_GRID)) or geo["smem_bytes"] > _MAX_SMEM_BYTES):
        raise ValueError(f"dw_spatial_dw: shape {tuple(x.shape)} exceeds the kernel's grid")
    workspace = torch.empty((geo["slabs"], k * k, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    _launch("dw_spatial_dw", x.dtype, x.device, x.data_ptr(), dy.data_ptr(), workspace.data_ptr(), dw.data_ptr(),
            b * t, h, wd, c, k, stride, geo["band"], geo["col_tile"], geo["cols"], geo["per_block"], geo["slabs"],
            geo["smem_bytes"])
    return dw


def _check_temporal_dw(x: torch.Tensor, dy: torch.Tensor) -> None:
    if dy.shape != x.shape:
        raise ValueError(f"dw_temporal_dw: dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")


def _temporal_dw_cpu(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    _check_temporal_dw(x, dy)
    return dw_temporal_dw_plain(x, dy, k)


def _temporal_dw_fake(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    _check_temporal_dw(x, dy)
    return x.new_empty((k, x.shape[-1]), dtype=_acc_dtype(x.dtype))


@_custom_op("dw_temporal_dw", _temporal_dw_cpu, _temporal_dw_fake)
def _dw_temporal_dw_op(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    _check_temporal_dw(x, dy)
    _check_cuda_operands("dw_temporal_dw", x=x, dy=dy)
    if k not in COMPILED_KS:
        raise NotImplementedError(f"dw_temporal_dw: the kernel is compiled for k in {COMPILED_KS}, got k={k}")
    b, t, h, wd, c = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = temporal_launch_geometry("dw_temporal_dw", b, t, h * wd, c, k, x.element_size(), sms)
    _check_temporal_offsets("dw_temporal_dw", x, geo)
    if (geo["columns"] + geo["per_block"] > _INT32_MAX or geo["slabs"] * k * c > _INT32_MAX
            or any(g > m for g, m in zip(geo["grid"], _MAX_GRID))):
        raise ValueError(f"dw_temporal_dw: shape {tuple(x.shape)} exceeds the kernel's grid")
    workspace = torch.empty((geo["slabs"], k, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, c), dtype=torch.float32, device=x.device)
    _launch("dw_temporal_dw", x.dtype, x.device, x.data_ptr(), dy.data_ptr(), workspace.data_ptr(), dw.data_ptr(),
            b, t, h * wd, c, k, geo["frame_tile"], geo["per_block"], geo["slabs"], geo["smem_bytes"])
    return dw


# ---------------------------------------------------------------------- wrappers
#
# Each wrapper checks its operands and calls its op: CPU tensors take the
# plain version, CUDA tensors the kernel, and any others raise.


def _check_route(name: str, **operands: torch.Tensor) -> None:
    if not _on_cpu(*operands.values()):
        _check_cuda_operands(name, **operands)


def dw_spatial_fwd(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise (1, k, k) conv over (H, W); CUDA kernel, or the plain version on CPU."""
    _check_spatial(x, w, stride)
    _check_route("dw_spatial_fwd", x=x, w=w)
    return torch.ops.sensorium.dw_spatial_fwd(x, w, stride)


def dw_spatial_fwd_bn(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor, eps: float, stride: int = 1) -> torch.Tensor:
    """``dw_spatial_fwd(bn_act_eval(x, mean, var, scale, bias, eps, act=True), w,
    stride)``, bitwise, with the BN inside the conv's kernel; or that chain's
    plain version on CPU."""
    _check_spatial(x, w, stride)
    _check_bn("dw_spatial_fwd_bn", x, (mean, var, scale, bias))
    if not _on_cpu(x, w, mean, var, scale, bias):
        _check_cuda_operands("dw_spatial_fwd_bn", x=x, w=w)
    return torch.ops.sensorium.dw_spatial_fwd_bn(x, w, mean, var, scale, bias, eps, stride)


def fused_bn_silu_dw_spatial(
    x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, w: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """``dw_spatial_fwd(silu(x * scale + shift), w, stride)`` with the prologue
    in fp32; CUDA kernel, or the plain version on CPU."""
    _check_fused(x, scale, shift, w, stride)
    if not _on_cpu(x, scale, shift, w):
        _check_cuda_operands("fused_bn_silu_dw_spatial", x=x, w=w)
    return torch.ops.sensorium.fused_bn_silu_dw_spatial(x, scale, shift, w, stride)


def dw_temporal_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise (k, 1, 1) conv over T; CUDA kernel, or the plain version on CPU."""
    _check_temporal(x, w)
    _check_route("dw_temporal_fwd", x=x, w=w)
    return torch.ops.sensorium.dw_temporal_fwd(x, w)


def dw_temporal_fwd_bn(x: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``dw_temporal_fwd(bn_act_eval(x, mean, var, scale, bias, eps, act=True),
    w)``, bitwise, with the BN inside the conv's kernel; or that chain's plain
    version on CPU."""
    _check_temporal(x, w)
    _check_bn("dw_temporal_fwd_bn", x, (mean, var, scale, bias))
    if not _on_cpu(x, w, mean, var, scale, bias):
        _check_cuda_operands("dw_temporal_fwd_bn", x=x, w=w)
    return torch.ops.sensorium.dw_temporal_fwd_bn(x, w, mean, var, scale, bias, eps)


def dw_spatial_dx(dy: torch.Tensor, w: torch.Tensor, stride: int, hw: tuple[int, int]) -> torch.Tensor:
    """dL/dx of ``dw_spatial_fwd`` for an input of spatial size ``hw``; CUDA
    kernel, or the plain version on CPU."""
    h, wd = hw
    _check_dx(dy, w, stride, h, wd)
    _check_route("dw_spatial_dx", dy=dy, w=w)
    return torch.ops.sensorium.dw_spatial_dx(dy, w, stride, h, wd)


def dw_spatial_dw(x: torch.Tensor, dy: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """dL/dw of ``dw_spatial_fwd``, (k, k, C) fp32; CUDA kernel (partial sums
    per block, then a fixed-order sum of them), or the plain version on CPU."""
    _check_spatial_dw(x, dy, k, stride)
    _check_route("dw_spatial_dw", x=x, dy=dy)
    return torch.ops.sensorium.dw_spatial_dw(x, dy, k, stride)


def dw_temporal_dw(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dL/dw of ``dw_temporal_fwd``, (k, C) fp32; CUDA kernel (partial sums
    per block, then a fixed-order sum of them), or the plain version on CPU."""
    _check_temporal_dw(x, dy)
    _check_route("dw_temporal_dw", x=x, dy=dy)
    return torch.ops.sensorium.dw_temporal_dw(x, dy, k)


# ----------------------------------------------------------------------- autograd


class DwSpatial(torch.autograd.Function):
    """``dw_spatial_fwd`` with its backward kernels (``pallas_dw.dw_spatial``)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return dw_spatial_fwd(x, w, stride)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dw_spatial_dx(dy, w, ctx.stride, (x.shape[2], x.shape[3])).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = dw_spatial_dw(x, dy, w.shape[0], ctx.stride).to(w.dtype)
        return dx, dw, None


class DwTemporal(torch.autograd.Function):
    """``dw_temporal_fwd`` with its backward (``pallas_dw.dw_temporal``): dx is
    the forward kernel with the taps reversed, dw its own kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dw_temporal_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dw_temporal_fwd(dy, w.flip(0)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = dw_temporal_dw(x, dy, w.shape[0]).to(w.dtype)
        return dx, dw


def dw_spatial(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Differentiable depthwise (1, k, k) conv (``DwSpatial``)."""
    return DwSpatial.apply(x, w, stride)


def dw_temporal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable depthwise (k, 1, 1) conv (``DwTemporal``)."""
    return DwTemporal.apply(x, w)
