"""Batch norm with its SiLU: CUDA kernels (``csrc/bn_act.cu``) and their plain
versions.

No TPU kernel is ported here: the JAX package leaves
``sensorium_tpu/ops/norm.py`` ``BatchNorm`` and the ``nn.silu`` after it to
XLA, which fuses them. In eager PyTorch the same arithmetic was a chain of
fp32 passes (about 140 bytes a bf16 element through a training step, 28
through eval); the kernels move the least the layer needs: the statistics
read x once, the apply reads x and writes y, the backward's sums read x and
dy, and dx reads them again and writes dx (about 16 and 4 bytes).

x is channels-last, viewed as (rows, C). Per-channel values are fp32 (float64
for float64 inputs, on the CPU):

* ``bn_stats(x, shift, scale, bias, running_mean, running_var, eps)``: the
  training statistics ``stats`` (5, C) = [mean, biased var, inv_std, a, b]
  with ``a = inv_std * scale`` and ``b = bias - mean * a``, the variance in
  the shifted one-pass form ``E[(x-c)^2] - (E[x]-c)^2`` (c = ``shift``);
  given running statistics, it moves them with torch's momentum (0.1), the
  variance unbiased (``var * n/(n-1)``), in place;
* ``bn_moments(x, shift)`` (2, C) = [E[x], E[(x-c)^2]] and
  ``bn_finalize(moments, ..., count)``: the same in two steps, for an
  all-reduce of the moments between them (a data-parallel mesh; ``count``
  is the global batch's rows, for the unbiased variance);
* ``bn_act_apply(x, stats, act)``: ``y = round(x * a + b)``, then
  ``round(silu(y))`` if ``act``, in x's dtype;
* ``bn_act_eval(x, mean, var, scale, bias, eps, act)``: the same with a and b
  from the running statistics, in one launch;
* ``bn_act_grad(x, dy, stats, act)`` (2, C) = [sum g, sum g * xhat] over the
  rows, with ``g = round(dy * silu'(round(x * a + b)))`` if ``act`` (the one
  rounding autograd's bf16 SiLU backward makes), else dy, and ``xhat = (x -
  mean) * inv_std``;
* ``bn_act_dx(x, dy, stats, sums, scale, count, act)``: ``((g - sums[0]/n) -
  xhat * sums[1]/n) * inv_std * scale`` in x's dtype, n = ``count``.

Each is the ``torch.library`` custom op ``sensorium::<name>`` (CUDA: the
kernels; CPU: the plain version, which is the eager arithmetic the port ran
before the kernels; fake: the output's shape), so a traced graph
(``torch.export``) holds it. CUDA tensors launch the kernels or raise; there
is no fallback. Sums over rows go through a workspace of one partial per
slab of rows, added in a fixed order: reruns are bitwise equal. ``LAUNCHES``
counts the kernel launches by kind (``bn_silu_*`` for those with SiLU).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sensorium_tpu_torch.ops import _build

MOMENTUM = 0.1  # torch's: running = (1 - m) * running + m * batch

LAUNCHES = {name: 0 for name in ("bn_stats", "bn_finalize", "bn_apply", "bn_silu_apply", "bn_grad", "bn_silu_grad",
                                 "bn_grad_sum", "bn_dx", "bn_silu_dx")}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# Entry point -> its arguments before the stream (bn_finalize has no dtype suffix).
_SIGNATURES = {
    "bn_stats_partial": (_P, _P, _P, _I, _I, _I, _I, _I),
    "bn_finalize": (_P, _I, _I, _I, _D, _P, _P, _P, _D, _D, _D, _P, _P, _P),
    "bn_act_apply": (_P, _P, _P, _P, _P, _P, _D, _I, _I, _I, _I, _I, _I, _I),
    "bn_act_grad_partial": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I),
    "bn_act_dx": (_P, _P, _P, _P, _P, _P, _D, _I, _I, _I, _I, _I, _I),
}
_ENTRIES: dict[str, ctypes._CFuncPtr] = {}
_SMS: dict[int, int] = {}  # card index -> its SMs
_CUDA_IMPLS: dict = {}  # op name -> its CUDA implementation
# bn_finalize_kernel's kinds (csrc/bn_act.cu FinalizeKind).
_STATS, _MOMENTS, _FROM_MOMENTS, _SUMS = 0, 1, 2, 3
# The row kernels: threads a block, the channel vectors of a tile at most, and
# the blocks per SM their registers are capped for (__launch_bounds__), which
# one wave of slabs fills.
_THREADS = 256
_MAX_TILE_VECS = 32
_BLOCKS_PER_SM = {"stats": 4, "apply": 4, "grad": 2, "dx": 2}
_MAX_TILES = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16 and fp32 data, float64 for float64."""
    return torch.promote_types(torch.float32, dtype)


def launch_geometry(rows: int, c: int, itemsize: int, sms: int, blocks_per_sm: int) -> dict:
    """How a row kernel covers x (rows, C): channel tiles of ``tile_vecs``
    16-byte vectors (at most 32, as even as the vectors allow) and
    ``_THREADS // tile_vecs`` row lanes a block; slabs of ``rows_per_slab``
    consecutive rows, as many as fill ``blocks_per_sm`` blocks on every SM
    beside the tiles, and no more than give each row lane a row. So a few
    wide rows (the cortex) split over channel tiles and many narrow ones
    (the core) over slabs."""
    vectors = _cdiv(c, 16 // itemsize)
    tiles = _cdiv(vectors, _MAX_TILE_VECS)
    tile_vecs = _cdiv(vectors, tiles)
    lanes = _THREADS // tile_vecs
    slabs = max(1, min(_cdiv(blocks_per_sm * sms, tiles), _cdiv(rows, lanes)))
    rows_per_slab = _cdiv(rows, slabs)
    return {"tile_vecs": tile_vecs, "lanes": lanes, "tiles": tiles, "rows_per_slab": rows_per_slab,
            "slabs": _cdiv(rows, rows_per_slab)}


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def _dims(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(x.ndim - 1))


# ----------------------------------------------------------------- plain versions


def bn_moments_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    dims, sd = _dims(x), stats_dtype(x.dtype)
    mean = x.mean(dim=dims, dtype=sd)
    centred = x.to(sd) - shift  # one temporary, squared in place
    return torch.stack([mean, centred.square_().mean(dim=dims)])


def bn_finalize_plain(moments: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor], eps: float,
                      count: int) -> torch.Tensor:
    mean, centred_sq = moments[0], moments[1]
    var = centred_sq - (mean - shift).square()
    inv_std = torch.rsqrt(var + eps)
    a = inv_std * scale
    if running_mean is not None:
        running_mean.copy_((1 - MOMENTUM) * running_mean + MOMENTUM * mean)
        running_var.copy_((1 - MOMENTUM) * running_var + MOMENTUM * (var * (count / max(count - 1, 1))))
    return torch.stack([mean, var, inv_std, a, bias - mean * a])


def bn_stats_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
                   eps: float) -> torch.Tensor:
    return bn_finalize_plain(bn_moments_plain(x, shift), shift, scale, bias, running_mean, running_var, eps,
                             _rows(x))


def _normalized(x: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """round(x * a + b) in x's dtype, computed in the statistics' dtype."""
    return torch.addcmul(stats[4], x.to(stats.dtype), stats[3]).to(x.dtype)


def bn_act_apply_plain(x: torch.Tensor, stats: torch.Tensor, act: bool) -> torch.Tensor:
    y = _normalized(x, stats)
    return F.silu(y) if act else y


def bn_act_eval_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float, act: bool) -> torch.Tensor:
    inv = torch.rsqrt(var + eps) * scale
    # One multiply-add per element in fp32, rounded once to x's dtype.
    y = torch.addcmul(bias - mean * inv, x.float(), inv).to(x.dtype)
    return F.silu(y) if act else y


def _grad_terms(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, act: bool):
    """g (dy through SiLU's backward, in x's dtype, as autograd rounds it) and
    xhat, both in the statistics' dtype."""
    sd = stats.dtype
    g = torch.ops.aten.silu_backward(dy, _normalized(x, stats)) if act else dy
    return g.to(sd), (x.to(sd) - stats[0]) * stats[2]


def bn_act_grad_plain(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, act: bool) -> torch.Tensor:
    dims = _dims(x)
    g, xhat = _grad_terms(x, dy, stats, act)
    return torch.stack([g.sum(dim=dims), (g * xhat).sum(dim=dims)])


def bn_act_dx_plain(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, sums: torch.Tensor,
                    scale: torch.Tensor, count: int, act: bool) -> torch.Tensor:
    g, xhat = _grad_terms(x, dy, stats, act)
    dx = ((g - sums[0] / count) - xhat * (sums[1] / count)) * (stats[2] * scale)
    return dx.to(x.dtype)


# ------------------------------------------------------------------- launches


def _entry(name: str, dtype: torch.dtype | None):
    """The C entry point ``<name>_<f32|bf16>`` (``<name>`` for ``dtype``
    None) with its signature declared: ``_SIGNATURES[name]``, then the stream."""
    symbol = name if dtype is None else f"{name}_{_SUFFIX[dtype]}"
    if symbol not in _ENTRIES:
        fn = getattr(_build.load("bn_act"), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [*_SIGNATURES[name], ctypes.c_void_p]
        _ENTRIES[symbol] = fn
    return _ENTRIES[symbol]


def _launch(counter: str, name: str, dtype: torch.dtype | None, device: torch.device, *args) -> None:
    # The current device's stream: make it the operands' card (a Predictor
    # over a mesh runs replicas on every card from one thread).
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _entry(name, dtype)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
    LAUNCHES[counter] += 1


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _geometry(x: torch.Tensor, kind: str) -> dict:
    sms = _sms(x.device)
    geo = launch_geometry(_rows(x), x.shape[-1], x.element_size(), sms, _BLOCKS_PER_SM[kind])
    if geo["tiles"] > _MAX_TILES:
        raise ValueError(f"batch norm: {x.shape[-1]} channels exceed the kernels' grid")
    return geo


def _row_args(x: torch.Tensor, geo: dict) -> tuple:
    return _rows(x), x.shape[-1], geo["tile_vecs"], geo["rows_per_slab"], geo["slabs"]


def _finalize(ws: torch.Tensor, slabs: int, kind: int, count: int, shift=None, scale=None, bias=None,
              eps: float = 0.0, running_mean=None, running_var=None, unbiased_count: int = 2) -> torch.Tensor:
    c = ws.shape[-1]
    out = ws.new_empty((5 if kind in (_STATS, _FROM_MOMENTS) else 2, c))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch("bn_grad_sum" if kind == _SUMS else "bn_finalize", "bn_finalize", None, ws.device, ws.data_ptr(), slabs,
            c, kind, float(count), ptr(shift), ptr(scale), ptr(bias), eps, MOMENTUM,
            unbiased_count / max(unbiased_count - 1, 1), out.data_ptr(), ptr(running_mean), ptr(running_var))
    return out


def _stats_partial(x: torch.Tensor, shift: torch.Tensor) -> tuple[torch.Tensor, int]:
    geo = _geometry(x, "stats")
    ws = torch.empty((geo["slabs"], 2, x.shape[-1]), dtype=torch.float32, device=x.device)
    _launch("bn_stats", "bn_stats_partial", x.dtype, x.device, x.data_ptr(), shift.data_ptr(), ws.data_ptr(),
            *_row_args(x, geo))
    return ws, geo["slabs"]


# ------------------------------------------------------------------ operand checks


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.ndim < 2 or x.shape[-1] < 1 or _rows(x) < 1:
        raise ValueError(f"{name}: x must be (..., C) with at least one row and channel, got {tuple(x.shape)}")


def _check_cuda(name: str, x: torch.Tensor, *others: torch.Tensor | None, channels: dict | None = None) -> None:
    """x (and each of ``others``, dy) CUDA, fp32 or bf16, contiguous, one
    shape; each of ``channels`` (name -> tensor or None) fp32, contiguous, on
    x's card, of the shape it names."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: x on {x.device}; the kernels take CUDA tensors, the plain version CPU ones")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    for t in (x, *others):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape or not t.is_contiguous():
            raise ValueError(f"{name}: x and dy must be contiguous tensors of one shape, dtype and card")
    for key, (t, shape) in (channels or {}).items():
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise TypeError(f"{name}: {key} must be a contiguous float32 tensor of shape {shape} on {x.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _per_channel(x: torch.Tensor, **tensors: torch.Tensor | None) -> dict:
    c = x.shape[-1]
    shapes = {"stats": (5, c), "moments": (2, c), "sums": (2, c)}
    return {key: (t, shapes.get(key, (c,))) for key, t in tensors.items()}


# -------------------------------------------------------------------- custom ops


def _custom_op(name: str, cpu_impl, fake_impl, mutates_args=()):
    """Register the decorated CUDA implementation as ``sensorium::<name>``,
    with ``cpu_impl`` and ``fake_impl`` beside it."""

    def register(cuda_impl):
        op = torch.library.custom_op(f"sensorium::{name}", cuda_impl, mutates_args=mutates_args,
                                     device_types="cuda")
        op.register_kernel("cpu")(cpu_impl)
        op.register_fake(fake_impl)
        _CUDA_IMPLS[name] = cuda_impl
        return op

    return register


def _call(name: str, *args):
    """``sensorium::<name>`` on ``args``. An eager call on plain CUDA tensors
    that need no gradient goes straight to the op's CUDA implementation: the
    dispatcher's round trip through Python costs about 70 us a call on the
    card's host, as much as eight kernel launches, and a flagship step makes
    some 330 of these calls. CPU tensors, tracing (``torch.export``,
    ``torch.compile``), tensor subclasses, dispatch modes and operands that
    need a gradient (which the op refuses in the backward) go through the op."""
    x = args[0]
    if (x.is_cuda and type(x) is torch.Tensor and not torch.compiler.is_compiling()
            and not torch._C._len_torch_dispatch_stack()
            and not (torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args))):
        return _CUDA_IMPLS[name](*args)
    return getattr(torch.ops.sensorium, name)(*args)


def _stats_fake(x, shift, scale, bias, running_mean, running_var, eps):
    return x.new_empty((5, x.shape[-1]), dtype=stats_dtype(x.dtype))


@_custom_op("bn_stats", bn_stats_plain, _stats_fake, mutates_args=("running_mean", "running_var"))
def _bn_stats_op(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
                 eps: float) -> torch.Tensor:
    _check_cuda("bn_stats", x, channels=_per_channel(x, shift=shift, scale=scale, bias=bias,
                                                     running_mean=running_mean, running_var=running_var))
    ws, slabs = _stats_partial(x, shift)
    return _finalize(ws, slabs, _STATS, _rows(x), shift, scale, bias, eps, running_mean, running_var, _rows(x))


def _moments_fake(x, shift):
    return x.new_empty((2, x.shape[-1]), dtype=stats_dtype(x.dtype))


@_custom_op("bn_moments", bn_moments_plain, _moments_fake)
def _bn_moments_op(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    _check_cuda("bn_moments", x, channels=_per_channel(x, shift=shift))
    ws, slabs = _stats_partial(x, shift)
    return _finalize(ws, slabs, _MOMENTS, _rows(x), shift)


def _finalize_fake(moments, shift, scale, bias, running_mean, running_var, eps, count):
    return moments.new_empty((5, moments.shape[-1]))


@_custom_op("bn_finalize", bn_finalize_plain, _finalize_fake, mutates_args=("running_mean", "running_var"))
def _bn_finalize_op(moments: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor], eps: float,
                    count: int) -> torch.Tensor:
    c = moments.shape[-1]
    for key, t in (("moments", moments), ("shift", shift), ("scale", scale), ("bias", bias),
                   ("running_mean", running_mean), ("running_var", running_var)):
        shape = (2, c) if key == "moments" else (c,)
        if t is not None and (t.device.type != "cuda" or t.device != moments.device or t.dtype != torch.float32
                              or tuple(t.shape) != shape or not t.is_contiguous()):
            raise TypeError(f"bn_finalize: {key} must be a contiguous float32 CUDA tensor of shape {shape} on "
                            f"{moments.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return _finalize(moments, 1, _FROM_MOMENTS, 1, shift, scale, bias, eps, running_mean, running_var, count)


def _apply_fake(x, stats, act):
    return torch.empty_like(x)


@_custom_op("bn_act_apply", bn_act_apply_plain, _apply_fake)
def _bn_act_apply_op(x: torch.Tensor, stats: torch.Tensor, act: bool) -> torch.Tensor:
    _check_cuda("bn_act_apply", x, channels=_per_channel(x, stats=stats))
    geo = _geometry(x, "apply")
    y = torch.empty_like(x)
    a, b = stats[3], stats[4]
    _launch("bn_silu_apply" if act else "bn_apply", "bn_act_apply", x.dtype, x.device, x.data_ptr(), y.data_ptr(),
            a.data_ptr(), b.data_ptr(), None, None, 0.0, *_row_args(x, geo), int(act), 0)
    return y


def _eval_fake(x, mean, var, scale, bias, eps, act):
    return torch.empty_like(x)


@_custom_op("bn_act_eval", bn_act_eval_plain, _eval_fake)
def _bn_act_eval_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float, act: bool) -> torch.Tensor:
    _check_cuda("bn_act_eval", x, channels=_per_channel(x, mean=mean, var=var, scale=scale, bias=bias))
    geo = _geometry(x, "apply")
    y = torch.empty_like(x)
    _launch("bn_silu_apply" if act else "bn_apply", "bn_act_apply", x.dtype, x.device, x.data_ptr(), y.data_ptr(),
            mean.data_ptr(), var.data_ptr(), scale.data_ptr(), bias.data_ptr(), eps, *_row_args(x, geo), int(act), 1)
    return y


def _grad_fake(x, dy, stats, act):
    return x.new_empty((2, x.shape[-1]), dtype=stats.dtype)


@_custom_op("bn_act_grad", bn_act_grad_plain, _grad_fake)
def _bn_act_grad_op(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, act: bool) -> torch.Tensor:
    _check_cuda("bn_act_grad", x, dy, channels=_per_channel(x, stats=stats))
    geo = _geometry(x, "grad")
    ws = torch.empty((geo["slabs"], 2, x.shape[-1]), dtype=torch.float32, device=x.device)
    _launch("bn_silu_grad" if act else "bn_grad", "bn_act_grad_partial", x.dtype, x.device, x.data_ptr(),
            dy.data_ptr(), stats.data_ptr(), ws.data_ptr(), *_row_args(x, geo), int(act))
    return _finalize(ws, geo["slabs"], _SUMS, 1)


def _dx_fake(x, dy, stats, sums, scale, count, act):
    return torch.empty_like(x)


@_custom_op("bn_act_dx", bn_act_dx_plain, _dx_fake)
def _bn_act_dx_op(x: torch.Tensor, dy: torch.Tensor, stats: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                  count: int, act: bool) -> torch.Tensor:
    _check_cuda("bn_act_dx", x, dy, channels=_per_channel(x, stats=stats, sums=sums, scale=scale))
    if count < 1:
        raise ValueError(f"bn_act_dx: count must be positive, got {count}")
    geo = _geometry(x, "dx")
    dx = torch.empty_like(x)
    _launch("bn_silu_dx" if act else "bn_dx", "bn_act_dx", x.dtype, x.device, x.data_ptr(), dy.data_ptr(),
            stats.data_ptr(), sums.data_ptr(), scale.data_ptr(), dx.data_ptr(), float(count), *_row_args(x, geo),
            int(act))
    return dx


# ----------------------------------------------------------------------- wrappers
#
# CPU tensors take the plain version, CUDA tensors the kernels (``_call``);
# the CUDA implementations check their operands themselves, since a loaded
# artifact calls the ops directly.


def bn_stats(x, shift, scale, bias, running_mean=None, running_var=None, eps: float = 1e-5) -> torch.Tensor:
    _check_x("bn_stats", x)
    return _call("bn_stats", x, shift, scale, bias, running_mean, running_var, eps)


def bn_moments(x, shift) -> torch.Tensor:
    _check_x("bn_moments", x)
    return _call("bn_moments", x, shift)


def bn_finalize(moments, shift, scale, bias, running_mean, running_var, eps: float, count: int) -> torch.Tensor:
    return _call("bn_finalize", moments, shift, scale, bias, running_mean, running_var, eps, count)


def bn_act_apply(x, stats, act: bool) -> torch.Tensor:
    _check_x("bn_act_apply", x)
    return _call("bn_act_apply", x, stats, act)


def bn_act_eval(x, mean, var, scale, bias, eps: float, act: bool) -> torch.Tensor:
    _check_x("bn_act_eval", x)
    return _call("bn_act_eval", x, mean, var, scale, bias, eps, act)


def bn_act_grad(x, dy, stats, act: bool) -> torch.Tensor:
    _check_x("bn_act_grad", x)
    return _call("bn_act_grad", x, dy, stats, act)


def bn_act_dx(x, dy, stats, sums, scale, count: int, act: bool) -> torch.Tensor:
    _check_x("bn_act_dx", x)
    return _call("bn_act_dx", x, dy, stats, sums, scale, count, act)
