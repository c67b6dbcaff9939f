"""Batch normalization over the trailing channel axis.

Counterpart of ``sensorium_tpu/ops/norm.py``. Parameters (``scale``,
``bias``) and running statistics (``mean``, ``var``) are fp32 whatever the
compute dtype, and keep the names of the JAX tree. Both modes compute in
fp32 (float64 for float64 inputs) and cast once to the compute dtype.

* Eval normalizes with the running statistics.
* Training normalizes with the batch statistics: the mean, and the biased
  variance from the *shifted* one-pass form ``E[(x-c)^2] - (E[x]-c)^2`` with
  ``c`` the running mean (no gradient), which keeps two-pass accuracy when
  |mean|/std is large. The running statistics then move with torch's
  momentum 0.1, ``running_var`` with the unbiased variance ``var * n/(n-1)``.

Training runs as one ``torch.autograd.Function`` (``batch_norm_train``): it
saves the input in its own dtype and the per-channel fp32 ``mean`` and
``inv_std``, where autograd of the formula would keep two fp32 copies of
every activation (7.5 GB for block 0's ``pw_bn`` at batch 32). Its backward is
the standard biased-BN backward, which is exact here: with ``c`` constant,
d var / dx = 2 (x - E[x]) / n.

Under a data-parallel mesh (``parallel.mesh.active``) the statistics are the
global batch's, as GSPMD makes them in JAX. Every process holds as many
rows (the mesh's sharding sees to it), so the global ``[E[x], E[(x-c)²]]``
per channel is the mean of the processes': the forward reduces its local
pair in one ``all_reduce`` over the data group (under a ``model`` axis the
processes of a model group hold the same rows, and are not summed) and
divides by the data extent (``c``, the
running mean, is the same on every process; the count is known, so no
``n`` travels), then takes the biased variance as above; the running
update and dx use the global ``n``. At one process this is the
single-process arithmetic bit for bit. The backward reduces ``[Σg,
Σg·x̂]`` in one ``all_reduce`` for dx, and returns the *local* ``dscale``
and ``dbias``: the train step's gradient reduction sums them, as torch's
``SyncBatchNorm`` leaves them. A rematerialized forward (``recompute``)
reduces again; its local moments are those of the first forward, so its
statistics are too. Without a mesh there is no collective.
"""

from __future__ import annotations

import torch
from torch import nn

from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.utils.profiling import span

MOMENTUM = 0.1  # torch's: running = (1 - m) * running + m * batch


def _stats_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(torch.float32, dtype)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, shift, eps, dtype, mesh):
        dims = tuple(range(x.ndim - 1))
        sd = _stats_dtype(x.dtype)
        n = x.numel() // x.shape[-1]
        mean = x.mean(dim=dims, dtype=sd)
        centred = x.to(sd) - shift  # one temporary, squared in place
        centred_sq = centred.square_().mean(dim=dims)
        del centred
        if mesh is not None:
            extent = mesh_lib.data_extent(mesh)
            moments = mesh_lib.all_reduce(mesh, torch.cat([mean, centred_sq])) / extent
            mean, centred_sq = moments.chunk(2)
            n *= extent
        var = centred_sq - (mean - shift).square()
        inv_std = torch.rsqrt(var + eps)
        inv = inv_std * scale
        y = torch.addcmul(bias - mean * inv, x.to(sd), inv).to(dtype)
        ctx.save_for_backward(x, mean, inv_std, scale)
        ctx.mesh, ctx.count = mesh, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        # Unpacked outside the span: the first unpack in a rematerialized
        # block reruns its forward, whose BN forwards are spans of their own.
        x, mean, inv_std, scale = ctx.saved_tensors
        with span("bn.backward"):
            dims = tuple(range(x.ndim - 1))
            sd = mean.dtype
            g = dy.to(sd)
            xhat = (x.to(sd) - mean) * inv_std
            dbias = g.sum(dim=dims)
            dscale = (g * xhat).sum(dim=dims)
            dx = None
            if ctx.needs_input_grad[0]:
                n, total_bias, total_scale = ctx.count, dbias, dscale
                if ctx.mesh is not None:
                    totals = mesh_lib.all_reduce(ctx.mesh, torch.cat([dbias, dscale]))
                    total_bias, total_scale = totals.chunk(2)
                dx = ((g - total_bias / n) - xhat * (total_scale / n)) * (inv_std * scale)
                dx = dx.to(x.dtype)
            return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None, None, None, None


def batch_norm_train(x, scale, bias, shift, eps: float, dtype: torch.dtype, mesh=None):
    """Training-mode BN: ``(y, batch mean, biased batch variance)``.

    ``shift`` is the running mean, used only to condition the variance; the
    statistics come back in fp32 (float64 for float64 inputs) without a
    gradient. With a ``mesh`` (``parallel.mesh.Mesh``) they are the global
    batch's.
    """
    return _BatchNormTrain.apply(x, scale, bias, shift, eps, dtype, mesh)


class BatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features = features
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self._shift: torch.Tensor | None = None

    def forward(self, x: torch.Tensor, recompute: bool = False) -> torch.Tensor:
        """``recompute`` marks a second run of the last training forward (a
        rematerialized block in the backward pass): it normalizes with the
        same shift and leaves the running statistics alone, as JAX's
        ``nn.remat`` discards the recompute's mutation."""
        if not self.training:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            # One multiply-add per element in fp32, cast once at the end.
            return torch.addcmul(self.bias - self.mean * inv, x.float(), inv).to(self.dtype)
        if recompute:
            if self._shift is None:
                raise RuntimeError("BatchNorm recompute without a training forward before it")
            shift = self._shift
        else:
            shift = self._shift = self.mean.clone()
        mesh = mesh_lib.current()
        y, mean, var = batch_norm_train(x, self.scale, self.bias, shift, self.eps, self.dtype, mesh)
        if not recompute:
            n = x.numel() // x.shape[-1] * (1 if mesh is None else mesh_lib.data_extent(mesh))
            with torch.no_grad():
                self.mean.copy_((1 - MOMENTUM) * self.mean + MOMENTUM * mean)
                self.var.copy_((1 - MOMENTUM) * self.var + MOMENTUM * (var * (n / max(n - 1, 1))))
        return y
