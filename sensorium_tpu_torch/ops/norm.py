"""Batch normalization over the trailing channel axis, with the SiLU after it.

Counterpart of ``sensorium_tpu/ops/norm.py`` (and of the ``nn.silu`` that
``sensorium_tpu/models/dwiseneuro.py`` ``BatchNormAct`` puts after it).
Parameters (``scale``, ``bias``) and running statistics (``mean``, ``var``)
are fp32 whatever the compute dtype, and keep the names of the JAX tree.
Both modes compute in fp32 (float64 for float64 inputs) and round once to
the compute dtype; with ``act`` the SiLU then runs on that result and rounds
again, as a SiLU of the compute dtype does. The arithmetic is
``ops/bn_kernels.py``'s: CUDA kernels on the card, their plain versions on
the CPU.

* Eval normalizes with the running statistics: one kernel launch.
* Training normalizes with the batch statistics: the mean, and the biased
  variance from the *shifted* one-pass form ``E[(x-c)^2] - (E[x]-c)^2`` with
  ``c`` the running mean (no gradient), which keeps two-pass accuracy when
  |mean|/std is large. The running statistics then move with torch's
  momentum 0.1, ``running_var`` with the unbiased variance ``var * n/(n-1)``.

Training runs as one ``torch.autograd.Function`` (``batch_norm_train``) for
BN and its SiLU: it saves the input in its own dtype and the per-channel fp32
statistics ``[mean, var, inv_std, a, b]`` (``a = inv_std * scale``, ``b =
bias - mean * a``), where autograd of the formula would keep two fp32 copies
of every activation (7.5 GB for block 0's ``pw_bn`` at batch 32) and SiLU its
own input. Its backward is the standard biased-BN backward, which is exact
here (with ``c`` constant, d var / dx = 2 (x - E[x]) / n), behind SiLU's,
which it recomputes from x.

Under a data-parallel mesh (``parallel.mesh.active``) the statistics are the
global batch's, as GSPMD makes them in JAX. Every process holds as many
rows (the mesh's sharding sees to it), so the global ``[E[x], E[(x-c)²]]``
per channel is the mean of the processes': the forward reduces its local
pair in one ``all_reduce`` over the data group (under a ``model`` axis the
processes of a model group hold the same rows, and are not summed) between
the partial sums and the finalize step, and divides by the data extent
(``c``, the running mean, is the same on every process; the count is known,
so no ``n`` travels), then takes the biased variance as above; the running
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

from sensorium_tpu_torch.ops import bn_kernels
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.utils.profiling import span


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, shift, running_mean, running_var, eps, act, mesh):
        x = x.contiguous()  # a strided shortcut: the kernels read (rows, C) rows
        n = x.numel() // x.shape[-1]
        if mesh is None:
            stats = bn_kernels.bn_stats(x, shift, scale, bias, running_mean, running_var, eps)
        else:
            extent = mesh_lib.data_extent(mesh)
            moments = mesh_lib.all_reduce(mesh, bn_kernels.bn_moments(x, shift)) / extent
            n *= extent
            stats = bn_kernels.bn_finalize(moments, shift, scale, bias, running_mean, running_var, eps, n)
        y = bn_kernels.bn_act_apply(x, stats, act)
        ctx.save_for_backward(x, stats, scale)
        ctx.mesh, ctx.count, ctx.act = mesh, n, act
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        # Unpacked outside the span: the first unpack in a rematerialized
        # block reruns its forward, whose BN forwards are spans of their own.
        x, stats, scale = ctx.saved_tensors
        with span("bn.backward"):
            dy = dy.contiguous()
            sums = bn_kernels.bn_act_grad(x, dy, stats, ctx.act)  # local [Σg, Σg·x̂]
            dx = None
            if ctx.needs_input_grad[0]:
                totals = sums if ctx.mesh is None else mesh_lib.all_reduce(ctx.mesh, sums.clone())
                dx = bn_kernels.bn_act_dx(x, dy, stats, totals, scale, ctx.count, ctx.act)
            return dx, sums[1].to(scale.dtype), sums[0].to(scale.dtype), None, None, None, None, None, None


def batch_norm_train(x, scale, bias, shift, eps: float, dtype: torch.dtype, mesh=None, *, act: bool = False):
    """Training-mode BN, then SiLU if ``act``: ``(y, batch mean, biased batch
    variance)``.

    ``shift`` is the running mean, used only to condition the variance; the
    statistics come back in fp32 (float64 for float64 inputs) without a
    gradient. With a ``mesh`` (``parallel.mesh.Mesh``) they are the global
    batch's. ``BatchNorm`` also hands the Function its running statistics,
    which move in place with the batch's.
    """
    y, stats = _BatchNormAct.apply(x, scale, bias, shift, None, None, eps, act, mesh)
    return y.to(dtype), stats[0], stats[1]


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

    def forward(self, x: torch.Tensor, recompute: bool = False, act: bool = False) -> torch.Tensor:
        """BN, then SiLU if ``act``. ``recompute`` marks a second run of the
        last training forward (a rematerialized block in the backward pass):
        it normalizes with the same shift and leaves the running statistics
        alone, as JAX's ``nn.remat`` discards the recompute's mutation."""
        if not self.training:
            return bn_kernels.bn_act_eval(x.contiguous(), self.mean, self.var, self.scale, self.bias, self.eps,
                                          act).to(self.dtype)
        if recompute:
            if self._shift is None:
                raise RuntimeError("BatchNorm recompute without a training forward before it")
            shift = self._shift
        else:
            shift = self._shift = self.mean.clone()
        running = (None, None) if recompute else (self.mean, self.var)
        y, _ = _BatchNormAct.apply(x, self.scale, self.bias, shift, *running, self.eps, act, mesh_lib.current())
        return y.to(self.dtype)
