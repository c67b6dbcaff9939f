"""DwiseNeuro, the Sensorium 2023 winning architecture: eval and training forward.

Counterpart of ``sensorium_tpu/models/dwiseneuro.py``, module for module.
Parameters and BN statistics keep the names and shapes of the JAX tree
(``block_0.pw_kernel`` (in, out), ``block_0.spatial_dw_kernel`` (k, k, C),
``block_0.pw_bn.bn.scale`` / ``.mean``, ``readout_kernel`` (M, G, C/G, P)),
so ``compat.jax_weights.from_jax_variables`` is a flatten-and-rename.

Parameters are fp32; compute runs in ``dtype`` (bf16 for the flagship) and
rounds to it where the JAX forward does: after every pointwise conv, every
depthwise conv and every BN. The readout logits are fp32 products of the
bf16-rounded operands. Layout is channels-last (B, T, H, W, C) inside.

Structure:
  stem: pointwise conv in->f0 + BN
  9x [add 3-axis sinusoidal PE,
      InvertedResidual3d: pw-expand -> spatial dw -> temporal dw -> SE ->
      pw-linear, BN after every conv, plus a downsample/tile shortcut]
  spatial mean
  cortex: 3x grouped-1x1 ShuffleLayer
  stacked per-mouse readouts -> Softplus(beta)

Eval mode normalizes with the running statistics; there each block's
``pw_bn`` and ``spatial_bn`` run inside the depthwise convs that read them
(``ops/conv.py`` ``depthwise_conv_*_bn``), bitwise the chain, where the
depthwise route allows it.

Training mode (``model.train()``) uses BN batch statistics and draws its
masks from the ``generator`` passed to ``forward``: drop-path on each block's
residual branch at ``drop_path_rate * i / num_blocks`` and on each cortex
layer at the full rate, channel dropout on the cortex output (one mask per
mouse on the all-mice path). ``remat`` / ``remat_blocks`` rerun the chosen
blocks in the backward pass (``torch.utils.checkpoint``) instead of keeping
their activations; a block's drop-path mask is drawn before the block, so the
recompute uses the same mask, and its BatchNorms keep their first forward's
shift and update their running statistics once.

Tensor parallelism (``parallel/tensor.py``): once ``shard_module`` has
sliced the cortex kernels and the readout over a mesh's ``model`` axis,
``model_mesh`` holds that mesh. A cortex layer then multiplies its
replicated input (through ``copy_to_model``) by its kernel slice, gathers
the slices along the per-group axis and flattens them to the (..., G *
Cout/G) layout that BN and the channel shuffle read; the readout multiplies
the replicated cortex output by its (…, P / model) slice, adds the bias
slice, applies softplus and gathers the rows. The core, every BN, the
learnable softplus betas (whose gradient is summed over the model group)
and the masks are replicated. Over a model group of one process's cards
(a mesh without a process group, for serving) the sharded weights are
``LocalSlices`` and each sharded product runs slice by slice on the
slices' cards through ``local_product``, which gathers on the group's first
card; the core, every BN and the softplus (after the gather: it is
elementwise) run there once. Without it the forward is the single-device
one.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sensorium_tpu_torch.ops.conv import (
    depthwise_conv_spatial,
    depthwise_conv_spatial_bn,
    depthwise_conv_temporal,
    depthwise_conv_temporal_bn,
    einsum_f32,
    eval_bn_runs_in_dw,
    grouped_pointwise,
    pointwise,
)
from sensorium_tpu_torch.ops.dw_kernels import spatial_out_size
from sensorium_tpu_torch.ops.norm import BatchNorm
from sensorium_tpu_torch.ops.pe import position_encoding_3d
from sensorium_tpu_torch.ops.shuffle import channel_shuffle
from sensorium_tpu_torch.ops.stochastic import channel_dropout, drop_path, drop_path_mask
from sensorium_tpu_torch.parallel.tensor import copy_to_model, gather_from_model, local_product
from sensorium_tpu_torch.utils.profiling import span


def kaiming_normal_out(shape: Sequence[int], fan_out: int, generator: torch.Generator) -> nn.Parameter:
    """Conv weight init: normal(0, sqrt(2 / fan_out)), fan_out group-corrected."""
    return nn.Parameter(torch.randn(*shape, generator=generator) * math.sqrt(2.0 / fan_out))


def softplus_beta(x: torch.Tensor, beta: float, threshold: float = 20.0) -> torch.Tensor:
    """softplus(beta * x) / beta with torch's linear region above threshold."""
    bx = beta * x
    return torch.where(bx > threshold, x, torch.logaddexp(bx, torch.zeros((), dtype=x.dtype, device=x.device)) / beta)


def softplus_learnable(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """softplus(beta * x) / beta with a trainable beta and no threshold."""
    bx = beta * x
    return torch.logaddexp(bx, torch.zeros((), dtype=x.dtype, device=x.device)) / beta


def readout_group_sizes(num_neurons: int, groups: int) -> list[int]:
    """How many of each group's conv outputs survive the slice to N neurons.

    The grouped conv emits ceil(N/G) channels per group; slicing the
    concatenated output to N keeps all of the leading groups and a partial
    tail group.
    """
    per_group = math.ceil(num_neurons / groups)
    sizes = []
    remaining = num_neurons
    for _ in range(groups):
        take = min(per_group, max(remaining, 0))
        sizes.append(take)
        remaining -= take
    return sizes


def padded_group_size(readout_outputs: Sequence[int], groups: int, multiple: int) -> int:
    """Per-group readout rows: the largest ``ceil(N / groups)``, padded up to ``multiple``."""
    largest = max(math.ceil(n / groups) for n in readout_outputs)
    return (largest + multiple - 1) // multiple * multiple


def tile_channels(x: torch.Tensor, features: int) -> torch.Tensor:
    """Repeat the channel axis and cut it to ``features`` channels."""
    reps = math.ceil(features / x.shape[-1])
    return torch.cat([x] * reps, dim=-1)[..., :features]


class BatchNormAct(nn.Module):
    """BN, then SiLU if ``act``, as one op (``ops/norm.py``): every BN of the
    model, each forward a span ``bn_act.train``, ``bn_act.recompute`` (a
    rematerialized block's rerun) or ``bn_act.eval``."""

    def __init__(self, features: int, act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = BatchNorm(features, dtype=dtype)
        self.act = act

    def forward(self, x: torch.Tensor, recompute: bool = False) -> torch.Tensor:
        with span("bn_act.recompute" if recompute else "bn_act.train" if self.training else "bn_act.eval"):
            return self.bn(x, recompute, self.act)


class SqueezeExcite(nn.Module):
    """Global-context channel gating: mean over (T,H,W) -> reduce -> expand."""

    def __init__(self, features: int, reduce_ratio: int, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        rd = features // reduce_ratio
        self.dtype = dtype
        self.reduce_kernel = kaiming_normal_out((features, rd), rd, generator)
        self.reduce_bias = nn.Parameter(torch.zeros(rd))
        self.expand_kernel = kaiming_normal_out((rd, features), features, generator)
        self.expand_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        squeezed = x.mean(dim=(1, 2, 3), dtype=torch.float32).to(dt)
        gate = F.silu(squeezed @ self.reduce_kernel.to(dt) + self.reduce_bias.to(dt))
        gate = torch.sigmoid(gate @ self.expand_kernel.to(dt) + self.expand_bias.to(dt))
        return x * gate[:, None, None, None, :]


class InvertedResidual3d(nn.Module):
    """(2+1)D depthwise inverted-residual block with SE and BN shortcuts."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        spatial_kernel: int,
        temporal_kernel: int,
        spatial_stride: int,
        expansion_ratio: int,
        se_reduce_ratio: int,
        dtype: torch.dtype,
        generator: torch.Generator,
    ):
        super().__init__()
        mid = in_features * expansion_ratio
        self.out_features = out_features
        self.spatial_stride = spatial_stride
        self.dtype = dtype
        self.pw_kernel = kaiming_normal_out((in_features, mid), mid, generator)
        self.pw_bn = BatchNormAct(mid, dtype=dtype)
        self.spatial_dw_kernel = kaiming_normal_out(
            (spatial_kernel, spatial_kernel, mid), spatial_kernel * spatial_kernel, generator
        )
        self.spatial_bn = BatchNormAct(mid, dtype=dtype)
        self.temporal_dw_kernel = kaiming_normal_out((temporal_kernel, mid), temporal_kernel, generator)
        self.temporal_bn = BatchNormAct(mid, dtype=dtype)
        self.se = SqueezeExcite(mid, se_reduce_ratio, dtype, generator)
        self.pwl_kernel = kaiming_normal_out((mid, out_features), out_features, generator)
        self.pwl_bn = BatchNormAct(out_features, act=False, dtype=dtype)
        self.bn_sc = BatchNormAct(out_features, act=False, dtype=dtype)

    def shortcut(self, x: torch.Tensor, recompute: bool = False) -> torch.Tensor:
        """Parameter-free shortcut: nearest spatial downsample + channel tile.

        When the stride divides H and W, the nearest index i*H // out_h is
        i*stride, a strided slice; otherwise the indexes are gathered.
        """
        _, _, h, w, c = x.shape
        s = self.spatial_stride
        if s > 1:
            if h % s == 0 and w % s == 0:
                x = x[:, :, ::s, ::s]
            else:
                out_h, out_w = math.ceil(h / s), math.ceil(w / s)
                idx_h = torch.arange(out_h, device=x.device) * h // out_h
                idx_w = torch.arange(out_w, device=x.device) * w // out_w
                x = x.index_select(2, idx_h).index_select(3, idx_w)
        if c != self.out_features:
            x = tile_channels(x, self.out_features)
        return self.bn_sc(x, recompute)

    def forward(self, x: torch.Tensor, drop_mask: torch.Tensor | None = None,
                recompute: bool = False) -> torch.Tensor:
        """``drop_mask``: the (B, 1, 1, 1, 1) drop-path mask of the residual
        branch, or None; ``recompute``: this is the backward pass's rerun of
        the last forward (see ``BatchNorm``). In eval, ``pw_bn`` and
        ``spatial_bn`` run inside the depthwise convs that read them, where
        the route allows (``ops/conv.py``): the same bits, and neither BN's
        output is written."""
        shortcut = self.shortcut(x, recompute)
        x = pointwise(x, self.pw_kernel.to(self.dtype))
        if self.training or not eval_bn_runs_in_dw(self.spatial_dw_kernel, self.temporal_dw_kernel):
            x = self.spatial_bn(depthwise_conv_spatial(self.pw_bn(x, recompute), self.spatial_dw_kernel,
                                                       self.spatial_stride), recompute)
            x = depthwise_conv_temporal(x, self.temporal_dw_kernel)
        else:
            x = depthwise_conv_spatial_bn(x, self.pw_bn.bn, self.spatial_dw_kernel, self.spatial_stride)
            x = depthwise_conv_temporal_bn(x, self.spatial_bn.bn, self.temporal_dw_kernel)
        x = self.temporal_bn(x, recompute)
        x = self.se(x)
        x = self.pwl_bn(pointwise(x, self.pwl_kernel.to(self.dtype)), recompute)
        if drop_mask is not None:
            x = x * drop_mask
        return x + shortcut


def checkpointed(block: InvertedResidual3d, x: torch.Tensor, drop_mask: torch.Tensor | None) -> torch.Tensor:
    """``block(x, drop_mask)`` without keeping its activations: the backward
    pass reruns it with ``recompute=True``."""
    calls = []

    def run(x, drop_mask):
        calls.append(None)
        return block(x, drop_mask, recompute=len(calls) > 1)

    return checkpoint(run, x, drop_mask, use_reentrant=False, preserve_rng_state=False)


class ShuffleLayer(nn.Module):
    """Grouped 1x1 conv over (B, T, C) + BN/SiLU + channel shuffle + shortcut."""

    def __init__(self, in_features: int, out_features: int, groups: int, drop_path_rate: float,
                 dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        cout_g = out_features // groups
        self.out_features = out_features
        self.groups = groups
        self.drop_path_rate = drop_path_rate
        self.dtype = dtype
        self.kernel = kaiming_normal_out((groups, in_features // groups, cout_g), cout_g, generator)
        self.bn = BatchNormAct(out_features, dtype=dtype)
        self.bn_sc = BatchNormAct(out_features, act=False, dtype=dtype)
        self.model_mesh = None  # set by parallel.tensor.shard_module

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        mesh = self.model_mesh
        if mesh is None:
            y = grouped_pointwise(x, self.kernel.to(self.dtype))
        elif mesh.distributed:
            # (..., G * Cout/G/model) -> gather each group's columns -> (..., G * Cout/G).
            y = grouped_pointwise(copy_to_model(x, mesh), self.kernel.to(self.dtype))
            y = gather_from_model(y.reshape(*y.shape[:-1], self.groups, -1), -1, mesh).flatten(-2)
        else:
            def product(x, kernel):
                y = grouped_pointwise(x, kernel.to(self.dtype))
                return y.reshape(*y.shape[:-1], self.groups, -1)

            y = local_product(product, x, self.kernel).flatten(-2)
        y = self.bn(y)
        y = channel_shuffle(y, self.groups)
        if self.training:
            y = drop_path(y, self.drop_path_rate, generator)
        shortcut = x if x.shape[-1] == self.out_features else tile_channels(x, self.out_features)
        return y + self.bn_sc(shortcut)


class DwiseNeuro(nn.Module):
    """Core + cortex + stacked per-mouse readouts.

    ``forward(inputs, mouse_index=None, generator=None)``: inputs
    (B, 5, T, H, W) float32. ``mouse_index`` None -> (num_mice, B,
    max(readout_outputs), T) padded with exact zeros; otherwise
    (B, readout_outputs[mouse_index], T). Both are fp32. In training mode
    with a drop rate above 0, ``generator`` (on the inputs' device) is
    required.

    Weights are kaiming-normal draws from ``generator`` (a fresh
    ``torch.Generator`` seeded with 0 when none is given), made on the CPU;
    move the module with ``.to(device)``.
    """

    def __init__(
        self,
        readout_outputs: Sequence[int],
        in_channels: int = 5,
        core_features: Sequence[int] = (64, 64, 64, 64, 128, 128, 128, 256, 256),
        spatial_strides: Sequence[int] = (2, 1, 1, 1, 2, 1, 1, 2, 1),
        spatial_kernel: int = 3,
        temporal_kernel: int = 5,
        expansion_ratio: int = 6,
        se_reduce_ratio: int = 32,
        cortex_features: Sequence[int] = (1024, 2048, 4096),
        groups: int = 2,
        softplus_beta: float = 0.07,
        learnable_softplus: bool = False,
        drop_rate: float = 0.4,
        drop_path_rate: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
        readout_pad_multiple: int = 128,
        remat: bool = True,
        remat_blocks: int | Sequence[int] = -1,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        features = tuple(core_features)
        if len(spatial_strides) != len(features):
            raise ValueError(
                f"spatial_strides has {len(spatial_strides)} entries for "
                f"{len(features)} core blocks (core_features {features})"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.readout_outputs = tuple(readout_outputs)
        self.core_features = features
        self.groups = groups
        self.softplus_beta = softplus_beta
        self.learnable_softplus = learnable_softplus
        self.dtype = dtype
        self.readout_pad_multiple = readout_pad_multiple
        self.drop_rate, self.drop_path_rate = drop_rate, drop_path_rate
        self.model_mesh = None  # set by parallel.tensor.shard_module
        self._pe_cache: dict[tuple, torch.Tensor] = {}
        self._pe_buffers: dict[tuple, str] = {}  # (C, T, H, W) -> name of a held table

        self.stem_kernel = kaiming_normal_out((in_channels, features[0]), features[0], generator)
        self.stem_bn = BatchNormAct(features[0], act=False, dtype=dtype)
        self.num_blocks = len(features)
        if not remat:
            self.remat_set = frozenset()
        elif isinstance(remat_blocks, int):
            self.remat_set = frozenset(range(self.num_blocks if remat_blocks < 0 else remat_blocks))
        else:
            self.remat_set = frozenset(int(i) for i in remat_blocks)
        for i in range(self.num_blocks):
            out_features = features[i + 1] if i + 1 < self.num_blocks else features[i]
            self.add_module(
                f"block_{i}",
                InvertedResidual3d(
                    features[i], out_features, spatial_kernel, temporal_kernel, spatial_strides[i],
                    expansion_ratio, se_reduce_ratio, dtype, generator,
                ),
            )
        self.num_cortex = len(cortex_features)
        prev = features[-1]
        for i, width in enumerate(cortex_features):
            self.add_module(f"cortex_{i}", ShuffleLayer(prev, width, groups, drop_path_rate, dtype, generator))
            prev = width

        cin_g = prev // groups
        pad = self.padded_group_size
        # Per-mouse init std follows the group-corrected fan_out of the
        # reference conv init: sqrt(2 / ceil(N_i / G)).
        stds = torch.tensor([math.sqrt(2.0 / math.ceil(n / groups)) for n in self.readout_outputs])
        kernel = torch.randn(self.num_mice, groups, cin_g, pad, generator=generator)
        self.readout_kernel = nn.Parameter(kernel * stds[:, None, None, None])
        self.readout_bias = nn.Parameter(torch.zeros(self.num_mice, groups, pad))
        if learnable_softplus:
            self.readout_softplus_beta = nn.Parameter(torch.full((self.num_mice,), float(softplus_beta)))

    @property
    def num_mice(self) -> int:
        return len(self.readout_outputs)

    @property
    def max_neurons(self) -> int:
        return max(self.readout_outputs)

    @property
    def padded_group_size(self) -> int:
        """Per-group readout rows, padded up to ``readout_pad_multiple``."""
        return padded_group_size(self.readout_outputs, self.groups, self.readout_pad_multiple)

    def _position_encoding(self, x: torch.Tensor) -> torch.Tensor:
        """The (T, H, W, C) PE table for x, in x's dtype, kept on x's device:
        a held buffer (``hold_position_encodings``), else a cached table.

        Under tracing without a held buffer the table is made anew and
        becomes a constant of the graph; the cache holds only tables of real
        tensors."""
        key = (x.shape[-1], *x.shape[1:4], x.dtype, x.device)
        held = self._pe_buffers.get(key[:4])
        if held is not None:
            return getattr(self, held).to(dtype=x.dtype)
        if torch.compiler.is_compiling():
            table = position_encoding_3d(x.shape[-1], *x.shape[1:4])
            return torch.from_numpy(table).to(device=x.device, dtype=x.dtype)
        if key not in self._pe_cache:
            table = position_encoding_3d(x.shape[-1], *x.shape[1:4])
            self._pe_cache[key] = torch.from_numpy(table).to(device=x.device, dtype=x.dtype)
        return self._pe_cache[key]

    def hold_position_encodings(self, frames: int, height: int, width: int) -> None:
        """Keep the PE tables that inputs of ``frames`` x ``height`` x
        ``width`` meet as non-persistent buffers, in the compute dtype on the
        module's device. A traced graph (``torch.export``) takes buffers as
        inputs; a table made while tracing the body of a ``scan`` would be a
        constant there, which the serializer refuses."""
        device = self.stem_kernel.device
        for i in range(self.num_blocks):
            block = getattr(self, f"block_{i}")
            key = (self.core_features[i], frames, height, width)
            if key not in self._pe_buffers:
                table = torch.from_numpy(position_encoding_3d(*key)).to(device=device, dtype=self.dtype)
                self._pe_buffers[key] = f"pe_table_{i}"
                self.register_buffer(f"pe_table_{i}", table, persistent=False)
            k = block.spatial_dw_kernel.shape[0]
            height = spatial_out_size(height, k, block.spatial_stride)
            width = spatial_out_size(width, k, block.spatial_stride)

    def core(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.stem_bn(pointwise(x, self.stem_kernel.to(self.dtype)))
        for i in range(self.num_blocks):
            x = x + self._position_encoding(x)
            block = getattr(self, f"block_{i}")
            rate = self.drop_path_rate * i / self.num_blocks
            mask = drop_path_mask(x, rate, generator) if self.training and rate > 0.0 else None
            if self.training and i in self.remat_set:
                x = checkpointed(block, x, mask)
            else:
                x = block(x, mask)
        return x

    def cortex(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(self.num_cortex):
            x = getattr(self, f"cortex_{i}")(x, generator)
        return x

    def _softplus(self, logits: torch.Tensor, beta: torch.Tensor | None) -> torch.Tensor:
        if self.learnable_softplus:
            return softplus_learnable(logits, beta)
        return softplus_beta(logits, self.softplus_beta)

    def _process_group(self) -> bool:
        """Whether the readout is sharded over a process group's model axis."""
        return self.model_mesh is not None and self.model_mesh.distributed

    def _betas(self) -> torch.Tensor | None:
        """The learnable (M,) softplus betas, or None. Under a process
        group's model axis each process applies them to its row slice only,
        so their gradient is summed over the model group (``copy_to_model``)."""
        if not self.learnable_softplus:
            return None
        if not self._process_group():
            return self.readout_softplus_beta
        return copy_to_model(self.readout_softplus_beta, self.model_mesh)

    def _gather_rows(self, grouped: torch.Tensor) -> torch.Tensor:
        """(..., G, P / model) readout slices -> (..., G, P) under a process group's model axis."""
        if not self._process_group():
            return grouped
        return gather_from_model(grouped, -1, self.model_mesh)

    def _logits(self, equation: str, x: torch.Tensor, mouse_index: int | None) -> torch.Tensor:
        """The readout's fp32 logits ``einsum(equation, x, kernel) + bias`` of
        one mouse's head, or of every mouse's (``mouse_index`` None): slice by
        slice over a model group of this process's cards (gathered on ``x``'s
        card), else of this process's weights."""

        def product(x, kernel, bias):
            if mouse_index is None:
                return einsum_f32(equation, x, kernel.to(self.dtype)) + bias[:, None, None]
            return einsum_f32(equation, x, kernel[mouse_index].to(self.dtype)) + bias[mouse_index]

        if self.model_mesh is not None and not self.model_mesh.distributed:
            return local_product(product, x, self.readout_kernel, self.readout_bias)
        return product(x, self.readout_kernel, self.readout_bias)

    def _assemble_flat(self, grouped: torch.Tensor, mouse: int) -> torch.Tensor:
        """(B, T, G, P) group-layout activations -> (B, N_mouse, T) flat order."""
        sizes = readout_group_sizes(self.readout_outputs[mouse], self.groups)
        flat = torch.cat([grouped[:, :, g, : sizes[g]] for g in range(self.groups)], dim=-1)
        return flat.transpose(1, 2)

    def forward(self, inputs: torch.Tensor, mouse_index: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training and generator is None and (self.drop_rate > 0.0 or self.drop_path_rate > 0.0):
            raise ValueError("a training forward with drop rates above 0 needs a torch.Generator")
        x = inputs.permute(0, 2, 3, 4, 1).to(self.dtype)  # (B, T, H, W, C)
        x = self.core(x, generator)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)  # (B, T, C)
        x = self.cortex(x, generator)
        dropout = self.training and self.drop_rate > 0.0
        if self._process_group():
            x = copy_to_model(x, self.model_mesh)

        if mouse_index is not None:
            if dropout:
                x = channel_dropout(x, self.drop_rate, generator)
            xg = x.reshape(*x.shape[:-1], self.groups, x.shape[-1] // self.groups)  # (B, T, G, C/G)
            logits = self._logits("btgc,gcp->btgp", xg, mouse_index)
            betas = self._betas()
            beta = None if betas is None else betas[mouse_index]
            return self._assemble_flat(self._gather_rows(self._softplus(logits, beta)), mouse_index)

        if dropout:
            # Each readout draws its own mask on the shared cortex output
            # (every reference Readout holds its own Dropout1d).
            m = self.num_mice
            xm = channel_dropout(x.expand(m, *x.shape), self.drop_rate, generator, sample_dims=2)
            xm = xm.reshape(m, *x.shape[:-1], self.groups, x.shape[-1] // self.groups)
            logits = self._logits("mbtgc,mgcp->mbtgp", xm, None)
        else:
            xg = x.reshape(*x.shape[:-1], self.groups, x.shape[-1] // self.groups)
            logits = self._logits("btgc,mgcp->mbtgp", xg, None)
        betas = self._betas()
        beta = None if betas is None else betas[:, None, None, None, None]
        pred = self._gather_rows(self._softplus(logits, beta))
        padded = []
        for mouse in range(self.num_mice):
            flat = self._assemble_flat(pred[mouse], mouse)  # (B, N_m, T)
            padded.append(F.pad(flat, (0, 0, 0, self.max_neurons - flat.shape[1])))
        return torch.stack(padded, dim=0)  # (M, B, N_max, T)


def neuron_validity_mask(readout_outputs: Sequence[int]) -> np.ndarray:
    """(M, N_max) float32 mask of real (non-padded) neurons per mouse."""
    mask = np.zeros((len(readout_outputs), max(readout_outputs)), dtype=np.float32)
    for i, n in enumerate(readout_outputs):
        mask[i, :n] = 1.0
    return mask
