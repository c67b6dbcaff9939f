"""Stochastic regularizers: stochastic depth (drop-path) and channel dropout.

Counterpart of ``sensorium_tpu/ops/stochastic.py``. Training only; every draw
comes from an explicit ``torch.Generator`` on the tensor's device (JAX passes
a PRNG key). The two frameworks draw different bits from the same seed, so
the tests compare mask shapes, scaling and distributions, not values.

Under a data-parallel mesh (``parallel.mesh.active``) a process holds its
rows of the global batch (by its data index: the processes of a model axis
hold the same rows), and every process's generator is in the same state:
each mask is drawn for the global batch and cut to the process's rows, so a
sharded step drops what the single-process step drops.
"""

from __future__ import annotations

import torch

from sensorium_tpu_torch.parallel import mesh as mesh_lib


def _keep_mask(shape: tuple, keep: float, like: torch.Tensor, generator: torch.Generator,
               row_dim: int = 0) -> torch.Tensor:
    """Bernoulli(keep) as 0/1 in ``like``'s dtype; ``row_dim`` is the axis of
    the batch's rows, which a mesh shards."""
    shard = mesh_lib.row_shard()
    if shard is None:
        draws = torch.rand(shape, generator=generator, device=like.device)
    else:
        index, extent = shard
        rows = shape[row_dim]
        full = shape[:row_dim] + (rows * extent,) + shape[row_dim + 1:]
        draws = torch.rand(full, generator=generator, device=like.device).narrow(row_dim, index * rows, rows)
    return (draws < keep).to(like.dtype)


def drop_path_mask(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """The per-sample (B, 1, ..., 1) mask of ``drop_path``: 0, or 1/keep
    rounded to x's dtype."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return _keep_mask(shape, keep, x, generator) / keep


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Stochastic depth: zero a sample's whole residual branch with
    probability ``rate`` and scale the kept ones by 1/keep. Rate 0 is the
    identity and draws nothing."""
    if rate == 0.0:
        return x
    return x * drop_path_mask(x, rate, generator)


def channel_dropout(x: torch.Tensor, rate: float, generator: torch.Generator, sample_dims: int = 1) -> torch.Tensor:
    """Dropout1d in channels-last layout: for x (B, ..., C) the mask is
    (B, 1, ..., 1, C), so a dropped channel is zeroed across the middle axes
    of its sample (torch ``nn.Dropout1d`` on (B, C, T)). With ``sample_dims``
    2, x is (M, B, ..., C) and each of its M x B samples draws its own mask,
    (M, B, 1, ..., 1, C), the draws of the (M * B, ..., C) view. Rate 0 is
    the identity and draws nothing."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape[:sample_dims] + (1,) * (x.ndim - 1 - sample_dims) + (x.shape[-1],)
    return x * _keep_mask(tuple(shape), keep, x, generator, row_dim=sample_dims - 1) / keep
