"""Stochastic regularizers: stochastic depth (drop-path) and channel dropout.

Counterpart of ``sensorium_tpu/ops/stochastic.py``. Training only; every draw
comes from an explicit ``torch.Generator`` on the tensor's device (JAX passes
a PRNG key). The two frameworks draw different bits from the same seed, so
the tests compare mask shapes, scaling and distributions, not values.
"""

from __future__ import annotations

import torch


def _keep_mask(shape: tuple, keep: float, like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(keep) as 0/1 in ``like``'s dtype."""
    draws = torch.rand(shape, generator=generator, device=like.device)
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


def channel_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Dropout1d in channels-last layout: for x (B, ..., C) the mask is
    (B, 1, ..., 1, C), so a dropped channel is zeroed across the middle axes
    of its sample (torch ``nn.Dropout1d`` on (B, C, T)). Rate 0 is the
    identity and draws nothing."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return x * _keep_mask(shape, keep, x, generator) / keep
