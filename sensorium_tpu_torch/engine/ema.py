"""Exponential moving average over a model's parameters and BN statistics.

Counterpart of ``sensorium_tpu/engine/ema.py``: ``ema = ema * decay + value *
(1 - decay)`` over every parameter and buffer, in place.
"""

from __future__ import annotations

import torch
from torch import nn


def ema_tensors(module: nn.Module) -> list[torch.Tensor]:
    """What the EMA averages: every parameter, then every buffer."""
    return [*module.parameters(), *module.buffers()]


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], values: list[torch.Tensor], decay: float) -> None:
    """One EMA step, in place on ``ema``."""
    if len(ema) != len(values):
        raise ValueError(f"EMA holds {len(ema)} tensors, the model {len(values)}")
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [v.detach().to(e.dtype) for e, v in zip(ema, values)], alpha=1.0 - decay)
