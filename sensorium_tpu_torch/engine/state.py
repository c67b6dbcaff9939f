"""Training state.

Counterpart of ``sensorium_tpu/engine/state.py``. The JAX state is one
immutable pytree; here it is the live objects: the model (fp32 master
weights and BN statistics), the optimizer with its moments, the update
count that drives the lr schedule, an optional EMA copy of the model, and
the generator that every dropout and drop-path mask is drawn from.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int  # optimizer updates done so far (the schedule's count)
    model: nn.Module
    optimizer: torch.optim.Optimizer | None  # None in a model loaded for inference (load_model)
    ema_model: nn.Module | None  # EMA of the parameters and buffers, or None
    generator: torch.Generator  # on the model's device

    @property
    def eval_model(self) -> nn.Module:
        """What validation and prediction run: the EMA model if there is one."""
        return self.model if self.ema_model is None else self.ema_model

    def eval_state_dict(self) -> dict[str, torch.Tensor]:
        """The weights and BN statistics of ``eval_model`` (JAX's
        ``eval_params`` and ``eval_batch_stats``, flattened)."""
        return self.eval_model.state_dict()
