"""Training losses over the padded multi-mouse batch.

Counterpart of ``sensorium_tpu/engine/losses.py``:

* predictions are one zero-padded (M, B, N_max, T) tensor (the all-mice
  forward), targets the sample's own-mouse (B, N_max, T) tensor (or a dense
  (M, B, N_max, T) one after distillation injection), weights a (B, M)
  matrix, one-hot for real samples;
* the weight matrix is normalized to sum 1, each (mouse, sample) cell's
  elementwise loss sum is scaled by its weight, and the cells are summed;
* zero-weight cells are masked by *selection* before the loss runs: the
  prediction is zeroed going in, so a NaN or inf there gets an exact-0
  gradient instead of poisoning the shared trunk (0 * NaN = NaN), and the
  per-cell sums are selected again after the reduction.

Elementwise Poisson NLL follows ``torch.nn.PoissonNLLLoss``:
``pred - target * log(pred + eps)`` (``log_input=False``) or
``exp(pred) - target * pred`` (``log_input=True``), plus the Stirling term
where ``target > 1`` with ``full=True``.

With a data-parallel ``mesh`` each process holds its rows of the global
batch, and the weight sum (and the distillation's count of filled cells) is
the global batch's, reduced over the mesh's data group (the processes of a
model axis hold the same rows and are not summed): each process's loss is
then its share of the global loss, and the shares add up to it, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from sensorium_tpu_torch.parallel import mesh as mesh_lib


def poisson_nll(prediction: torch.Tensor, target: torch.Tensor, eps: float = 1e-8,
                log_input: bool = False, full: bool = False) -> torch.Tensor:
    """Elementwise Poisson NLL (``torch.nn.PoissonNLLLoss`` semantics)."""
    if log_input:
        elem = torch.exp(prediction) - target * prediction
    else:
        elem = prediction - target * torch.log(prediction + eps)
    if full:
        # On a safe value, so that rows with target <= 1 make no nan/inf.
        safe = torch.where(target > 1.0, target, torch.full_like(target, 2.0))
        stirling = safe * torch.log(safe) - safe + 0.5 * torch.log(2.0 * math.pi * safe)
        elem = elem + torch.where(target > 1.0, stirling, torch.zeros_like(stirling))
    return elem


def _broadcast_target(target: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
    """The compact (B, N, T) own-mouse target, or a dense (M, B, N, T) one."""
    return target if target.ndim == prediction.ndim else target[None]


def _masked_cells(prediction, target, weights, elem_fn, neuron_mask=None, mesh=None):
    """Normalized weights, selection-masked elementwise loss, per-cell sums."""
    weights = weights / mesh_lib.all_reduce(mesh, weights.sum())
    active = weights.T != 0.0  # (M, B)
    prediction = torch.where(active[:, :, None, None], prediction, torch.zeros((), dtype=prediction.dtype,
                                                                               device=prediction.device))
    elem = elem_fn(prediction, _broadcast_target(target, prediction))  # (M, B, N, T)
    if neuron_mask is not None:
        elem = elem * neuron_mask[:, None, :, None]
    per_cell = elem.sum(dim=(2, 3))  # (M, B)
    per_cell = torch.where(active, per_cell, torch.zeros_like(per_cell))
    return (per_cell * weights.T).sum()


def mice_poisson_loss(prediction: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, eps: float = 1e-8,
                      log_input: bool = False, full: bool = False,
                      neuron_mask: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """Weighted multi-mouse Poisson NLL.

    With ``log_input=False`` padded rows (prediction == target == 0) add
    exactly 0; ``log_input=True`` makes each padded element worth
    ``exp(0) = 1``, so that form needs ``neuron_mask`` (M, N_max).
    """
    def elem(p, t):
        return poisson_nll(p, t, eps, log_input, full)

    return _masked_cells(prediction, target, weights, elem, neuron_mask, mesh)


def inject_distill_targets(target: torch.Tensor, weights: torch.Tensor, teacher_prediction: torch.Tensor,
                           distill_ratio: float, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Fill every zero-weight (sample, mouse) cell with the teacher's
    prediction as its target and the weight ``ratio / (1 - ratio) *
    sum(weights) / #distilled``, so that after normalization the distilled
    cells carry ``distill_ratio`` of the loss. Returns the dense
    (M, B, N_max, T) target and the filled (B, M) weights."""
    active = weights != 0.0  # (B, M)
    if mesh is None:
        total, num_distilled = weights.sum(), (~active).sum()
    else:
        total, num_distilled = mesh_lib.all_reduce(
            mesh, torch.stack([weights.sum(), (~active).sum().to(weights.dtype)]))
    distill_weight = distill_ratio / (1.0 - distill_ratio) * total / num_distilled
    full_weights = torch.where(active, weights, distill_weight)
    full_target = torch.where(active.T[:, :, None, None], target[None], teacher_prediction)
    return full_target, full_weights


def mice_poisson_distill_loss(prediction, target, weights, teacher_prediction, distill_ratio: float,
                              eps: float = 1e-8) -> torch.Tensor:
    """``inject_distill_targets`` composed with ``mice_poisson_loss``."""
    full_target, full_weights = inject_distill_targets(target, weights, teacher_prediction, distill_ratio)
    return mice_poisson_loss(prediction, full_target, full_weights, eps=eps)


def _l1(pred, target):
    return (pred - target).abs()


def _mse(pred, target):
    return (pred - target).square()


def _smooth_l1(pred, target, beta: float = 1.0):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _huber(pred, target, delta: float = 1.0):
    d = (pred - target).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def _weighted_mice_reduce(elem_fn: Callable) -> Callable:
    """A stock elementwise loss over the padded mice batch, with the same
    weighting and selection masking as ``mice_poisson_loss``."""

    def loss(prediction, target, weights, mesh=None, **kwargs):
        return _masked_cells(prediction, target, weights, lambda p, t: elem_fn(p, t, **kwargs), mesh=mesh)

    return loss


_LOSSES = {
    "mice_poisson": mice_poisson_loss,
    "PoissonNLLLoss": mice_poisson_loss,
    "L1Loss": _weighted_mice_reduce(_l1),
    "MSELoss": _weighted_mice_reduce(_mse),
    "SmoothL1Loss": _weighted_mice_reduce(_smooth_l1),
    "HuberLoss": _weighted_mice_reduce(_huber),
}

# Which optional config kwargs each loss accepts (name -> cast).
_POISSON_KWARGS = {"eps": float, "log_input": bool, "full": bool}
_LOSS_KWARGS = {
    "mice_poisson": _POISSON_KWARGS,
    "PoissonNLLLoss": _POISSON_KWARGS,
    "SmoothL1Loss": {"beta": float},
    "HuberLoss": {"delta": float},
}


def get_loss(name: str, loss_params: dict, neuron_mask: np.ndarray | None = None, mesh=None) -> Callable:
    """The loss a config names, as ``loss_fn(prediction, target, weights)``;
    with a ``mesh``, each process's share of the global batch's loss.

    ``mice_poisson`` defaults to ``log_input=False`` (the reference's
    ``MicePoissonLoss``), the stock ``PoissonNLLLoss`` name to True (torch's
    default). ``log_input=True`` needs the model's (M, N_max) real-neuron
    ``neuron_mask``; it is moved to the prediction's device on use.
    """
    if name not in _LOSSES:
        raise KeyError(f"Unknown loss '{name}'")
    base = _LOSSES[name]
    kwargs = {key: cast(loss_params[key]) for key, cast in _LOSS_KWARGS.get(name, {}).items() if key in loss_params}
    mask = None
    if name in ("mice_poisson", "PoissonNLLLoss"):
        kwargs.setdefault("log_input", name == "PoissonNLLLoss")
        if kwargs["log_input"]:
            if neuron_mask is None:
                raise ValueError(
                    "log_input=True requires the model's neuron mask: padded readout rows would each "
                    "contribute exp(0) = 1 otherwise (get_loss(neuron_mask=...), built from readout_outputs)"
                )
            mask = torch.as_tensor(np.asarray(neuron_mask, np.float32))

    def loss_fn(prediction, target, weights):
        if mask is None:
            return base(prediction, target, weights, mesh=mesh, **kwargs)
        return base(prediction, target, weights, neuron_mask=mask.to(prediction.device), mesh=mesh, **kwargs)

    return loss_fn
