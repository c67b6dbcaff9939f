"""Plain training arithmetic of the published recipe: the multi-mouse Poisson
loss, the distillation targets, the learning-rate plan, AdamW and the EMA,
and a float32 training run that follows the program's first steps.

Imports torch, numpy and this folder only.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import model as ref

ADAM_BETAS = (0.9, 0.999)  # torch.optim.AdamW's defaults, which the recipe keeps
ADAM_EPS = 1e-8


def poisson_loss(prediction: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
                 eps: float = 1e-8) -> torch.Tensor:
    """Weighted multi-mouse Poisson NLL, ``pred - target * log(pred + eps)``
    summed over (neurons, frames) of each (mouse, sample) cell, the cells
    weighted by ``weights`` (B, M) normalized to sum 1. ``prediction`` is
    (M, B, N, T); ``target`` (B, N, T) of each sample's own mouse, or dense
    (M, B, N, T). Cells of weight 0 add nothing."""
    weights = weights / weights.sum()
    active = weights.T != 0.0
    prediction = torch.where(active[:, :, None, None], prediction, torch.zeros_like(prediction))
    target = target if target.ndim == prediction.ndim else target[None]
    per_cell = (prediction - target * torch.log(prediction + eps)).sum(dim=(2, 3))
    per_cell = torch.where(active, per_cell, torch.zeros_like(per_cell))
    return (per_cell * weights.T).sum()


def distill_targets(target, weights, teacher_prediction, ratio: float):
    """Every cell of weight 0 takes the teacher's prediction as its target
    and the weight ``ratio / (1 - ratio) * sum(weights) / #filled``, so that
    the filled cells carry ``ratio`` of the loss."""
    active = weights != 0.0
    fill = ratio / (1.0 - ratio) * weights.sum() / (~active).sum()
    return (torch.where(active.T[:, :, None, None], target[None], teacher_prediction),
            torch.where(active, weights, fill))


def cosine_lr(step: int, peak: float, floor: float, warmup: int, total: int) -> float:
    """Linear warmup from 0, then cosine from peak to floor over ``total`` updates."""
    if step < warmup:
        return peak * step / warmup
    t = min(step - warmup, total)
    return floor + (peak - floor) * 0.5 * (1.0 + math.cos(math.pi * t / total))


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, lr: float, weight_decay: float) -> None:
    """One decoupled-weight-decay Adam update of every parameter with a gradient."""
    b1, b2 = ADAM_BETAS
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for name, g in grads.items():
        p = params[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        p.mul_(1.0 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v / (1.0 - b2 ** t)).sqrt_().add_(ADAM_EPS)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


@torch.no_grad()
def ema_step(ema: dict, values: dict, decay: float) -> None:
    for name, e in ema.items():
        e.mul_(decay).add_(values[name], alpha=1.0 - decay)


def leaf_norms(tensors: dict) -> dict:
    return {name: float(t.double().norm()) for name, t in tensors.items()}


def follow_steps(recipe: dict, weights: dict, batches, generator: torch.Generator, teacher=None,
                 q: ref.Precision = ref.FLOAT32, half_batch: bool = False) -> dict:
    """Train from ``weights`` on ``batches`` (callables giving ``(inputs,
    targets, weights)`` on the device) as the recipe states, drawing the
    masks from ``generator``; returns each step's loss, the first step's
    gradient norm of every parameter, and the norm of each parameter's
    change and of each EMA tensor's change after the last step.

    ``recipe``: ``cfg`` (the nn_module dict), ``lr`` (a function of the
    update count), ``weight_decay``, ``ema_decay``, ``eps``, and
    ``distill_ratio`` with ``teacher`` as ``(teacher cfg, teacher weights)``.
    ``half_batch`` keeps only the first half of each batch's rows (a fault,
    for the control readings).
    """
    cfg = recipe["cfg"]
    names = [n for n, _, _, is_param in ref.param_specs(cfg) if is_param]
    start = {n: t.detach().clone() for n, t in weights.items()}
    params = {n: t.detach().clone().requires_grad_(n in names) for n, t in weights.items()}
    ema = {n: t.detach().clone() for n, t in weights.items()}
    state: dict = {}
    losses, first_grads = [], None
    for count, make_batch in enumerate(batches):
        inputs, targets, row_weights = make_batch()
        masks = ref.draw_masks(cfg, inputs.shape[0], generator, inputs.device)
        if half_batch:
            keep = inputs.shape[0] // 2
            inputs, targets, row_weights = inputs[:keep], targets[:keep], row_weights[:keep]
            masks = ref.Masks({i: m[:keep] for i, m in masks.blocks.items()}, [m[:keep] for m in masks.cortex],
                              None if masks.readout is None else masks.readout[:, :keep])
        stats: dict = {}
        prediction = ref.forward(params, inputs, cfg, train=True, masks=masks, stats=stats, q=q,
                                 checkpoint_blocks=True)
        if teacher is not None:
            teacher_cfg, teacher_weights = teacher
            with torch.no_grad():
                teacher_pred = ref.forward(teacher_weights, inputs, teacher_cfg, q=q)
            targets, row_weights = distill_targets(targets, row_weights, teacher_pred, recipe["distill_ratio"])
            del teacher_pred
        loss = poisson_loss(prediction, targets, row_weights, recipe["eps"])
        del prediction
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = leaf_norms(grads)
        ref.update_running_stats(params, stats)
        adamw_step(params, grads, state, recipe["lr"](count), recipe["weight_decay"])
        del grads
        ema_step(ema, params, recipe["ema_decay"])
    change = leaf_norms({n: params[n].detach() - start[n] for n in names})
    ema_change = leaf_norms({n: ema[n] - start[n] for n in ema})
    return {"losses": losses, "grad_norms": first_grads, "change_norms": change, "ema_change_norms": ema_change}
