"""Learning-rate schedules as plain functions of the integer step.

Counterpart of ``sensorium_tpu/engine/schedule.py``. ``count`` is the number
of optimizer updates done so far (optax's count): the train step sets every
group's ``lr`` to ``schedule(count)`` before ``optimizer.step()``. The
closed forms are those of the JAX module, which reproduce torch's schedulers
(``LambdaLR(x / N)`` warmup, ``CosineAnnealingLR`` and the registry names),
not a ``LambdaLR`` that would multiply the initial lr.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def cosine_annealing(peak_lr: float, min_lr: float, num_iterations: int) -> Schedule:
    """``CosineAnnealingLR``: min + (peak - min) / 2 * (1 + cos(pi * t / T_max))."""

    def schedule(count: int) -> float:
        t = min(count, num_iterations)
        return min_lr + (peak_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t / num_iterations))

    return schedule


def warmup_then(peak_lr: float, warmup_iterations: int, train_schedule: Schedule) -> Schedule:
    """Linear 0 -> peak over the warmup stage (lr 0 at iteration 0), then the
    train-stage schedule on a count that restarts at 0."""
    if warmup_iterations <= 0:
        return train_schedule

    def schedule(count: int) -> float:
        if count < warmup_iterations:
            return peak_lr * count / warmup_iterations
        return train_schedule(count - warmup_iterations)

    return schedule


def warmup_cosine(peak_lr: float, min_lr: float, warmup_iterations: int, train_iterations: int) -> Schedule:
    """Linear 0 -> peak over the warmup stage, then cosine peak -> min."""
    return warmup_then(peak_lr, warmup_iterations, cosine_annealing(peak_lr, min_lr, train_iterations))


def _step_lr(base_lr, *, step_size: int, gamma: float = 0.1) -> Schedule:
    return lambda count: base_lr * gamma ** (count // step_size)


def _multi_step_lr(base_lr, *, milestones, gamma: float = 0.1) -> Schedule:
    ms = tuple(sorted(int(m) for m in milestones))
    return lambda count: base_lr * gamma ** sum(1 for m in ms if count >= m)


def _exponential_lr(base_lr, *, gamma: float) -> Schedule:
    return lambda count: base_lr * gamma**count


def _linear_lr(base_lr, *, start_factor: float = 1.0 / 3, end_factor: float = 1.0, total_iters: int = 5) -> Schedule:
    def schedule(count: int) -> float:
        frac = min(count, total_iters) / total_iters
        return base_lr * (start_factor + (end_factor - start_factor) * frac)

    return schedule


def _constant_lr(base_lr, *, factor: float = 1.0 / 3, total_iters: int = 5) -> Schedule:
    return lambda count: base_lr * (factor if count < total_iters else 1.0)


def _polynomial_lr(base_lr, *, total_iters: int = 5, power: float = 1.0) -> Schedule:
    return lambda count: base_lr * (1.0 - min(count, total_iters) / total_iters) ** power


def _cosine_annealing_lr(base_lr, *, T_max: int, eta_min: float = 0.0) -> Schedule:
    return cosine_annealing(base_lr, eta_min, T_max)


def _cosine_warm_restarts(base_lr, *, T_0: int, T_mult: int = 1, eta_min: float = 0.0) -> Schedule:
    """``CosineAnnealingWarmRestarts`` stepped once per iteration: cycle n
    spans T_0 * T_mult**n iterations."""
    if T_mult < 1:
        raise ValueError("T_mult must be >= 1")

    def schedule(count: int) -> float:
        t_cur, t_i = count, T_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= T_mult
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * t_cur / t_i))

    return schedule


def _one_cycle_lr(base_lr, *, max_lr: float | None = None, total_steps: int | None = None, pct_start: float = 0.3,
                  anneal_strategy: str = "cos", div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """``OneCycleLR`` (three_phase=False): initial = max / div_factor up to
    max over ``pct_start * total_steps - 1`` steps, then down to
    initial / final_div_factor."""
    if total_steps is None:
        raise ValueError("OneCycleLR requires total_steps")
    if anneal_strategy not in ("cos", "linear"):
        raise ValueError(f"anneal_strategy must be cos/linear, got {anneal_strategy!r}")
    max_lr = base_lr if max_lr is None else max_lr
    initial_lr = max_lr / div_factor
    floor_lr = initial_lr / final_div_factor
    up_end = float(pct_start * total_steps) - 1.0
    down_end = float(total_steps) - 1.0

    def anneal(start, end, pct):
        if anneal_strategy == "cos":
            return end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * pct))
        return (end - start) * pct + start

    def schedule(count: int) -> float:
        t = min(float(count), down_end)
        if t <= up_end:
            return anneal(initial_lr, max_lr, min(max(t / up_end, 0.0), 1.0))
        return anneal(max_lr, floor_lr, min(max((t - up_end) / (down_end - up_end), 0.0), 1.0))

    return schedule


_SCHEDULERS = {
    "StepLR": _step_lr,
    "MultiStepLR": _multi_step_lr,
    "ExponentialLR": _exponential_lr,
    "LinearLR": _linear_lr,
    "ConstantLR": _constant_lr,
    "PolynomialLR": _polynomial_lr,
    "CosineAnnealingLR": _cosine_annealing_lr,
    "CosineAnnealingWarmRestarts": _cosine_warm_restarts,
    "OneCycleLR": _one_cycle_lr,
}


def get_scheduler(name: str, base_lr: float, scheduler_params: dict) -> Schedule:
    """A named train-stage schedule, as a function of the iteration count."""
    if name not in _SCHEDULERS:
        raise KeyError(f"Unknown lr scheduler '{name}' (have {sorted(_SCHEDULERS)})")
    return _SCHEDULERS[name](base_lr, **scheduler_params)


def build_stage_schedule(peak_lr: float, min_lr: float, warmup_iterations: int, train_iterations: int,
                         scheduler_spec=None) -> Schedule:
    """The full lr plan of a config's stage list: warmup + cosine by default;
    with ``("Name", {...})`` the named scheduler replaces the cosine, and a
    parameter value ``"train_iters"`` becomes the train-stage length."""
    if scheduler_spec is None:
        return warmup_cosine(peak_lr, min_lr, warmup_iterations, train_iterations)
    name, params = scheduler_spec
    params = {k: (train_iterations if v == "train_iters" else v) for k, v in dict(params).items()}
    return warmup_then(peak_lr, warmup_iterations, get_scheduler(name, peak_lr, params))
