"""Optimizer registry keyed by the config names used in experiment files.

Counterpart of ``sensorium_tpu/engine/optimizers.py``. The JAX registry maps
these names to optax transforms built to reproduce ``torch.optim`` step for
step (eps placement, accumulator init, coupled or decoupled weight decay);
here each name is the native ``torch.optim`` class. Every parameter goes in
one group: ``optax.adamw`` decays every leaf, BN scales and biases included.
The JAX ``clip_grad_norm`` transform reproduces
``torch.nn.utils.clip_grad_norm_``, which the train step calls.
"""

from __future__ import annotations

from typing import Iterable

import torch

_OPTIMIZERS = {
    "AdamW": torch.optim.AdamW,
    "Adam": torch.optim.Adam,
    "SGD": torch.optim.SGD,
    "RMSprop": torch.optim.RMSprop,
    "Adagrad": torch.optim.Adagrad,
    "Adamax": torch.optim.Adamax,
    "RAdam": torch.optim.RAdam,
    "NAdam": torch.optim.NAdam,
}

# The keyword arguments the JAX registry takes for each name; torch would
# accept more (Adagrad's lr_decay, AdamW's amsgrad, ...), which the JAX
# package does not have.
_KWARGS = {
    "AdamW": {"weight_decay", "betas", "eps"},
    "Adam": {"weight_decay", "betas", "eps"},
    "SGD": {"momentum", "weight_decay", "nesterov"},
    "RMSprop": {"alpha", "eps", "weight_decay", "momentum", "centered"},
    "Adagrad": {"lr_decay", "weight_decay", "initial_accumulator_value", "eps"},
    "Adamax": {"betas", "eps", "weight_decay"},
    "RAdam": {"betas", "eps", "weight_decay"},
    "NAdam": {"betas", "eps", "weight_decay", "momentum_decay"},
}


def get_optimizer(name: str, optimizer_params: dict, params: Iterable[torch.nn.Parameter],
                  learning_rate: float | None = None) -> torch.optim.Optimizer:
    """Build the ``torch.optim`` optimizer a config names over ``params``.

    ``learning_rate`` overrides the config's ``lr`` (the engine passes the
    schedule's first value and sets ``lr`` before every step).
    """
    if name not in _OPTIMIZERS:
        raise KeyError(f"Unknown optimizer '{name}'")
    kwargs = dict(optimizer_params)
    lr = kwargs.pop("lr", None)
    if learning_rate is None:
        learning_rate = lr
    if learning_rate is None:
        raise ValueError("No learning rate given")
    unknown = set(kwargs) - _KWARGS[name]
    if unknown:
        raise TypeError(f"{name} got unexpected arguments {sorted(unknown)}")
    if name == "Adagrad" and kwargs.get("lr_decay"):
        raise NotImplementedError("Adagrad lr_decay is not supported")
    return _OPTIMIZERS[name](list(params), lr=float(learning_rate), **kwargs)
