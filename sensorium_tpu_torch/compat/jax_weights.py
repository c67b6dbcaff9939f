"""Move weights and training state between the JAX package and the port.

The port's parameters and BN statistics keep the JAX tree's names and
shapes (``models/dwiseneuro.py``), so the conversion flattens the nested
``params`` and ``batch_stats`` dicts with ``.`` (``to_jax_variables``
splits them again) and changes no layout. A parity failure after loading
therefore points at the compute, not at this file. Nothing here imports
JAX: the trees arrive as nested dicts of arrays.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            _flatten(value, name + ".", out)
        else:
            if name in out:
                raise ValueError(f"{name} appears in both params and batch_stats")
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """``state.eval_params`` / ``state.eval_batch_stats`` (nested dicts of
    arrays) -> the port's ``state_dict``, to load with ``strict=True``."""
    state: dict[str, torch.Tensor] = {}
    _flatten(params, "", state)
    _flatten(batch_stats, "", state)
    return state


def nest(flat: Mapping[str, object]) -> dict:
    """``{"a.b": v}`` -> ``{"a": {"b": v}}``, keys sorted at every level."""
    tree: dict = {}
    for name in sorted(flat):
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = flat[name]
    return tree


def to_jax_variables(module: torch.nn.Module) -> dict[str, dict]:
    """The inverse of ``from_jax_variables``: ``{"params": nested,
    "batch_stats": nested}`` of the module's parameters and persistent
    buffers (the tensors themselves, not copies)."""
    buffers = dict(module.named_buffers())
    persistent = {name: buffers[name] for name in module.state_dict() if name in buffers}
    return {
        "params": nest({name: p.detach() for name, p in module.named_parameters()}),
        "batch_stats": nest(persistent),
    }


def _adam_moments(opt_state):
    """The optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an
    optimizer state of nested tuples, or None."""
    if all(hasattr(opt_state, key) for key in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_moments(part)
            if found is not None:
                return found
    return None


def from_jax_state(jax_state, state):
    """Carry a JAX ``TrainState`` of an Adam or AdamW run into the port's
    ``TrainState`` built from the same config (in place; returns it).

    Moves the parameters and BN statistics, the EMA copies when both sides
    keep one, the Adam moments ``mu`` / ``nu`` with their count, and the
    update count. The dropout generator is not carried: the two frameworks
    draw different bits.
    """
    if not isinstance(state.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        name = type(state.optimizer).__name__
        raise TypeError(f"from_jax_state carries Adam moments; the port's optimizer is {name}")
    state.model.load_state_dict(from_jax_variables(jax_state.params, jax_state.batch_stats), strict=True)
    if (jax_state.ema_params is None) != (state.ema_model is None):
        raise ValueError("the JAX state and the port's state must both keep an EMA, or neither")
    if state.ema_model is not None:
        state.ema_model.load_state_dict(
            from_jax_variables(jax_state.ema_params, jax_state.ema_batch_stats), strict=True
        )
    adam = _adam_moments(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments")
    mu, nu = {}, {}
    _flatten(adam.mu, "", mu)
    _flatten(adam.nu, "", nu)
    count = float(np.asarray(adam.count))
    for name, param in state.model.named_parameters():
        state.optimizer.state[param] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(param.device),
            "exp_avg_sq": nu[name].to(param.device),
        }
    state.step = int(np.asarray(jax_state.step))
    return state
