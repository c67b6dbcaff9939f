"""Small host-side helpers (counterpart of ``sensorium_tpu/utils/misc.py``)."""

from __future__ import annotations


def get_lr(base_lr: float, batch_size: int, base_batch_size: int = 4) -> float:
    """Linear learning-rate scaling with global batch size."""
    return base_lr * (batch_size / base_batch_size)
