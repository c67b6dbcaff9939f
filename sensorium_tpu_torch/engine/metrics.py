"""Validation metrics (counterpart of ``sensorium_tpu/engine/metrics.py``).

The per-neuron single-trial correlation, per mouse and averaged (keys
``val_corr_mouse_{i}`` and ``val_corr``), with (batch, time) flattened into
the sample axis. Pearson correlation over a fixed population is a function
of five running sums per neuron (Σx, Σy, Σxy, Σx², Σy²), so the metric keeps
an ``(M, N_max, 5)`` block of sums instead of every prediction:

* ``batch_corr_stats`` reduces one batch on the prediction's device, in
  fp32, and ``MouseModel.fit`` copies only the sums to the host;
* the host accumulates them in float64, and the correlation
  ``cov / ((std_x + eps) * (std_y + eps))`` is the reference's
  standardized-product mean (ddof 0, eps on the std).
"""

from __future__ import annotations

import numpy as np
import torch

from sensorium_tpu_torch import constants


def corr(y1: np.ndarray, y2: np.ndarray, axis=-1, eps: float = 1e-8, **kwargs) -> np.ndarray:
    """Pearson correlation along ``axis`` (standardized product mean, ddof 0)."""
    y1 = (y1 - y1.mean(axis=axis, keepdims=True)) / (y1.std(axis=axis, keepdims=True, ddof=0) + eps)
    y2 = (y2 - y2.mean(axis=axis, keepdims=True)) / (y2.std(axis=axis, keepdims=True, ddof=0) + eps)
    return (y1 * y2).mean(axis=axis, **kwargs)


def batch_corr_stats(prediction: torch.Tensor, target: torch.Tensor, weights: torch.Tensor):
    """Per-mouse correlation sums of one batch, on the prediction's device.

    prediction (M, B, N_max, T); target (B, N_max, T); weights (B, M).
    Returns ``counts`` (M,), the number of (sample, frame) pairs, and
    ``sums`` (M, N_max, 5) = [Σx, Σy, Σxy, Σx², Σy²] over the samples of each
    mouse, both fp32.
    """
    x = prediction.float()  # (M, B, N, T)
    y = target.float()[None]  # (1, B, N, T)
    mask = (weights != 0.0).float()  # (B, M)
    w = mask.t()[:, :, None, None]  # (M, B, 1, 1)

    def msum(v):
        return (v * w).sum(dim=(1, 3))  # (M, N)

    sums = torch.stack([msum(x), msum(y), msum(x * y), msum(x * x), msum(y * y)], dim=-1)
    counts = mask.sum(dim=0) * x.shape[-1]
    return counts, sums


class CorrelationMetric:
    """Running-sums Pearson correlation per mouse (see the module docstring)."""

    name = "corr"
    eps = 1e-8

    def __init__(self, num_neurons: list[int] | None = None):
        self.num_neurons = num_neurons if num_neurons is not None else constants.num_neurons
        self.reset()

    def reset(self) -> None:
        m = len(self.num_neurons)
        self._counts = np.zeros(m, np.float64)
        self._sums = np.zeros((m, max(self.num_neurons), 5), np.float64)

    # The device path: MouseModel.fit reduces on the card and feeds the sums in.
    batch_stats = staticmethod(batch_corr_stats)

    def update_stats(self, counts, sums) -> None:
        counts = np.asarray(counts, np.float64)
        sums = np.asarray(sums, np.float64)
        # The prediction may be padded past this metric's (M, N_max).
        self._counts += counts[: self._counts.shape[0]]
        self._sums += sums[: self._sums.shape[0], : self._sums.shape[1]]

    def update(self, prediction, target, weights) -> None:
        """The host-array path, in float64: prediction (M, B, N_max, T),
        target (B, N_max, T), weights (B, M)."""
        prediction = np.asarray(prediction, np.float32)
        mask = (np.asarray(weights) != 0.0).astype(np.float64)  # (B, M)
        w = mask.T[:, :, None, None]  # (M, B, 1, 1)
        x = prediction.astype(np.float64)
        y = np.asarray(target, np.float32)[None].astype(np.float64)

        def msum(v):
            return np.sum(v * w, axis=(1, 3))

        sums = np.stack([msum(x), msum(y), msum(x * y), msum(x * x), msum(y * y)], axis=-1)
        self.update_stats(mask.sum(axis=0) * prediction.shape[-1], sums)

    def compute(self) -> dict[int, float]:
        mice_corr: dict[int, float] = {}
        for mouse_index, count in enumerate(self._counts):
            if count == 0:
                continue
            n = self.num_neurons[mouse_index]
            sx, sy, sxy, sxx, syy = np.moveaxis(self._sums[mouse_index, :n], -1, 0)
            mean_x = sx / count
            mean_y = sy / count
            cov = sxy / count - mean_x * mean_y
            std_x = np.sqrt(np.maximum(sxx / count - mean_x**2, 0.0))
            std_y = np.sqrt(np.maximum(syy / count - mean_y**2, 0.0))
            values = cov / ((std_x + self.eps) * (std_y + self.eps))
            mice_corr[mouse_index] = float(values.mean())
        return mice_corr

    def epoch_metrics(self, prefix: str = "val_") -> dict[str, float]:
        """``{prefix}corr_mouse_{i}`` for each mouse seen and their mean ``{prefix}corr``."""
        mice_corr = self.compute()
        metrics = {f"{prefix}{self.name}_mouse_{i}": value for i, value in mice_corr.items()}
        if mice_corr:
            metrics[f"{prefix}{self.name}"] = float(np.mean(list(mice_corr.values())))
        return metrics


_METRICS = {
    "corr": CorrelationMetric,
}


def get_metric(name: str, **kwargs):
    """A metric of the registry by name (``"corr"``), built with ``kwargs``."""
    if name not in _METRICS:
        raise KeyError(f"Unknown metric '{name}'")
    return _METRICS[name](**kwargs)
