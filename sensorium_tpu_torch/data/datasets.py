"""The collated batch of the training engine.

Counterpart of ``MiceBatch`` in ``sensorium_tpu/data/datasets.py`` (the
datasets and loaders themselves come with the data-feed slice).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MiceBatch:
    """One batch in compact (padded) form."""

    inputs: np.ndarray  # (B, 5, T, H, W) float32
    targets: np.ndarray  # (B, max_neurons, T) float32, zero-padded per mouse
    weights: np.ndarray  # (B, num_mice) float32, one-hot by sample's mouse

    def __len__(self) -> int:
        return self.inputs.shape[0]
