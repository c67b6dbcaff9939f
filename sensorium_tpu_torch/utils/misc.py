"""Small host-side helpers (counterpart of ``sensorium_tpu/utils/misc.py``)."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# The sign belongs to the score: 'model-003--0.500000.ckpt' is val_corr -0.5.
_SCORE_RE = re.compile(r"-(-?\d+(?:\.\d+)?)\.(?:pth|ckpt|msgpack)$")


def get_lr(base_lr: float, batch_size: int, base_batch_size: int = 4) -> float:
    """Linear learning-rate scaling with global batch size."""
    return base_lr * (batch_size / base_batch_size)


def get_best_model_path(dir_path, return_score: bool = False, more_better: bool = True):
    """The checkpoint in ``dir_path`` with the best score in its name
    (``model-{epoch:03d}-{score:.6f}.ckpt``, or ``.pth`` / ``.msgpack``);
    None (and -inf or inf) when there is none."""
    scored: list[tuple[Path, float]] = []
    for pattern in ("*.ckpt", "*.pth", "*.msgpack"):
        for model_path in Path(dir_path).glob(pattern):
            match = _SCORE_RE.search(model_path.name)
            if match is not None:
                scored.append((model_path, float(match.group(1))))
    if not scored:
        missing = -np.inf if more_better else np.inf
        return (None, missing) if return_score else None
    scored.sort(key=lambda item: item[1], reverse=more_better)
    best_path, best_score = scored[0]
    return (best_path, best_score) if return_score else best_path


def get_length_without_nan(array: np.ndarray) -> int:
    """Length of the leading NaN-free prefix of a 1-D array."""
    nan_indexes = np.argwhere(np.isnan(array)).ravel()
    if nan_indexes.shape[0]:
        return int(nan_indexes[0])
    return int(array.shape[0])
