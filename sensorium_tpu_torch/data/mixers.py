"""Sample-mixing augmentations (CutMix, Mixup) on host-side NumPy arrays.

A copy of ``sensorium_tpu/data/mixers.py``. A mixer takes an explicit
``np.random.Generator`` and draws from it in the JAX package's order, so the
same seed mixes the same samples the same way.

A sample is an ``(input, target)`` pair: input (5, T, H, W), target (N, T).
"""

from __future__ import annotations

import abc

import numpy as np

Sample = tuple[np.ndarray, np.ndarray]


class Mixer(abc.ABC):
    def __init__(self, prob: float):
        self.prob = prob

    def use(self, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.prob)

    @abc.abstractmethod
    def __call__(self, sample1: Sample, sample2: Sample, rng: np.random.Generator) -> Sample:
        ...

    def mix_into(self, sample1: Sample, sample2: Sample, rng: np.random.Generator) -> None:
        """Mix ``sample2`` into ``sample1`` in place (batch-row views on the
        loader's zero-copy path), drawing from ``rng`` as ``__call__`` does."""
        inputs, target = self(sample1, sample2, rng)
        sample1[0][...] = inputs
        sample1[1][...] = target


class Mixup(Mixer):
    """Convex interpolation of inputs and targets with a Beta(alpha, alpha) weight."""

    def __init__(self, alpha: float = 0.4, prob: float = 1.0):
        super().__init__(prob)
        self.alpha = alpha

    def __call__(self, sample1, sample2, rng):
        inputs1, target1 = sample1
        inputs2, target2 = sample2
        lam = rng.beta(self.alpha, self.alpha)
        inputs = (1 - lam) * inputs1 + lam * inputs2
        target = (1 - lam) * target1 + lam * target2
        return inputs, target

    # mix_into is the default (__call__, then a copy back): the float64 lam
    # promotes the mixed arrays to float64 before the cast to the row's
    # float32, and an in-place form would round differently.


def sample_bbox(height: int, width: int, lam: float, rng: np.random.Generator):
    """Random box whose relative area is ~lam, clipped to the frame."""
    cut_ratio = np.sqrt(lam)
    cut_h = int(height * cut_ratio)
    cut_w = int(width * cut_ratio)
    center_x = rng.integers(width)
    center_y = rng.integers(height)
    x1 = int(np.clip(center_x - cut_w // 2, 0, width))
    y1 = int(np.clip(center_y - cut_h // 2, 0, height))
    x2 = int(np.clip(center_x + cut_w // 2, 0, width))
    y2 = int(np.clip(center_y + cut_h // 2, 0, height))
    return x1, y1, x2, y2


class CutMix(Mixer):
    """Paste a random box of sample2 into sample1 over the last two axes.

    The target weight is the pasted area's actual fraction (after clipping),
    and the box is indexed as [..., x1:x2, y1:y2] with x drawn against the
    width and y against the height, as the reference does.
    """

    def __init__(self, alpha: float = 1.0, prob: float = 1.0):
        super().__init__(prob)
        self.alpha = alpha

    def __call__(self, sample1, sample2, rng):
        inputs1, target1 = sample1
        inputs2, target2 = sample2
        lam = rng.beta(self.alpha, self.alpha)
        h, w = inputs1.shape[-2:]
        x1, y1, x2, y2 = sample_bbox(h, w, lam, rng)
        inputs = np.array(inputs1)
        inputs[..., x1:x2, y1:y2] = inputs2[..., x1:x2, y1:y2]
        area = (x2 - x1) * (y2 - y1) / (h * w)
        target = (1 - area) * target1 + area * target2
        return inputs, target

    def mix_into(self, sample1, sample2, rng):
        """In-place CutMix; it overwrites ``sample2``'s target (the loader
        passes thread-local scratch)."""
        inputs1, target1 = sample1
        inputs2, target2 = sample2
        lam = rng.beta(self.alpha, self.alpha)
        h, w = inputs1.shape[-2:]
        x1, y1, x2, y2 = sample_bbox(h, w, lam, rng)
        inputs1[..., x1:x2, y1:y2] = inputs2[..., x1:x2, y1:y2]
        area = (x2 - x1) * (y2 - y1) / (h * w)
        # The rounding sequence of __call__: (1-area)*t1, area*t2, their sum,
        # in float32 (area is a Python float).
        target1 *= 1 - area
        np.multiply(target2, area, out=target2)
        target1 += target2


class RandomChoiceMixer(Mixer):
    def __init__(self, mixers: list[Mixer], choice_probs: list[float], prob: float = 1.0):
        super().__init__(prob)
        self.mixers = mixers
        self.choice_probs = choice_probs

    def __call__(self, sample1, sample2, rng):
        index = rng.choice(len(self.mixers), p=self.choice_probs)
        return self.mixers[index](sample1, sample2, rng)
