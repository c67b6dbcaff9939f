"""Response (target) processing and submission-time normalization.

A copy of ``sensorium_tpu/data/responses.py``: the processors clamp targets
at zero (ReLU) and optionally index the temporal axis; ``ResponseNormalizer``
rescales predictions by the inverse per-neuron response standard deviation
(clamped at 1% of the mean std), for submissions only.
"""

from __future__ import annotations

import abc

import numpy as np

from sensorium_tpu_torch import constants


class ResponseNormalizer:
    def __init__(self, mouse: str):
        std = np.load(str(constants.sensorium_dir / mouse / "meta" / "statistics" / "responses" / "all" / "std.npy"))
        threshold = 0.01 * np.nanmean(std)
        precision = np.full_like(std, 1.0 / threshold)
        well_measured = std > threshold
        precision[well_measured] = 1.0 / std[well_measured]
        self._response_precision = precision

    def __call__(self, responses: np.ndarray) -> np.ndarray:
        return responses * self._response_precision[..., : responses.shape[-1]]


class ResponsesProcessor(abc.ABC):
    @abc.abstractmethod
    def __call__(self, responses: np.ndarray) -> np.ndarray:
        """responses (N, T) -> float32 target array (negative values clamped)."""


class IdentityResponsesProcessor(ResponsesProcessor):
    def __call__(self, responses):
        return np.maximum(responses.astype(np.float32), 0.0)


class IndexingResponsesProcessor(ResponsesProcessor):
    def __init__(self, index):
        self.index = index

    def __call__(self, responses):
        return np.maximum(responses[..., self.index].astype(np.float32), 0.0)


class SelectLastResponsesProcessor(IndexingResponsesProcessor):
    def __init__(self):
        super().__init__(index=-1)


_REGISTRY: dict[str, type[ResponsesProcessor]] = {
    "identity": IdentityResponsesProcessor,
    "indexing": IndexingResponsesProcessor,
    "last": SelectLastResponsesProcessor,
}


def get_responses_processor(name: str, processor_params: dict) -> ResponsesProcessor:
    if name not in _REGISTRY:
        raise KeyError(f"Unknown responses processor '{name}'")
    return _REGISTRY[name](**processor_params)
