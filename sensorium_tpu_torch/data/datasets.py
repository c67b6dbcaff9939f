"""Host-side datasets of the training and validation loops.

Counterpart of ``sensorium_tpu/data/datasets.py``, and bit for bit the same
samples for the same seed and epoch:

* trial ``.npy`` files are opened once with ``mmap_mode="r"`` and windows
  gathered from the memory map (by the native library where it can);
* a batch is a ``MiceBatch``: one zero-padded target array
  ``(B, max_neurons, T)`` and a one-hot ``(B, num_mice)`` weight matrix
  instead of ten mostly zero per-mouse target tensors;
* randomness comes from ``np.random.Generator`` seeds derived from
  ``(seed, epoch, sample_index)``, so runs are reproducible.

``fill_into`` writes a sample straight into the rows of a collated batch
(the loader's zero-copy path); ``get`` returns it for ``collate_mice_batch``.
The two give identical batches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data import native
from sensorium_tpu_torch.data.indexes import WindowIndexer
from sensorium_tpu_torch.data.inputs import InputsProcessor, StackInputsProcessor
from sensorium_tpu_torch.data.mixers import Mixer
from sensorium_tpu_torch.data.responses import IdentityResponsesProcessor, ResponsesProcessor


@dataclass
class MiceBatch:
    """One batch in compact (padded) form."""

    inputs: np.ndarray  # (B, 5, T, H, W) float32
    targets: np.ndarray  # (B, max_neurons, T) float32, zero-padded per mouse
    weights: np.ndarray  # (B, num_mice) float32, one-hot by sample's mouse

    def __len__(self) -> int:
        return self.inputs.shape[0]


class MouseTrialStore:
    """Memory-mapped access to one mouse's trials, with window gathering."""

    def __init__(
        self,
        mouse_data: dict,
        indexer: WindowIndexer,
        inputs_processor: InputsProcessor,
        responses_processor: ResponsesProcessor,
    ):
        self.mouse_data = mouse_data
        self.mouse = mouse_data["mouse"]
        self.mouse_index = constants.mouse2index[self.mouse]
        self.num_neurons = mouse_data["num_neurons"]
        self.indexer = indexer
        self.inputs_processor = inputs_processor
        self.responses_processor = responses_processor
        self.trials = mouse_data["trials"]
        self.trial_lengths = [t["length"] for t in self.trials]
        self._mmap_cache: dict = {}
        self._filler_cache: dict[int, object] = {}

    def _array(self, path: str) -> np.ndarray:
        arr = self._mmap_cache.get(path)
        if arr is None:
            arr = np.load(path, mmap_mode="r")
            self._mmap_cache[path] = arr
        return arr

    def _f32_array(self, path: str) -> np.ndarray:
        """A small per-trial signal array, converted to float32 once."""
        key = ("f32", path)
        arr = self._mmap_cache.get(key)
        if arr is None:
            arr = np.ascontiguousarray(self._array(path), np.float32)
            self._mmap_cache[key] = arr
        return arr

    def gather(self, trial_index: int, frame_indexes: np.ndarray, key: str) -> np.ndarray:
        arr = self._array(self.trials[trial_index][key])
        if arr.ndim == 2 and arr.dtype == np.float32:
            return native.gather_rows(arr, frame_indexes)
        return np.asarray(arr[..., frame_indexes])

    def _native_input(self, trial_index: int, frame_indexes: np.ndarray, out=None):
        proc = self.inputs_processor
        if type(proc) is not StackInputsProcessor:
            return None
        trial = self.trials[trial_index]
        return native.assemble_stack_input(
            self._array(trial["video_path"]),
            self._f32_array(trial["behavior_path"]),
            self._f32_array(trial["pupil_center_path"]),
            frame_indexes,
            proc.size,
            proc.pad_fill_value,
            out=out,
        )

    def window_sample(
        self, trial_index: int, anchor: int, with_responses: bool = True
    ) -> tuple[np.ndarray, np.ndarray | None]:
        """(input, target) of the window anchored at ``anchor``."""
        frame_indexes = self.indexer.window(anchor)
        inputs = self._native_input(trial_index, frame_indexes)
        if inputs is None:
            frames = self.gather(trial_index, frame_indexes, "video_path")
            behavior = self.gather(trial_index, frame_indexes, "behavior_path")
            pupil_center = self.gather(trial_index, frame_indexes, "pupil_center_path")
            inputs = self.inputs_processor(frames, behavior, pupil_center)
        target = None
        if with_responses and "response_path" in self.trials[trial_index]:
            target = self.responses_processor(self.gather(trial_index, frame_indexes, "response_path"))
        return inputs, target

    def _trial_filler(self, trial_index: int):
        """The native one-call-per-sample filler of a trial, made once (None
        where the processors or the layout do not allow it)."""
        filler = self._filler_cache.get(trial_index, False)
        if filler is not False:
            return filler
        filler = None
        proc = self.inputs_processor
        trial = self.trials[trial_index]
        if type(proc) is StackInputsProcessor and type(self.responses_processor) is IdentityResponsesProcessor:
            responses = self._array(trial["response_path"]) if "response_path" in trial else None
            filler = native.make_trial_filler(
                self._array(trial["video_path"]),
                self._f32_array(trial["behavior_path"]),
                self._f32_array(trial["pupil_center_path"]),
                responses,
                proc.size,
            )
        self._filler_cache[trial_index] = filler
        return filler

    def window_sample_into(
        self, trial_index: int, anchor: int, input_out: np.ndarray, target_out: np.ndarray
    ) -> None:
        """``window_sample`` written into batch rows: ``input_out`` (5, S, H, W)
        and ``target_out``, the row's first ``num_neurons`` target rows.
        Labeled trials only; draws no random numbers."""
        frame_indexes = self.indexer.window(anchor)
        if "response_path" not in self.trials[trial_index]:
            raise ValueError(
                f"trial {trial_index} has no responses; the zero-copy fill path requires labeled trials "
                "(train/val splits only)"
            )
        filler = self._trial_filler(trial_index)
        if filler is not None:
            filler(frame_indexes, self.inputs_processor.pad_fill_value, input_out, target_out)
            return
        if self._native_input(trial_index, frame_indexes, out=input_out) is None:
            frames = self.gather(trial_index, frame_indexes, "video_path")
            behavior = self.gather(trial_index, frame_indexes, "behavior_path")
            pupil_center = self.gather(trial_index, frame_indexes, "pupil_center_path")
            input_out[...] = self.inputs_processor(frames, behavior, pupil_center)

        responses = self._array(self.trials[trial_index]["response_path"])
        fused = (
            type(self.responses_processor) is IdentityResponsesProcessor
            and responses.ndim == 2
            and responses.dtype == np.float32
        )
        if fused and native.gather_rows_relu_into(responses, frame_indexes, target_out):
            return
        if fused:
            np.take(responses, frame_indexes, axis=-1, out=target_out)
            np.maximum(target_out, 0.0, out=target_out)
            return
        target_out[...] = self.responses_processor(self.gather(trial_index, frame_indexes, "response_path"))


def _row_shapes(stores, max_neurons: int, augmentations=None):
    """(input_shape, target_shape) of a batch row for the zero-copy path, or
    None where they are not known beforehand (other processors, per-sample
    augmentations)."""
    store = stores[0]
    proc = store.inputs_processor
    if augmentations is not None or type(proc) is not StackInputsProcessor:
        return None
    if type(store.responses_processor) is not IdentityResponsesProcessor:
        return None
    s = store.indexer.size
    width, height = proc.size
    return (5, s, height, width), (max_neurons, s)


def _check_mice_order(mice_data: list[dict]) -> None:
    if [constants.mouse2index[d["mouse"]] for d in mice_data] != constants.mice_indexes:
        raise ValueError("mice_data must be all 10 mice in canonical constants.mice order")


class TrainMiceDataset:
    """Random-window training sampler over all mice.

    The index space is ``num_mice * mouse_epoch_size``, by mouse in blocks
    (samples [m*E, (m+1)*E) are mouse m's). Each sample draws a random trial
    and a random valid anchor, optionally mixed (CutMix) with a second draw
    of the same mouse.
    """

    def __init__(
        self,
        mice_data: list[dict],
        indexer: WindowIndexer,
        inputs_processor: InputsProcessor,
        responses_processor: ResponsesProcessor,
        mouse_epoch_size: int,
        mixer: Mixer | None = None,
        seed: int = 0,
        augmentations=None,
    ):
        _check_mice_order(mice_data)
        self.stores = [MouseTrialStore(d, indexer, inputs_processor, responses_processor) for d in mice_data]
        self.num_mice = len(self.stores)
        self.max_neurons = max(s.num_neurons for s in self.stores)
        self.mouse_epoch_size = mouse_epoch_size
        self.mixer = mixer
        self.seed = seed
        # Thread-local buffers for the mixer partner on the zero-copy path.
        self._scratch = threading.local()
        # Per-sample input augmentation, ``(inputs, rng) -> inputs``, applied
        # to mixer partners too.
        self.augmentations = augmentations
        # Trials shorter than one raw window have no valid anchor: refuse a
        # mouse with none here rather than mid-epoch in a loader thread.
        self._valid_trials = []
        for store, data in zip(self.stores, mice_data):
            valid = np.flatnonzero(np.asarray(store.trial_lengths) >= indexer.width)
            if len(valid) == 0:
                raise ValueError(
                    f"Mouse '{data['mouse']}' has no trial of at least {indexer.width} raw frames "
                    f"in splits {data['splits']}"
                )
            self._valid_trials.append(valid)

    def __len__(self) -> int:
        return constants.num_mice * self.mouse_epoch_size

    def _draw_window(self, mouse_index: int, rng: np.random.Generator) -> tuple[int, int]:
        """(trial, anchor): two ``integers`` draws."""
        store = self.stores[mouse_index]
        valid = self._valid_trials[mouse_index]
        trial_index = int(valid[rng.integers(len(valid))])
        length = store.trial_lengths[trial_index]
        return trial_index, int(rng.integers(store.indexer.behind, length - store.indexer.ahead))

    def _draw(self, mouse_index: int, rng: np.random.Generator):
        inputs, target = self.stores[mouse_index].window_sample(*self._draw_window(mouse_index, rng))
        if self.augmentations is not None:
            inputs = self.augmentations(inputs, rng)
        return inputs, target

    def get(self, index: int, epoch: int = 0) -> tuple[int, np.ndarray, np.ndarray]:
        """Returns (mouse_index, input, target)."""
        mouse_index = index // self.mouse_epoch_size
        rng = np.random.default_rng((self.seed, epoch, index))
        inputs, target = self._draw(mouse_index, rng)
        if self.mixer is not None and self.mixer.use(rng):
            partner = self._draw(mouse_index, np.random.default_rng((self.seed, epoch, index, 1)))
            inputs, target = self.mixer((inputs, target), partner, rng)
        return mouse_index, inputs, target

    @property
    def row_shapes(self):
        return _row_shapes(self.stores, self.max_neurons, self.augmentations)

    def fill_into(self, index: int, epoch: int, input_out: np.ndarray, target_out: np.ndarray) -> int:
        """``get`` written into batch rows (the same random draws in the same
        order); returns the mouse index."""
        mouse_index = index // self.mouse_epoch_size
        store = self.stores[mouse_index]
        target_view = target_out[: store.num_neurons]
        rng = np.random.default_rng((self.seed, epoch, index))
        store.window_sample_into(*self._draw_window(mouse_index, rng), input_out, target_view)
        if self.mixer is not None and self.mixer.use(rng):
            partner_rng = np.random.default_rng((self.seed, epoch, index, 1))
            partner = self._draw_scratch(mouse_index, partner_rng, input_out.shape)
            self.mixer.mix_into((input_out, target_view), partner, rng)
        return mouse_index

    def _draw_scratch(self, mouse_index: int, rng, input_shape):
        """``_draw`` into reused thread-local buffers (zero-copy path only,
        where there are no augmentations)."""
        scratch = self._scratch
        if getattr(scratch, "input", None) is None or scratch.input.shape != input_shape:
            scratch.input = np.empty(input_shape, np.float32)
            scratch.target = np.empty((self.max_neurons, input_shape[1]), np.float32)
        store = self.stores[mouse_index]
        target_view = scratch.target[: store.num_neurons]
        store.window_sample_into(*self._draw_window(mouse_index, rng), scratch.input, target_view)
        return scratch.input, target_view


class ValMiceDataset:
    """Deterministic non-overlapping validation windows over all mice."""

    def __init__(
        self,
        mice_data: list[dict],
        indexer: WindowIndexer,
        inputs_processor: InputsProcessor,
        responses_processor: ResponsesProcessor,
    ):
        _check_mice_order(mice_data)
        self.stores = [MouseTrialStore(d, indexer, inputs_processor, responses_processor) for d in mice_data]
        self.num_mice = len(self.stores)
        self.max_neurons = max(s.num_neurons for s in self.stores)
        self.width = indexer.width
        # Flat index -> (mouse, trial, window position).
        self._samples: list[tuple[int, int, int]] = [
            (mouse_index, trial_index, position)
            for mouse_index, store in enumerate(self.stores)
            for trial_index, length in enumerate(store.trial_lengths)
            for position in range(length // self.width)
        ]

    def __len__(self) -> int:
        return len(self._samples)

    def _window(self, index: int) -> tuple[int, MouseTrialStore, int, int]:
        mouse_index, trial_index, position = self._samples[index]
        store = self.stores[mouse_index]
        return mouse_index, store, trial_index, store.indexer.behind + position * self.width

    def get(self, index: int, epoch: int = 0) -> tuple[int, np.ndarray, np.ndarray]:
        mouse_index, store, trial_index, anchor = self._window(index)
        inputs, target = store.window_sample(trial_index, anchor)
        return mouse_index, inputs, target

    @property
    def row_shapes(self):
        return _row_shapes(self.stores, self.max_neurons)

    def fill_into(self, index: int, epoch: int, input_out: np.ndarray, target_out: np.ndarray) -> int:
        mouse_index, store, trial_index, anchor = self._window(index)
        store.window_sample_into(trial_index, anchor, input_out, target_out[: store.num_neurons])
        return mouse_index


def collate_mice_batch(
    samples: list[tuple[int, np.ndarray, np.ndarray]],
    num_mice: int | None = None,
    max_neurons: int | None = None,
) -> MiceBatch:
    """(mouse_index, input, target) triples into a padded ``MiceBatch``; the
    padding defaults to the competition's 10 mice and 8,285 neurons."""
    num_mice = constants.num_mice if num_mice is None else num_mice
    max_neurons = constants.max_num_neurons if max_neurons is None else max_neurons
    batch = len(samples)
    inputs = np.empty((batch,) + samples[0][1].shape, dtype=np.float32)
    time_shape = samples[0][2].shape[1:]  # () or (T,)
    targets = np.zeros((batch, max_neurons) + time_shape, dtype=np.float32)
    weights = np.zeros((batch, num_mice), dtype=np.float32)
    for row, (mouse_index, sample_input, sample_target) in enumerate(samples):
        inputs[row] = sample_input
        targets[row, : sample_target.shape[0]] = sample_target
        weights[row, mouse_index] = 1.0
    return MiceBatch(inputs=inputs, targets=targets, weights=weights)
