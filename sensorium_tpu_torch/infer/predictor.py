"""Sliding-window trial inference.

Counterpart of ``sensorium_tpu/infer/predictor.py``: predict a whole trial
by blending overlapping windows at every valid anchor (stride 1), with
"ones" or "linear" per-window blend weights.

* The trial's compact arrays (video planes and the (2, T) signals) cross to
  the device once; the 5-channel input stack is assembled there
  (``assemble_trial_stack``), and each chunk's windows are gathered from it
  with ``index_select``.
* Anchors are forwarded in chunks of ``chunk_size`` windows through the
  single-mouse readout. The last chunk is short: the JAX predictor pads it
  with zero-weight windows only because XLA needs static shapes, and its
  trial-length bucketing exists for the same reason. Both are left out here,
  which gives the same results without the padded forwards.
* Predictions are scatter-added into an fp32 (N, T) accumulator with
  ``index_add_``, the blend weights into a (T,) one, and the sum is divided
  by ``clamp(blend_acc, min=1)``: numerator unweighted, denominator the
  per-frame blend weights, as the reference predictor does. On the card
  ``index_add_`` adds overlapping windows in an order that may change from
  run to run, so results agree to fp32 rounding, not bit for bit.
* ``predict_mouse_split`` blends several predictors (the fold models) over
  a split's trials: one disk read and one upload a trial for all of them,
  the mean on the device, and each trial's copy to the host overlapped
  with the next trial's forwards.
* ``length_bucket`` is read only by the whole-trial export
  (``infer/export.py`` ``export_trial``): its artifact takes any multiple of
  the bucket. ``chunk_updates`` is the chunk step that the live path and the
  export share.
* ``Predictor(..., mesh=mesh)``, a mesh of this process's cards
  (``parallel.mesh.create_mesh()``, ``create_mesh(num_model=2)``,
  ``create_hybrid_mesh(...)``): one eval replica a data index (replica x
  data), each over its model group's cards with the cortex and readout
  weights sliced across them (``parallel/tensor.py`` ``local_replicas``);
  each chunk's windows are split over the replicas, every replica's
  forward is queued, then their predictions are gathered onto the first
  card for the blend. Without a mesh there is one replica: the same code.
  Trials spread over hosts through ``predict_mouse_split``'s
  ``trial_shard`` instead.
* Spans (``utils/profiling.py``): a trial's upload (``predict.upload``:
  ``stage_trial``), the stack's assembly and its copies to the replicas
  (``predict.stage``), each chunk's window gather (``predict.gather``),
  each chunk's scatter-adds and the final divide (``predict.blend``), and
  ``predict_trial``'s copy to the host (``predict.fetch``).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data.indexes import WindowIndexer
from sensorium_tpu_torch.data.inputs import StackInputsProcessor, get_inputs_processor
from sensorium_tpu_torch.data.mouse_data import get_mouse_data
from sensorium_tpu_torch.engine.model import load_model
from sensorium_tpu_torch.ops.conv import set_matmul_policy
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel import tensor as tensor_lib
from sensorium_tpu_torch.utils.device import fetch_to_host, resolve_device
from sensorium_tpu_torch.utils.profiling import span


def get_blend_weights(name: str, size: int) -> np.ndarray:
    if name == "ones":
        return np.ones(size, dtype=np.float32)
    if name == "linear":
        return np.linspace(0, 1, num=size, dtype=np.float32)
    raise ValueError(f"Blend weights '{name}' is not supported")


class StagedTrial(NamedTuple):
    """One trial's device-resident inputs and window plan (``Predictor.stage_trial``).

    ``hoststack`` marks a (5, T, H, W) stack assembled on the host (frames
    larger than the canvas); otherwise ``trial_args`` holds the compact
    (video, behavior, pupil_center) tensors. ``windows is None`` marks a trial
    shorter than one window (``run_staged`` returns zeros).
    """

    length: int
    hoststack: bool
    trial_args: tuple
    windows: torch.Tensor | None


def assemble_trial_stack(
    video: torch.Tensor,
    behavior: torch.Tensor,
    pupil_center: torch.Tensor,
    height: int,
    width: int,
    fill: float,
) -> torch.Tensor:
    """Device-side 5-channel input assembly from compact trial arrays.

    ``video``: (T, sh, sw); ``behavior`` / ``pupil_center``: (2, T) ->
    (5, T, H, W). Same semantics as ``StackInputsProcessor``: the video is
    centered on the canvas, the four scalar signals broadcast to full planes.
    """
    length, src_h, src_w = video.shape
    h0 = (height - src_h) // 2
    w0 = (width - src_w) // 2
    ch0 = F.pad(video, (w0, width - src_w - w0, h0, height - src_h - h0), value=fill)[None]
    planes = torch.cat([behavior, pupil_center], dim=0)  # (4, T)
    return torch.cat([ch0, planes[:, :, None, None].expand(4, length, height, width)], dim=0)


class Predictor:
    """Predict whole trials of one model with window blending.

    ``Predictor(model_path)`` loads a model checkpoint (``engine/model.py``
    ``load_model``: the port's, the JAX package's or one converted from the
    reference by ``cli/import_torch``) onto ``device``; ``from_module``
    takes a module and the params dict instead. Raises if ``device`` is CUDA
    and there is no card.

    ``mesh``: a mesh of this process's devices; the model is loaded onto the
    first and copied to each model group (``replicas``: one ``(module, first
    card)`` a data index), and ``device`` is not read. A ``chunk_size`` that
    does not divide over the replicas raises, and so does a mesh over
    several processes (run one ``Predictor`` a host and spread the trials
    with ``trial_shard`` instead).
    """

    def __init__(
        self,
        model_path: Path | str,
        blend_weights: str = "ones",
        chunk_size: int = 32,
        length_bucket: int = 64,
        device: str | torch.device = "cuda",
        mesh: mesh_lib.Mesh | None = None,
    ):
        if mesh is not None:
            if mesh.processes > 1:
                raise ValueError("mesh-sharded prediction spans a single process; run one Predictor per host "
                                 "instead of one mesh across hosts")
            if chunk_size % mesh_lib.data_extent(mesh):
                raise ValueError(f"chunk_size {chunk_size} must be a multiple of the mesh batch-sharding ways "
                                 f"({mesh_lib.data_extent(mesh)})")
            device = mesh.device
        model = load_model(model_path, device=device)
        self._setup(model.state.eval_model, model.params, blend_weights, chunk_size, length_bucket, model.device)
        if mesh is not None:
            self.replicas = tensor_lib.local_replicas(self.model, mesh)
        self.mesh = mesh

    @classmethod
    def from_module(
        cls,
        nn_module: torch.nn.Module,
        argus_params: dict,
        blend_weights: str = "ones",
        chunk_size: int = 32,
        device: str | torch.device = "cuda",
        length_bucket: int = 64,
    ) -> "Predictor":
        """A predictor of ``nn_module`` (weights loaded), which is moved to
        ``device``; of ``argus_params`` it reads ``frame_stack``,
        ``inputs_processor`` and ``responses_processor``."""
        predictor = cls.__new__(cls)
        predictor._setup(nn_module, argus_params, blend_weights, chunk_size, length_bucket, resolve_device(device))
        predictor.mesh = None
        return predictor

    def _setup(self, nn_module, argus_params: dict, blend_weights: str, chunk_size: int, length_bucket: int,
               device: torch.device) -> None:
        self.device = device
        frame_stack = argus_params["frame_stack"]
        if frame_stack["position"] != "last":
            raise ValueError(
                f"predictor requires frame_stack position 'last'; got {frame_stack['position']!r}"
            )
        if argus_params["responses_processor"][0] != "identity":
            raise ValueError(
                "predictor emits raw responses (responses_processor 'identity'); got "
                f"{argus_params['responses_processor'][0]!r}"
            )
        if chunk_size <= 0 or length_bucket <= 0:
            raise ValueError(f"chunk_size and length_bucket must be positive, got {chunk_size} / {length_bucket}")
        if self.device.type == "cuda":
            set_matmul_policy()
        self.model = nn_module.to(self.device).eval()
        self.replicas = [(self.model, self.device)]  # (module, device): the first is self.model
        self.inputs_processor = get_inputs_processor(*argus_params["inputs_processor"])
        self.indexes_generator = WindowIndexer(
            frame_stack["size"], frame_stack["step"], frame_stack["position"]
        )
        self.blend_weights = torch.from_numpy(
            get_blend_weights(blend_weights, frame_stack["size"])
        ).to(self.device)
        self.chunk_size = chunk_size
        self.length_bucket = length_bucket

    def stage_signature(self) -> tuple:
        """What a staged trial depends on: the input processor, the window
        plan and the device, not the weights, the blend weights or the chunk
        size. Predictors with equal signatures can run one ``stage_trial``."""
        ip = self.inputs_processor
        gen = self.indexes_generator
        return (
            type(ip),
            getattr(ip, "size", None),
            getattr(ip, "pad_fill_value", None),
            (gen.size, gen.step, gen.position),
            self.device,
        )

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    def stage_trial(
        self, video: np.ndarray, behavior: np.ndarray, pupil_center: np.ndarray
    ) -> StagedTrial:
        """Upload one trial's compact arrays and its window plan once (the
        span ``predict.upload``)."""
        with span("predict.upload"):
            length = video.shape[-1]
            anchors = self.indexes_generator.valid_anchors(length)
            if len(anchors) == 0:
                # Trial shorter than one window: the reference loop runs zero
                # iterations and the blend denominator clamps to 1 -> zeros.
                return StagedTrial(length, False, (), None)
            windows = torch.from_numpy(self.indexes_generator.windows(anchors)).to(self.device)

            device_assembly = isinstance(self.inputs_processor, StackInputsProcessor)
            if device_assembly:
                width, height = self.inputs_processor.size
                device_assembly = video.shape[0] <= height and video.shape[1] <= width
            if device_assembly:
                trial_args = (
                    self._to_device(np.transpose(video, (2, 0, 1))),
                    self._to_device(behavior),
                    self._to_device(pupil_center),
                )
            else:
                # Raises the processor's canvas-size error for oversize frames.
                trial_args = (self._to_device(self.inputs_processor(video, behavior, pupil_center)),)
            return StagedTrial(length, not device_assembly, trial_args, windows)

    @torch.inference_mode()
    def run_staged(self, staged: StagedTrial, mouse_index: int) -> torch.Tensor:
        """Window forwards and blend over a staged trial -> (N, T) fp32 on the device."""
        num_neurons = self.model.readout_outputs[mouse_index]
        resp_acc = torch.zeros((num_neurons, staged.length), dtype=torch.float32, device=self.device)
        if staged.windows is None:
            return resp_acc
        with span("predict.stage"):
            if staged.hoststack:
                (trial_inputs,) = staged.trial_args
            else:
                width, height = self.inputs_processor.size
                trial_inputs = assemble_trial_stack(
                    *staged.trial_args, height, width, self.inputs_processor.pad_fill_value
                )
            replica_inputs = [trial_inputs.to(device) for _, device in self.replicas]  # once a trial
        blend_acc = torch.zeros(staged.length, dtype=torch.float32, device=self.device)
        models = [model for model, _ in self.replicas]
        for start in range(0, staged.windows.shape[0], self.chunk_size):
            windows = staged.windows[start : start + self.chunk_size]  # (C, S)
            flat, resp, blend = chunk_updates(models, replica_inputs, windows, self.blend_weights, mouse_index)
            with span("predict.blend"):
                resp_acc.index_add_(1, flat, resp)
                blend_acc.index_add_(0, flat, blend)
        with span("predict.blend"):
            return resp_acc / blend_acc.clamp(min=1.0)

    def predict_trial_device(
        self,
        video: np.ndarray,
        behavior: np.ndarray,
        pupil_center: np.ndarray,
        mouse_index: int,
    ) -> torch.Tensor:
        """``predict_trial`` with the (N, T) result left on the device."""
        return self.run_staged(self.stage_trial(video, behavior, pupil_center), mouse_index)

    def predict_trial(
        self,
        video: np.ndarray,
        behavior: np.ndarray,
        pupil_center: np.ndarray,
        mouse_index: int,
    ) -> np.ndarray:
        """video (H, W, T), behavior / pupil_center (2, T) -> (N, T) float32."""
        result = self.predict_trial_device(video, behavior, pupil_center, mouse_index)
        with span("predict.fetch"):
            return result.cpu().numpy()

    def predict_trial_data(self, trial_data: dict, mouse_index: int) -> np.ndarray:
        """Predict a trial of ``get_mouse_data``'s catalog."""
        return self.predict_trial(*_load_trial_arrays(trial_data), mouse_index)


def _window_forward(model, trial_inputs: torch.Tensor, windows: torch.Tensor, mouse_index: int) -> torch.Tensor:
    """The single-mouse forward of the (C, S) windows of a (5, T, H, W)
    trial stack -> (C, N, S) fp32."""
    count, size = windows.shape
    with span("predict.gather"):
        batch = trial_inputs.index_select(1, windows.reshape(-1))  # (5, C*S, H, W)
        batch = batch.view(batch.shape[0], count, size, *batch.shape[2:]).transpose(0, 1)
    return model(batch, mouse_index=mouse_index).float()


def replica_forwards(models: list, replica_inputs: list[torch.Tensor], windows: torch.Tensor,
                     mouse_index: int) -> torch.Tensor:
    """The (C, S) windows split in order over the replicas (``models``,
    each with the trial stack on its first card in ``replica_inputs``), each
    part's forward queued, then the (C, N, S) predictions gathered onto the
    windows' device. One replica is one forward.

    Every part is copied to its card before any forward is queued: a copy
    between cards runs on the source card's stream, so a copy queued after
    the first replica's forward would hold the next replica's card until
    that forward ends."""
    parts = [part.to(inputs.device) for part, inputs in zip(windows.tensor_split(len(models)), replica_inputs)]
    preds = [_window_forward(model, inputs, part, mouse_index)
             for model, inputs, part in zip(models, replica_inputs, parts) if len(part)]
    if len(preds) == 1:
        return preds[0]
    return torch.cat([pred.to(windows.device) for pred in preds])


def blend_updates(pred: torch.Tensor, windows: torch.Tensor, blend_weights: torch.Tensor,
                  valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the (C, N, S) predictions of the (C, S) ``windows`` add to the
    blend: the frame indexes (C*S,), the (N, C*S) predictions and the (C*S,)
    blend weights, each window's weighed by its 1/0 ``valid`` entry if given."""
    count = windows.shape[0]
    if valid is None:
        blend = blend_weights.repeat(count)
    else:
        pred = pred * valid[:, None, None]
        blend = (blend_weights[None, :] * valid[:, None]).reshape(-1)
    return windows.reshape(-1), pred.transpose(0, 1).reshape(pred.shape[1], -1), blend


def chunk_updates(models: list, replica_inputs: list[torch.Tensor], windows: torch.Tensor,
                  blend_weights: torch.Tensor, mouse_index: int,
                  valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk of window forwards over a (5, T, H, W) trial stack (on each
    replica's first card, ``replica_forwards``), as ``blend_updates`` of
    their predictions: a pure function of the stack, the (C, S) windows and
    their (C,) ``valid`` rows, which the live ``Predictor`` and the exported
    trial program (``infer/export.py``) both run."""
    pred = replica_forwards(models, replica_inputs, windows, mouse_index)
    return blend_updates(pred, windows, blend_weights, valid)


def _load_trial_arrays(trial_data: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(video, behavior, pupil_center) of a catalog entry, cut to its length."""
    length = trial_data["length"]
    return (
        np.load(trial_data["video_path"])[..., :length],
        np.load(trial_data["behavior_path"])[..., :length],
        np.load(trial_data["pupil_center_path"])[..., :length],
    )


class _PendingSave(NamedTuple):
    path: Path
    host: torch.Tensor
    copied: torch.cuda.Event | None


def _start_fetch(path: Path, blend: torch.Tensor) -> _PendingSave:
    """Start the copy of ``blend`` to the host (``fetch_to_host``)."""
    return _PendingSave(path, *fetch_to_host(blend))


def _finish_fetch(pending: _PendingSave) -> None:
    if pending.copied is not None:
        pending.copied.synchronize()
    np.save(str(pending.path), pending.host.numpy())


def predict_mouse_split(
    mouse: str,
    split: str,
    predictors: list[Predictor],
    save_dir: Path,
    trial_shard: tuple[int, int] | None = None,
) -> None:
    """Blend ``predictors`` (the fold models) over one mouse's split trials
    and save each trial's (N, T) mean as ``save_dir/<trial_id>.npy``.

    ``trial_shard=(i, n)`` predicts every n-th trial from the i-th. Each
    trial is read from disk once for all predictors; when their
    ``stage_signature`` is equal it is also staged once and the mean is
    taken on the device, otherwise each predicts on its own and the mean is
    taken on the host. Trial t-1 is saved after trial t's forwards are
    queued, so the disk and the card work at the same time.
    """
    if not predictors:
        raise ValueError("predictors must be non-empty")
    mouse_index = constants.mouse2index[mouse]
    trials = get_mouse_data(mouse=mouse, splits=[split])["trials"]
    if trial_shard is not None:
        index, count = trial_shard
        trials = trials[index::count]
    save_dir.mkdir(parents=True, exist_ok=True)
    lead = predictors[0]
    shared_staging = all(p.stage_signature() == lead.stage_signature() for p in predictors[1:])
    pending: _PendingSave | None = None
    for trial_data in trials:
        video, behavior, pupil_center = _load_trial_arrays(trial_data)
        if shared_staging:
            staged = lead.stage_trial(video, behavior, pupil_center)
            responses = [p.run_staged(staged, mouse_index) for p in predictors]
            blend = responses[0] if len(responses) == 1 else torch.stack(responses).mean(dim=0)
        else:
            blend = torch.from_numpy(np.mean(
                [p.predict_trial(video, behavior, pupil_center, mouse_index) for p in predictors], axis=0))
        fetch = _start_fetch(save_dir / f"{trial_data['trial_id']}.npy", blend)
        if pending is not None:
            _finish_fetch(pending)
        pending = fetch
    if pending is not None:
        _finish_fetch(pending)
