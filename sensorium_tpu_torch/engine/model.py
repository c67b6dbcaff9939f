"""The training engine's model object: ``MouseModel``, and ``load_model``.

Counterpart of ``sensorium_tpu/engine/model.py``: construction from a
config's ``argus_params``, EMA, distillation, the train / val / predict
steps, the fit loop with preemption, checkpoints and resume. The files are
the JAX package's (``engine/checkpoint.py``): a model checkpoint either
package wrote loads in the other. A train state keeps JAX's names for the
step, weights and EMA, and the port's own for the optimizer's moments and
the dropout generator, which JAX does not share.

    model = MouseModel(argus_params)           # on the card; device="cpu" to ask for the CPU
    model.set_ema(0.999)
    model.build_state(seed=0, learning_rate=2.4e-3)
    loss = model.train_step(batch)             # a MiceBatch of numpy arrays
    loss, prediction, targets, weights = model.val_step(batch)
    model.fit(train_loader, val_loader, num_epochs=2, callbacks=[...], metrics=[CorrelationMetric()])
    model.save("model-000-0.123456.ckpt")      # the eval (EMA) weights and the config
    model.save_train_state("train_state.ckpt", extra={"epoch": 0})
    model.load_train_state("train_state.ckpt") # into a model built from the same config
    model.save_train_state("train_state.orbax") # the sharded format: a directory, every process writes
    restored = load_model("model-000-0.123456.ckpt", device="cuda")

Data parallelism: ``MouseModel(argus_params, mesh=mesh)`` (a
``parallel.mesh.Mesh`` over a process group, one card a process) runs on
the mesh's card. The weights are broadcast from the first process after
``build_state``, ``init_from_checkpoint`` and ``load_train_state``.
``train_step`` and ``val_step`` take the global batch and keep this
process's rows (a loader built with ``shard=`` hands them over already):
a train batch that does not divide over the mesh raises, a val batch is
padded with zero-weight rows. Losses, gradients and the metric sums are
the global batch's. In ``fit`` the processes agree on a preemption signal
(an ``all_reduce`` of the flag over every process at each check point), so
that none of them is left waiting in a collective. Over a process group
only the first process writes a single-file checkpoint.

Tensor parallelism: with a ``model`` axis above 1 (``tensor_parallel``, as
the JAX package defines it) the state is placed as JAX's ``shard_state``
places it (``parallel/tensor.py``): the module is built whole from the
seed on every process, broadcast from the first, then sliced, so the live
weights, the EMA copy and the optimizer's moments hold this process's
slices of the cortex and readout weights; the BN statistics, the step and
the generator are whole. Global-batch sums run over the data group, the
preemption flag over every process. ``eval_variables``, ``save`` and the
msgpack ``save_train_state`` gather the slices, so their files are byte for
byte a one-process model's with the same values: a collective, which every
process calls. ``load_train_state`` and ``load_model(mesh=)`` slice after
reading. A ``.orbax`` path is the sharded train state
(``engine/checkpoint.py``): every process writes and reads its own slices,
a collective too; one written over another model axis size is resliced as
it is read. A distillation teacher stays whole on every process: it
only runs an eval forward.
"""

from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from sensorium_tpu_torch.compat.jax_weights import from_jax_variables, nest
from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine import checkpoint as ckpt
from sensorium_tpu_torch.engine.callbacks import Callback, EngineState, build_logger
from sensorium_tpu_torch.engine.losses import get_loss
from sensorium_tpu_torch.engine.metrics import CorrelationMetric
from sensorium_tpu_torch.engine.optimizers import get_optimizer
from sensorium_tpu_torch.engine.preemption import PreemptionHandler, TrainingPreempted
from sensorium_tpu_torch.engine.state import TrainState
from sensorium_tpu_torch.engine.steps import make_predict_step, make_train_step, make_val_step
from sensorium_tpu_torch.models.dwiseneuro import neuron_validity_mask
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel import tensor as tensor_lib
from sensorium_tpu_torch.utils.device import fetch_to_host, resolve_device
from sensorium_tpu_torch.utils.profiling import span


class MouseModel:
    """Registry-built model, training state and step functions.

    ``params`` is the config's ``argus_params`` dict: ``nn_module``,
    ``loss``, ``optimizer``, ``frame_stack``, ``inputs_processor``,
    ``iter_size``, optionally ``grad_clip``. The network itself is built by
    ``build_state`` from its seed. With a ``mesh`` the model runs on the
    mesh's device, and ``device`` is not read.
    """

    def __init__(self, params: dict, device: str | torch.device = "cuda", mesh: mesh_lib.Mesh | None = None):
        if mesh is not None:
            if len(mesh.devices) != 1:
                raise ValueError(f"a training mesh holds one device a process, this one {mesh.devices}: the port "
                                 "trains one card a process, over a process group (cli.train --mesh data or "
                                 "--mesh data,model starts a rank a card); a mesh of one process's cards serves "
                                 "through Predictor(mesh=)")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tensor_parallel = mesh_lib.tensor_parallel(mesh)
        self.params = params
        self.nn_name, self.nn_params = params["nn_module"]
        loss_name, loss_params = params.get("loss", ("mice_poisson", {}))
        outputs = self.nn_params.get("readout_outputs")
        neuron_mask = neuron_validity_mask(outputs) if outputs is not None else None
        self.loss_fn = get_loss(loss_name, loss_params, neuron_mask=neuron_mask, mesh=mesh)
        self.optimizer_spec = params.get("optimizer", ("AdamW", {"lr": 1e-3}))
        self.grad_clip = float(params.get("grad_clip", 0.0) or 0.0)
        self.iter_size = int(params.get("iter_size", 1))

        self.ema_decay = 0.0
        self.distill_ratio = 0.0
        self.teacher_module: nn.Module | None = None

        self.nn_module: nn.Module | None = None
        self.state: TrainState | None = None
        self.schedule: Callable[[int], float] | None = None
        self._train_step = None
        self._val_step = make_val_step(self.loss_fn)
        self._predict_steps: dict[int | None, Callable] = {}
        self.logger = build_logger()

    # ---------------------------------------------------------------- setup

    def example_input(self, batch_size: int = 1) -> np.ndarray:
        frame_stack = self.params.get("frame_stack", {"size": 16})
        size = self.params.get("inputs_processor", ("stack_inputs", {}))[1].get("size", (64, 64))
        in_channels = self.nn_params.get("in_channels", 5)
        # The processor's size is (width, height); batch arrays are (..., height, width).
        return np.zeros((batch_size, in_channels, frame_stack["size"], size[1], size[0]), np.float32)

    def set_ema(self, decay: float) -> None:
        """Set the EMA decay, before or after ``build_state``; with a state,
        the EMA copy is made from the live model or dropped to match."""
        decay = float(decay)
        if decay == self.ema_decay:
            return
        self.ema_decay = decay
        self._train_step = None
        if self.state is None:
            return
        if decay > 0.0 and self.state.ema_model is None:
            self.state.ema_model = self._ema_copy(self.state.model)
        elif decay == 0.0:
            self.state.ema_model = None

    def set_distill(self, teacher_module: nn.Module, ratio: float) -> None:
        """Attach a frozen teacher whose predictions fill the unlabeled cells
        (a whole module, also under a model axis: it runs an eval forward)."""
        self.teacher_module = teacher_module.to(self.device).eval().requires_grad_(False)
        self.distill_ratio = float(ratio)
        self._train_step = None

    @staticmethod
    def _ema_copy(model: nn.Module) -> nn.Module:
        return copy.deepcopy(model).requires_grad_(False)

    def build_state(self, seed: int = 0, learning_rate: float | Callable[[int], float] | None = None) -> TrainState:
        """Initialize the network from ``seed``, the optimizer and (with a
        decay set) the EMA copy. ``learning_rate`` is a float or a schedule
        of the update count; None takes the config's ``lr``."""
        self.nn_module = get_nn_module(self.nn_name, self.nn_params, device=self.device,
                                       generator=torch.Generator().manual_seed(seed)).train()
        mesh_lib.replicate_tree(self.mesh, self.nn_module)
        tensor_lib.shard_module(self.nn_module, self.mesh)
        self.schedule = learning_rate if callable(learning_rate) else None
        first_lr = learning_rate(0) if callable(learning_rate) else learning_rate
        opt_name, opt_params = self.optimizer_spec
        optimizer = get_optimizer(opt_name, opt_params, self.nn_module.parameters(), learning_rate=first_lr)
        ema_model = self._ema_copy(self.nn_module) if self.ema_decay > 0.0 else None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState(step=0, model=self.nn_module, optimizer=optimizer, ema_model=ema_model,
                                generator=generator)
        self._train_step = None
        return self.state

    def init_from_checkpoint(self, file_path) -> None:
        """Warm start: the weights (and EMA copy) of a model checkpoint
        replace the freshly built ones; the optimizer, update count and
        generator stay as ``build_state`` made them. Raises ``ValueError``
        if a leaf's shape differs from the built model's."""
        if self.state is None:
            raise RuntimeError("Call build_state() before init_from_checkpoint()")
        nn_state = ckpt.load_model_checkpoint(file_path)["nn_state"]
        weights = from_jax_variables(nn_state["params"], nn_state.get("batch_stats", {}))
        current = self.state.model.state_dict()
        for name, value in weights.items():
            built = tensor_lib.full_shape(name, current[name].shape, self.mesh) if name in current else None
            if built is not None and tuple(value.shape) != built:
                raise ValueError(
                    f"init_from checkpoint leaf {name} has shape {tuple(value.shape)}, the built model "
                    f"{built}: config/checkpoint architecture mismatch"
                )
        weights = tensor_lib.scatter_state_dict(weights, self.mesh)
        self.state.model.load_state_dict(weights, strict=True)
        if self.state.ema_model is not None:
            # load_state_dict copies: the EMA keeps tensors of its own.
            self.state.ema_model.load_state_dict(weights, strict=True)
        self._replicate()

    def _replicate(self) -> None:
        """The weights (and EMA) of the first process of this process's data
        group on every process of it: under a model axis each slice from the
        first process that holds it, else the first process's."""
        mesh_lib.replicate_tree(self.mesh, self.state.model, over="data")
        if self.state.ema_model is not None:
            mesh_lib.replicate_tree(self.mesh, self.state.ema_model, over="data")

    # ---------------------------------------------------------------- steps

    def _ensure_train_step(self) -> Callable:
        if self.state is None:
            raise RuntimeError("Call build_state() before training")
        if self._train_step is None:
            self._train_step = make_train_step(
                self.loss_fn,
                ema_decay=self.ema_decay,
                iter_size=self.iter_size,
                schedule=self.schedule,
                grad_clip=self.grad_clip,
                distill_ratio=self.distill_ratio,
                teacher_model=self.teacher_module,
                mesh=self.mesh,
            )
        return self._train_step

    def _on_device(self, value) -> bool:
        """Whether ``value`` is a tensor on this model's device ("cuda" is
        the current card, whatever index the tensor's device names)."""
        if not isinstance(value, torch.Tensor) or value.device.type != self.device.type:
            return False
        return self.device.index is None or value.device.index == self.device.index

    def _stage_inputs(self, inputs) -> torch.Tensor:
        """The batch inputs on the device, cast to bf16 on the host before the
        copy when the model's ``dtype`` is bf16, the teacher is None or its
        ``dtype`` is bf16 too (a module without ``dtype`` counts as not bf16),
        and ``SENSORIUM_STAGE_BF16`` is not ``"0"``. The model's first op is
        that cast, round-to-nearest-even either way, so only the copy halves;
        a teacher that is not bf16 would see rounded inputs, so it gets fp32.
        A tensor already on the device passes as it is."""
        if self._on_device(inputs):
            return inputs
        inputs = torch.as_tensor(np.asarray(inputs, np.float32))

        def is_bf16(module) -> bool:
            return getattr(module, "dtype", None) == torch.bfloat16

        if (is_bf16(self.nn_module) and (self.teacher_module is None or is_bf16(self.teacher_module))
                and os.environ.get("SENSORIUM_STAGE_BF16", "1") != "0"):
            inputs = inputs.to(torch.bfloat16)
        return inputs.to(self.device)

    def _stage(self, batch: MiceBatch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The batch on the device (the span ``fit.stage``); a tensor already
        there passes as it is."""
        def to_device(a):
            if self._on_device(a):
                return a
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        with span("fit.stage"):
            return self._stage_inputs(batch.inputs), to_device(batch.targets), to_device(batch.weights)

    def _shard(self, batch: MiceBatch, train: bool) -> MiceBatch:
        """This process's rows of a global batch: each microbatch's slice for
        training (a batch that does not divide over the mesh raises), the
        zero-weight padded batch's for evaluation."""
        if self.mesh is None:
            return batch
        extent = mesh_lib.data_extent(self.mesh)
        if train and len(batch.inputs) % extent:
            raise ValueError(f"Train batch of {len(batch.inputs)} does not divide the data axis ({extent}); "
                             "use drop_last=True: padding would alter BN batch statistics")
        arrays = mesh_lib.shard_batch(self.mesh, batch.inputs, batch.targets, batch.weights,
                                      chunks=self.iter_size if train else 1, pad=not train)
        return MiceBatch(*arrays)

    def train_step(self, batch: MiceBatch, sharded: bool = False) -> torch.Tensor:
        """One optimizer update; returns the loss as a 0-d tensor on the device.
        ``sharded``: the batch is this process's rows already (a loader built
        with ``shard=``), not the global batch."""
        step = self._ensure_train_step()
        if not sharded:
            batch = self._shard(batch, train=True)
        return step(self.state, *self._stage(batch))

    def val_step(self, batch: MiceBatch, sharded: bool = False):
        """``(loss, prediction, targets, weights)`` on the eval (EMA) weights;
        the staged targets and weights come back for the metrics. With a
        mesh, the loss is the global batch's and the rest this process's rows."""
        if self.state is None:
            raise RuntimeError("Call build_state() before validation")
        if not sharded:
            batch = self._shard(batch, train=False)
        inputs, targets, weights = self._stage(batch)
        loss, prediction = self._val_step(self.state.eval_model, inputs, targets, weights)
        if self.mesh is not None:
            # An inference tensor takes no in-place update outside inference mode: reduce a copy.
            loss = mesh_lib.all_reduce(self.mesh, loss.clone())
        return loss, prediction, targets, weights

    def predict(self, inputs, mouse_index: int | None = None) -> torch.Tensor:
        """Eval forward on the eval (EMA) weights. A single clip (4-D input)
        gives (N, T) for one mouse or (M, N_max, T) for all."""
        if self.state is None:
            raise RuntimeError("Call build_state() before predict()")
        if mouse_index not in self._predict_steps:
            self._predict_steps[mouse_index] = make_predict_step(mouse_index)
        inputs = torch.as_tensor(np.asarray(inputs, np.float32))
        squeeze = inputs.ndim == 4
        if squeeze:
            inputs = inputs[None]
        prediction = self._predict_steps[mouse_index](self.state.eval_model, inputs.to(self.device))
        if squeeze:
            return prediction[0] if mouse_index is not None else prediction[:, 0]
        return prediction

    # ------------------------------------------------------------------ fit

    def fit(
        self,
        train_loader,
        val_loader=None,
        num_epochs: int = 1,
        callbacks: Sequence[Callback] = (),
        metrics: Sequence[CorrelationMetric] = (),
        stage: str = "train",
        start_epoch: int = 0,
        preemption: PreemptionHandler | None = None,
        preemption_save_path=None,
    ) -> None:
        """The train and validation loop: per epoch, every batch of
        ``train_loader`` through ``train_step``, then (with a ``val_loader``)
        every batch through ``val_step`` with the metrics, then the
        callbacks. ``fit_complete`` runs on every callback however the loop
        ends; one that raises is logged and does not hide the loop's error.

        With ``preemption`` (a ``PreemptionHandler``), a latched signal is
        acted on after each train step, after validation and after the
        epoch's callbacks: the train state goes to ``preemption_save_path``
        (if given), with ``extra["epoch"]`` the last epoch completed, and
        ``TrainingPreempted`` is raised. An epoch cut short is redone on
        resume. Over a process group every process must pass a handler: they
        act on a signal when any of them has latched one (an ``all_reduce``
        of the flag at each check point), and the caller gives the save path
        to one of them. After a train step they act on the flag reduced
        after the step before, one step late: reading it waits for that step
        only, so the host still prepares the next batch while the card runs
        this one.

        With a mesh, a loader built with ``shard=`` (this process's index and
        the mesh's extent) hands over this process's rows; any other loader
        hands over global batches, which ``train_step`` and ``val_step`` shard.
        The metrics need ``batch_stats``: their sums are reduced over the mesh."""
        if self.state is None:
            raise RuntimeError("Call build_state() before fit()")
        if self.mesh is not None and any(not hasattr(metric, "batch_stats") for metric in metrics):
            raise ValueError("under a mesh every metric needs batch_stats (sums that reduce over the mesh)")
        engine_state = EngineState(model=self, stage=stage, logger=self.logger)

        pending: list[tuple[torch.Tensor, torch.cuda.Event | None]] = []  # reduced flags not yet read

        def triggered(after_step: bool) -> bool:
            if preemption is None:
                return False
            if self.mesh is None or not self.mesh.distributed:
                return preemption.triggered
            # Filled on the device: a copy from the host would wait for the step.
            flag = torch.full((1,), float(preemption.triggered), device=self.device)
            pending.append(fetch_to_host(mesh_lib.all_reduce(self.mesh, flag, "max", over="all")))
            if not after_step:  # this check point's own flag; the signal stays latched, so it covers the older ones
                host, copied = pending.pop()
                pending.clear()
            elif len(pending) == 1:
                return False
            else:
                host, copied = pending.pop(0)
            if copied is not None:
                copied.synchronize()
            return bool(host.item())

        def check_preempted(epochs_behind: int = 1, after_step: bool = False) -> None:
            """``epochs_behind`` 1 inside an epoch, 0 once its callbacks ran."""
            if not triggered(after_step):
                return
            epoch_done = engine_state.global_epoch - epochs_behind
            if preemption_save_path is not None:
                self.save_train_state(preemption_save_path, extra={"epoch": epoch_done})
            self.logger.info(f"Preemption signal: state saved (epoch {epoch_done} complete), exiting")
            raise TrainingPreempted(preemption_save_path)

        try:
            self._fit_epochs(engine_state, train_loader, val_loader, num_epochs, callbacks, metrics, stage,
                             start_epoch, check_preempted)
        finally:
            for callback in callbacks:
                try:
                    callback.fit_complete(engine_state)
                except Exception:
                    self.logger.exception(f"fit_complete failed in {type(callback).__name__}; continuing")

    def _fit_epochs(self, engine_state, train_loader, val_loader, num_epochs, callbacks, metrics, stage,
                    start_epoch, check_preempted) -> None:
        for epoch in range(num_epochs):
            engine_state.epoch = epoch
            engine_state.global_epoch = start_epoch + epoch
            engine_state.metrics = {}
            for callback in callbacks:
                callback.epoch_start(engine_state)

            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(engine_state.global_epoch)
            # The losses stay on the device until the epoch ends: one copy
            # to the host per epoch, not a wait for the card every step.
            losses = []
            sharded = self._loader_sharded(train_loader, chunks=self.iter_size)
            for batch in train_loader:
                losses.append(self.train_step(batch, sharded=sharded))
                check_preempted(after_step=True)
            engine_state.metrics["train_loss"] = _mean_on_host(losses)

            if val_loader is not None:
                for metric in metrics:
                    metric.reset()
                val_losses = []
                sharded = self._loader_sharded(val_loader, chunks=1)
                for batch in val_loader:
                    loss, prediction, targets, weights = self.val_step(batch, sharded=sharded)
                    val_losses.append(loss)
                    for metric in metrics:
                        if hasattr(metric, "batch_stats"):
                            # Reduced on the device: only (M, N_max, 5) sums cross to the host.
                            counts, sums = metric.batch_stats(prediction, targets, weights)
                            mesh_lib.all_reduce(self.mesh, counts)
                            mesh_lib.all_reduce(self.mesh, sums)
                            metric.update_stats(counts.cpu().numpy(), sums.cpu().numpy())
                        else:
                            metric.update(prediction.cpu().numpy(), batch.targets, batch.weights)
                engine_state.metrics["val_loss"] = _mean_on_host(val_losses)
                for metric in metrics:
                    engine_state.metrics.update(metric.epoch_metrics(prefix="val_"))
                check_preempted()

            lr = self._current_lr()
            if lr is not None:
                engine_state.metrics["lr"] = lr
            self.logger.info(
                f"{stage} epoch {engine_state.global_epoch}: "
                + ", ".join(f"{k}={v:.6g}" for k, v in engine_state.metrics.items())
            )
            for callback in callbacks:
                callback.epoch_complete(engine_state)
            check_preempted(epochs_behind=0)
            if engine_state.stopped:
                break

    def _loader_sharded(self, loader, chunks: int) -> bool:
        """Whether ``loader`` hands over this process's rows (built with
        ``shard=``); raises if they are not this mesh's, or not cut by
        ``chunks`` microbatches."""
        shard = getattr(loader, "shard", None)
        if shard is None:
            return False
        expected = None if self.mesh is None else (self.mesh.data_index, mesh_lib.data_extent(self.mesh))
        if tuple(shard) != expected or getattr(loader, "microbatches", 1) != chunks:
            raise ValueError(f"the loader holds shard {tuple(shard)} of {getattr(loader, 'microbatches', 1)} "
                             f"microbatches a batch; this model needs shard {expected} of {chunks}")
        return True

    def _current_lr(self) -> float | None:
        """The scheduled lr at the current update count, for the log."""
        if self.schedule is None:
            return None
        return float(self.schedule(self.state.step))

    # ----------------------------------------------------------- checkpoint

    @property
    def writes_files(self) -> bool:
        """Whether this process writes the single-file checkpoints: without a
        process group, or as its first process."""
        return self.mesh is None or not self.mesh.distributed or self.mesh.index == 0

    def _gathers(self) -> bool:
        """Whether this process takes part in gathering a single-file
        checkpoint: the processes of the first model group under a model
        axis (a collective over it); else the process that writes."""
        return self.mesh.data_index == 0 if self.tensor_parallel else self.writes_files

    def _variables(self, module: nn.Module) -> dict:
        """``{"params", "batch_stats"}`` of ``module`` nested in the JAX
        tree's names (``compat.to_jax_variables``), the sharded tensors
        gathered whole."""
        whole = tensor_lib.gather_state_dict(module, self.mesh)
        params = {name for name, _ in module.named_parameters()}
        return {"params": nest({n: v for n, v in whole.items() if n in params}),
                "batch_stats": nest({n: v for n, v in whole.items() if n not in params})}

    def eval_variables(self) -> dict:
        """``{"params", "batch_stats"}`` of the eval (EMA) weights, nested in
        the JAX tree's names (the tensors themselves; under a model axis the
        gathered ones, a collective over the model group)."""
        return self._variables(self.state.eval_model)

    def save(self, file_path, background: bool = False) -> None:
        """Write a model checkpoint of the eval (EMA) weights. The copy to
        the host is made before this returns; with ``background`` the
        serialization and the write go on in a thread. Over a process group
        the first process writes; under a model axis every process calls it."""
        if not self._gathers():
            return
        variables = self.eval_variables()
        if self.writes_files:
            ckpt.save_model_checkpoint(file_path, self.params, variables, background=background)

    def _optimizer_tensors(self) -> dict[str, dict]:
        """torch.optim's per-parameter state as ``{key: {parameter name: value}}``."""
        names = [name for name, _ in self.state.model.named_parameters()]
        per_key: dict[str, dict] = {}
        for index, entry in self.state.optimizer.state_dict()["state"].items():
            for key, value in entry.items():
                per_key.setdefault(key, {})[names[index]] = value
        return per_key

    def _train_state_tree(self) -> dict:
        state = self.state
        live = self._variables(state.model)
        ema = self._variables(state.ema_model) if state.ema_model is not None else None
        per_key = {key: tensor_lib.gather_tensors(flat, self.mesh) for key, flat in self._optimizer_tensors().items()}
        return {
            "step": np.asarray(state.step, np.int32),
            "params": live["params"],
            "batch_stats": live["batch_stats"],
            "ema_params": None if ema is None else ema["params"],
            "ema_batch_stats": None if ema is None else ema["batch_stats"],
            # The port's own: torch.optim's per-parameter state and the
            # dropout generator, which the JAX package does not share.
            "optimizer": {key: nest(flat) for key, flat in per_key.items()},
            "generator": state.generator.get_state(),
        }

    def save_train_state(self, file_path, extra: dict | None = None, background: bool = False) -> None:
        """Write the resume state: weights, BN statistics, EMA, optimizer
        state, the generator and the update count, with ``extra``. A path
        ending in ``.orbax`` is the sharded format (``background`` is not
        read): every process of the mesh must call it. Otherwise one msgpack
        file, written as ``save`` writes."""
        if self.state is None:
            raise RuntimeError("Call build_state() before save_train_state()")
        if Path(file_path).suffix == ".orbax":
            ckpt.save_train_state_sharded(file_path, self._sharded_tensors(), self.params, extra=extra,
                                          process_group=self._process_group(), primary=self.writes_files)
            return
        if not self._gathers():
            return
        tree = self._train_state_tree()
        if self.writes_files:
            ckpt.save_train_state(file_path, tree, self.params, extra=extra, background=background)

    def load_train_state(self, file_path) -> dict:
        """Restore a state ``save_train_state`` wrote into this model, built
        from the same config; returns its ``extra``. Either format loads on
        any mesh: a ``.orbax`` state written over another ``model`` size is
        resliced as it is read."""
        if self.state is None:
            raise RuntimeError("Call build_state() before load_train_state()")
        if Path(file_path).suffix == ".orbax":
            return self._load_sharded(file_path)
        tree, extra = ckpt.load_train_state(file_path)
        state = self.state
        if (tree["ema_params"] is None) != (state.ema_model is None):
            raise ValueError("the train state and this model must both keep an EMA, or neither")
        state.model.load_state_dict(self._slices(tree["params"], tree["batch_stats"]), strict=True)
        if state.ema_model is not None:
            state.ema_model.load_state_dict(self._slices(tree["ema_params"], tree["ema_batch_stats"]), strict=True)
        index = {name: i for i, (name, _) in enumerate(state.model.named_parameters())}
        per_param: dict[int, dict] = {}
        for key, nested in tree["optimizer"].items():
            for name, value in _leaves(nested):
                if isinstance(value, torch.Tensor):
                    value = tensor_lib.scatter_state_dict({name: value}, self.mesh)[name]
                per_param.setdefault(index[name], {})[key] = value
        # load_state_dict moves the moments to their parameters' device and dtype.
        state.optimizer.load_state_dict({"state": per_param,
                                         "param_groups": state.optimizer.state_dict()["param_groups"]})
        state.generator.set_state(ckpt.as_tensor(tree["generator"]))
        state.step = int(tree["step"])
        self._replicate()
        return extra

    def _slices(self, params: dict, batch_stats: dict) -> dict:
        """A state dict of this process's slices from nested whole trees."""
        return tensor_lib.scatter_state_dict(from_jax_variables(params, batch_stats), self.mesh)

    # ------------------------------------------------------ sharded state

    def _process_group(self):
        """The group a sharded save or load runs over (None: this process alone)."""
        return self.mesh.group if self.mesh is not None and self.mesh.distributed else None

    def _key(self, prefix: str, name: str, shape) -> str:
        """The sharded train state's key of a tensor: its slice's key under a model axis."""
        key = f"{prefix}/{name}"
        if self.tensor_parallel and tensor_lib.param_sharding_rules(name, shape) is not None:
            key = ckpt.SLICE_KEY.format(key=key, index=self.mesh.model_index, count=self.mesh.num_model)
        return key

    def _module_tensors(self) -> dict[str, torch.Tensor]:
        """The live and EMA weights and BN statistics under their keys (the tensors themselves)."""
        out = {}
        models = [("", self.state.model)]
        if self.state.ema_model is not None:
            models.append(("ema_", self.state.ema_model))
        for prefix, module in models:
            params = {name for name, _ in module.named_parameters()}
            for name, value in module.state_dict().items():
                kind = "params" if name in params else "batch_stats"
                out[self._key(prefix + kind, name, value.shape)] = value
        return out

    def _sharded_tensors(self) -> dict[str, torch.Tensor]:
        """Everything the sharded train state holds, flat: this process's tensors."""
        out = self._module_tensors()
        for key, flat in self._optimizer_tensors().items():
            for name, value in flat.items():
                out[self._key(f"optimizer/{key}", name, value.shape)] = value
        out["step"] = torch.tensor(self.state.step, dtype=torch.int64)
        out["generator"] = self.state.generator.get_state()
        return out

    def _load_sharded(self, dir_path) -> dict:
        """Read a sharded train state into this model. Over the model axis
        size it was written over, each process reads its own keys into its
        live tensors. Over another size, each process reads every saved
        slice of each sliced tensor, joins them along the axis that
        ``param_sharding_rules`` names and keeps its own slice of the whole,
        as ``scatter_state_dict`` does."""
        meta, keys = ckpt.sharded_train_state_keys(dir_path)
        saved = ckpt.model_axis_of(keys)
        state = self.state
        tensors = self._module_tensors()
        if ("ema_params" in {k.split("/")[0] for k in keys}) != (state.ema_model is not None):
            raise ValueError("the train state and this model must both keep an EMA, or neither")
        parameters = dict(state.model.named_parameters())
        moments: dict[str, tuple[str, str]] = {}
        for key, (shape, dtype) in keys.items():
            if not key.startswith("optimizer/"):
                continue
            _, kind, name = key.split("/", 2)
            name = ckpt.SLICE_SUFFIX.sub("", name)
            shape = tuple(parameters[name].shape) if len(shape) else ()
            key = self._key(f"optimizer/{kind}", name, shape)
            if key in moments:
                continue  # another slice of one already listed
            device = parameters[name].device if len(shape) else "cpu"
            tensors[key] = torch.empty(shape, dtype=dtype, device=device)
            moments[key] = (kind, name)
        joins = {}  # this process's key -> (its tensor, the saved slices' keys, their axis, the tensor's name)
        for key in list(tensors):
            if key in keys:
                continue
            base = ckpt.SLICE_SUFFIX.sub("", key)
            name = base.rsplit("/", 1)[1]
            axis = tensor_lib.param_sharding_rules(name, tensors[key].shape)
            pieces = ([ckpt.SLICE_KEY.format(key=base, index=i, count=saved) for i in range(saved)]
                      if saved > 1 else [base])
            if axis is None or any(piece not in keys for piece in pieces):
                raise ValueError(f"{dir_path} holds no {key} and no slices of it: not a train state of this model")
            joins[key] = (tensors.pop(key), pieces, axis, name)
            for piece in pieces:
                shape, dtype = keys[piece]
                tensors[piece] = torch.empty(shape, dtype=dtype, device=joins[key][0].device)
        tensors["step"] = torch.zeros((), dtype=torch.int64)
        tensors["generator"] = torch.empty(keys["generator"][0], dtype=torch.uint8)
        ckpt.load_train_state_sharded(dir_path, tensors, process_group=self._process_group())
        for key, (target, pieces, axis, name) in joins.items():
            whole = torch.cat([tensors.pop(piece) for piece in pieces], axis)
            with torch.no_grad():
                target.copy_(tensor_lib.scatter_state_dict({name: whole}, self.mesh)[name])
            tensors[key] = target
        index = {name: i for i, name in enumerate(parameters)}
        per_param: dict[int, dict] = {}
        for key, (kind, name) in moments.items():
            per_param.setdefault(index[name], {})[kind] = tensors[key]
        state.optimizer.load_state_dict({"state": per_param,
                                         "param_groups": state.optimizer.state_dict()["param_groups"]})
        state.generator.set_state(tensors["generator"])
        state.step = int(tensors["step"])
        return meta.get("extra", {})


def _leaves(tree: dict, prefix: str = ""):
    """``(dotted name, leaf)`` of a nested dict; array leaves as tensors."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            is_array = isinstance(value, (np.ndarray, np.generic, torch.Tensor))
            yield f"{prefix}{key}", ckpt.as_tensor(value) if is_array else value


def load_model(file_path, device: str | torch.device = "cuda", mesh: mesh_lib.Mesh | None = None) -> MouseModel:
    """A ``MouseModel`` from a model checkpoint (the port's or the JAX
    package's): the module built from the checkpoint's config, its saved
    eval weights loaded, on ``device`` (with a ``mesh``, on the mesh's, the
    first process's weights on every process, sliced under a model axis);
    ``predict`` and ``val_step`` run them."""
    device = resolve_device(device if mesh is None else mesh.device)
    payload = ckpt.load_model_checkpoint(file_path)
    model = MouseModel(payload["params"], device=device, mesh=mesh)
    nn_state = payload["nn_state"]
    module = get_nn_module(model.nn_name, model.nn_params, device=model.device)
    module.load_state_dict(from_jax_variables(nn_state["params"], nn_state.get("batch_stats", {})), strict=True)
    mesh_lib.replicate_tree(mesh, module)
    tensor_lib.shard_module(module, mesh)
    model.nn_module = module
    model.state = TrainState(step=0, model=module, optimizer=None, ema_model=None,
                             generator=torch.Generator(device=model.device).manual_seed(0))
    return model


def _mean_on_host(values: list[torch.Tensor]) -> float:
    """The mean of 0-d device tensors, copied to the host in one transfer."""
    if not values:
        return float("nan")
    return float(np.mean(torch.stack(values).cpu().numpy()))
