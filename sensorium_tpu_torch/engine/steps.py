"""Train, validation and predict steps.

Counterpart of ``sensorium_tpu/engine/steps.py``. One train step:

* ``iter_size`` microbatches, which must divide the batch evenly (as in
  JAX): each chunk runs the all-mice training forward (drawing its own
  dropout and drop-path masks), casts the predictions to fp32, takes the
  loss and backpropagates ``loss / iter_size``, so the gradients are the
  chunks' mean and the loss the sum of ``chunk loss / iter_size``. BN
  running statistics carry from chunk to chunk, as sequential forwards do;
* with a teacher, its eval forward runs under ``no_grad`` and
  ``inject_distill_targets`` fills the zero-weight cells before the loss;
* optional clipping (``torch.nn.utils.clip_grad_norm_``: every gradient
  scaled by ``min(1, clip / (global norm + 1e-6))``), then the lr of the
  update count, the optimizer step, and the EMA over parameters and BN
  statistics.

The gradient reset, the update (clip, lr and optimizer step) and the EMA
are spans (``utils/profiling.py``): ``step.zero_grad``, ``step.optimizer``
and ``step.ema``.

With a data-parallel ``mesh`` the step gets this process's rows of the
global batch (its slice of each microbatch, ``parallel.mesh.shard_rows``)
and runs its forwards and backwards under ``parallel.mesh.active``: BN
takes the global batch's statistics, the masks are the global batch's, and
the loss is this process's share of the global loss (``get_loss(mesh=)``).
After the microbatches the gradients are summed over the mesh in flat
buckets (``reduce_gradients``; a sum, because the shares carry the global
normalization, as JAX's psum does), and so is the reported loss. Clipping,
the lr and AdamW then run on the same gradients on every process, so the
parameters, the BN statistics and the EMA stay identical without more
communication.

Mixed precision is the model's own: fp32 master parameters cast to bf16
where the JAX model casts them. No autocast and no GradScaler (bf16 keeps
fp32's exponent range).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from sensorium_tpu_torch.engine.ema import ema_tensors, ema_update
from sensorium_tpu_torch.engine.losses import inject_distill_targets
from sensorium_tpu_torch.engine.state import TrainState
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel.tensor import param_sharding_rules
from sensorium_tpu_torch.utils.profiling import span


def make_train_step(
    loss_fn: Callable,
    ema_decay: float = 0.0,
    iter_size: int = 1,
    schedule: Callable[[int], float] | None = None,
    grad_clip: float = 0.0,
    distill_ratio: float = 0.0,
    teacher_model: nn.Module | None = None,
    mesh: mesh_lib.Mesh | None = None,
) -> Callable:
    """Returns ``step(state, inputs, targets, weights) -> loss``, which
    updates ``state`` in place and returns the loss as a 0-d fp32 tensor on
    the model's device (reading it waits for the card). With a ``mesh``,
    ``loss_fn`` must be that mesh's (``get_loss(mesh=)``)."""
    use_distill = distill_ratio > 0.0 and teacher_model is not None

    def chunk_loss(state: TrainState, inputs, targets, weights):
        prediction = state.model(inputs, generator=state.generator).float()
        if use_distill:
            with torch.no_grad():
                teacher_pred = teacher_model(inputs).float()
            targets, weights = inject_distill_targets(targets, weights, teacher_pred, distill_ratio, mesh)
        return loss_fn(prediction, targets, weights)

    def step(state: TrainState, inputs, targets, weights) -> torch.Tensor:
        batch = inputs.shape[0]
        if batch % iter_size:
            raise ValueError(
                f"batch_size {batch} is not divisible by iter_size {iter_size}: gradient-accumulation "
                "microbatches are equal-size chunks; pick batch_size % iter_size == 0"
            )
        model, optimizer = state.model, state.optimizer
        model.train()
        with span("step.zero_grad"):
            optimizer.zero_grad(set_to_none=True)
        chunk = batch // iter_size
        total = torch.zeros((), dtype=torch.float32, device=inputs.device)
        with mesh_lib.active(mesh):
            for i in range(iter_size):
                part = slice(i * chunk, (i + 1) * chunk)
                loss = chunk_loss(state, inputs[part], targets[part], weights[part])
                if iter_size > 1:
                    loss = loss / iter_size
                loss.backward()
                total += loss.detach()
        if mesh is not None:
            mesh_lib.reduce_gradients(mesh, model.parameters())
            mesh_lib.all_reduce(mesh, total)
        with span("step.optimizer"):
            if grad_clip > 0.0:
                if mesh_lib.tensor_parallel(mesh):
                    clip_sharded_grad_norm_(model, grad_clip, mesh)
                else:
                    torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
            if schedule is not None:
                lr = float(schedule(state.step))
                for group in optimizer.param_groups:
                    group["lr"] = lr
            optimizer.step()
        if ema_decay > 0.0:
            with span("step.ema"):
                ema_update(ema_tensors(state.ema_model), ema_tensors(model), ema_decay)
        state.step += 1
        return total

    return step


@torch.no_grad()
def clip_sharded_grad_norm_(model: nn.Module, max_norm: float, mesh: mesh_lib.Mesh) -> torch.Tensor:
    """``clip_grad_norm_`` over a model whose sharded gradients are slices:
    the squared norms of the sharded ones summed over the model group, the
    replicated ones' added once; returns the global norm."""
    grads = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
    squares = [torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device) for _ in range(2)]
    for name, g in grads.items():
        squares[param_sharding_rules(name, g.shape) is not None] += g.float().square().sum()
    mesh_lib.all_reduce(mesh, squares[1], over="model")
    total = (squares[0] + squares[1]).sqrt()
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(list(grads.values()), coef)
    return total


def make_val_step(loss_fn: Callable) -> Callable:
    """``step(model, inputs, targets, weights) -> (loss, prediction)``: the
    all-mice eval forward (pass ``state.eval_model``, the EMA weights when
    there are any), predictions in fp32."""

    @torch.inference_mode()
    def step(model: nn.Module, inputs, targets, weights):
        model.eval()
        prediction = model(inputs).float()
        return loss_fn(prediction, targets, weights), prediction

    return step


def make_predict_step(mouse_index: int | None = None) -> Callable:
    """``step(model, inputs) -> prediction``: the eval forward in fp32."""

    @torch.inference_mode()
    def step(model: nn.Module, inputs):
        model.eval()
        return model(inputs, mouse_index=mouse_index).float()

    return step
