"""The port's data-parallel and tensor-parallel steps on the CPU, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_tensor_parallel.py``.

    python -m tests.torch_mesh_worker JOB_DIR RANK WORLD PORT [NUM_MODEL [NUM_SLICES]]

One rank of a gloo group of WORLD processes (store at 127.0.0.1:PORT). It
reads ``JOB_DIR/inputs.npz`` (the weights as the port's state dict under
``w/<name>``, the batches under ``<batch>/<array>``). With NUM_MODEL 1 (the
default) it runs ``run_scenarios`` over ``create_mesh()``; otherwise
``run_tp_scenarios`` over ``create_mesh(num_model=NUM_MODEL)``, or over
``create_hybrid_mesh(NUM_SLICES, num_model=NUM_MODEL)`` when NUM_SLICES is
given. It writes ``JOB_DIR/rank<RANK>.npz``. The test runs the same
scenarios without a mesh in its own process: that is the single-process
reference. This module imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine.metrics import batch_corr_stats
from sensorium_tpu_torch.engine.model import MouseModel, load_model
from sensorium_tpu_torch.engine.steps import clip_sharded_grad_norm_
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from sensorium_tpu_torch.parallel import tensor as tensor_lib

LR = 1e-3
DISTILL_RATIO = 0.36
EMA_DECAY = 0.9
GRAD_CLIP = 1e-3  # far below the tiny model's gradient norm: every step is clipped

# tests/test_engine.py tiny_params() (the test holds the two equal), SGD.
TINY_NN = {
    "readout_outputs": [5, 7], "in_channels": 5, "core_features": (8, 8), "spatial_strides": (2, 2),
    "spatial_kernel": 3, "temporal_kernel": 3, "expansion_ratio": 2, "se_reduce_ratio": 4,
    "cortex_features": (16, 16), "groups": 2, "softplus_beta": 0.07, "drop_rate": 0.2, "drop_path_rate": 0.1,
    "dtype": "float32", "readout_pad_multiple": 8,
}


def tiny_params(drop: bool = False, iter_size: int = 1) -> dict:
    nn_params = dict(TINY_NN)
    if not drop:
        nn_params["drop_rate"] = nn_params["drop_path_rate"] = 0.0
    return {
        "nn_module": ("dwiseneuro", nn_params),
        "loss": ("mice_poisson", {"log_input": False, "full": False, "eps": 1e-8}),
        "optimizer": ("SGD", {"lr": LR}),
        "frame_stack": {"size": 4, "step": 2, "position": "last"},
        "inputs_processor": ("stack_inputs", {"size": (16, 16), "pad_fill_value": 0.0}),
        "responses_processor": ("identity", {}),
        "iter_size": iter_size,
    }


def _batch(inputs: dict, name: str) -> MiceBatch:
    return MiceBatch(*(inputs[f"{name}/{key}"] for key in ("inputs", "targets", "weights")))


def _model(params: dict, mesh, weights: dict, lr: float = LR) -> MouseModel:
    model = MouseModel(params, device="cpu", mesh=mesh)
    model.build_state(seed=0, learning_rate=lr)
    model.state.model.load_state_dict(weights, strict=True)
    return model


def _record(out: dict, label: str, model: MouseModel, loss=None, grads: bool = False) -> None:
    if loss is not None:
        out[f"{label}/loss"] = np.float64(float(loss))
    module = model.state.model
    for name, value in module.state_dict().items():
        out[f"{label}/state/{name}"] = value.detach().numpy().copy()
    if grads:
        for name, p in module.named_parameters():
            out[f"{label}/grad/{name}"] = p.grad.detach().numpy().copy()


def _error(fn) -> str:
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def run_scenarios(mesh, inputs: dict) -> dict:
    """Each scenario from the same weights; returns ``{"<scenario>/...": array}``."""
    weights = {key[2:]: torch.from_numpy(value) for key, value in inputs.items() if key.startswith("w/")}
    out: dict = {}

    # One SGD step, drop rates 0: loss, weights and BN statistics after it, gradients.
    model = _model(tiny_params(), mesh, weights)
    _record(out, "sgd", model, model.train_step(_batch(inputs, "batch8")), grads=True)

    # BN running statistics over a batch whose halves differ (lr 0).
    model = _model(tiny_params(), mesh, weights, lr=0.0)
    model.train_step(_batch(inputs, "hetero8"))
    _record(out, "hetero", model)

    # Two microbatches.
    model = _model(tiny_params(iter_size=2), mesh, weights)
    _record(out, "iter2", model, model.train_step(_batch(inputs, "batch8")))

    # Distillation: a teacher from seed 1 fills the unlabeled cells.
    model = _model(tiny_params(), mesh, weights)
    teacher = get_nn_module("dwiseneuro", tiny_params()["nn_module"][1], device="cpu",
                            generator=torch.Generator().manual_seed(1))
    model.set_distill(teacher, DISTILL_RATIO)
    _record(out, "distill", model, model.train_step(_batch(inputs, "batch8")))

    # The drop rates on: the masks are the global batch's.
    model = _model(tiny_params(drop=True), mesh, weights)
    _record(out, "dropout", model, model.train_step(_batch(inputs, "batch8")))

    # A ragged val batch: loss, this process's prediction rows, the metric sums.
    model = _model(tiny_params(), mesh, weights)
    loss, prediction, targets, val_weights = model.val_step(_batch(inputs, "batch5"))
    counts, sums = batch_corr_stats(prediction, targets, val_weights)
    out["ragged_val/loss"] = np.float64(float(loss))
    out["ragged_val/prediction"] = prediction.numpy().copy()
    out["ragged_val/counts"] = mesh_lib.all_reduce(mesh, counts).numpy().copy()
    out["ragged_val/sums"] = mesh_lib.all_reduce(mesh, sums).numpy().copy()

    # A ragged train batch, and microbatches that do not divide over the mesh.
    out["ragged_train/error"] = np.str_(_error(lambda: model.train_step(_batch(inputs, "batch5"))))
    uneven = _model(tiny_params(iter_size=2), mesh, weights)
    out["uneven_microbatches/error"] = np.str_(_error(lambda: uneven.train_step(_batch(inputs, "batch6"))))

    # Replicas: weights broadcast from the first process.
    seeded = MouseModel(tiny_params(), device="cpu", mesh=mesh)
    seeded.build_state(seed=int(inputs["seed_by_rank"][mesh.index if mesh is not None else 0]), learning_rate=LR)
    _record(out, "broadcast", seeded)
    return out


def tp_params(optimizer: tuple, drop: bool = False, grad_clip: float = 0.0,
              learnable_softplus: bool = False) -> dict:
    params = {**tiny_params(drop=drop), "optimizer": optimizer, "grad_clip": grad_clip}
    if learnable_softplus:
        name, nn_params = params["nn_module"]
        params["nn_module"] = (name, {**nn_params, "learnable_softplus": True})
    return params


SGD_MOMENTUM = ("SGD", {"lr": LR, "momentum": 0.9})
RESUMED = ["tp1", "tp2"]  # the steps a resumed train state takes after "tp0"
ADAMW = ("AdamW", {"lr": LR, "weight_decay": 0.05})


def _tp_model(params: dict, mesh, init: Path, seed: int = 0, ema: bool = True) -> MouseModel:
    """A model whose live and EMA weights are the ``init`` checkpoint's, sliced under a model axis."""
    model = MouseModel(params, device="cpu", mesh=mesh)
    if ema:
        model.set_ema(EMA_DECAY)
    model.build_state(seed=seed, learning_rate=LR)
    model.init_from_checkpoint(init)
    return model


def _whole(model: MouseModel, module) -> dict:
    return {k: v.numpy().copy() for k, v in tensor_lib.gather_state_dict(module, model.mesh).items()}


def _momentum(model: MouseModel) -> dict:
    """The momentum buffers, gathered whole, by parameter name."""
    buffers = model._optimizer_tensors().get("momentum_buffer", {})
    return {k: v.numpy().copy() for k, v in tensor_lib.gather_tensors(buffers, model.mesh).items()}


def _local(model: MouseModel) -> dict:
    """Everything this process holds of the state, its slices as they are."""
    out = {f"live/{k}": v for k, v in model.state.model.state_dict().items()}
    if model.state.ema_model is not None:
        out.update({f"ema/{k}": v for k, v in model.state.ema_model.state_dict().items()})
    for key, flat in model._optimizer_tensors().items():
        out.update({f"opt/{key}/{k}": torch.as_tensor(v) for k, v in flat.items()})
    out["generator"] = model.state.generator.get_state()
    return out


def _bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _record_tp(out: dict, label: str, model: MouseModel, losses=None) -> None:
    if losses is not None:
        out[f"{label}/losses"] = np.asarray(losses, np.float64)
    for name, value in _whole(model, model.state.model).items():
        out[f"{label}/state/{name}"] = value
    if model.state.ema_model is not None:
        for name, value in _whole(model, model.state.ema_model).items():
            out[f"{label}/ema/{name}"] = value
    for name, value in _momentum(model).items():
        out[f"{label}/momentum/{name}"] = value
    # This process's replicated tensors, as they are (a model group's must be equal bitwise).
    for name, value in model.state.model.state_dict().items():
        if tensor_lib.param_sharding_rules(name, value.shape) is None:
            out[f"{label}/replicated/{name}"] = value.numpy().copy()


def run_tp_scenarios(mesh, inputs: dict, job_dir: Path, label: str) -> dict:
    """The tensor-parallel cases, each from the ``init.ckpt`` of ``job_dir``
    (the JAX package's tiny model; ``init_softplus.ckpt`` with learnable
    softplus betas); the files go to ``job_dir/label``.
    Without a mesh this is the single-process reference."""
    init, files = job_dir / "init.ckpt", job_dir / label
    files.mkdir(exist_ok=True)
    out: dict = {}

    def steps(model, names):
        return [float(model.train_step(_batch(inputs, name))) for name in names]

    # Two SGD-momentum steps with an EMA: losses, weights, EMA, momentum, and the shards' shapes.
    model = _tp_model(tp_params(SGD_MOMENTUM), mesh, init)
    _record_tp(out, "sgdm", model, steps(model, ["tp0", "tp1"]))
    # The global gradient norm the clip takes, of the last step's gradients (max_norm inf: no clip).
    if mesh is None:
        norm = torch.nn.utils.clip_grad_norm_(model.state.model.parameters(), float("inf"))
    else:
        norm = clip_sharded_grad_norm_(model.state.model, float("inf"), mesh)
    out["sgdm/grad_norm"] = np.float64(float(norm))
    for name, module in (("live", model.state.model), ("ema", model.state.ema_model)):
        out[f"shapes/{name}"] = np.asarray(module.state_dict()["readout_kernel"].shape)
    out["shapes/momentum"] = np.asarray(model._optimizer_tensors()["momentum_buffer"]["readout_kernel"].shape)
    out["shapes/cortex"] = np.asarray(model.state.model.state_dict()["cortex_0.kernel"].shape)
    # predict on the EMA weights: one mouse and all mice.
    out["predict/mouse1"] = model.predict(inputs["probe"], mouse_index=1).numpy().copy()
    out["predict/all"] = model.predict(inputs["probe"]).numpy().copy()
    model.save_train_state(files / "stepped_state.ckpt", extra={"epoch": 1})

    # The learnable softplus betas (from ``init_softplus.ckpt``): replicated,
    # each process applies them to its row slice, so their gradient is summed
    # over the model group.
    model = _tp_model(tp_params(SGD_MOMENTUM, learnable_softplus=True), mesh, job_dir / "init_softplus.ckpt")
    _record_tp(out, "softplus", model, steps(model, ["tp0", "tp1"]))

    # The drop rates on: the masks are the global batch's on every process.
    model = _tp_model(tp_params(SGD_MOMENTUM, drop=True), mesh, init, ema=False)
    _record_tp(out, "dropout", model, steps(model, ["tp0"]))

    # AdamW with every step clipped: the clip takes the global norm.
    model = _tp_model(tp_params(ADAMW, grad_clip=GRAD_CLIP), mesh, init)
    _record_tp(out, "adamw_clip", model, steps(model, ["tp0", "tp1"]))

    # The msgpack files of a model before any step.
    model = _tp_model(tp_params(ADAMW), mesh, init)
    model.save(files / "model.ckpt")
    model.save_train_state(files / "state.ckpt", extra={"epoch": 0})

    # load_model over the mesh: the single process's checkpoint, sliced.
    loaded = load_model(job_dir / "single_model.ckpt", device="cpu", mesh=mesh)
    out["load_model/mouse1"] = loaded.predict(inputs["probe"], mouse_index=1).numpy().copy()
    out["load_model/all"] = loaded.predict(inputs["probe"]).numpy().copy()

    # The sharded train state: a step, save, a fresh model loads it, and both take one more step.
    model = _tp_model(tp_params(SGD_MOMENTUM), mesh, init)
    steps(model, ["tp0"])
    model.save_train_state(files / "train_state.orbax", extra={"epoch": 2})
    # The same values whole, and as a msgpack train state, for the reads over another model axis size.
    _record_tp(out, "orbax_saved", model)
    model.save_train_state(files / "saved_state.ckpt", extra={"epoch": 2})
    resumed = _tp_model(tp_params(SGD_MOMENTUM), mesh, init, seed=9)
    extra = resumed.load_train_state(files / "train_state.orbax")
    out["orbax/epoch"] = np.int64(extra["epoch"])
    out["orbax/step"] = np.int64(resumed.state.step)
    out["orbax/shape"] = np.asarray(resumed.state.model.state_dict()["readout_kernel"].shape)
    out["orbax/restored_bitwise"] = np.bool_(_bitwise(_local(model), _local(resumed)))
    out["orbax/continued_losses"] = np.asarray([steps(model, ["tp1"]), steps(resumed, ["tp1"])], np.float64)
    out["orbax/continued_bitwise"] = np.bool_(_bitwise(_local(model), _local(resumed)))

    # A sharded state written by one process (a model axis of 1) read over this mesh's, and the
    # same values read from the msgpack train state: both take two more steps.
    onto = _tp_model(tp_params(SGD_MOMENTUM), mesh, init, seed=9)
    extra = onto.load_train_state(job_dir / "single_state.orbax")
    out["reshard/epoch"] = np.int64(extra["epoch"])
    out["reshard/step"] = np.int64(onto.state.step)
    out["reshard/generator"] = onto.state.generator.get_state().numpy().copy()
    _record_tp(out, "reshard/restored", onto)
    twin = _tp_model(tp_params(SGD_MOMENTUM), mesh, init, seed=9)
    twin.load_train_state(job_dir / "single_state.ckpt")
    out["reshard/twin_bitwise"] = np.bool_(_bitwise(_local(onto), _local(twin)))
    out["reshard/continued_losses"] = np.asarray([steps(onto, RESUMED), steps(twin, RESUMED)], np.float64)
    out["reshard/continued_bitwise"] = np.bool_(_bitwise(_local(onto), _local(twin)))
    _record_tp(out, "reshard/continued", onto)

    # The run the resumed ones continue, uninterrupted over this mesh.
    model = _tp_model(tp_params(SGD_MOMENTUM), mesh, init)
    _record_tp(out, "uninterrupted", model, steps(model, ["tp0", *RESUMED]))
    return out


def write_single_state(job_dir: Path, inputs: dict) -> dict:
    """One process (no mesh) steps the ``init.ckpt`` model once and writes
    ``single_state.orbax`` (a model axis of 1) and ``single_state.ckpt``;
    returns what it saved, whole (``_record_tp``), with its generator."""
    model = _tp_model(tp_params(SGD_MOMENTUM), None, job_dir / "init.ckpt")
    model.train_step(_batch(inputs, "tp0"))
    model.save_train_state(job_dir / "single_state.orbax", extra={"epoch": 3})
    model.save_train_state(job_dir / "single_state.ckpt", extra={"epoch": 3})
    out: dict = {"generator": model.state.generator.get_state().numpy().copy()}
    _record_tp(out, "saved", model)
    return out


def main(job_dir: str, rank: str, world: str, port: str, num_model: str = "1", num_slices: str = "") -> None:
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world), rank=int(rank))
    try:
        job = Path(job_dir)
        inputs = dict(np.load(job / "inputs.npz"))
        if num_model == "1":
            mesh = mesh_lib.create_mesh()
            out = run_scenarios(mesh, inputs)
        else:
            mesh = (mesh_lib.create_hybrid_mesh(int(num_slices), num_model=int(num_model)) if num_slices
                    else mesh_lib.create_mesh(num_model=int(num_model)))
            out = run_tp_scenarios(mesh, inputs, job, "_".join(f"{k}{v}" for k, v in mesh.shape.items()))
            out["mesh/index"] = np.asarray([mesh.data_index, mesh.model_index])
        out["mesh/shape"] = np.asarray([mesh.shape["data"], mesh.index, mesh.processes])
        np.savez(job / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
