"""The port's data-parallel steps on the CPU, for ``tests/test_torch_parallel.py``.

    python -m tests.torch_mesh_worker JOB_DIR RANK WORLD PORT

One rank of a gloo group of WORLD processes (store at 127.0.0.1:PORT). It
reads ``JOB_DIR/inputs.npz`` (the weights as the port's state dict under
``w/<name>``, the batches under ``<batch>/<array>``), runs ``run_scenarios``
over ``create_mesh()`` and writes ``JOB_DIR/rank<RANK>.npz``. The test runs
the same ``run_scenarios`` without a mesh in its own process: that is the
single-process reference. This module imports torch and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.engine.metrics import batch_corr_stats
from sensorium_tpu_torch.engine.model import MouseModel
from sensorium_tpu_torch.models.registry import get_nn_module
from sensorium_tpu_torch.parallel import mesh as mesh_lib

LR = 1e-3
DISTILL_RATIO = 0.36

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


def main(job_dir: str, rank: str, world: str, port: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=int(world), rank=int(rank))
    try:
        mesh = mesh_lib.create_mesh()
        inputs = dict(np.load(Path(job_dir) / "inputs.npz"))
        out = run_scenarios(mesh, inputs)
        out["mesh/shape"] = np.asarray([mesh.shape["data"], mesh.index, mesh.processes])
        np.savez(Path(job_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
