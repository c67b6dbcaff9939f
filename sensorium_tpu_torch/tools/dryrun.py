"""One sharded training step over n ranks: ``dryrun_multichip``.

Counterpart of ``dryrun_multichip`` in the JAX repo's ``__graft_entry__.py``:
the real parallelism plan, data parallelism over the mesh's data axes (the
BN moments and gradients summed over them) and the cortex and readout
weights sliced over its ``model`` axis (``parallel/tensor.py``), in one
train step of n ranks, one card a rank through NCCL, as ``cli.train --mesh
data,model`` runs a fold. The mesh shape is JAX's rule (``mesh_shape``):
model 2 for an even n, model 4 where 4 divides n and there are no slices;
``SENSORIUM_DRYRUN_SLICES=k`` gives the hybrid ``(replica, data, model)``
mesh, ``SENSORIUM_DRYRUN_MODEL=m`` sets the model extent.

``flagship=True`` runs the ``true_batch_001`` model (bf16, block 1
rematerialized, the 10 mice's readout padded to 128 rows a group) at one
clip a data index, on a 16x16 canvas and 4 frames, or at the config's
geometry with ``SENSORIUM_DRYRUN_FULL=1``; ``flagship=False`` the JAX
toy. Either way rank 0 then takes the same step without a mesh, from the
same seed (or the same weights, ``init``: a model checkpoint, the port's or
the JAX package's), and the sharded loss must be within 1e-4 relative of
it. The last line printed is JAX's ``dryrun_multichip(n) ok: mesh=...``.

``device="cpu"`` runs gloo ranks on the CPU; ``share_card=True`` runs
every rank on card 0 through gloo (numbers, not speed). Otherwise fewer
cards than n raise::

    python -m sensorium_tpu_torch.tools.dryrun N [--toy] [--device cpu] [--share-card]
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import socket
import time
import traceback
from importlib.machinery import SourceFileLoader
from pathlib import Path

import numpy as np
import torch

LOSS_RTOL = 1e-4
RANK_TIMEOUT = 900  # seconds for the ranks to report

# __graft_entry__.py's _TOY_NN_KWARGS.
TOY_NN = {
    "readout_outputs": [16 + i for i in range(10)],
    "in_channels": 5,
    "core_features": (8, 8),
    "spatial_strides": (2, 2),
    "spatial_kernel": 3,
    "temporal_kernel": 3,
    "expansion_ratio": 2,
    "se_reduce_ratio": 4,
    "cortex_features": (16, 32),
    "groups": 2,
    "softplus_beta": 0.07,
    "drop_rate": 0.2,
    "drop_path_rate": 0.1,
    "dtype": "float32",
    "readout_pad_multiple": 8,
}


def mesh_shape(n_devices: int, env=os.environ) -> dict:
    """The dry run's mesh axes for ``n_devices``, by JAX's rule and
    environment variables (``SENSORIUM_DRYRUN_SLICES``,
    ``SENSORIUM_DRYRUN_MODEL``), with its errors."""
    num_slices = int(env.get("SENSORIUM_DRYRUN_SLICES", "0") or 0)
    num_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    if num_slices <= 1 and n_devices % 4 == 0:
        num_model = 4
    env_model = int(env.get("SENSORIUM_DRYRUN_MODEL", "0") or 0)
    if env_model:
        if n_devices % env_model != 0:
            raise ValueError(f"SENSORIUM_DRYRUN_MODEL={env_model} does not divide {n_devices}")
        num_model = env_model
    if num_slices > 1:
        if n_devices % (num_slices * num_model) != 0:
            raise ValueError(f"{n_devices} devices do not factor into slices={num_slices} x model={num_model}")
        return {"replica": num_slices, "data": n_devices // (num_slices * num_model), "model": num_model}
    return {"data": n_devices // num_model, "model": num_model}


def dryrun_params(flagship: bool, env=os.environ) -> tuple[dict, int, tuple[int, int]]:
    """``(argus_params, frames, (width, height))`` of the dry run's model."""
    if not flagship:
        params = {
            "nn_module": ("dwiseneuro", dict(TOY_NN)),
            "loss": ("mice_poisson", {}),
            "optimizer": ("AdamW", {"lr": 1e-3, "weight_decay": 0.05}),
            "frame_stack": {"size": 4, "step": 2, "position": "last"},
            "inputs_processor": ("stack_inputs", {"size": (16, 16), "pad_fill_value": 0.0}),
            "responses_processor": ("identity", {}),
            "iter_size": 1,
        }
        return params, 4, (16, 16)
    path = Path(__file__).resolve().parents[1] / "configs" / "true_batch_001.py"
    params = dict(SourceFileLoader("true_batch_001", str(path)).load_module().config["argus_params"])
    if env.get("SENSORIUM_DRYRUN_FULL", "0") not in ("", "0"):
        return params, int(params["frame_stack"]["size"]), tuple(params["inputs_processor"][1]["size"])
    image = (16, 16)
    params["inputs_processor"] = (params["inputs_processor"][0], {**params["inputs_processor"][1], "size": image})
    params["frame_stack"] = {**params["frame_stack"], "size": 4}
    return params, 4, image


def global_batch(params: dict, batch: int, frames: int, image: tuple[int, int]):
    """JAX's dry-run batch from ``default_rng(0)``: a ``MiceBatch``."""
    from sensorium_tpu_torch.data.datasets import MiceBatch

    outputs = list(params["nn_module"][1]["readout_outputs"])
    rng = np.random.default_rng(0)
    inputs = rng.uniform(0, 255, (batch, 5, frames, image[1], image[0])).astype(np.float32)
    targets = rng.gamma(1.5, 1.0, (batch, max(outputs), frames)).astype(np.float32)
    weights = np.zeros((batch, len(outputs)), np.float32)
    weights[np.arange(batch), np.arange(batch) % len(outputs)] = 1.0
    return MiceBatch(inputs, targets, weights)


def _built(model, init):
    """``model`` with its state built from seed 0, then ``init``'s weights if given."""
    model.set_ema(0.999)
    model.build_state(seed=0, learning_rate=1e-3)
    if init is not None:
        model.init_from_checkpoint(init)
    return model


def _step_seconds(model, batch, device: torch.device) -> tuple[float, float]:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    loss = float(model.train_step(batch))
    return loss, time.perf_counter() - start


def run_rank(rank: int, n_devices: int, port: int, device: str, share_card: bool, shape: dict, config: tuple,
             flagship: bool, init, results) -> None:
    """One rank: join the group, take the sharded step over a mesh of
    ``shape``; rank 0 then takes the unsharded one. ``config`` is
    ``dryrun_params``'. Puts ``(rank, result)`` or ``(rank, {"error": ...})``."""
    import torch.distributed as dist

    from sensorium_tpu_torch.engine.model import MouseModel
    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    try:
        if device == "cpu":
            card, backend = torch.device("cpu"), "gloo"
        elif share_card:
            card, backend = torch.device("cuda", 0), "gloo"
        else:
            card, backend = torch.device("cuda", rank), "nccl"
        if card.type == "cuda":
            torch.cuda.set_device(card)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n_devices, rank=rank)
        try:
            if "replica" in shape:
                mesh = mesh_lib.create_hybrid_mesh(shape["replica"], shape["data"], shape["model"], devices=[card])
            else:
                mesh = mesh_lib.create_mesh(shape["data"], shape["model"], devices=[card])
            params, frames, image = config
            extent = mesh_lib.data_extent(mesh)
            batch = global_batch(params, extent if flagship else max(2 * extent, 4), frames, image)
            model = _built(MouseModel(params, mesh=mesh), init)
            for name in dw_kernels.LAUNCHES:
                dw_kernels.LAUNCHES[name] = 0
            loss, step_s = _step_seconds(model, batch, card)
            result = {"loss": loss, "step_seconds": step_s, "launches": dict(dw_kernels.LAUNCHES),
                      "batch": len(batch.inputs), "frames": frames, "image": list(image),
                      "peak_bytes": torch.cuda.max_memory_allocated(card) if card.type == "cuda" else None}
        finally:
            dist.destroy_process_group()
        if rank == 0:
            del model
            reference = _built(MouseModel(params, device=card), init)
            result["unsharded_loss"], result["unsharded_step_seconds"] = _step_seconds(reference, batch, card)
            result["parameters"] = sum(p.numel() for p in reference.state.model.parameters())
        results.put((rank, result))
    except Exception:  # reported to the launcher, which stops the other ranks
        results.put((rank, {"error": traceback.format_exc()}))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _collect(procs: list, results, timeout: float) -> dict:
    """Every rank's result; kills the ranks and raises if one fails, exits
    without reporting, or ``timeout`` runs out."""
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < len(procs):
            try:
                rank, result = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, proc in enumerate(procs) if proc.exitcode not in (None, 0) and r not in got]
                if lost or time.monotonic() > deadline:
                    raise RuntimeError(f"dryrun ranks {lost or 'all'} did not report (exit codes "
                                       f"{[proc.exitcode for proc in procs]})")
                continue
            if "error" in result:
                raise RuntimeError(f"dryrun rank {rank} failed:\n{result['error']}")
            got[rank] = result
    finally:
        for proc in procs:
            if len(got) < len(procs):
                proc.kill()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    return got


def dryrun_multichip(n_devices: int, flagship: bool = True, device: str = "cuda", share_card: bool = False,
                     init=None) -> dict:
    """One sharded train step of ``n_devices`` ranks (module docstring),
    from seed 0's weights or those of the model checkpoint ``init``; prints
    JAX's ``ok`` line and returns rank 0's record (the mesh, both losses,
    the step's seconds, its kernel launches a rank)."""
    import torch.multiprocessing as mp

    shape = mesh_shape(n_devices)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        visible = torch.cuda.device_count()
        if visible < (1 if share_card else n_devices):
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, one a rank; {visible} "
                               "visible (share_card=True runs every rank on card 0)")
    context = mp.get_context("spawn")
    results = context.Queue()
    port, config = _free_port(), dryrun_params(flagship)
    procs = [context.Process(target=run_rank, args=(rank, n_devices, port, device, share_card, shape, config, flagship,
                                                    init, results))
             for rank in range(n_devices)]
    for proc in procs:
        proc.start()
    ranks = _collect(procs, results, RANK_TIMEOUT)
    first = ranks[0]
    loss, reference = first["loss"], first["unsharded_loss"]
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if abs(loss - reference) > LOSS_RTOL * max(abs(reference), 1.0):
        raise RuntimeError(f"sharded loss {loss} != unsharded {reference}")
    image = first["image"]
    print(f"[dryrun] sharded loss {loss!r}, unsharded {reference!r} (relative {abs(loss - reference) / abs(reference):.3g}, "
          f"tolerance {LOSS_RTOL}); launches a rank {first['launches']}", flush=True)
    print(f"dryrun_multichip({n_devices}) ok: mesh={shape} {'flagship' if flagship else 'toy'} "
          f"params={first['parameters'] / 1e6:.1f}M batch={first['batch']} canvas={image[0]}x{image[1]} "
          f"frames={first['frames']} loss={loss:.4f} step_s={first['step_seconds']:.1f}", flush=True)
    return {"mesh": shape, **first, "launches_by_rank": [ranks[r]["launches"] for r in range(n_devices)]}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--toy", action="store_true", help="JAX's toy model instead of the flagship")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="'cuda' (one card a rank, NCCL) or 'cpu' (gloo ranks)")
    parser.add_argument("--share-card", action="store_true", help="every rank on card 0 through gloo")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, flagship=not args.toy, device=args.device, share_card=args.share_card)


if __name__ == "__main__":
    main()
