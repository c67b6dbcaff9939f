"""The device mesh of the port: data parallelism and the ``model`` axis.

Counterpart of ``sensorium_tpu/parallel/mesh.py``. JAX shards one
program's global batch (and, over ``model``, the cortex and readout
weights) over a device mesh and lets GSPMD turn every global-batch sum
into a collective. Here each card is one process of a
``torch.distributed`` group, and the mesh says which rows of each global
batch a process holds and how its sums meet the others':

* ``Mesh``: the axis sizes (``data``, or ``replica`` = hosts and ``data`` =
  cards a host, then ``model``, as JAX names them), this process's devices,
  its index among the mesh's processes, and the process groups;
* ``create_mesh`` / ``create_hybrid_mesh`` raise the JAX package's
  factoring errors. Processes follow JAX's device order: global rank r has
  model index ``r % model`` and data index ``r // model``, so a model group
  is adjacent ranks and never leaves a host. With ``model`` above 1 two
  groups are made on every process: the *data group* (the ranks with this
  model index), over which every global-batch sum runs, and the *model
  group* (the ranks with this data index), over which only the tensor
  parallel collectives of ``parallel/tensor.py`` run. With ``model`` 1 the
  data group is the whole group;
* ``shard_rows`` / ``shard_batch``: a process's rows of a global batch (by
  its data index), its slice of each of the ``iter_size`` microbatches, so
  that microbatch i holds the same rows as without a mesh; the processes of
  a model group hold the same rows;
* ``replicate_tree`` (a broadcast from a group's first process),
  ``all_reduce`` and ``reduce_gradients`` (the gradients' sum in flat
  buckets), each over the group it names (``over``: "data", "model" or
  "all"). The port's only collectives are ``all_reduce``, ``all_gather``
  and ``broadcast``, which gloo also runs on CUDA tensors;
* ``active(mesh)``: while it is entered, training-mode BN takes its
  statistics over the data group (``ops/norm.py``), and dropout and
  drop-path masks are drawn for the global batch and cut to this process's
  rows (``ops/stochastic.py``).

A mesh over one process's own devices (``create_mesh(devices=[...])``, or
``create_mesh()`` with no process group: every visible card) has no process
group and runs no collective; ``Predictor`` serves over it. Its devices
follow the same order: device d has model index ``d % model`` and data
index ``d // model``, and ``model_groups`` cuts it into one ``{"model":
m}`` mesh a data index (replica x data), the cards over which one eval
replica's weight slices lie (``parallel/tensor.py``). Training takes one
card a process: ``MouseModel`` refuses a mesh of several devices.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 64 * 2**20  # gradients summed per all_reduce
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape``: axis name -> size. ``devices``: this process's devices in
    mesh order (one a process over a process group). ``index``: this
    process's place among the mesh's ``processes`` (its global rank).
    ``group``: the process group, None for a mesh of one process's devices.
    ``data_group`` / ``model_group``: the ranks with this process's model
    index / data index, made when ``model`` is above 1 (the data group is
    ``group`` otherwise). A mesh is a handle on shared communicators: a
    deep copy (a module's EMA copy holds it) is the mesh itself."""

    shape: dict
    devices: tuple
    index: int
    processes: int
    group: object = None
    data_group: object = None
    model_group: object = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def num_model(self) -> int:
        return self.shape.get("model", 1)

    @property
    def data_index(self) -> int:
        """This process's batch shard: the rows it holds."""
        return self.index // self.num_model

    @property
    def model_index(self) -> int:
        """This process's slice of the weights that shard over ``model``."""
        return self.index % self.num_model

    def __deepcopy__(self, memo) -> "Mesh":
        return self


def tensor_parallel(mesh: Mesh | None) -> bool:
    """Whether ``mesh`` shards weights over a ``model`` axis above 1."""
    return mesh is not None and mesh.num_model > 1


def _process_devices(devices) -> tuple:
    """This process's one device in a process group: the card NCCL uses, or the CPU under gloo."""
    if devices is None:
        if dist.get_backend() == "nccl":
            return (torch.device("cuda", torch.cuda.current_device()),)
        return (torch.device("cpu"),)
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != 1:
        raise ValueError(f"a mesh over a process group holds one device a process, got {devices}")
    return devices


def _indexed(device) -> torch.device:
    """``device`` with the card's index ("cuda" is the current card): the
    name a tensor on it reports, which export's device mapping keys on."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _local_devices(devices) -> tuple:
    if devices is not None:
        return tuple(_indexed(d) for d in devices)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA card is visible; pass devices=[...] for a mesh of CPU devices")
    return tuple(torch.device("cuda", i) for i in range(count))


def _devices_and_count(devices) -> tuple[tuple, int]:
    if dist.is_initialized():
        return _process_devices(devices), dist.get_world_size()
    devices = _local_devices(devices)
    return devices, len(devices)


def _model_groups(num_model: int) -> tuple:
    """``(data group, model group)`` of this process, made on every process
    in the same order: one data group a model index, then one model group a
    data index. Global rank r is (data r // num_model, model r % num_model)."""
    rank, extent = dist.get_rank(), dist.get_world_size() // num_model
    data_group = model_group = None
    for m in range(num_model):
        group = dist.new_group([d * num_model + m for d in range(extent)])
        if rank % num_model == m:
            data_group = group
    for d in range(extent):
        group = dist.new_group([d * num_model + m for m in range(num_model)])
        if rank // num_model == d:
            model_group = group
    return data_group, model_group


def _build(shape: dict, count: int, devices: tuple) -> Mesh:
    extent = math.prod(shape.values())
    if not dist.is_initialized():
        return Mesh(dict(shape), devices[:extent], 0, 1)
    if extent != count:
        raise ValueError(f"a mesh over a process group spans all its {count} processes, not {extent}")
    world = dist.group.WORLD
    data_group, model_group = _model_groups(shape["model"]) if shape["model"] != 1 else (world, None)
    return Mesh(dict(shape), devices, dist.get_rank(), extent, world, data_group, model_group)


def create_mesh(num_data: int | None = None, num_model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh.

    With ``torch.distributed`` initialized it spans the group's processes,
    one device each (``devices``: this process's); ``num_model`` above 1
    shards the cortex and readout weights over adjacent ranks
    (``parallel/tensor.py``). Otherwise it spans ``devices`` of this process
    (by default every visible card; a device may repeat), in JAX's device
    order (``model_groups``).

    As in JAX, an auto ``num_data`` that leaves devices out, or a mesh larger
    than the devices, raises ``ValueError``; an explicit smaller
    ``num_data`` is a deliberate subset of one process's devices.
    """
    devices, count = _devices_and_count(devices)
    auto_data = num_data is None
    if auto_data:
        num_data = count // num_model
    if num_data * num_model > count or (auto_data and num_data * num_model != count):
        raise ValueError(
            f"mesh {num_data}x{num_model} (data x model) does not fit the {count} available devices; "
            "pick factors of the slice"
        )
    return _build({"data": num_data, "model": num_model}, count, devices)


def create_hybrid_mesh(num_slices: int | None = None, num_data: int | None = None, num_model: int = 1,
                       devices=None) -> Mesh:
    """A ``(replica, data, model)`` mesh: ``replica`` over hosts, ``data``
    and ``model`` over a host's cards. Processes are numbered host by host
    (global rank = host x cards a host + local rank), so ``data`` and
    ``model`` never leave a host. With ``num_slices`` None the host count is
    the world size over ``LOCAL_WORLD_SIZE`` (the cards a host, which
    torchrun and the train CLI's launcher set). A mesh that does not cover
    every device raises."""
    devices, count = _devices_and_count(devices)
    if num_slices is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", count)) if dist.is_initialized() else count
        num_slices = max(1, count // per_host)
    if count % (num_slices * num_model):
        raise ValueError(
            f"{count} devices do not factor into slices={num_slices} x model={num_model} (per-slice device "
            f"count {count / num_slices:g} must be a multiple of num_model)"
        )
    if num_data is None:
        num_data = count // (num_slices * num_model)
    covered = num_slices * num_data * num_model
    if covered != count:
        raise ValueError(f"mesh {(num_slices, num_data, num_model)} covers {covered} devices but {count} are present")
    return _build({"replica": num_slices, "data": num_data, "model": num_model}, count, devices)


def model_groups(mesh: Mesh) -> list[Mesh]:
    """The model groups of a mesh over one process's devices, in data order
    (replica x data): group i a ``{"model": m}`` mesh of devices ``i * m``
    to ``i * m + m - 1``, the cards of data index i's weight slices."""
    if mesh.distributed:
        raise ValueError("model_groups cuts a mesh over one process's devices; a process group's mesh holds one "
                         "device a process")
    m = mesh.num_model
    return [Mesh({"model": m}, mesh.devices[i * m:(i + 1) * m], 0, 1) for i in range(data_extent(mesh))]


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes the batch shards over."""
    return tuple(axis for axis in ("replica", "data") if axis in mesh.shape)


def data_extent(mesh: Mesh) -> int:
    """The number of batch shards: the product of the data-like axes."""
    return math.prod(mesh.shape[axis] for axis in data_axes(mesh))


def shard_rows(batch: int, index: int, extent: int, chunks: int = 1, pad: bool = False) -> np.ndarray:
    """The rows of a global batch of ``batch`` rows that shard ``index`` of
    ``extent`` holds: its contiguous slice of each of ``chunks`` equal
    microbatches. With ``pad`` (evaluation), the batch is first rounded up to
    a multiple of ``extent``, and rows >= ``batch`` are padding."""
    if pad:
        batch = -(-batch // extent) * extent
    if batch % chunks:
        raise ValueError(f"batch_size {batch} is not divisible by iter_size {chunks}")
    chunk = batch // chunks
    if chunk % extent:
        raise ValueError(
            f"a microbatch of {chunk} rows (batch_size {batch} / iter_size {chunks}) does not divide over the "
            f"data extent {extent}; pick batch_size % (iter_size * {extent}) == 0"
        )
    per = chunk // extent
    return np.concatenate([np.arange(i * chunk + index * per, i * chunk + (index + 1) * per) for i in range(chunks)])


def shard_batch(mesh: Mesh | None, *arrays, chunks: int = 1, pad: bool = False) -> tuple:
    """This process's rows (``shard_rows``) of each global-batch numpy
    array; 0-d values pass as they are, and padding rows are zeros. Without
    a mesh the arrays come back unchanged."""
    if mesh is None:
        return arrays
    batch = next(len(a) for a in arrays if np.ndim(a) > 0)
    per_process = len(mesh.devices)
    rows = np.concatenate([shard_rows(batch, mesh.data_index * per_process + k, data_extent(mesh), chunks, pad)
                           for k in range(per_process)])
    source, padding = np.minimum(rows, batch - 1), rows >= batch

    def take(a):
        if np.ndim(a) == 0:
            return a
        out = np.asarray(a)[source]
        out[padding] = 0
        return out

    return tuple(take(a) for a in arrays)


def _group(mesh: Mesh, over: str):
    """The process group of ``over``: "data" (the ranks holding other rows,
    with this model index), "model" (the ranks holding other weight slices,
    with these rows; None without a model axis) or "all"."""
    if over == "data":
        return mesh.group if mesh.data_group is None else mesh.data_group
    if over == "model":
        return mesh.model_group
    if over == "all":
        return mesh.group
    raise ValueError(f"over={over!r}: expected 'data', 'model' or 'all'")


def _first_rank(mesh: Mesh, over: str) -> int:
    """The global rank of the first process of this process's ``over`` group."""
    if over == "data":
        return mesh.model_index
    if over == "model":
        return mesh.data_index * mesh.num_model
    return 0


def replicate_tree(mesh: Mesh | None, tree, over: str = "all"):
    """Broadcast ``tree`` (a module's parameters and buffers, or a tensor)
    from the first process of this process's ``over`` group, in place, and
    return it. Over "data" each weight slice of a model axis comes from the
    first process that holds it. Nothing to do without a process group."""
    if mesh is None or not mesh.distributed:
        return tree
    group = _group(mesh, over)
    if group is None:
        return tree
    tensors = [*tree.parameters(), *tree.buffers()] if isinstance(tree, torch.nn.Module) else [tree]
    for tensor in tensors:
        dist.broadcast(tensor.detach(), src=_first_rank(mesh, over), group=group)
    return tree


def all_reduce(mesh: Mesh | None, tensor: torch.Tensor, op: str = "sum", over: str = "data") -> torch.Tensor:
    """``op`` ("sum", "max" or "min") of ``tensor`` over this process's
    ``over`` group (the data group by default: a global-batch sum; under a
    model axis a sum over every process would count each row once a model
    rank), in place; returns it. Nothing to do without a process group."""
    if mesh is not None and mesh.distributed:
        group = _group(mesh, over)
        if group is not None:
            dist.all_reduce(tensor, op=_OPS[op], group=group)
    return tensor


def reduce_gradients(mesh: Mesh | None, parameters, bucket_bytes: int = BUCKET_BYTES, over: str = "data") -> None:
    """Sum every parameter's ``.grad`` over this process's ``over`` group
    (the data group: the processes that hold the same weight slice and other
    rows): consecutive gradients of one dtype are flattened into buckets of
    at most ``bucket_bytes``, one ``all_reduce`` each; a gradient larger than
    that is reduced where it lies."""
    if mesh is None or not mesh.distributed:
        return
    group = _group(mesh, over)
    grads = [p.grad for p in parameters if p.grad is not None]

    def flush(bucket):
        if len(bucket) == 1 and bucket[0].is_contiguous():
            dist.all_reduce(bucket[0], group=group)
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    bucket, size = [], 0
    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > bucket_bytes or g.dtype != bucket[0].dtype):
            flush(bucket)
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush(bucket)


_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def active(mesh: Mesh | None):
    """Make ``mesh`` the one training-mode BN and the dropout masks see (a
    module global, not a thread-local: the backward pass may run on
    autograd's device thread). None leaves them single-process."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = previous


def current() -> Mesh | None:
    """The mesh ``active`` entered, or None."""
    return _ACTIVE


def row_shard() -> tuple[int, int] | None:
    """``(shard index, data extent)`` of this process under the active mesh, or None."""
    mesh = _ACTIVE
    if mesh is None:
        return None
    return mesh.data_index * len(mesh.devices), data_extent(mesh)
