"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``param_sharding_rules``, ``shard_params`` and
``shard_state`` in ``sensorium_tpu/parallel/mesh.py``. JAX places the
weights with a ``PartitionSpec`` and GSPMD inserts the collectives; here a
process holds its slice of each sharded weight and the model calls the two
collectives of the Megatron pattern itself:

* ``param_sharding_rules(name, shape)``: the axis a weight shards over, the
  JAX rules by name and rank: ``readout_kernel`` (M, G, C/G, P) on P,
  ``readout_bias`` (M, G, P) on P, every 3-d ``cortex_*`` kernel (G,
  Cin/G, Cout/G) on Cout/G; everything else (the core, every BN, the
  softplus beta) is replicated. The rules apply to a weight, its EMA copy
  and its optimizer moments alike (an optimizer's 0-d step count stays
  whole);
* ``shard_module(module, mesh)``: each sharded ``nn.Parameter`` replaced by
  this process's contiguous 1/``model`` slice (model index k holds slice
  k), before the optimizer is built; submodules that declare a
  ``model_mesh`` attribute get the mesh, which their forward reads;
* ``gather_state_dict`` / ``scatter_state_dict``: full tensors from a
  sharded module, and this process's slices of full tensors, for
  checkpoints;
* ``copy_to_model``: the identity forward whose backward sums the input
  gradient over the model group (the replicated input of a sharded
  product); ``gather_from_model(x, dim)``: the slices of the model group
  concatenated in rank order along ``dim``, whose backward keeps this
  process's slice of the gradient.

Over a mesh of one process's devices (``model_groups``: one group of m
cards a data index) the same rules hold in a local form, for evaluation:

* ``shard_module(module, group)`` replaces each sharded weight by a
  ``LocalSlices`` of its m slices, slice k a parameter on the group's card
  k; the rest of the module stays whole on the group's first card;
* ``local_product(fn, x, *slices)``: ``fn`` of ``x`` (copied to each
  slice's card) and each slice, run on every card before the results are
  copied back and concatenated in model order on ``x``'s card. It is plain
  tensor code in one thread, so ``torch.export`` traces it;
* ``local_replicas(module, mesh)``: one such replica a data index;
* ``gather_state_dict`` concatenates the slices: the names and shapes are
  the JAX tree's.

The only collectives are ``all_reduce`` and ``all_gather`` (gloo has no
CUDA ``reduce_scatter``). A shape that does not divide over ``model``
raises ``ValueError``: the JAX package pads uneven shards, but every
configuration in the repo divides (the readout rows are padded to 128 a
group, and the cortex widths 1024/2048/4096 over 2 groups give 512, 1024
and 2048 columns a group).
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn

from sensorium_tpu_torch.parallel.mesh import Mesh, model_groups, tensor_parallel


def param_sharding_rules(name: str, shape) -> int | None:
    """The axis of ``name`` (a state-dict name) that shards over ``model``,
    or None for a replicated tensor."""
    ndim = len(shape)
    if "readout_kernel" in name:
        axis = 3
    elif "readout_bias" in name:
        axis = 2
    elif "cortex" in name and name.endswith("kernel") and ndim == 3:
        axis = 2
    else:
        return None
    return axis if ndim == axis + 1 else None


def _slice(value: torch.Tensor, axis: int, mesh: Mesh, name: str, index: int | None = None) -> torch.Tensor:
    """Slice ``index`` (by default this process's model index) of ``value`` along ``axis``."""
    size, count = value.shape[axis], mesh.num_model
    if size % count:
        raise ValueError(f"{name} {tuple(value.shape)}: axis {axis} of {size} does not divide over the "
                         f"model axis ({count})")
    index = mesh.model_index if index is None else index
    return value.narrow(axis, index * (size // count), size // count)


class LocalSlices(nn.ParameterList):
    """The slices of one sharded weight over a model group of one process's
    cards: entry k, slice k along ``axis`` of the whole weight, on the
    group's card k."""

    def __init__(self, whole: torch.Tensor, axis: int, group: Mesh, name: str, requires_grad: bool):
        super().__init__(
            nn.Parameter(_slice(whole, axis, group, name, k).to(device, copy=True), requires_grad=requires_grad)
            for k, device in enumerate(group.devices))
        self.axis = axis


def shard_module(module: nn.Module, mesh: Mesh | None) -> nn.Module:
    """Replace each sharded parameter of ``module`` by this process's slice
    (a tensor of its own), or over a model group of this process's cards
    (``model_groups``; the module on its first card) by a ``LocalSlices``,
    and hand the mesh to every submodule with a ``model_mesh`` attribute; in
    place, returns the module. Without a model axis nothing changes."""
    if not tensor_parallel(mesh):
        return module
    for name, param in list(module.named_parameters()):
        axis = param_sharding_rules(name, param.shape)
        if axis is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if mesh.distributed:
            piece = _slice(param.detach(), axis, mesh, name).clone()
            setattr(owner, attr, nn.Parameter(piece, requires_grad=param.requires_grad))
        else:
            delattr(owner, attr)
            owner.add_module(attr, LocalSlices(param.detach(), axis, mesh, name, param.requires_grad))
    for sub in module.modules():
        if hasattr(sub, "model_mesh"):
            sub.model_mesh = mesh
    return module


def local_replicas(module: nn.Module, mesh: Mesh) -> list[tuple[nn.Module, torch.device]]:
    """``(replica, its first card)`` for each model group of a mesh over
    this process's devices (``model_groups``): a copy of ``module`` (whole,
    on the mesh's first device) sharded over the group's cards; the first is
    ``module`` itself."""
    groups = model_groups(mesh)
    copies = [module] + [copy.deepcopy(module).to(group.device) for group in groups[1:]]
    return [(shard_module(replica, group), group.device) for replica, group in zip(copies, groups)]


def local_product(fn, x: torch.Tensor, *slices: LocalSlices) -> torch.Tensor:
    """``fn(x, slice_k, ...)`` on the card of the slices k (``x`` copied
    there) for every k, then the results copied to ``x``'s card and
    concatenated along the last axis in model order. Every card's work is
    queued before the first copy back."""
    parts = [fn(x.to(group[0].device), *group) for group in zip(*slices)]
    return torch.cat([part.to(x.device) for part in parts], -1)


def full_shape(name: str, shape, mesh: Mesh | None) -> tuple:
    """The whole tensor's shape of ``name``, whose slice has ``shape``."""
    axis = param_sharding_rules(name, shape) if tensor_parallel(mesh) else None
    shape = tuple(shape)
    if axis is None:
        return shape
    return shape[:axis] + (shape[axis] * mesh.num_model,) + shape[axis + 1:]


def gather(value: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The model group's slices of ``value`` concatenated along ``axis`` (no gradient)."""
    value = value.detach().contiguous()
    parts = [torch.empty_like(value) for _ in range(mesh.num_model)]
    dist.all_gather(parts, value, group=mesh.model_group)
    return torch.cat(parts, dim=axis)


def gather_tensors(tensors: dict, mesh: Mesh | None) -> dict:
    """``{name: tensor}`` with every sharded tensor gathered whole (a
    collective over the model group, in the dict's order); replicated ones
    pass as they are."""
    if not tensor_parallel(mesh):
        return dict(tensors)
    out = {}
    for name, value in tensors.items():
        axis = param_sharding_rules(name, value.shape)
        out[name] = value if axis is None else gather(value, axis, mesh)
    return out


def gather_state_dict(module: nn.Module, mesh: Mesh | None) -> dict:
    """``module.state_dict()`` with the sharded tensors whole: a collective
    over the model group, or the ``LocalSlices`` of a module sharded over
    this process's cards concatenated on the first slice's card."""
    local = {name: sub for name, sub in module.named_modules() if isinstance(sub, LocalSlices)}
    if not local:
        return gather_tensors(module.state_dict(), mesh)
    out = {}
    for key, value in module.state_dict().items():
        owner, _, index = key.rpartition(".")
        if owner not in local:
            out[key] = value
        elif index == "0":
            out[owner] = torch.cat([piece.detach().to(value.device) for piece in local[owner]], local[owner].axis)
    return out


def scatter_state_dict(state: dict, mesh: Mesh | None) -> dict:
    """This process's slices of a state of whole tensors (``{name: tensor}``);
    replicated tensors pass as they are."""
    if not tensor_parallel(mesh):
        return dict(state)
    out = {}
    for name, value in state.items():
        axis = param_sharding_rules(name, value.shape)
        out[name] = value if axis is None else _slice(value, axis, mesh, name)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim, mesh, x.shape[dim]
        return gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad):
        piece = grad.narrow(ctx.dim, ctx.mesh.model_index * ctx.size, ctx.size)
        return piece.contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (replicated over the model group) as the input of a sharded
    product: the backward sums each slice's input gradient over the group."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's slices of ``x`` concatenated along ``dim`` in rank
    order; the backward returns this process's slice of the gradient."""
    return _GatherFromModel.apply(x, dim % x.ndim, mesh)
