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

The only collectives are ``all_reduce`` and ``all_gather`` (gloo has no
CUDA ``reduce_scatter``). A shape that does not divide over ``model``
raises ``ValueError``: the JAX package pads uneven shards, but every
configuration in the repo divides (the readout rows are padded to 128 a
group, and the cortex widths 1024/2048/4096 over 2 groups give 512, 1024
and 2048 columns a group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from sensorium_tpu_torch.parallel.mesh import Mesh, tensor_parallel


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


def _slice(value: torch.Tensor, axis: int, mesh: Mesh, name: str) -> torch.Tensor:
    size, count = value.shape[axis], mesh.num_model
    if size % count:
        raise ValueError(f"{name} {tuple(value.shape)}: axis {axis} of {size} does not divide over the "
                         f"model axis ({count})")
    return value.narrow(axis, mesh.model_index * (size // count), size // count)


def shard_module(module: nn.Module, mesh: Mesh | None) -> nn.Module:
    """Replace each sharded parameter of ``module`` by this process's slice
    (a tensor of its own) and hand the mesh to every submodule with a
    ``model_mesh`` attribute; in place, returns the module. Without a model
    axis nothing changes."""
    if not tensor_parallel(mesh):
        return module
    for name, param in list(module.named_parameters()):
        axis = param_sharding_rules(name, param.shape)
        if axis is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        piece = _slice(param.detach(), axis, mesh, name).clone()
        setattr(owner, attr, nn.Parameter(piece, requires_grad=param.requires_grad))
    for sub in module.modules():
        if hasattr(sub, "model_mesh"):
            sub.model_mesh = mesh
    return module


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
    over the model group."""
    return gather_tensors(module.state_dict(), mesh)


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
