"""Process-group bring-up for the CLIs (counterpart of ``sensorium_tpu/parallel/multihost.py``).

``init_from_spec`` initializes ``torch.distributed`` from a CLI spec:

* ``auto``: the variables torchrun sets (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), the
  counterpart of TPU pod metadata; each process is one rank;
* ``COORD,N,ID``: ``N`` hosts, this one ``ID``, the first host's store at
  ``COORD`` (``host:port``). A host runs ``local_size`` ranks, one a card,
  and rank ``local_rank`` of them is global rank ``ID * local_size +
  local_rank`` of ``N * local_size``.

NCCL on the card, gloo when the caller asks for the CPU; nothing falls
back from one to the other.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class Rank(NamedTuple):
    rank: int
    world: int
    device: torch.device


def parse_spec(spec: str) -> tuple[str, int, int]:
    """``COORD,N,ID`` -> (coordinator, hosts, host id)."""
    coordinator, hosts, host_id = spec.rsplit(",", 2)
    hosts, host_id = int(hosts), int(host_id)
    if not 0 <= host_id < hosts:
        raise ValueError(f"--multihost {spec!r}: process id {host_id} is not in [0, {hosts})")
    return coordinator, hosts, host_id


def init_from_spec(spec: str, device_type: str = "cuda", local_rank: int = 0, local_size: int = 1) -> Rank:
    """Initialize the default process group from ``spec`` (see the module
    docstring) and return this process's ``Rank``. On the card it first
    makes ``cuda:<local rank>`` the current device."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}; use 'cuda' or 'cpu'")
    if spec == "auto":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        init = {"init_method": "env://"}
    else:
        coordinator, hosts, host_id = parse_spec(spec)
        init = {"init_method": f"tcp://{coordinator}", "world_size": hosts * local_size,
                "rank": host_id * local_size + local_rank}
    # create_hybrid_mesh reads the cards a host from here, as under torchrun.
    os.environ["LOCAL_WORLD_SIZE"] = str(local_size)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--multihost on the card, but CUDA is not available; pass --device cpu for gloo")
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", **init)
    rank = Rank(dist.get_rank(), dist.get_world_size(), device)
    print(f"Multihost: process {rank.rank}/{rank.world}, {rank.world} global devices "
          f"({dist.get_backend()}, {device})", flush=True)
    return rank


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op with one process)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
