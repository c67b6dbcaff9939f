"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no card.

    Entry points default to ``"cuda"``. Running on the CPU is something the
    caller asks for with ``device="cpu"``, never a silent fallback.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def fetch_to_host(tensor: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Start the copy of a card tensor into pinned host memory without
    waiting, with an event recorded behind it; a blocking copy would also
    wait for every launch queued after it. A CPU tensor comes back as it is,
    with no event."""
    if tensor.device.type != "cuda":
        return tensor, None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return host, copied
