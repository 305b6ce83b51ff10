"""Where the port's entry points run: the card unless the caller names
another device."""
from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  No CUDA device and none named is an error, never a
    quiet run on the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def host_like(t: torch.Tensor) -> torch.Tensor:
    """An empty host tensor shaped and typed like ``t``: pinned when
    ``t`` is on the card, so a copy from it runs at the link's rate and
    may be queued without blocking."""
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")
