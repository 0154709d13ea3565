"""Device resolution shared by the port's entry points.

Every entry point takes ``device=None``, which means ``"cuda"``. The port never falls back to
the CPU on its own: without CUDA the caller must ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["per_device", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA is requested but not available.

    A CUDA device comes back with its index (``cuda`` -> ``cuda:<current>``), so it
    compares equal to the ``device`` of the tensors made on it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def per_device(make: Callable):
    """``get(device)``: ``make(device)``, made once per device. A constant built from host
    data is copied to the card once, not at every solve: each such copy from pageable memory
    makes the host wait for the stream."""
    made = {}

    def get(device):
        if device not in made:
            made[device] = make(device)
        return made[device]

    return get
