"""Target transforms for dynamics learning (counterpart of ``blackbox_mpc_tpu/models/
transforms.py``): the network predicts the state delta by default and the inverse transform
recovers the next state."""
from __future__ import annotations

import torch

__all__ = [
    "delta_transform", "delta_inverse_transform", "identity_transform",
    "identity_inverse_transform",
]


def delta_transform(state: torch.Tensor, next_state: torch.Tensor) -> torch.Tensor:
    """target = next_state - state."""
    return next_state - state


def delta_inverse_transform(state: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """next_state = target + state."""
    return target + state


def identity_transform(state: torch.Tensor, next_state: torch.Tensor) -> torch.Tensor:
    del state
    return next_state


def identity_inverse_transform(state: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    del state
    return target
