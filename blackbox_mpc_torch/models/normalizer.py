"""Normalization statistics for dynamics-model inputs and targets.

Counterpart of ``blackbox_mpc_tpu/models/normalizer.py``, as a frozen dataclass of tensors.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["NormalizerStats", "STATS_FIELDS", "fit_normalizer", "identity_stats"]

_EPS = 1e-7

STATS_FIELDS = (
    "mean_states", "std_states", "mean_actions", "std_actions", "mean_targets", "std_targets",
)


@dataclasses.dataclass(frozen=True)
class NormalizerStats:
    mean_states: torch.Tensor  # [S]
    std_states: torch.Tensor  # [S]
    mean_actions: torch.Tensor  # [U]
    std_actions: torch.Tensor  # [U]
    mean_targets: torch.Tensor  # [S]
    std_targets: torch.Tensor  # [S]

    def normalize_states(self, states: torch.Tensor) -> torch.Tensor:
        return (states - self.mean_states) / (self.std_states + _EPS)

    def normalize_actions(self, actions: torch.Tensor) -> torch.Tensor:
        return (actions - self.mean_actions) / (self.std_actions + _EPS)

    def normalize_targets(self, targets: torch.Tensor) -> torch.Tensor:
        return (targets - self.mean_targets) / (self.std_targets + _EPS)

    def denormalize_targets(self, targets: torch.Tensor) -> torch.Tensor:
        return targets * (self.std_targets + _EPS) + self.mean_targets

    def replace(self, **changes) -> "NormalizerStats":
        """A copy with the given fields changed (``dataclasses.replace``), as JAX's flax
        struct stats have."""
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "NormalizerStats":
        return NormalizerStats(*(getattr(self, f).to(device) for f in STATS_FIELDS))


def identity_stats(dim_s: int, dim_u: int, device=None) -> NormalizerStats:
    return NormalizerStats(
        mean_states=torch.zeros(dim_s, device=device),
        std_states=torch.ones(dim_s, device=device),
        mean_actions=torch.zeros(dim_u, device=device),
        std_actions=torch.ones(dim_u, device=device),
        mean_targets=torch.zeros(dim_s, device=device),
        std_targets=torch.ones(dim_s, device=device),
    )


def fit_normalizer(states: torch.Tensor, actions: torch.Tensor,
                   targets: torch.Tensor) -> NormalizerStats:
    """Mean and std of (state, action, target) training arrays, per column. The std is the
    population one (``correction=0``), as ``jnp.std`` computes it."""
    columns = []
    for x in (states, actions, targets):
        columns += [x.mean(dim=0), x.std(dim=0, correction=0)]
    return NormalizerStats(*columns)
