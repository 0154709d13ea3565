"""Policy base classes (a copy of ``blackbox_mpc_tpu/policies/base.py``): the split between
model-based and model-free policies that the rollout runner branches on.
"""
from __future__ import annotations

import abc

__all__ = ["Policy", "ModelBasedPolicy", "ModelFreePolicy"]


class Policy(abc.ABC):
    @abc.abstractmethod
    def act(self, observations, t: int, exploration_noise: bool = False):
        """Returns the action(s) for the current observation(s)."""

    def reset(self) -> None:
        """Per-episode reset; default no-op."""


class ModelBasedPolicy(Policy):
    """Policies backed by a dynamics model (can report predicted next state/reward)."""


class ModelFreePolicy(Policy):
    """Policies with no dynamics model (e.g. random exploration)."""
