"""Uniform random policy for bootstrap data collection (a copy of
``blackbox_mpc_tpu/policies/random_policy.py``; numpy only, so it runs on the host).
"""
from __future__ import annotations

import numpy as np

from blackbox_mpc_torch.core.spaces import BoxSpace, as_box_space
from blackbox_mpc_torch.policies.base import ModelFreePolicy

__all__ = ["RandomPolicy"]


class RandomPolicy(ModelFreePolicy):
    def __init__(self, action_space: BoxSpace, num_agents: int = 1, seed: int = 0):
        self._space = as_box_space(action_space)
        self._num_agents = num_agents
        self._rng = np.random.default_rng(seed)

    def act(self, observations, t: int = 0, exploration_noise: bool = False):
        del t, exploration_noise
        obs = np.asarray(observations)
        batched = obs.ndim > 1
        n = obs.shape[0] if batched else self._num_agents
        actions = self._rng.uniform(
            self._space.low, self._space.high, size=(n, self._space.dim)
        ).astype(np.float32)
        return actions if batched else actions[0]

    def reset(self) -> None:
        pass
