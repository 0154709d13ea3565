"""Batched pure-numpy Pendulum environment (gymnasium Pendulum-v1 semantics).

A copy of ``blackbox_mpc_tpu/envs/native_pendulum.py``: N pendulums stepped as one batched
array op, no processes and no pipes, with the same seeded RNG, so the same seed and actions give
the same bits in both packages.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from blackbox_mpc_torch.core.spaces import BoxSpace

__all__ = ["NativePendulumVecEnv"]

_G, _M, _L, _DT = 10.0, 1.0, 1.0, 0.05
_MAX_SPEED, _MAX_TORQUE = 8.0, 2.0


def _angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class NativePendulumVecEnv:
    """N independent pendulums stepped in one vectorized numpy op."""

    def __init__(self, num_envs: int = 1, seed: int = 0, max_episode_steps: int = 200):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self._th = np.zeros(num_envs)
        self._thdot = np.zeros(num_envs)
        self._t = 0
        self._pending = None
        self.action_space = BoxSpace.of(-_MAX_TORQUE, _MAX_TORQUE, dim=1)
        self.observation_space = BoxSpace(
            low=np.array([-1.0, -1.0, -_MAX_SPEED]), high=np.array([1.0, 1.0, _MAX_SPEED])
        )

    def _obs(self) -> np.ndarray:
        return np.stack(
            [np.cos(self._th), np.sin(self._th), self._thdot], axis=-1
        ).astype(np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        # gymnasium Pendulum-v1 reset distribution: th ~ U(-pi, pi), thdot ~ U(-1, 1)
        self._th = self._rng.uniform(-np.pi, np.pi, self.num_envs)
        self._thdot = self._rng.uniform(-1.0, 1.0, self.num_envs)
        self._t = 0
        return self._obs()

    def reset_down(self) -> np.ndarray:
        """Deterministic hanging-down start (useful for swing-up benchmarks)."""
        self._th = np.full(self.num_envs, np.pi)
        self._thdot = np.zeros(self.num_envs)
        self._t = 0
        return self._obs()

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        u = np.clip(np.asarray(actions).reshape(self.num_envs, -1)[:, 0], -_MAX_TORQUE, _MAX_TORQUE)
        th, thdot = self._th, self._thdot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (-3 * _G / (2 * _L) * np.sin(th + np.pi) + 3.0 / (_M * _L**2) * u) * _DT
        # gymnasium clips the angular velocity BEFORE integrating theta
        newthdot = np.clip(newthdot, -_MAX_SPEED, _MAX_SPEED)
        self._th = th + newthdot * _DT
        self._thdot = newthdot
        self._t += 1
        done = np.full(self.num_envs, self._t >= self._max_steps)
        return self._obs(), (-cost).astype(np.float32), done, [{}] * self.num_envs

    def step_async(self, actions: np.ndarray) -> None:
        """Async-API parity with the process-backed vec envs (physics is instantaneous
        here, so the 'pending' step simply buffers the result)."""
        self._pending = self.step(actions)

    def step_wait(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        if self._pending is None:
            raise RuntimeError("step_wait called without step_async")
        result, self._pending = self._pending, None
        return result

    def render(self):
        """Returns a simple [H, W, 3] frame visualizing env 0 (for video recording)."""
        size = 200
        frame = np.full((size, size, 3), 255, np.uint8)
        cx = cy = size // 2
        x = int(cx + 70 * np.sin(self._th[0]))
        y = int(cy - 70 * np.cos(self._th[0]))
        # draw a thick line from center to bob
        steps = 100
        for i in range(steps):
            px = int(cx + (x - cx) * i / steps)
            py = int(cy + (y - cy) * i / steps)
            frame[max(py - 2, 0) : py + 3, max(px - 2, 0) : px + 3] = (180, 40, 40)
        return frame

    def close(self):
        pass
