"""Batched pure-numpy continuous-force cart-pole environment (swing-up task).

A copy of ``blackbox_mpc_tpu/envs/native_cartpole.py``. It steps the constants and the Euler
integration of ``models/analytic.py::cartpole_dynamics``, so a true-model policy plans with the
exact dynamics. The action is a continuous force in [-1, 1] (scaled x10 N inside the
dynamics); episodes are fixed-length (no |x| or angle termination), so batched shapes stay
static for the solve.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from blackbox_mpc_torch.core.spaces import BoxSpace

__all__ = ["NativeCartpoleVecEnv"]

# Must match blackbox_mpc_torch/models/analytic.py _CP_* exactly (true-model parity is tested).
_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 0.1
_LENGTH = 0.5
_DT = 0.02
_FORCE_SCALE = 10.0
_MAX_FORCE = 1.0  # action bound; the dynamics scale by _FORCE_SCALE


class NativeCartpoleVecEnv:
    """N independent cart-poles stepped in one vectorized numpy op.

    State per env: ``[x, x_dot, theta, theta_dot]`` (theta = 0 is upright), which is also
    the observation — the analytic model plans on the raw state.
    """

    def __init__(self, num_envs: int = 1, seed: int = 0, max_episode_steps: int = 200):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self._max_steps = max_episode_steps
        self._state = np.zeros((num_envs, 4))
        self._t = 0
        self._pending = None
        self.action_space = BoxSpace.of(-_MAX_FORCE, _MAX_FORCE, dim=1)
        big = np.asarray([4.8, np.inf, np.pi, np.inf])
        self.observation_space = BoxSpace(low=-big, high=big)

    def _obs(self) -> np.ndarray:
        return self._state.astype(np.float32).copy()

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        """Near-upright start (gym CartPole's U(-0.05, 0.05) on every state dim)."""
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self._t = 0
        return self._obs()

    def reset_down(self) -> np.ndarray:
        """Deterministic hanging-pole start (theta = pi) for swing-up benchmarks."""
        self._state = np.zeros((self.num_envs, 4))
        self._state[:, 2] = np.pi
        self._t = 0
        return self._obs()

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, list]:
        u = np.clip(
            np.asarray(actions).reshape(self.num_envs, -1)[:, 0], -_MAX_FORCE, _MAX_FORCE
        )
        x, x_dot, th, th_dot = (self._state[:, i] for i in range(4))
        force = _FORCE_SCALE * u
        total_mass = _MASSCART + _MASSPOLE
        polemass_length = _MASSPOLE * _LENGTH
        costh, sinth = np.cos(th), np.sin(th)
        temp = (force + polemass_length * th_dot**2 * sinth) / total_mass
        thacc = (_GRAVITY * sinth - costh * temp) / (
            _LENGTH * (4.0 / 3.0 - _MASSPOLE * costh**2 / total_mass)
        )
        xacc = temp - polemass_length * thacc * costh / total_mass
        # Reward on the pre-step state, matching the evaluator's (s, a, s') contract with
        # cartpole_reward (which reads `state`, not `next_state`).
        reward = np.cos(th) - 0.01 * np.square(x) - 0.001 * np.square(u)
        self._state = np.stack(
            [x + _DT * x_dot, x_dot + _DT * xacc, th + _DT * th_dot, th_dot + _DT * thacc],
            axis=-1,
        )
        self._t += 1
        done = np.full(self.num_envs, self._t >= self._max_steps)
        return self._obs(), reward.astype(np.float32), done, [{}] * self.num_envs

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
        w, h = 300, 200
        frame = np.full((h, w, 3), 255, np.uint8)
        cx = int(w / 2 + 40 * self._state[0, 0])
        cx = int(np.clip(cx, 20, w - 20))
        cy = 140
        frame[cy : cy + 12, max(cx - 18, 0) : cx + 18] = (60, 60, 60)  # cart
        th = self._state[0, 2]
        tipx = int(cx + 60 * np.sin(th))
        tipy = int(cy - 60 * np.cos(th))
        steps = 80
        for i in range(steps):
            px = int(np.clip(cx + (tipx - cx) * i / steps, 2, w - 3))
            py = int(np.clip(cy + (tipy - cy) * i / steps, 2, h - 3))
            frame[py - 2 : py + 3, px - 2 : px + 3] = (180, 40, 40)
        return frame

    def close(self):
        pass
