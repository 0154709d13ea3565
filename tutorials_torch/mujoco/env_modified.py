"""A customized MuJoCo HalfCheetah with a modified observation vector.

Twin of ``tutorials/mujoco/env_modified.py`` (the env holds no JAX, so the class is the same):
a user-defined env subclass whose observation is ``[qpos[1:], qvel, torso-COM]`` (joint
angles, velocities, and the torso centre of mass: 8 + 9 + 3 = 20 dims for cheetah) and whose
reward is forward progress minus control cost, built on gymnasium's HalfCheetahEnv.

Used by ``tutorial_three.py`` together with the planning cost in ``cost_func.py``: the pattern
for bringing your own robot model and task cost to the framework.
"""
from __future__ import annotations

import numpy as np

try:
    from gymnasium.envs.mujoco.half_cheetah_v5 import HalfCheetahEnv
except ImportError:  # pragma: no cover - older gymnasium layouts
    from gymnasium.envs.mujoco.half_cheetah import HalfCheetahEnv


class HalfCheetahEnvModified(HalfCheetahEnv):
    """HalfCheetah with the reference tutorial's custom observation layout."""

    # obs = [qpos[1:] (8), qvel (9), torso COM (3)] = 20 dims
    OBS_DIM = 20

    def __init__(self, **kwargs):
        super().__init__(exclude_current_positions_from_observation=False, **kwargs)
        # Re-declare the observation space for the custom _get_obs layout.
        from gymnasium.spaces import Box

        self.observation_space = Box(-np.inf, np.inf, (self.OBS_DIM,), np.float64)

    def _get_obs(self):
        return np.concatenate(
            [
                self.data.qpos.flat[1:],
                self.data.qvel.flat,
                self.get_body_com("torso").flat,
            ]
        )

    def step(self, action):
        x_before = self.data.qpos[0]
        self.do_simulation(action, self.frame_skip)
        x_after = self.data.qpos[0]
        obs = self._get_obs()
        reward_ctrl = -0.1 * float(np.square(action).sum())
        reward_run = (x_after - x_before) / self.dt
        reward = reward_ctrl + reward_run
        return obs, reward, False, False, {"reward_run": reward_run, "reward_ctrl": reward_ctrl}
