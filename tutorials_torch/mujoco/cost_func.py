"""A custom planning cost for the modified HalfCheetah (see ``env_modified.py``).

Torch twin of ``tutorials/mujoco/cost_func.py``: reward = forward torso-COM progress, with
flat penalties whenever the front leg / shin / foot joints exceed an angle range (discourages
the cheetah from flipping onto its back, the classic cheetah-MPC hack).

Written as a torch function with the framework's ``(state, action, next_state)`` convention;
indices follow the ``env_modified`` observation layout: ``[qpos[1:] (8), qvel (9), torso COM
(3)]``; front thigh/shin/foot are obs 5/6/7 and the COM x-coordinate is obs 17.
"""
from __future__ import annotations

import torch

_DT = 0.05  # env_modified dt (gymnasium HalfCheetah frame_skip 5 x 0.01)
_HEADING_PENALTY = -10.0


def reward_function(state, action, next_state):
    rewards = torch.zeros(state.shape[0], dtype=state.dtype, device=state.device)
    rewards = torch.where(state[:, 5] >= 0.2, rewards + _HEADING_PENALTY, rewards)  # front thigh
    rewards = torch.where(state[:, 6] >= 0.0, rewards + _HEADING_PENALTY, rewards)  # front shin
    rewards = torch.where(state[:, 7] >= 0.0, rewards + _HEADING_PENALTY, rewards)  # front foot
    rewards = rewards + (next_state[:, 17] - state[:, 17]) / _DT  # forward COM progress
    return rewards
