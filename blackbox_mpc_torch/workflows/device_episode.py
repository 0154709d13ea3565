"""Device-resident episode evaluation: a whole MPC episode with no host round trip.

Counterpart of ``blackbox_mpc_tpu/workflows/device_episode.py``. When the "environment" is
itself a model (an analytic true model or learned dynamics), nothing needs the host between
control steps: the loop chains solve -> model step -> reward on device tensors, and the host
only launches work. JAX runs the loop as one ``lax.scan``; here it is a Python loop whose every
step stays on the device, so the only wait for the card is the caller's readback of the
result. A solver, dynamics or reward that reads a device value on the host (``.item()``, a
numpy copy, a Python scalar written into a CUDA tensor) breaks that, and ``chip_smoke.py``
counts the waits.
"""
from __future__ import annotations

from typing import Callable

import torch

from blackbox_mpc_torch.core.types import Solver

__all__ = ["evaluate_solver_on_model"]


def evaluate_solver_on_model(
    solver: Solver,
    dynamics_fn: Callable,  # (state [A,S], action [A,U]) -> next_state (the episode "env")
    reward_fn: Callable,  # (state, action, next_state) -> reward [A]
    initial_obs: torch.Tensor,  # [A, S]
    episode_steps: int,
    generator: torch.Generator,
    solver_state=None,
):
    """Runs ``episode_steps`` of closed-loop MPC on ``initial_obs``'s device.

    Returns ``(episode_rewards [T, A], final_obs [A, S], final_solver_state)``, all on the
    device. Every solve draws from ``generator`` (on that device); ``solver_state=None``
    starts from ``solver.init(generator)``.
    """
    if solver_state is None:
        solver_state = solver.init(generator)
    obs = initial_obs
    rewards = []
    for _ in range(episode_steps):
        action, solver_state, _aux = solver.solve(solver_state, obs, 0, generator)
        next_obs = dynamics_fn(obs, action)
        rewards.append(reward_fn(obs, action, next_obs))
        obs = next_obs
    if rewards:
        episode_rewards = torch.stack(rewards)
    else:
        episode_rewards = initial_obs.new_zeros((0, initial_obs.shape[0]))
    return episode_rewards, obs, solver_state
