"""Learn dynamics from rollouts collected with an arbitrary policy.

Counterpart of ``blackbox_mpc_tpu/workflows/dynamics_learning.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from blackbox_mpc_torch.learning.handler import DynamicsHandler
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig
from blackbox_mpc_torch.workflows.rollouts import RolloutResult, perform_rollouts

__all__ = ["learn_dynamics_from_policy", "rollouts_to_episodes"]


def rollouts_to_episodes(result: RolloutResult):
    """Splits [T+1, E, S] / [T, E, U] stacks into per-(episode, env) sequences.

    Each env's sequence is truncated at its first ``done``: the loop only stops when ALL envs
    are done, so post-terminal transitions of early-finishing envs must not reach dynamics
    training (gymnasium's post-terminal steps are undefined).
    """
    observations, actions = [], []
    dones = result.get("dones")
    for idx, (ep_obs, ep_act) in enumerate(zip(result["observations"], result["actions"])):
        ep_done = dones[idx] if dones else None
        for e in range(ep_obs.shape[1]):
            t_end = ep_act.shape[0]
            if ep_done is not None and ep_done[:, e].any():
                t_end = int(np.argmax(ep_done[:, e])) + 1  # include the terminal transition
            observations.append(ep_obs[: t_end + 1, e])
            actions.append(ep_act[:t_end, e])
    return observations, actions


def learn_dynamics_from_policy(
    env,
    policy,
    handler: Optional[DynamicsHandler] = None,
    dynamics_config: Optional[LearnedDynamicsConfig] = None,
    number_of_rollouts: int = 1,
    rollout_horizon: int = 200,
    epochs: int = 30,
    batch_size: int = 128,
    patience: Optional[int] = None,
    exploration_noise: bool = False,
    metrics_writer=None,
    learning_rate: float = 1e-3,
    overlap: bool = False,
    **handler_kwargs,
):
    """Collects rollouts with ``policy`` and (re)trains the dynamics handler on them.

    Returns ``(handler, rollout_result, train_metrics)``. Creates the handler from
    ``dynamics_config`` (or the env's spaces) if not supplied; ``handler_kwargs`` go to its
    constructor (``device``, ``seed``, ...).
    """
    if handler is None:
        if dynamics_config is None:
            dynamics_config = LearnedDynamicsConfig(
                dim_s=env.observation_space.dim, dim_u=env.action_space.dim
            )
        handler = DynamicsHandler(
            config=dynamics_config, metrics_writer=metrics_writer,
            learning_rate=learning_rate, **handler_kwargs,
        )
    result = perform_rollouts(
        env,
        policy,
        number_of_rollouts=number_of_rollouts,
        rollout_horizon=rollout_horizon,
        exploration_noise=exploration_noise,
        metrics_writer=metrics_writer,
        overlap=overlap,
    )
    observations, actions = rollouts_to_episodes(result)
    metrics = handler.train(
        observations, actions, epochs=epochs, batch_size=batch_size, patience=patience
    )
    return handler, result, metrics
