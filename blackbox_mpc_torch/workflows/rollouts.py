"""Rollout collection: run a policy against a vectorized environment.

Counterpart of ``blackbox_mpc_tpu/workflows/rollouts.py``, with its metric tags: the per-step
actual reward and, for a model-based policy, the model's reward and observation errors; per
episode the actual and the predicted return; per call the solve rate and the ``act()`` latency
percentiles (p50 and p95). ``overlap=True`` (the speculative pipeline of
``policies/pipeline.py``) is not ported yet and raises.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np

from blackbox_mpc_torch.policies.base import ModelBasedPolicy
from blackbox_mpc_torch.utils.metrics import LatencyTimer, MetricsWriter

logger = logging.getLogger(__name__)

__all__ = ["perform_rollouts", "RolloutResult"]


class RolloutResult(dict):
    """Dict with attribute access: observations, actions, rewards, dones, reward_sum, latency."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            # AttributeError (not KeyError) so hasattr/copy/pickle protocols behave.
            raise AttributeError(name) from None


def perform_rollouts(
    env,
    policy,
    number_of_rollouts: int = 1,
    rollout_horizon: int = 200,
    exploration_noise: bool = False,
    metrics_writer: Optional[MetricsWriter] = None,
    start_step: int = 0,
    overlap: bool = False,
    spec_tol: Optional[float] = 0.05,
) -> RolloutResult:
    """Collects ``number_of_rollouts`` episodes of length ``rollout_horizon``.

    Returns observations [N, T+1, E, S], actions [N, T, E, U], rewards [N, T, E] and dones
    [N, T, E] with E = env.num_envs, plus per-episode reward sums and act-latency stats. An
    episode ends early once every env is done. ``overlap`` and ``spec_tol`` belong to the
    speculative pipeline, which is not ported yet: ``overlap=True`` raises.
    """
    del spec_tol
    model_based = isinstance(policy, ModelBasedPolicy)
    if overlap:
        if not model_based:
            raise ValueError("overlap=True requires a model-based policy (it speculates "
                             "on the policy's predicted next observation)")
        raise NotImplementedError(
            "overlap=True needs policies/pipeline.py, which is not ported yet (ROADMAP "
            "Queue 1 item 8)")
    all_obs: List[np.ndarray] = []
    all_actions: List[np.ndarray] = []
    all_rewards: List[np.ndarray] = []
    all_dones: List[np.ndarray] = []
    timer = LatencyTimer()
    step_counter = start_step

    wall_start = time.perf_counter()
    for episode in range(number_of_rollouts):
        policy.reset()
        obs = env.reset()
        ep_obs, ep_actions, ep_rewards, ep_dones = [obs], [], [], []
        predicted_rewards = []
        for t in range(rollout_horizon):
            timer.start()
            if model_based:
                action, pred_next, pred_reward = policy.act(
                    obs, t, exploration_noise=exploration_noise
                )
                predicted_rewards.append(np.asarray(pred_reward))
            else:
                action = policy.act(obs, t, exploration_noise=exploration_noise)
            timer.stop()
            obs, reward, done, _infos = env.step(action)
            ep_obs.append(obs)
            ep_actions.append(np.asarray(action))
            ep_rewards.append(reward)
            ep_dones.append(np.asarray(done))
            if metrics_writer is not None:
                step_counter += 1
                metrics_writer.scalar(
                    "rewards/actual_reward", float(np.mean(reward)), step_counter
                )
                if model_based:
                    metrics_writer.scalar(
                        "rewards/predicted_reward_abs_error",
                        float(np.mean(np.abs(predicted_rewards[-1] - reward))),
                        step_counter,
                    )
                    # Per-step model error |f(s,a) - s'|: how good the dynamics model is.
                    metrics_writer.scalar(
                        "states/predicted_observations_abs_error",
                        float(np.mean(np.abs(np.asarray(pred_next) - obs))),
                        step_counter,
                    )
            if np.all(done):
                break
        all_obs.append(np.stack(ep_obs))
        all_actions.append(np.stack(ep_actions))
        all_rewards.append(np.stack(ep_rewards))
        all_dones.append(np.stack(ep_dones))
        ep_sum = float(np.stack(ep_rewards).sum(axis=0).mean())
        if metrics_writer is not None:
            metrics_writer.scalar("rewards/actual_episode_reward", ep_sum, episode)
            if model_based and predicted_rewards:
                # The model's own estimate of the episode return, beside the actual one.
                metrics_writer.scalar(
                    "rewards/predicted_episode_reward",
                    float(np.sum([np.mean(p) for p in predicted_rewards])),
                    episode,
                )
        logger.info("rollout %d/%d: mean episode reward %.2f", episode + 1,
                    number_of_rollouts, ep_sum)

    latency = timer.summary()
    if latency:
        logger.info(
            "act() latency: mean %.4fs p50 %.4fs p95 %.4fs over %d solves",
            latency["mean_s"], latency["p50_s"], latency["p95_s"], latency["count"],
        )
        if metrics_writer is not None:
            wall_s = max(time.perf_counter() - wall_start, 1e-9)
            metrics_writer.scalar("perf/solves_per_s", latency["count"] / wall_s, start_step)
            metrics_writer.scalar(
                "perf/rollouts_per_s", number_of_rollouts / wall_s, start_step
            )
            metrics_writer.scalar("perf/act_latency_p50_s", latency["p50_s"], start_step)
            metrics_writer.scalar("perf/act_latency_p95_s", latency["p95_s"], start_step)
    return RolloutResult(
        observations=all_obs,
        actions=all_actions,
        rewards=all_rewards,
        dones=all_dones,
        reward_sum=[float(r.sum(axis=0).mean()) for r in all_rewards],
        latency=latency,
        spec_hit_rate=None,
    )
