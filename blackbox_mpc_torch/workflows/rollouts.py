"""Rollout collection: run a policy against a vectorized environment.

Counterpart of ``blackbox_mpc_tpu/workflows/rollouts.py``, with its metric tags: the per-step
actual reward and, for a model-based policy, the model's reward and observation errors; per
episode the actual and the predicted return; per call the solve rate and the ``act()`` latency
percentiles (p50 and p95). ``overlap=True`` runs the speculative pipeline of
``policies/pipeline.py``: while the env steps (``step_async``/``step_wait``), the next solve runs
from the model's predicted observation.
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
    episode ends early once every env is done.

    ``overlap=True`` (model-based policies only): depth-1 speculative pipelining. While the
    env executes ``step_async``, the next solve runs from the model's predicted observation;
    a real observation within ``spec_tol`` (max-abs) of the prediction adopts the
    speculative action, else the step solves again exactly with the same per-step
    randomness. ``spec_tol=None`` keeps exact semantics (prefetch only).
    """
    model_based = isinstance(policy, ModelBasedPolicy)
    pipe = None
    if overlap:
        if not model_based:
            raise ValueError("overlap=True requires a model-based policy (it speculates "
                             "on the policy's predicted next observation)")
        from blackbox_mpc_torch.policies.pipeline import SpeculativePipeline

        pipe = SpeculativePipeline(policy, spec_tol=spec_tol,
                                   exploration_noise=exploration_noise)
    all_obs: List[np.ndarray] = []
    all_actions: List[np.ndarray] = []
    all_rewards: List[np.ndarray] = []
    all_dones: List[np.ndarray] = []
    timer = LatencyTimer()
    step_counter = start_step

    wall_start = time.perf_counter()
    for episode in range(number_of_rollouts):
        if pipe is not None:
            pipe.reset()
        else:
            policy.reset()
        obs = env.reset()
        ep_obs, ep_actions, ep_rewards, ep_dones = [obs], [], [], []
        predicted_rewards = []
        for t in range(rollout_horizon):
            timer.start()
            if pipe is not None:
                action, pred_next, pred_reward, _hit = pipe.act(obs, t)
                predicted_rewards.append(np.asarray(pred_reward))
            elif model_based:
                action, pred_next, pred_reward = policy.act(
                    obs, t, exploration_noise=exploration_noise
                )
                predicted_rewards.append(np.asarray(pred_reward))
            else:
                action = policy.act(obs, t, exploration_noise=exploration_noise)
            timer.stop()
            if pipe is not None:
                # The speculative solve and its readback overlap the env step.
                env.step_async(action)
                obs, reward, done, _infos = env.step_wait()
            else:
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
            if pipe is not None:
                metrics_writer.scalar("perf/spec_hit_rate", pipe.hit_rate, start_step)
    if pipe is not None:
        logger.info(
            "speculative pipeline: %d hits / %d misses (%.0f%% hit rate)",
            pipe.hits, pipe.misses, 100 * pipe.hit_rate,
        )
    return RolloutResult(
        observations=all_obs,
        actions=all_actions,
        rewards=all_rewards,
        dones=all_dones,
        reward_sum=[float(r.sum(axis=0).mean()) for r in all_rewards],
        latency=latency,
        spec_hit_rate=pipe.hit_rate if pipe is not None else None,
    )
