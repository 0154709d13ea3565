"""Episode video recording (a copy of ``blackbox_mpc_torch/workflows/recording.py``): frames of
``env.render()`` written with imageio, which is imported only when a recording is made.
"""
from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["record_rollout"]


def record_rollout(
    env,
    policy,
    horizon: int,
    path: str,
    fps: int = 30,
    exploration_noise: bool = False,
) -> float:
    """Runs one episode, writing ``env.render()`` frames to an mp4/gif at ``path``.

    Returns the mean episode reward.
    """
    import imageio

    from blackbox_mpc_torch.policies.base import ModelBasedPolicy

    model_based = isinstance(policy, ModelBasedPolicy)
    policy.reset()
    obs = env.reset()
    frames = []
    total = 0.0
    for t in range(horizon):
        frame = env.render()
        if frame is not None:
            frames.append(np.asarray(frame))
        if model_based:
            action, _, _ = policy.act(obs, t, exploration_noise=exploration_noise)
        else:
            action = policy.act(obs, t, exploration_noise=exploration_noise)
        obs, reward, done, _ = env.step(action)
        total += float(np.mean(reward))
        if np.all(done):
            break
    if frames:
        try:
            imageio.mimsave(path, frames, fps=fps)
        except ValueError:
            # No mp4 backend (ffmpeg/pyav) in this environment — fall back to GIF.
            fallback = os.path.splitext(path)[0] + ".gif"
            imageio.mimsave(fallback, frames, duration=1000.0 / fps)
            logger.warning("no backend for %s; wrote GIF to %s instead", path, fallback)
            path = fallback
        logger.info("wrote %d frames to %s (episode reward %.2f)", len(frames), path, total)
    else:
        logger.warning("env.render() produced no frames; nothing written")
    return total
