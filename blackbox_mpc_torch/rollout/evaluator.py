"""Trajectory evaluation: the rollout hot loop as an eager PyTorch loop over the horizon.

Counterpart of ``blackbox_mpc_tpu/rollout/evaluator.py`` (its ``lax.scan`` becomes a Python
loop). This is the ``"eager"`` backend of :class:`~blackbox_mpc_torch.policies.MPCPolicy`;
the ``"kernel"`` backend is :mod:`blackbox_mpc_torch.ops.rollout_kernel`.

Stochastic dynamics (PETS ``ts_inf``/``mm``) take their randomness as a tensor: ``noise``
``[H, B, S]`` of standard normals, step ``t`` reading ``noise[t]``, where JAX splits one key
into H step keys and draws ``normal(key_t, [B, S])``.

``remat`` (JAX's ``jax.checkpoint`` of the scan body) runs each horizon step through
``torch.utils.checkpoint``: differentiating through the rollout (the Gradient and CEM-GD
solvers) then keeps each step's inputs only and computes the step again in the backward pass.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.core.types import DynamicsFn, RewardFn, TrajectoryEvaluator
from blackbox_mpc_torch.utils.profiling import span

__all__ = [
    "make_trajectory_evaluator", "rollout_trajectories", "action_smoothness_penalty",
    "NAN_REWARD",
]

# NaN rewards are clamped to this, matching the reference's guard.
NAN_REWARD = -1e6


def rollout_trajectories(
    dynamics_fn: DynamicsFn,
    reward_fn: RewardFn,
    initial_states: torch.Tensor,  # [B, S]
    action_sequences: torch.Tensor,  # [B, H, U] ([H, B, U] when time_major)
    *,
    discount: float = 1.0,
    return_states: bool = False,
    noise: torch.Tensor | None = None,
    dynamics_returns_penalty: bool = False,
    time_major: bool = False,
    remat: bool = False,
):
    """Rolls a batch of action sequences through the dynamics, accumulating reward.

    Returns total_reward [B] (and the visited states [H, B, S] if requested). The discount
    is carried by repeated multiplication, as the JAX scan carries it. ``noise`` ([H, B, S]):
    step ``t`` calls ``dynamics_fn(state, action, noise[t])``; None keeps the two-argument
    call. ``dynamics_returns_penalty``: the dynamics return ``(next_state, penalty [B])`` and
    each step adds ``discount^t * (r - penalty)``.

    ``remat``: each step runs under ``torch.utils.checkpoint`` (non-reentrant), which stores
    the step's inputs instead of its activations and recomputes them in the backward pass.
    The step's noise is one of those inputs, so a recomputation sees the same draws; the
    gradients are the same as without it.
    """
    actions = action_sequences if time_major else action_sequences.transpose(0, 1)
    state = initial_states
    total = torch.zeros(state.shape[0], dtype=state.dtype, device=state.device)
    disc = torch.ones((), dtype=state.dtype, device=state.device)
    states = []

    def step(state, actions_t, noise_t):
        with span("models.step"):
            out = (dynamics_fn(state, actions_t) if noise_t is None
                   else dynamics_fn(state, actions_t, noise_t))
            next_state, penalty = out if dynamics_returns_penalty else (out, None)
            r = reward_fn(state, actions_t, next_state)
            if penalty is not None:
                r = r - penalty
            return next_state, r

    for t, actions_t in enumerate(actions):
        noise_t = None if noise is None else noise[t]
        if remat and torch.is_grad_enabled():
            # The step draws nothing, so there is no RNG state to save and restore.
            next_state, r = checkpoint(step, state, actions_t, noise_t, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            next_state, r = step(state, actions_t, noise_t)
        total = total + disc * r
        disc = disc * discount
        state = next_state
        if return_states:
            states.append(next_state)
    if return_states:
        return total, torch.stack(states)
    return total


def action_smoothness_penalty(
    action_sequences: torch.Tensor, weight: float, discount: float = 1.0,
    time_major: bool = False,
) -> torch.Tensor:
    """``w * sum_t discount^t * ||a_t - a_{t-1}||^2`` over [P, A, H, U] plans -> [P, A]
    (``[H, P, A, U]`` plans when ``time_major``)."""
    h_axis = 0 if time_major else 2
    horizon = action_sequences.shape[h_axis]
    diffs = torch.sum(torch.square(torch.diff(action_sequences, dim=h_axis)), dim=-1)
    if discount != 1.0:
        disc = torch.tensor(
            discount, dtype=diffs.dtype, device=diffs.device
        ) ** torch.arange(1, horizon, device=diffs.device)
        diffs = diffs * (disc[:, None, None] if time_major else disc)
    return weight * torch.sum(diffs, dim=h_axis)


def make_trajectory_evaluator(
    dynamics_fn: DynamicsFn,
    reward_fn: RewardFn,
    *,
    discount: float = 1.0,
    nan_guard: bool = True,
    num_particles: int = 1,
    action_smoothness_weight: float = 0.0,
    dynamics_returns_penalty: bool = False,
    time_major: bool = False,
    remat: bool = False,
    device=None,
) -> TrajectoryEvaluator:
    """Builds ``evaluate(initial_states [A,S], action_sequences [P,A,H,U], noise=None) ->
    rewards [P,A]``.

    The initial state of agent ``a`` is tiled across the population agent-minor, each
    candidate is rolled out for H steps, the discounted rewards are summed, the smoothness
    cost is subtracted and NaN rewards become -1e6. ``time_major``: candidates are
    ``[H, P, A, U]``. Inputs must lie on ``device``.

    ``noise`` (stochastic dynamics): ``[H, P*K*A, S]`` standard normals with
    ``K = num_particles``. Each candidate is then rolled out K times, particle ``j`` of
    candidate ``i`` on rows ``(i*K + j)*A + a``, and the K returns are averaged (the PETS
    estimator); without noise K is 1. ``dynamics_returns_penalty`` and ``remat``: see
    :func:`rollout_trajectories`.
    """
    if num_particles < 1:
        raise ValueError(f"num_particles must be >= 1, got {num_particles}")
    if action_smoothness_weight < 0:
        raise ValueError(
            f"action_smoothness_weight must be >= 0, got {action_smoothness_weight}"
        )
    device = resolve_device(device)

    def evaluate(initial_states: torch.Tensor, action_sequences: torch.Tensor,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        if initial_states.device != device or action_sequences.device != device:
            raise ValueError(f"inputs must be on {device}")
        k = num_particles if noise is not None else 1
        if time_major:
            horizon, pop, agents, dim_u = action_sequences.shape
        else:
            pop, agents, horizon, dim_u = action_sequences.shape
        # [P, A, H, U] -> [P*K, A, H, U]: particle j of candidate i is row i*K + j.
        repeated = (action_sequences if k == 1
                    else action_sequences.repeat_interleave(k, dim=1 if time_major else 0))
        if time_major:
            flat_actions = repeated.reshape(horizon, pop * k * agents, dim_u)
        else:
            flat_actions = repeated.reshape(pop * k * agents, horizon, dim_u)
        if noise is not None and noise.shape[:2] != (horizon, pop * k * agents):
            raise ValueError(f"noise must be [H, P*K*A, S] = [{horizon}, {pop * k * agents}, "
                             f"S], got {list(noise.shape)}")
        # [A, S] -> [P*K*A, S], agent minor (as tf.tile(current_states, [pop, 1])).
        flat_states = initial_states.repeat(pop * k, 1)
        total = rollout_trajectories(
            dynamics_fn, reward_fn, flat_states, flat_actions, discount=discount, noise=noise,
            dynamics_returns_penalty=dynamics_returns_penalty, time_major=time_major,
            remat=remat,
        )
        rewards = total.reshape(pop, k, agents).mean(1) if k > 1 else total.reshape(pop, agents)
        if action_smoothness_weight > 0.0:
            # Every particle of a candidate carries its plan's penalty: take the plans once.
            rewards = rewards - action_smoothness_penalty(
                action_sequences, action_smoothness_weight, discount, time_major=time_major
            )
        if nan_guard:
            rewards = torch.where(torch.isnan(rewards), NAN_REWARD, rewards)
        return rewards

    return evaluate
