"""Depth-1 speculative MPC pipelining: hide solve and readback time behind env stepping.

Counterpart of ``blackbox_mpc_tpu/policies/pipeline.py``. The policy's one-step lookahead
predicts the next observation, so while the environment steps, the pipeline solves step
``t+1`` from that prediction and copies its action to the host. When the real observation
arrives within ``spec_tol`` (max-abs) of the prediction, the speculative action is adopted; on
a miss the solver runs again from the real observation with the same per-step randomness, so a
miss gives the bits of a run that never speculated.

Per-step determinism (JAX's ``fold_in(ep_key, t)``): ``reset()`` draws an episode seed from the
policy's host generator (no read of the device), and the solve and noise generators of step
``t`` are seeded from ``(episode seed, t)``. A speculative solve never writes into the committed
solver state: it starts from it and returns a new one.

The outputs of a solve (action, predicted observation, predicted reward) are copied with
``non_blocking=True`` into one of two pinned host buffers, each with a CUDA event, so the copy
of step ``t+1`` never overwrites what step ``t`` reads. The host enqueues every operation of the
speculative solve before ``act()`` returns: overlap hides the device's time and the readback,
not the host's enqueueing.

Used by ``workflows.perform_rollouts(overlap=True)`` through the env's ``step_async``/
``step_wait``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["SpeculativePipeline"]


class _HostSlots:
    """Two pinned (on the CPU: plain) host buffers, used in turn, each with an event that
    marks its copy done."""

    def __init__(self, size: int, device: torch.device):
        pinned = device.type == "cuda"
        self._buffers = [torch.empty(size, dtype=torch.float32, pin_memory=pinned)
                         for _ in range(2)]
        self._events = [torch.cuda.Event() if pinned else None for _ in range(2)]
        self._next = 0

    def copy(self, flat: torch.Tensor) -> int:
        """Starts the copy of ``flat`` into the next buffer; returns its slot."""
        slot, self._next = self._next, 1 - self._next
        self._buffers[slot].copy_(flat, non_blocking=True)
        if self._events[slot] is not None:
            self._events[slot].record()
        return slot

    def read(self, slot: int) -> np.ndarray:
        """Waits for the copy into ``slot`` (that copy only) and returns its values."""
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return self._buffers[slot].numpy().copy()


class SpeculativePipeline:
    """Wraps an :class:`~blackbox_mpc_torch.policies.mpc_policy.MPCPolicy` with depth-1
    speculative execution.

    Usage (what ``perform_rollouts(overlap=True)`` runs)::

        pipe = SpeculativePipeline(policy, spec_tol=0.05)
        pipe.reset()
        obs = env.reset()
        for t in range(T):
            action, pred_next, pred_reward, hit = pipe.act(obs, t)
            env.step_async(action)                   # the env steps while the t+1
            obs, reward, done, _ = env.step_wait()   # speculation runs on the device

    ``spec_tol``: the largest max-abs observation mismatch at which the speculative action is
    adopted. ``None`` adopts nothing (prefetch only: every step solves exactly).
    """

    def __init__(self, policy, spec_tol: Optional[float] = 0.05,
                 exploration_noise: bool = False):
        required = ("_step", "_solver_state", "_handler", "_host_rng")
        missing = [a for a in required if not hasattr(policy, a)]
        if missing:
            raise TypeError(
                f"SpeculativePipeline (perform_rollouts overlap=True) requires a live "
                f"MPCPolicy; {type(policy).__name__} lacks {missing}. Served artifacts "
                f"(ServingPolicy) do not support speculative overlap."
            )
        self._policy = policy
        self._spec_tol = spec_tol
        self._noise = bool(exploration_noise)
        self._ep_seed = None
        self._slots = None
        self._spec = None  # (t, slot, new_state, next_obs on the device)
        self._pred_obs = None  # host copy of the prediction the speculation started from
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ internals

    def step_generators(self, t: int):
        """The solve and noise generators of step ``t`` of the episode: a speculative solve
        of step ``t`` and an exact one draw the same numbers."""
        device = self._policy.device
        seeds = np.random.SeedSequence([self._ep_seed, t]).generate_state(2, np.uint64)
        generators = []
        for seed in seeds:
            generators.append(torch.Generator(device=device))
            generators[-1].manual_seed(int(seed))
        return generators

    @torch.no_grad()
    def _dispatch(self, obs_dev: torch.Tensor, t: int):
        """Enqueues step ``t``'s solve from the committed state and the copy of its outputs to
        a host slot; returns ``(slot, new_state, next_obs)`` without waiting."""
        p = self._policy
        action, new_state, _, next_obs, pred_reward = p._step(
            p._solver_state, obs_dev, t, *self.step_generators(t), self._noise)
        flat = torch.cat([action.reshape(-1), next_obs.reshape(-1), pred_reward.reshape(-1)])
        if self._slots is None:
            self._slots = _HostSlots(flat.numel(), p.device)
        return self._slots.copy(flat.float()), new_state, next_obs

    def _to_device(self, obs: np.ndarray) -> torch.Tensor:
        """The observation on the device: from pinned memory without a wait on CUDA."""
        device = self._policy.device
        host = torch.from_numpy(obs)
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.clone()

    # ------------------------------------------------------------------ public API

    def reset(self) -> None:
        self._policy.reset()
        self._ep_seed = int(self._policy._host_rng.integers(2**63))
        self._spec = None
        self._pred_obs = None

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def act(self, observations, t: int = 0):
        """Returns ``(action, pred_next, pred_reward, speculation_hit)`` as host arrays.

        Accepts batched ``[num_agents, S]`` (or unbatched ``[S]``) observations like
        ``MPCPolicy.act``; after it returns, step ``t+1``'s speculative solve is in flight.
        """
        if self._ep_seed is None:
            raise RuntimeError("call reset() before the first act() of an episode")
        p = self._policy
        obs = np.asarray(observations, dtype=np.float32)
        batched = obs.ndim > 1
        if not batched:
            obs = np.tile(obs[None], (p._num_agents, 1))
        if obs.shape[0] != p._num_agents:
            raise ValueError(
                f"observations batch {obs.shape[0]} != num_agents {p._num_agents}"
            )

        hit = False
        had_spec = self._spec is not None and self._spec[0] == t and self._spec_tol is not None
        if had_spec and float(np.max(np.abs(self._pred_obs - obs))) <= self._spec_tol:
            hit = True
            _, slot, new_state, next_dev = self._spec
        else:
            slot, new_state, next_dev = self._dispatch(self._to_device(obs), t)
        self._spec = None
        if had_spec:
            # The first act of an episode has no speculation to hit or miss.
            self.hits += hit
            self.misses += not hit

        # Commit, then speculate on step t+1 from the predicted observation on the device;
        # its copy to the host goes to the other slot.
        p._solver_state = new_state
        spec_slot, spec_state, spec_next = self._dispatch(next_dev, t + 1)
        self._spec = (t + 1, spec_slot, spec_state, spec_next)

        flat = self._slots.read(slot)
        n_a, n_o = p._num_agents * p._bounds.dim, obs.size
        action = flat[:n_a].reshape(p._num_agents, p._bounds.dim)
        next_obs = flat[n_a:n_a + n_o].reshape(obs.shape)
        pred_reward = flat[n_a + n_o:]
        self._pred_obs = next_obs
        p._act_counter += 1
        if p._writer is not None:
            p._writer.scalar(
                "rewards/predicted_reward", float(np.mean(pred_reward)), p._act_counter
            )
        if batched:
            return action, next_obs, pred_reward, hit
        return action[0], next_obs[0], pred_reward[0], hit
