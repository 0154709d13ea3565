"""Transition replay store for dynamics learning (a numpy copy of
``blackbox_mpc_tpu/learning/replay.py``).

Rollouts are flattened into (state, action) -> next_state pairs with a random train/validation
split, an optional ``max_size`` ring bound, and per-ensemble-member bootstrap minibatches. The
RNG is the same ``default_rng(seed)`` stream, and ``state_dict`` packs its PCG64 state into 6
uint64s as the JAX package does, so a JAX replay's ``state_dict`` loads here unchanged and
continues the same stream.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["ReplayBuffer"]


class ReplayBuffer:
    """Host-side (numpy) transition store; batches are shipped to device per epoch."""

    def __init__(
        self,
        dim_s: int,
        dim_u: int,
        validation_fraction: float = 0.2,
        max_size: Optional[int] = None,
        seed: int = 0,
    ):
        self._dim_s = dim_s
        self._dim_u = dim_u
        self._val_frac = validation_fraction
        self._max_size = max_size
        self._rng = np.random.default_rng(seed)
        self._states = np.zeros((0, dim_s), np.float32)
        self._actions = np.zeros((0, dim_u), np.float32)
        self._next_states = np.zeros((0, dim_s), np.float32)
        self._is_val = np.zeros((0,), bool)

    def __len__(self) -> int:
        return self._states.shape[0]

    @property
    def num_train(self) -> int:
        return int((~self._is_val).sum())

    @property
    def num_val(self) -> int:
        return int(self._is_val.sum())

    def add_transitions(self, states, actions, next_states) -> None:
        """Appends flat [N, S], [N, U], [N, S] transition arrays with a random val split."""
        states = np.asarray(states, np.float32).reshape(-1, self._dim_s)
        actions = np.asarray(actions, np.float32).reshape(-1, self._dim_u)
        next_states = np.asarray(next_states, np.float32).reshape(-1, self._dim_s)
        n = states.shape[0]
        if not (actions.shape[0] == n and next_states.shape[0] == n):
            raise ValueError("mismatched transition array lengths")
        is_val = self._rng.random(n) < self._val_frac
        self._states = np.concatenate([self._states, states])
        self._actions = np.concatenate([self._actions, actions])
        self._next_states = np.concatenate([self._next_states, next_states])
        self._is_val = np.concatenate([self._is_val, is_val])
        if self._max_size is not None and len(self) > self._max_size:
            keep = len(self) - self._max_size
            self._states = self._states[keep:]
            self._actions = self._actions[keep:]
            self._next_states = self._next_states[keep:]
            self._is_val = self._is_val[keep:]

    def add_rollouts(self, observations, actions) -> None:
        """Appends episode rollouts.

        ``observations``: [N_episodes, T+1, S] (or list thereof); ``actions``: [N, T, U].
        Mirrors the reference's per-agent slicing (system_dynamics_handler.py:300-318).
        """
        for obs, acts in zip(observations, actions):
            obs = np.asarray(obs, np.float32)
            acts = np.asarray(acts, np.float32)
            if obs.shape[0] == acts.shape[0]:  # obs without trailing state: drop last action
                acts = acts[:-1]
            self.add_transitions(obs[:-1], acts, obs[1:])

    def _split(self, validation: bool):
        mask = self._is_val if validation else ~self._is_val
        return self._states[mask], self._actions[mask], self._next_states[mask]

    def arrays(self, validation: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._split(validation)

    def minibatches(
        self,
        batch_size: int,
        ensemble_size: int = 1,
        validation: bool = False,
        bootstrap: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yields epoch minibatches shaped [E, B, ...].

        With ``bootstrap=True`` each ensemble member sees an independent shuffled ordering
        (bootstrap-by-shuffling); otherwise members share one ordering.
        """
        s, a, ns = self._split(validation)
        n = s.shape[0]
        if n == 0:
            return
        batch_size = min(batch_size, n)
        if validation:
            # Deterministic, full-coverage evaluation: natural order, tail included, and
            # NO RNG consumption — a mid-training validation pass (early stopping) must
            # not perturb the subsequent training minibatch stream.
            orders = np.tile(np.arange(n), (ensemble_size, 1))
        elif bootstrap and ensemble_size > 1:
            orders = np.stack([self._rng.permutation(n) for _ in range(ensemble_size)])
        else:
            orders = np.tile(self._rng.permutation(n), (ensemble_size, 1))
        stops = list(range(batch_size, n + 1, batch_size))
        if validation and (not stops or stops[-1] != n):
            stops.append(n)  # remainder batch (one extra compiled shape, cached)
        start = 0
        for stop in stops:
            idx = orders[:, start:stop]  # [E, B]
            start = stop
            yield s[idx], a[idx], ns[idx]

    _U64 = (1 << 64) - 1

    def _rng_state_array(self) -> np.ndarray:
        """PCG64 generator state packed into 6 uint64s (an array a checkpoint stores)."""
        st = self._rng.bit_generator.state
        s, inc = st["state"]["state"], st["state"]["inc"]
        return np.array(
            [s & self._U64, s >> 64, inc & self._U64, inc >> 64,
             st["has_uint32"], st["uinteger"]],
            np.uint64,
        )

    def _set_rng_state_array(self, arr: np.ndarray) -> None:
        a = [int(x) for x in np.asarray(arr, np.uint64)]
        self._rng.bit_generator.state = {
            "bit_generator": "PCG64",
            "state": {"state": a[0] | (a[1] << 64), "inc": a[2] | (a[3] << 64)},
            "has_uint32": a[4],
            "uinteger": a[5],
        }

    def state_dict(self) -> dict:
        return {
            "states": self._states,
            "actions": self._actions,
            "next_states": self._next_states,
            "is_val": self._is_val,
            # RNG state makes resumed runs bit-reproducible: the val-split assignment of
            # future transitions and bootstrap minibatch orderings continue the same stream.
            "rng": self._rng_state_array(),
        }

    def load_state_dict(self, state: dict) -> None:
        self._states = np.asarray(state["states"], np.float32)
        self._actions = np.asarray(state["actions"], np.float32)
        self._next_states = np.asarray(state["next_states"], np.float32)
        self._is_val = np.asarray(state["is_val"], bool)
        if "rng" in state and state["rng"] is not None:  # absent in pre-round-2 checkpoints
            self._set_rng_state_array(state["rng"])
