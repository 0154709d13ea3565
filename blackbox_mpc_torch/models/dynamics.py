"""Learned-dynamics wrappers: from MLP params and normalizer stats to a rollout-ready
``dynamics_fn(dp, state, action) -> next_state``.

Counterpart of ``blackbox_mpc_tpu/models/dynamics.py`` for the deterministic propagations:

* ``"mean"``: average the member predictions each step;
* ``"ts1"``: row ``i`` runs member ``ts_member_ids(B, E)[i]`` (a balanced, seeded shuffle)
  for the whole horizon; batches not divisible by E are edge-padded by fewer than E rows.

Unlike the JAX package, the parameters always carry the leading ``[E]`` axis, also for
``ensemble_size=1`` (the weight bridge adds it). The probabilistic stack (``ts_inf``, ``mm``,
Gaussian heads, learned logvar bounds, the uncertainty penalty) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from blackbox_mpc_torch.models import transforms
from blackbox_mpc_torch.models.mlp import MLPConfig, ensemble_apply, ensemble_init
from blackbox_mpc_torch.models.normalizer import NormalizerStats, identity_stats

__all__ = [
    "DynamicsParams", "LearnedDynamicsConfig", "make_learned_dynamics", "ts_member_ids",
]

_PROBABILISTIC_TODO = "is not ported yet (ROADMAP Queue 1 items 4 and 8, the probabilistic stack)"


def ts_member_ids(n: int, ensemble: int) -> np.ndarray:
    """Balanced member assignment for TS propagation: row ``i`` runs member ``ids[i]``.

    A seeded static shuffle of ``[0..E)`` tiled to ``n`` rows, the same numbers as
    ``blackbox_mpc_tpu.models.dynamics.ts_member_ids``: ``i % E`` would alias with the
    agent stride of the agent-minor batch layout.
    """
    if n % ensemble:
        raise ValueError(f"n ({n}) must be a multiple of ensemble ({ensemble})")
    ids = np.tile(np.arange(ensemble, dtype=np.int32), n // ensemble)
    np.random.default_rng(0x75B007).shuffle(ids)
    return ids


@dataclasses.dataclass(frozen=True)
class DynamicsParams:
    """Everything the dynamics function needs at call time."""

    params: Any  # list of {"w": [E, in, out], "b": [E, out]}
    stats: NormalizerStats

    def replace(self, **changes) -> "DynamicsParams":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "DynamicsParams":
        return DynamicsParams(
            params=[{k: v.to(device) for k, v in layer.items()} for layer in self.params],
            stats=self.stats.to(device),
        )


@dataclasses.dataclass(frozen=True)
class LearnedDynamicsConfig:
    dim_s: int
    dim_u: int
    hidden: tuple = (32, 32, 32)
    activation: str = "tanh"
    ensemble_size: int = 1
    propagation: str = "mean"  # "mean" | "ts1" ("ts_inf" | "mm" not ported yet)
    num_particles: int = 1
    normalized: bool = True
    predict_delta: bool = True
    probabilistic: bool = False
    learn_logvar_bounds: bool = False
    plan_uncertainty_penalty: float = 0.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.dim_s + self.dim_u,
            out_dim=self.dim_s * (2 if self.probabilistic else 1),
            hidden=tuple(self.hidden),
            activation=self.activation,
            compute_dtype=self.compute_dtype,
        )


def check_config(config: LearnedDynamicsConfig) -> None:
    """Raises for configurations the port does not (yet) run."""
    if config.propagation not in ("mean", "ts1", "ts_inf", "mm"):
        raise ValueError(f"unknown propagation {config.propagation!r}")
    if config.plan_uncertainty_penalty < 0:
        raise ValueError(
            f"plan_uncertainty_penalty must be >= 0, got {config.plan_uncertainty_penalty}"
        )
    if config.propagation in ("ts_inf", "mm"):
        raise NotImplementedError(f"propagation={config.propagation!r} {_PROBABILISTIC_TODO}")
    if config.probabilistic or config.learn_logvar_bounds:
        raise NotImplementedError(f"probabilistic=True {_PROBABILISTIC_TODO}")
    if config.plan_uncertainty_penalty > 0:
        raise NotImplementedError(f"plan_uncertainty_penalty {_PROBABILISTIC_TODO}")
    if config.num_particles != 1:
        raise NotImplementedError(f"num_particles > 1 {_PROBABILISTIC_TODO}")


def make_learned_dynamics(
    config: LearnedDynamicsConfig,
) -> Tuple[Callable[[torch.Generator], DynamicsParams], Callable]:
    """Returns ``(init, dynamics_fn)``.

    ``init(generator) -> DynamicsParams``: Glorot weights drawn from ``generator`` on its
    device, identity stats. ``dynamics_fn(dp, state [B,S], action [B,U]) -> next_state [B,S]``
    runs normalize -> MLP -> denormalize -> inverse transform.
    """
    check_config(config)
    mlp_cfg = config.mlp
    ensemble = config.ensemble_size
    inverse = (
        transforms.delta_inverse_transform
        if config.predict_delta
        else transforms.identity_inverse_transform
    )

    def init(generator: torch.Generator) -> DynamicsParams:
        params = ensemble_init(generator, mlp_cfg, ensemble)
        stats = identity_stats(config.dim_s, config.dim_u, device=generator.device)
        return DynamicsParams(params=params, stats=stats)

    def _net_input(dp: DynamicsParams, state, action):
        if config.normalized:
            return torch.cat(
                [dp.stats.normalize_states(state), dp.stats.normalize_actions(action)], dim=-1
            )
        return torch.cat([state, action], dim=-1)

    def _member_partitioned(params, x: torch.Tensor) -> torch.Tensor:
        """Row i of x through member ts_member_ids(B, E)[i] (see the JAX counterpart)."""
        batch = x.shape[0]
        pad = (-batch) % ensemble
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, -1)], dim=0)
        n = batch + pad
        perm = np.argsort(ts_member_ids(n, ensemble), kind="stable")
        inv = torch.as_tensor(np.argsort(perm), device=x.device)
        x_groups = x[torch.as_tensor(perm, device=x.device)].reshape(ensemble, n // ensemble, -1)
        raw_groups = ensemble_apply(params, x_groups, config=mlp_cfg)
        return raw_groups.reshape(n, -1)[inv][:batch]

    def dynamics_fn(dp: DynamicsParams, state: torch.Tensor, action: torch.Tensor):
        x = _net_input(dp, state, action)
        if ensemble <= 1:
            raw = ensemble_apply(dp.params, x, config=mlp_cfg)[0]
        elif config.propagation == "mean":
            raw = ensemble_apply(dp.params, x, config=mlp_cfg).mean(0)
        else:  # "ts1"
            raw = _member_partitioned(dp.params, x)
        target = dp.stats.denormalize_targets(raw) if config.normalized else raw
        return inverse(state, target)

    return init, dynamics_fn
