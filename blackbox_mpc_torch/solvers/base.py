"""Shared configuration and helpers for the derivative-free trajectory solvers.

Counterpart of ``blackbox_mpc_tpu/solvers/base.py``: bounds bookkeeping, midpoint/variance
initialization, warm-start time shifting and the exploration-noise rule.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, truncated_normal

__all__ = [
    "SolverConfig",
    "with_state_dtype",
    "init_solution_mean",
    "init_solution_variance",
    "constrain_variance",
    "shift_time",
    "exploration_noise",
]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration common to all solvers (defaults of the reference CEM signature)."""

    planning_horizon: int = 50
    population: int = 500
    num_agents: int = 1
    max_iterations: int = 5
    # Storage dtype of the solver state between solves; the update math stays float32.
    dtype: torch.dtype = torch.float32


def _cast_state(state, dtype):
    changes = {
        f.name: getattr(state, f.name).to(dtype)
        for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name))
        and torch.is_floating_point(getattr(state, f.name))
    }
    return dataclasses.replace(state, **changes)


def with_state_dtype(solver: Solver, dtype) -> Solver:
    """Stores the persistent solver state in ``dtype`` between solves.

    Identity for float32. Otherwise the floating tensors of the state dataclass are cast to
    ``dtype`` by init/reset and after each solve, and upcast to float32 before the update.
    """
    if dtype == torch.float32:
        return solver

    def init(generator):
        return _cast_state(solver.init(generator), dtype)

    def solve(state, obs, t, generator):
        action, next_state, aux = solver.solve(_cast_state(state, torch.float32), obs, t, generator)
        return action, _cast_state(next_state, dtype), aux

    def reset(state, generator):
        return _cast_state(solver.reset(_cast_state(state, torch.float32), generator), dtype)

    return Solver(init=init, solve=solve, reset=reset, name=solver.name,
                  plan_field=solver.plan_field)


def init_solution_mean(
    bounds: Bounds, horizon: int, num_agents: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Midpoint-of-action-space initial plan, [A, H, U]."""
    mid = torch.as_tensor(bounds.midpoint, dtype=dtype, device=device)
    return mid.expand(num_agents, horizon, bounds.dim).clone()


def init_solution_variance(
    bounds: Bounds, horizon: int, num_agents: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(range/4)^2 initial variance, [A, H, U]."""
    var = torch.as_tensor(bounds.default_variance, dtype=dtype, device=device)
    return var.expand(num_agents, horizon, bounds.dim).clone()


def constrain_variance(
    mean: torch.Tensor, variance: torch.Tensor, bounds: Bounds
) -> torch.Tensor:
    """Caps the sampling variance so +/-2 sigma stays inside the bounds:
    min(((m-lb)/2)^2, ((ub-m)/2)^2, var)."""
    lower, upper = bounds.on(mean.device)
    lower_dist = mean - lower
    upper_dist = upper - mean
    return torch.minimum(
        torch.minimum(torch.square(lower_dist / 2.0), torch.square(upper_dist / 2.0)), variance
    )


def shift_time(plan: torch.Tensor) -> torch.Tensor:
    """Warm-start shift: drop step 0, repeat the final step. plan=[..., H, U]."""
    return torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)


def exploration_noise(
    generator: torch.Generator, action: torch.Tensor, bounds: Bounds, scale: float = 0.05
) -> torch.Tensor:
    """Adds truncated-normal exploration noise to an [A, U] action and clips to bounds.

    Keeps the reference quirk: the noise is centered at the action-space midpoint, not 0.
    """
    mid = torch.as_tensor(bounds.midpoint, dtype=action.dtype, device=action.device)
    std = torch.as_tensor(
        (bounds.default_variance * scale) ** 0.5, dtype=action.dtype, device=action.device
    )
    noise = truncated_normal(generator, mid, std, action.shape)
    return bounds.clip(action + noise)
