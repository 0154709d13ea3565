"""Cross-Entropy Method trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/cem.py`` at the reference defaults: per iteration,
sample a truncated normal population under bound-constrained variance, evaluate, keep
per-agent top-k elites, and blend the elite moments into the running mean/variance with
momentum ``alpha``. The moments are top-k masked sums over the candidate tensor, as in the
JAX package. ``warm_start=False`` (the default) leaves the state unchanged between solves.

The time-major candidate layout and the iCEM options are not ported yet: setting any of them
raises ``NotImplementedError`` rather than being ignored.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import (
    Bounds,
    Solver,
    SolverAux,
    TrajectoryEvaluator,
    truncated_normal,
)
from blackbox_mpc_torch.solvers import base

__all__ = ["CEMConfig", "CEMState", "make_cem", "cem_iteration"]


@dataclasses.dataclass(frozen=True)
class CEMConfig(base.SolverConfig):
    """Defaults match the reference. The fields after ``warm_start`` exist so configs carry
    over from the JAX package; only their defaults run here."""

    num_elite: int = 50
    alpha: float = 0.25  # weight of the previous mean/var
    warm_start: bool = False
    colored_noise_beta: float = 0.0
    keep_elites: int = 0
    population_decay: float = 1.0
    mean_as_candidate: bool = False
    execute_best: bool = False
    time_major: bool = False


# Field -> value under which it runs; anything else is not ported yet.
_UNPORTED_DEFAULTS = {
    "colored_noise_beta": 0.0,
    "keep_elites": 0,
    "population_decay": 1.0,
    "mean_as_candidate": False,
    "execute_best": False,
    "time_major": False,
}


def check_config(config: CEMConfig) -> None:
    for name, default in _UNPORTED_DEFAULTS.items():
        if getattr(config, name) != default:
            raise NotImplementedError(
                f"CEMConfig.{name}={getattr(config, name)!r} is not ported yet (ROADMAP "
                f"Queue 1 item 4: the time-major layout and the iCEM options)"
            )


@dataclasses.dataclass(frozen=True)
class CEMState:
    mean: torch.Tensor  # [A, H, U]
    variance: torch.Tensor  # [A, H, U]


def cem_iteration(config: CEMConfig, bounds: Bounds, evaluate, obs, mean, var, generator):
    """One CEM update. Returns ``(mean, var, elite_vals [A, k])`` (values best-first)."""
    check_config(config)
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    k, alpha = config.num_elite, config.alpha
    constrained = base.constrain_variance(mean, var, bounds)
    samples = truncated_normal(
        generator, mean, torch.sqrt(constrained), (pop, agents, horizon, bounds.dim)
    )
    rewards = evaluate(obs, samples)  # [P, A]
    elite_vals, elite_idx = torch.topk(rewards.T, k, dim=1)  # [A, k]
    mask = torch.zeros((pop, agents), dtype=samples.dtype, device=samples.device)
    mask[elite_idx.T, torch.arange(agents, device=samples.device)[None, :]] = 1.0
    w = mask[:, :, None, None]
    new_mean = torch.sum(w * samples, dim=0) / k
    new_var = torch.sum(w * torch.square(samples - new_mean[None]), dim=0) / k
    mean = alpha * mean + (1.0 - alpha) * new_mean
    var = alpha * var + (1.0 - alpha) * new_var
    return mean, var, elite_vals


def make_cem(config: CEMConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    check_config(config)
    horizon, agents = config.planning_horizon, config.num_agents

    def init(generator: torch.Generator) -> CEMState:
        device = generator.device
        return CEMState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=device),
            variance=base.init_solution_variance(bounds, horizon, agents, device=device),
        )

    def solve(state: CEMState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        mean, var = state.mean, state.variance
        for _ in range(config.max_iterations):
            mean, var, elite_vals = cem_iteration(
                config, bounds, evaluate, obs, mean, var, generator
            )
        aux = SolverAux(expected_reward=torch.mean(elite_vals, dim=1), plan=mean)
        if config.warm_start:
            next_state = CEMState(mean=base.shift_time(mean), variance=state.variance)
        else:
            # Reference semantics: the persistent mean/variance are never updated.
            next_state = state
        return mean[:, 0], next_state, aux

    def reset(state: CEMState, generator: torch.Generator) -> CEMState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CEM", plan_field="mean"), config.dtype
    )
