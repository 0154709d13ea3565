"""Random-shooting trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/random_search.py``: one uniform population, one
evaluation, per-agent argmax. Stateless. The time-major candidate layout is not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers import base

__all__ = ["RandomSearchConfig", "RandomSearchState", "make_random_search"]


@dataclasses.dataclass(frozen=True)
class RandomSearchConfig(base.SolverConfig):
    population: int = 1024
    max_iterations: int = 1  # single-shot by definition
    time_major: bool = False  # carried over from the JAX package; only False runs


@dataclasses.dataclass(frozen=True)
class RandomSearchState:
    """Random search carries no solver state."""


def unit_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """U[0, 1) draws on the generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)


def make_random_search(
    config: RandomSearchConfig, bounds: Bounds, evaluate: TrajectoryEvaluator
) -> Solver:
    if config.time_major:
        raise NotImplementedError(
            "RandomSearchConfig.time_major=True is not ported yet (ROADMAP Queue 1 item 4: "
            "the time-major candidate layout)"
        )
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population

    def init(generator: torch.Generator) -> RandomSearchState:
        del generator
        return RandomSearchState()

    def solve(state: RandomSearchState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        lower, upper = bounds.on(obs.device)
        u = unit_uniform(generator, (pop, agents, horizon, bounds.dim))
        samples = lower + u * (upper - lower)
        rewards = evaluate(obs, samples)  # [P, A]
        best_idx = torch.argmax(rewards, dim=0)  # [A]
        agent_ids = torch.arange(agents, device=obs.device)
        best_plan = samples[best_idx, agent_ids]  # [A, H, U]
        aux = SolverAux(expected_reward=rewards[best_idx, agent_ids], plan=best_plan)
        return best_plan[:, 0], state, aux

    def reset(state: RandomSearchState, generator: torch.Generator) -> RandomSearchState:
        del generator
        return state

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="RandomSearch"), config.dtype
    )
