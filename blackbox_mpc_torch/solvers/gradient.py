"""First-order (Adam) trajectory solver: gradient ascent through the differentiable rollout.

Counterpart of ``blackbox_mpc_tpu/solvers/gradient.py``. ``population`` is the number of
random restarts optimized together per agent; restart 0 is the (warm-started) incumbent plan
itself, the others are drawn around it as ``std * noise`` with ``std`` the bound-derived
default (range/4). Each restart takes ``max_iterations`` projected Adam steps
(:func:`~blackbox_mpc_torch.solvers.base.adam_polish`) on the return, and the final argmax runs
over all restarts. The state is the incumbent plan, time-shifted between solves.

Autograd runs through the evaluator, so this solver needs the eager backend: the CUDA rollout
kernel has no backward (the policy refuses it on ``"kernel"`` and ``"fused"``).
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers import base

__all__ = ["GradientConfig", "GradientState", "make_gradient", "restart_noise"]


@dataclasses.dataclass(frozen=True)
class GradientConfig(base.SolverConfig):
    population: int = 16  # random restarts per agent (not samples)
    max_iterations: int = 20  # Adam steps
    learning_rate: float = 0.1
    # Restart spread as a fraction of the bound-derived default std (range/4).
    restart_scale: float = 1.0
    warm_start: bool = True


@dataclasses.dataclass(frozen=True)
class GradientState(base.StateReplace):
    mean: torch.Tensor  # [A, H, U] incumbent plan


def restart_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The standard normals the restarts are drawn from, ``[P, A, H, U]``."""
    return torch.randn(shape, generator=generator, device=device)


def best_of(plans: torch.Tensor, rewards: torch.Tensor):
    """Per-agent argmax of ``rewards [P, A]`` over ``plans [P, A, H, U]``: ``(plan [A, H, U],
    reward [A])``."""
    best_idx = torch.argmax(rewards, dim=0)
    agent_ids = torch.arange(plans.shape[1], device=plans.device)
    return plans[best_idx, agent_ids], rewards.max(dim=0).values


def make_gradient(config: GradientConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    if pop < 1:
        raise ValueError(f"population (restarts) must be >= 1, got {pop}")

    def init(generator: torch.Generator) -> GradientState:
        return GradientState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=generator.device))

    def solve(state: GradientState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        std = torch.sqrt(base.init_solution_variance(bounds, horizon, agents,
                                                     device=state.mean.device))
        noise = restart_noise(generator, (pop, agents, horizon, bounds.dim), state.mean.device)
        restarts = state.mean + config.restart_scale * std * noise
        # The incumbent survives verbatim as restart 0.
        plans = bounds.clip(torch.cat([state.mean[None], restarts[1:]], dim=0))
        plans = base.adam_polish(lambda p: evaluate(obs, p), bounds, config.learning_rate,
                                 plans, config.max_iterations)
        best, best_reward = best_of(plans, evaluate(obs, plans))
        next_mean = base.shift_time(best) if config.warm_start else state.mean
        return best[:, 0], GradientState(mean=next_mean), SolverAux(
            expected_reward=best_reward, plan=best)

    def reset(state: GradientState, generator: torch.Generator) -> GradientState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="Gradient", plan_field="mean"),
        config.dtype)
