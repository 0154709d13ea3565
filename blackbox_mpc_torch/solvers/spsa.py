"""SPSA (simultaneous perturbation stochastic approximation) trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/spsa.py``. Per iteration ``k``: the gains
``a_k = a / (k + 1 + A)^alpha`` and ``c_k = c / (k + 1)^gamma`` (host scalars), a population of
Rademacher +/-1 perturbations, one evaluation of the ``2P`` batch ``[plus; minus]``, the
averaged gradient estimate and a clipped ascent step. Warm-starts by time-shifting the
solution. ``time_major``: the ``2P`` batch is sampled and evaluated ``[H, 2P, A, U]``.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers import base

__all__ = ["SPSAConfig", "SPSAState", "make_spsa", "rademacher"]


@dataclasses.dataclass(frozen=True)
class SPSAConfig(base.SolverConfig):
    """Defaults match the reference."""

    alpha: float = 0.602
    gamma: float = 0.101
    a_par: float = 0.01
    noise_parameter: float = 0.3
    time_major: bool = False  # the 2P batch [H, 2P, A, U]; pair with a time-major evaluator


@dataclasses.dataclass(frozen=True)
class SPSAState(base.StateReplace):
    solution: torch.Tensor  # [A, H, U]


def rademacher(generator: torch.Generator, shape) -> torch.Tensor:
    """Independent +/-1 draws (float32) on the generator's device."""
    bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
    return (2 * bits - 1).to(torch.float32)


def make_spsa(config: SPSAConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    big_a = config.max_iterations / 10.0
    tm = config.time_major
    shape = (horizon, pop, agents, bounds.dim) if tm else (pop, agents, horizon, bounds.dim)
    # The population axis of the batch, and a [P, A] tensor lifted to its rank.
    p_axis = 1 if tm else 0
    lift = (lambda r: r[None, :, :, None]) if tm else (lambda r: r[:, :, None, None])

    def init(generator: torch.Generator) -> SPSAState:
        return SPSAState(
            solution=base.init_solution_mean(bounds, horizon, agents, device=generator.device))

    def solve(state: SPSAState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        solution = state.solution
        best_reward = None
        for k in range(config.max_iterations):
            ak = config.a_par / (k + 1.0 + big_a) ** config.alpha
            ck = config.noise_parameter / (k + 1.0) ** config.gamma
            delta = rademacher(generator, shape).to(solution.dtype)
            center = solution.permute(1, 0, 2)[:, None] if tm else solution
            plus, plus_penalty = base.bound_violation_penalty(center + ck * delta, bounds, tm)
            minus, minus_penalty = base.bound_violation_penalty(center - ck * delta, bounds, tm)
            rewards = evaluate(obs, torch.cat([plus, minus], dim=p_axis))  # [2P, A]
            r_plus = rewards[:pop] - plus_penalty
            r_minus = rewards[pop:] - minus_penalty
            ghat = torch.mean(lift(r_plus - r_minus) / (2.0 * ck * delta), dim=p_axis)
            if tm:
                ghat = ghat.permute(1, 0, 2)
            solution = bounds.clip(solution + ak * ghat)
            best_reward = torch.maximum(r_plus, r_minus).max(dim=0).values
        if best_reward is None:
            best_reward = torch.full((agents,), -torch.inf, device=solution.device)
        next_state = SPSAState(solution=base.shift_time(solution))
        return solution[:, 0], next_state, SolverAux(expected_reward=best_reward, plan=solution)

    def reset(state: SPSAState, generator: torch.Generator) -> SPSAState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="SPSA", plan_field="solution"),
        config.dtype)
