"""PI2 / path-integral (MPPI-style) trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/pi2.py``: sample a truncated-normal (or colored)
population around the running mean, clip to bounds with a squared-violation penalty, turn
rewards into costs and softmax-weight the samples with temperature ``lamda`` against the
per-agent best cost. The variance is static unless ``adapt_variance`` (PI2-CMA) is set;
``control_cost`` adds MPPI's information-theoretic control cost. Warm-starts by time-shifting
the solution. ``time_major=True`` samples and evaluates the candidates ``[H, P, A, U]``.
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

__all__ = ["MPPIConfig", "PI2Config", "PI2State", "make_pi2"]


@dataclasses.dataclass(frozen=True)
class PI2Config(base.SolverConfig):
    lamda: float = 1.0  # energy temperature
    colored_noise_beta: float = 0.0  # 0.0 = white truncated normal
    # PI2-CMA: adapt the per-coordinate sampling variance across iterations as the
    # softmax-weighted variance of the population, floored at a fraction of the initial one.
    adapt_variance: bool = False
    variance_floor_frac: float = 0.01
    # MPPI: add lambda * sum_t u_t^T Sigma^-1 eps_t to each sample's cost before the softmax.
    control_cost: bool = False
    time_major: bool = False  # candidates [H, P, A, U]; pair with a time-major evaluator


@dataclasses.dataclass(frozen=True)
class MPPIConfig(PI2Config):
    """The ``"MPPI"`` registry entry: PI2 with the information-theoretic control cost on."""

    control_cost: bool = True


@dataclasses.dataclass(frozen=True)
class PI2State(base.StateReplace):
    mean: torch.Tensor  # [A, H, U]


def softmax_weights(costs: torch.Tensor, lamda: float) -> torch.Tensor:
    """``exp(-(cost - min) / lamda)`` normalized over the population axis; costs ``[P, A]``."""
    prob = torch.exp(-(costs - costs.min(dim=0, keepdim=True).values) / lamda)
    return prob / prob.sum(dim=0, keepdim=True)


def make_pi2(config: PI2Config, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    lamda = config.lamda
    tm = config.time_major
    # The candidates' shape, an [A, H, U] tensor lifted to them, and the weighted sum over P.
    shape = (horizon, pop, agents, bounds.dim) if tm else (pop, agents, horizon, bounds.dim)
    lift = (lambda x: x.permute(1, 0, 2)[:, None]) if tm else (lambda x: x)
    weighted = "pa,hpau->hau" if tm else "pa,pahu->ahu"

    def init(generator: torch.Generator) -> PI2State:
        return PI2State(
            mean=base.init_solution_mean(bounds, horizon, agents, device=generator.device)
        )

    def solve(state: PI2State, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        mean = state.mean
        variance0 = base.init_solution_variance(bounds, horizon, agents, device=mean.device)
        variance = variance0
        for _ in range(config.max_iterations):
            stddev = torch.sqrt(variance)
            if config.colored_noise_beta > 0.0:
                colored = base.colored_noise_time_major if tm else base.colored_noise
                samples = lift(mean) + lift(stddev) * colored(
                    generator, config.colored_noise_beta, shape)
            else:
                samples = truncated_normal(generator, lift(mean), lift(stddev), shape)
            samples, penalty = base.bound_violation_penalty(samples, bounds, time_major=tm)
            rewards = evaluate(obs, samples) - penalty  # [P, A]
            costs = -rewards
            if config.control_cost:
                # MPPI exploration cost on the post-clip (actually applied) perturbation.
                precision = mean / variance
                costs = costs + lamda * (
                    torch.einsum("hau,hpau->pa", precision.permute(1, 0, 2), samples - lift(mean))
                    if tm else torch.einsum("ahu,pahu->pa", precision, samples - mean[None]))
            omega = softmax_weights(costs, lamda)  # [P, A]
            new_mean = torch.einsum(weighted, omega, samples)
            if config.adapt_variance:
                dev = samples - new_mean[:, None] if tm else samples - new_mean[None]
                new_var = torch.einsum(weighted, omega, torch.square(dev))
                if tm:
                    new_var = new_var.permute(1, 0, 2)
                variance = torch.maximum(new_var, config.variance_floor_frac * variance0)
            mean = new_mean.permute(1, 0, 2) if tm else new_mean
        aux = SolverAux(expected_reward=rewards.max(dim=0).values, plan=mean)
        return mean[:, 0], PI2State(mean=base.shift_time(mean)), aux

    def reset(state: PI2State, generator: torch.Generator) -> PI2State:
        del state
        return init(generator)

    name = "MPPI" if config.control_cost else "PI2"
    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name=name, plan_field="mean"), config.dtype
    )
