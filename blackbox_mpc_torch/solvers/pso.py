"""Particle-swarm trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/pso.py``. The swarm (positions, velocities, personal
bests, global best) persists across solves in the state. Per iteration: clip the positions to
the bounds with a squared-violation penalty, evaluate, update the personal and global bests,
then ``v = w v + c1 r1 (pbest - x) + c2 r2 (gbest - x)``. After the loop the swarm is drawn
again around the time-shifted global best, under the bound-constrained default variance.

``elementwise_random=False`` keeps the reference's scalar standard-normal ``r1``/``r2`` per
iteration, as the JAX package does (its ``tests/test_solvers.py`` explains why); ``True`` takes
per-element uniforms. ``time_major``: the swarm tensors are ``[H, P, A, U]``.
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

__all__ = ["PSOConfig", "PSOState", "make_pso", "velocity_coefficients"]


@dataclasses.dataclass(frozen=True)
class PSOConfig(base.SolverConfig):
    """Defaults match the reference."""

    c1: float = 0.3
    c2: float = 0.5
    w: float = 0.2
    initial_velocity_fraction: float = 0.01
    elementwise_random: bool = False
    time_major: bool = False  # swarm tensors [H, P, A, U]; pair with a time-major evaluator


@dataclasses.dataclass(frozen=True)
class PSOState(base.StateReplace):
    positions: torch.Tensor  # [P, A, H, U] ([H, P, A, U] when config.time_major)
    velocities: torch.Tensor  # as positions
    best_positions: torch.Tensor  # as positions
    best_rewards: torch.Tensor  # [P, A]
    global_best_position: torch.Tensor  # [A, H, U]
    global_best_reward: torch.Tensor  # [A]


def velocity_coefficients(generator: torch.Generator, shape, elementwise: bool):
    """``(r1, r2)`` of one iteration: per-element U[0, 1) draws of ``shape``, or one standard
    normal each (0-d tensors on the generator's device)."""
    size = shape if elementwise else ()
    draw = torch.rand if elementwise else torch.randn
    return tuple(draw(size, generator=generator, device=generator.device) for _ in range(2))


def make_pso(config: PSOConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    tm = config.time_major
    shape = (horizon, pop, agents, bounds.dim) if tm else (pop, agents, horizon, bounds.dim)
    # Lift a [P, A] mask or an [A, H, U] plan to the swarm tensor's rank.
    lift_mask = (lambda m: m[None, :, :, None]) if tm else (lambda m: m[:, :, None, None])
    lift_plan = (lambda p: p.permute(1, 0, 2)[:, None]) if tm else (lambda p: p[None])

    def uniform(generator, low, high):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return low + u * (high - low)

    def initial_velocities(generator):
        init_vel = config.initial_velocity_fraction * bounds.constant("range", generator.device)
        return uniform(generator, -init_vel, init_vel)

    def init(generator: torch.Generator) -> PSOState:
        """A uniform swarm in the bounds (the reference's ``reset()``)."""
        device = generator.device
        lower, upper = bounds.on(device)
        positions = uniform(generator, lower, upper)
        return PSOState(
            positions=positions,
            velocities=initial_velocities(generator),
            best_positions=positions,
            best_rewards=torch.full((pop, agents), -torch.inf, device=device),
            global_best_position=torch.zeros((agents, horizon, bounds.dim), device=device),
            global_best_reward=torch.full((agents,), -torch.inf, device=device),
        )

    def solve(state: PSOState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        agent_ids = torch.arange(agents, device=obs.device)
        for _ in range(config.max_iterations):
            positions, penalty = base.bound_violation_penalty(state.positions, bounds,
                                                              time_major=tm)
            rewards = evaluate(obs, positions) - penalty  # [P, A]
            improved = state.best_rewards < rewards
            best_positions = torch.where(lift_mask(improved), positions, state.best_positions)
            best_rewards = torch.where(improved, rewards, state.best_rewards)
            gbest_idx = torch.argmax(best_rewards, dim=0)  # [A]
            if tm:
                gbest_pos = best_positions[:, gbest_idx, agent_ids].permute(1, 0, 2)
            else:
                gbest_pos = best_positions[gbest_idx, agent_ids]
            gbest_rew = best_rewards[gbest_idx, agent_ids]
            r1, r2 = velocity_coefficients(generator, shape, config.elementwise_random)
            velocities = (
                state.velocities * config.w
                + (best_positions - positions) * config.c1 * r1
                + (lift_plan(gbest_pos) - positions) * config.c2 * r2
            )
            state = PSOState(
                positions=positions + velocities,
                velocities=velocities,
                best_positions=best_positions,
                best_rewards=best_rewards,
                global_best_position=gbest_pos,
                global_best_reward=gbest_rew,
            )
        gbest = state.global_best_position
        # Warm start: the swarm drawn again around the time-shifted global best.
        constrained = base.constrain_variance(
            gbest, base.init_solution_variance(bounds, horizon, agents, device=gbest.device),
            bounds)
        new_positions = truncated_normal(generator, lift_plan(base.shift_time(gbest)),
                                         lift_plan(torch.sqrt(constrained)), shape)
        next_state = PSOState(
            positions=new_positions,
            velocities=initial_velocities(generator),
            best_positions=new_positions,
            best_rewards=torch.full((pop, agents), -torch.inf, device=gbest.device),
            global_best_position=gbest,
            global_best_reward=torch.full((agents,), -torch.inf, device=gbest.device),
        )
        return gbest[:, 0], next_state, SolverAux(expected_reward=state.global_best_reward,
                                                  plan=gbest)

    def reset(state: PSOState, generator: torch.Generator) -> PSOState:
        del state
        return init(generator)

    # plan_field stays None: the swarm is only drawn around the global best at warm-start
    # time, so a seeded plan would not steer the search as a seeded sampling mean does.
    return base.with_state_dtype(Solver(init=init, solve=solve, reset=reset, name="PSO"),
                                 config.dtype)
