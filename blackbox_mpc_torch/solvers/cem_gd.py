"""CEM-GD hybrid trajectory solver: CEM global search, then an Adam polish of the top plans.

Counterpart of ``blackbox_mpc_tpu/solvers/cem_gd.py``. Phase 1 runs the CEM iterations of
:func:`~blackbox_mpc_torch.solvers.cem.cem_iteration` (every iCEM option included) and keeps
the top ``gd_candidates`` elites of the last one. Phase 2 polishes ``{blended mean} U {top
elites}`` with ``gd_iterations`` projected Adam steps; the unpolished (clipped) mean then rejoins
the final argmax, so CEM-GD never returns a worse plan than its CEM phase found.

``time_major``: phase 1 samples time-major; phase 2's few plans are presented to the
time-major evaluator through one small transpose (gradients flow through it). Needs the eager
backend, as Gradient does.
"""
from __future__ import annotations

import dataclasses

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers import base, cem
from blackbox_mpc_torch.solvers.gradient import best_of

__all__ = ["CEMGDConfig", "CEMGDState", "make_cem_gd"]


@dataclasses.dataclass(frozen=True)
class CEMGDConfig(cem.CEMConfig):
    """The CEM phase takes ``CEMConfig`` (with the iCEM options); the GD phase's defaults
    follow ``GradientConfig``."""

    # Top elites of the last CEM iteration polished beside the blended mean; <= num_elite.
    gd_candidates: int = 8
    gd_iterations: int = 10
    gd_learning_rate: float = 0.02
    # CEM's restart-every-solve default: the JAX package measured warm_start=False ahead on
    # HalfCheetah (benchmarks/cheetah_cemgd_nows_run.jsonl against cheetah_cemgd_run.jsonl).
    warm_start: bool = False


@dataclasses.dataclass(frozen=True)
class CEMGDState(base.StateReplace):
    mean: torch.Tensor  # [A, H, U]
    variance: torch.Tensor  # [A, H, U]


def make_cem_gd(config: CEMGDConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    k, m = config.num_elite, config.gd_candidates
    if not 1 <= m <= k:
        raise ValueError(f"gd_candidates ({m}) must be in [1, num_elite={k}]")
    ev_pm = ((lambda o, p: evaluate(o, p.permute(2, 0, 1, 3))) if config.time_major
             else evaluate)
    if k > pop:
        raise ValueError(f"num_elite ({k}) must be <= population ({pop})")
    cem.check_config(config)
    if config.execute_best:
        raise ValueError(
            "CEM-GD does not take execute_best: its final argmax already selects over "
            "the polished elites AND the unpolished incumbent, which subsumes it"
        )
    pops = cem.iteration_populations(config) or [pop] * config.max_iterations

    def init(generator: torch.Generator) -> CEMGDState:
        device = generator.device
        return CEMGDState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=device),
            variance=base.init_solution_variance(bounds, horizon, agents, device=device),
        )

    def solve(state: CEMGDState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        # Phase 1: CEM; the top m elites of the last iteration, best first.
        mean, var = state.mean, state.variance
        carried = cem.init_carried(config, bounds, state, generator)
        for pop_i in pops:
            mean, var, carried, elites, _ = cem.cem_iteration(
                config, bounds, evaluate, obs, mean, var, generator, carried,
                population=pop_i, n_extract=m,
            )
        top_elites = elites[:, :m]  # [A, m, H, U]
        # Phase 2: the incumbent is a slot of its own, so CEM's best plan is polished too.
        incumbent = bounds.clip(mean)
        plans = torch.cat([incumbent[None], top_elites.transpose(0, 1)], dim=0)  # [m+1, A, H, U]
        plans = base.adam_polish(lambda p: ev_pm(obs, p), bounds, config.gd_learning_rate,
                                 plans, config.gd_iterations)
        plans = torch.cat([plans, incumbent[None]], dim=0)  # [m+2, A, H, U]
        best, best_reward = best_of(plans, ev_pm(obs, plans))
        if config.warm_start:
            next_state = CEMGDState(mean=base.shift_time(best), variance=state.variance)
        else:
            next_state = state
        return best[:, 0], next_state, SolverAux(expected_reward=best_reward, plan=best)

    def reset(state: CEMGDState, generator: torch.Generator) -> CEMGDState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CEM-GD", plan_field="mean"),
        config.dtype)
