"""Cross-Entropy Method trajectory solver.

Counterpart of ``blackbox_mpc_tpu/solvers/cem.py``: per iteration, sample a population under
bound-constrained variance, evaluate, keep per-agent top-k elites, and blend the elite moments
into the running mean/variance with momentum ``alpha``. The moments are top-k masked sums over
the candidate tensor, as in the JAX package. ``warm_start=False`` (the default) leaves the
state unchanged between solves.

The iCEM options run as in the JAX package: ``colored_noise_beta`` (colored samples, clipped to
the bounds), ``keep_elites`` (the previous iteration's best rejoin the population),
``mean_as_candidate``, ``population_decay`` (iteration i samples
``max(population * decay^i, 2 * num_elite)``) and ``execute_best``. ``time_major=True`` samples
and evaluates the candidates ``[H, P, A, U]`` (pair it with a time-major evaluator); the state,
the returned elites and the moments keep their layouts. Colored noise draws the same spectrum
in both layouts; a truncated normal is as random in both but not the same draw.
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

__all__ = [
    "CEMConfig", "CEMState", "make_cem", "cem_iteration", "check_config", "init_carried",
    "iteration_populations",
]


@dataclasses.dataclass(frozen=True)
class CEMConfig(base.SolverConfig):
    """Defaults match the reference; the fields after ``warm_start`` are the iCEM options of
    the JAX package, then the candidate layout."""

    num_elite: int = 50
    alpha: float = 0.25  # weight of the previous mean/var
    warm_start: bool = False
    colored_noise_beta: float = 0.0  # 0.0 = white truncated normal
    keep_elites: int = 0
    population_decay: float = 1.0
    mean_as_candidate: bool = False
    execute_best: bool = False
    time_major: bool = False


def check_config(config: CEMConfig) -> None:
    """Raises for the option ranges the JAX factories refuse."""
    reserved = 1 + (1 if config.mean_as_candidate else 0)
    if not 0 <= config.keep_elites <= min(config.num_elite, config.population - reserved):
        raise ValueError(
            f"keep_elites ({config.keep_elites}) must be in "
            f"[0, min(num_elite, population - {reserved})]"
        )
    if not 0.0 < config.population_decay <= 1.0:
        raise ValueError(f"population_decay ({config.population_decay}) must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class CEMState(base.StateReplace):
    mean: torch.Tensor  # [A, H, U]
    variance: torch.Tensor  # [A, H, U]


def cem_iteration(config: CEMConfig, bounds: Bounds, evaluate, obs, mean, var, generator,
                  carried=None, population=None, n_extract=None):
    """One CEM update. Returns ``(mean, var, carried, elites, elite_vals)``.

    Samples ``population - keep_elites`` (less one with ``mean_as_candidate``) fresh candidates
    around ``mean``: colored noise clipped to the bounds when ``config.colored_noise_beta >
    0``, else a truncated normal. The clipped mean and the ``carried`` elites of the previous
    iteration rejoin them. ``elites`` is ``[A, n, H, U]`` ranked best-first with ``n =
    num_elite``, or ``max(n_extract, keep_elites)`` when ``n_extract`` is given;
    ``elite_vals`` is ``[A, k]``. ``population`` overrides ``config.population`` (iCEM decay).

    ``config.time_major``: the candidates are ``[H, P, A, U]`` and ``carried`` is
    ``[H, keep, A, U]`` (``[A, keep, H, U]`` otherwise); everything else keeps its layout.
    """
    horizon, agents = config.planning_horizon, config.num_agents
    pop = config.population if population is None else population
    k, alpha, keep = config.num_elite, config.alpha, config.keep_elites
    tm = config.time_major
    std = torch.sqrt(base.constrain_variance(mean, var, bounds))
    n_fresh = pop - keep - (1 if config.mean_as_candidate else 0)
    if tm:
        # [H, 1, A, U] anchors: small transposes of the [A, H, U] state.
        center, spread = mean.permute(1, 0, 2)[:, None], std.permute(1, 0, 2)[:, None]
        shape, p_axis = (horizon, n_fresh, agents, bounds.dim), 1
    else:
        center, spread = mean, std
        shape, p_axis = (n_fresh, agents, horizon, bounds.dim), 0
    if config.colored_noise_beta > 0.0:
        colored = base.colored_noise_time_major if tm else base.colored_noise
        samples = bounds.clip(center + spread * colored(generator, config.colored_noise_beta,
                                                        shape))
    else:
        samples = truncated_normal(generator, center, spread, shape)
    if config.mean_as_candidate:
        samples = torch.cat([samples, bounds.clip(center if tm else mean[None])], dim=p_axis)
    if keep:
        samples = torch.cat([samples, carried if tm else carried.transpose(0, 1)], dim=p_axis)
    rewards = evaluate(obs, samples)  # [P, A]
    elite_vals, elite_idx = torch.topk(rewards.T, k, dim=1)  # [A, k]
    # scatter_ from a source on the device: a Python scalar would be a host copy that waits
    # for the rollout.
    mask = torch.zeros((pop, agents), dtype=samples.dtype, device=samples.device).scatter_(
        0, elite_idx.T, torch.ones((k, agents), dtype=samples.dtype, device=samples.device))
    if tm:
        w = mask[None, :, :, None]
        new_mean_t = torch.sum(w * samples, dim=1) / k  # [H, A, U]
        new_var_t = torch.sum(w * torch.square(samples - new_mean_t[:, None]), dim=1) / k
        new_mean, new_var = new_mean_t.permute(1, 0, 2), new_var_t.permute(1, 0, 2)
    else:
        w = mask[:, :, None, None]
        new_mean = torch.sum(w * samples, dim=0) / k
        new_var = torch.sum(w * torch.square(samples - new_mean[None]), dim=0) / k
    n = k if n_extract is None else max(n_extract, keep)
    if tm:
        index = elite_idx[:, :n].T[None, :, :, None].expand(horizon, n, agents, bounds.dim)
        elites_t = torch.gather(samples, 1, index)  # [H, n, A, U]
        elites = elites_t.permute(2, 1, 0, 3)
    else:
        index = elite_idx[:, :n, None, None].expand(agents, n, horizon, bounds.dim)
        elites = torch.gather(samples.transpose(0, 1), 1, index)  # [A, n, H, U]
    mean = alpha * mean + (1.0 - alpha) * new_mean
    var = alpha * var + (1.0 - alpha) * new_var
    if keep:
        carried = elites_t[:, :keep] if tm else elites[:, :keep]
    return mean, var, carried, elites, elite_vals


def iteration_populations(config: CEMConfig):
    """Per-iteration population sizes under iCEM decay; ``None`` when constant. Iteration
    ``i`` uses ``max(population * decay^i, 2 * num_elite)`` samples, and never fewer than the
    injected slots plus one."""
    g = config.population_decay
    if g >= 1.0:
        return None
    floor = max(2 * config.num_elite,
                config.keep_elites + (2 if config.mean_as_candidate else 1))
    return [max(int(config.population * g**i), floor) for i in range(config.max_iterations)]


def init_carried(config: CEMConfig, bounds: Bounds, state: CEMState, generator):
    """The initial carried-elite buffer ``[A, keep, H, U]`` (``[H, keep, A, U]`` time-major):
    placeholders sampled around the incoming plan. ``keep_elites == 0`` draws nothing."""
    keep = config.keep_elites
    if config.time_major:
        shape = (config.planning_horizon, keep, config.num_agents, bounds.dim)
        mean, std = state.mean.permute(1, 0, 2)[:, None], torch.sqrt(state.variance).permute(
            1, 0, 2)[:, None]
    else:
        shape = (keep, config.num_agents, config.planning_horizon, bounds.dim)
        mean, std = state.mean, torch.sqrt(state.variance)
    if not keep:
        carried = torch.zeros(shape, dtype=state.mean.dtype, device=state.mean.device)
    else:
        carried = truncated_normal(generator, mean, std, shape)
    return carried if config.time_major else carried.transpose(0, 1)


def make_cem(config: CEMConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    check_config(config)
    horizon, agents = config.planning_horizon, config.num_agents
    pops = iteration_populations(config) or [config.population] * config.max_iterations
    n_extract = max(config.keep_elites, 1 if config.execute_best else 0)

    def init(generator: torch.Generator) -> CEMState:
        device = generator.device
        return CEMState(
            mean=base.init_solution_mean(bounds, horizon, agents, device=device),
            variance=base.init_solution_variance(bounds, horizon, agents, device=device),
        )

    def solve(state: CEMState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        mean, var = state.mean, state.variance
        carried = init_carried(config, bounds, state, generator)
        best_val = torch.full((agents,), -torch.inf, dtype=mean.dtype, device=mean.device)
        best_plan = mean
        for pop_i in pops:
            mean, var, carried, elites, elite_vals = cem_iteration(
                config, bounds, evaluate, obs, mean, var, generator, carried,
                population=pop_i, n_extract=n_extract,
            )
            if config.execute_best:
                # the best candidate seen over all iterations
                improve = elite_vals[:, 0] > best_val
                best_val = torch.where(improve, elite_vals[:, 0], best_val)
                best_plan = torch.where(improve[:, None, None], elites[:, 0], best_plan)
        if config.execute_best:
            action = best_plan[:, 0]
            aux = SolverAux(expected_reward=best_val, plan=best_plan)
        else:
            action = mean[:, 0]
            aux = SolverAux(expected_reward=torch.mean(elite_vals, dim=1), plan=mean)
        if config.warm_start:
            next_state = CEMState(mean=base.shift_time(mean), variance=state.variance)
        else:
            # Reference semantics: the persistent mean/variance are never updated.
            next_state = state
        return action, next_state, aux

    def reset(state: CEMState, generator: torch.Generator) -> CEMState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CEM", plan_field="mean"), config.dtype
    )
