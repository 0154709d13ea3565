"""One planning step (an ``act()``) written out plainly, for the cross-entropy method and for
random search, with the one-step lookahead the step reports.

The planners are the published ones: CEM samples a truncated normal (inverse CDF, cut at two
standard deviations) around its mean with the variance capped so that two standard
deviations stay inside the bounds, keeps the ``num_elite`` best per agent, and blends their
mean and variance into its own with weight ``alpha`` on the old; with warm start the next
step starts from the final mean shifted by one step (the last step repeated) and the first
variance. Random search draws uniform plans and keeps each agent's best. A candidate's
return is the sum of rewards along its rollout; with particles (TS-infinity) each candidate
is rolled out once per particle and the returns are averaged. NaN returns count as -1e6.

Randomness follows the program's generators: ``gen_state`` is the state of the planner's
``torch.Generator`` when the step began, and each draw is the same call on it (a
``torch.rand`` of the candidates' shape per iteration); the particles' noise is one
``torch.randn`` of ``[H, rows, S]`` from ``noise_state``, the same for every iteration of a
step. The candidates' rows are candidate-major, then particle, then agent.

Rounding: the program's returns and these lie some millionths of the largest return's
magnitude apart (the kernels sum in another order than cuBLAS). Where returns crowd at the
elite boundary the program may keep other elites than this reference, and from there on its
step goes another way. ``plan_step`` therefore searches the outcomes that such rounding
allows, cheapest first: the reference's own ranking, then the elite sets that trade
candidates whose returns lie within ``2 * tie`` of the largest return's magnitude of each
other, in the order of the gap that rounding has to bridge. It stops at an outcome that
``accept`` takes.
"""
from __future__ import annotations

import heapq
import itertools
import math

import torch

__all__ = ["plan_step", "lookahead", "shift"]

SQRT2 = math.sqrt(2.0)
ERF_LO = math.erf(-2.0 / SQRT2)
ERF_HI = math.erf(2.0 / SQRT2)
NAN_RETURN = -1e6
# The widest gap between a candidate's return here and in the program, as a share of the
# largest return's magnitude (at least 1): the rollout kernel's returns lie up to 2e-6 from
# this reference's on most steps, 8e-6 at the farthest candidate seen (PERF.md). Two
# candidates whose returns lie within twice this may trade places.
TIE = 1e-5
BAND = 8  # candidates on each side of the elite boundary that may trade places
MOST_SWAPS = 3  # candidates traded at once, per agent and iteration
MOST_CHILDREN = 16  # elite sets followed from one iteration's returns
MOST_ROLLOUTS = 64  # rollouts of one step's search


def reward(config: dict, s, a, ns):
    r = config["reward"]
    return ns[:, r["velocity_index"]] - r["action_cost"] * (a * a).sum(-1)


def shift(plan: torch.Tensor) -> torch.Tensor:
    """Drop the first step, repeat the last: ``[..., H, U]``."""
    return torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)


def _returns(model, config, obs, samples, particles, noise_state):
    """``samples`` [P, A, H, U] -> the mean return per candidate and agent, [P, A]."""
    pop, agents, horizon, dim_u = samples.shape
    rows = pop * particles * agents
    actions = samples.repeat_interleave(particles, dim=0).reshape(rows, horizon, dim_u)
    s = obs.repeat(pop * particles, 1)
    total = torch.zeros(rows, device=obs.device)
    if model.propagation == "ts_inf":
        gen = torch.Generator(device=obs.device)
        gen.set_state(noise_state)
        noise = torch.randn((horizon, rows, model.dim_s), generator=gen, device=obs.device)
        members = model.member_rows(rows)
    for t in range(horizon):
        a = actions[:, t]
        if model.propagation == "ts_inf":
            ns = model.sampled_step(s, a, members, noise[t])
        else:
            ns = model.mean_step(s, a)
        total = total + reward(config, s, a, ns)
        s = ns
    returns = total.reshape(pop, particles, agents).mean(1)
    return torch.where(torch.isnan(returns), torch.full_like(returns, NAN_RETURN), returns)


def _agent_sets(ranked: list, k: int, tie: float) -> list:
    """``(gap, positions)`` of each set of ``k`` of one agent's candidates, by their place in
    ``ranked`` (the agent's returns, best first), that rounding of the returns by ``tie`` could
    keep: the top ``k`` (gap 0), and those that trade up to ``MOST_SWAPS`` of the ``BAND``
    candidates above the boundary for as many below it, where the best left out lies at most
    ``2 * tie`` of the largest return's magnitude above the worst kept. The gap is that
    excess, as a share of the same magnitude. Cheapest first."""
    scale = max(abs(ranked[0]), 1.0)
    margin = 2.0 * tie * scale
    sets = [(0.0, tuple(range(k)))]
    if k >= len(ranked):
        return sets
    above = [p for p in range(max(0, k - BAND), k) if ranked[p] <= ranked[k] + margin]
    below = [q for q in range(k, min(len(ranked), k + BAND))
             if ranked[q] >= ranked[k - 1] - margin]
    for swaps in range(1, min(MOST_SWAPS, len(above), len(below)) + 1):
        for out in itertools.combinations(above, swaps):
            kept = [ranked[p] for p in range(k) if p not in out]
            for into in itertools.combinations(below, swaps):
                rest = next((q for q in range(k, len(ranked)) if q not in into), None)
                left_out = max(ranked[out[0]], -math.inf if rest is None else ranked[rest])
                gap = left_out - min(kept + [ranked[into[-1]]])
                if gap <= margin:
                    chosen = sorted(set(range(k)).difference(out).union(into))
                    sets.append((max(gap, 0.0) / scale, tuple(chosen)))
    return sorted(sets, key=lambda s: s[0])


def _alternatives(returns, k: int, tie: float) -> list:
    """``(gap, index set [A, k])`` of the elites that rounding of ``returns`` [P, A] by ``tie``
    could select, cheapest first and at most ``MOST_CHILDREN``: every agent's top ``k`` first
    (``tie=0``: that alone). A set's gap is the sum of its agents'."""
    order = torch.argsort(returns.T, dim=1, descending=True)  # [A, P]
    if tie == 0:
        return [(0.0, order[:, :k])]
    ranked = torch.gather(returns.T, 1, order).tolist()
    per_agent = [_agent_sets(r, k, tie) for r in ranked]
    combos = sorted(itertools.product(*per_agent), key=lambda c: sum(g for g, _ in c))
    return [(sum(g for g, _ in combo),
             torch.stack([order[a, list(places)] for a, (_, places) in enumerate(combo)]))
            for combo in combos[:MOST_CHILDREN]]


def _choices(returns, k: int, tie: float) -> list:
    """The index sets ``[A, k]`` of ``_alternatives``, the top ``k`` first."""
    return [best for _, best in _alternatives(returns, k, tie)]


def plan_step(model, config: dict, traffic: dict, obs, mean, var, gen_state, noise_state,
              tie: float = TIE, accept=None):
    """One ``act()``'s planning from its start: ``obs`` [A, S] and, for CEM, the carried
    ``mean``/``var`` [A, H, U]. Returns the outcomes found, each ``(action [A, U], final mean
    or None)``: the reference's own ranking first, then those that rounding of the returns by
    ``tie`` allows (the module's notes), cheapest first, until ``accept(action, final)`` holds
    or ``MOST_ROLLOUTS`` rollouts are spent. ``tie=0`` gives the first alone."""
    low, high = (float(x) for x in config["action_bounds"])
    kw, horizon = traffic["solver_kwargs"], traffic["planning_horizon"]
    agents, dim_u = obs.shape[0], model.dim_u
    particles = config["model"].get("num_particles", 1) if model.propagation == "ts_inf" else 1
    gen = torch.Generator(device=obs.device)
    gen.set_state(gen_state)
    shape = (kw["population"], agents, horizon, dim_u)
    outcomes = []
    if traffic["solver"] == "RandomSearch":
        u = torch.rand(shape, generator=gen, device=obs.device)
        samples = low + u * (high - low)
        returns = _returns(model, config, obs, samples, particles, noise_state)
        agent_ids = torch.arange(agents, device=obs.device)
        for _, best in _alternatives(returns, 1, tie):
            outcomes.append((samples[best[:, 0], agent_ids, 0], None))
            if accept is not None and accept(*outcomes[-1]):
                break
        return outcomes
    if traffic["solver"] != "CEM":
        raise ValueError(f"no reference for solver {traffic['solver']!r}")
    k, alpha, iterations = kw["num_elite"], kw["alpha"], kw["max_iterations"]
    zs = []  # one draw an iteration, the same on every path
    for _ in range(iterations):
        u = torch.rand(shape, generator=gen, device=obs.device)
        zs.append(torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * u), -2.0, 2.0))
    # The cheapest path first and, of equal cost, the deepest (a node's depth is stored
    # negated), so that the reference's own ranking ends first; the counter orders the rest
    # and keeps the tensors out of the comparison.
    count = itertools.count()
    heap = [(0.0, 0, next(count), mean, var)]
    rollouts = 0
    while heap:
        cost, depth, _, mean, var = heapq.heappop(heap)
        if -depth == iterations:
            outcomes.append((mean[:, 0], mean))
            if accept is not None and accept(*outcomes[-1]):
                break
            continue
        if rollouts == MOST_ROLLOUTS:
            continue
        cap = torch.minimum(((mean - low) / 2.0) ** 2, ((high - mean) / 2.0) ** 2)
        samples = mean + zs[-depth] * torch.sqrt(torch.minimum(cap, var))
        returns = _returns(model, config, obs, samples, particles, noise_state)
        rollouts += 1
        for gap, best in _alternatives(returns, k, tie):
            elites = torch.stack([samples[best[i], i] for i in range(agents)])  # [A, k, H, U]
            elite_mean = elites.mean(1)
            elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
            heapq.heappush(heap, (cost + gap, depth - 1, next(count),
                                  alpha * mean + (1.0 - alpha) * elite_mean,
                                  alpha * var + (1.0 - alpha) * elite_var))
    return outcomes


def lookahead(model, config: dict, obs, action):
    """The step's report at ``action``: the ensemble's mean prediction of the next state and
    its reward."""
    ns = model.mean_step(obs, action)
    return ns, reward(config, obs, action, ns)
