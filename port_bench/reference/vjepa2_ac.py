"""V-JEPA 2-AC's world model and one planning step toward a goal image through it, for the cell
``vjepa2_ac_300m.goal_cem_closed_loop``: the plain model of ``references/vjepa2_ac.py`` (the one
the CPU tests hold the program to) with every matrix product through
:func:`port_bench.reference.matmul`, the patch embedding and the attention's two products
included, so that the control can run it in TF32; computed in blocks of candidates, so that it
fits beside the run's weights; and the planner of an ``act()``.

The model, its equations and what they assume are in that module's notes. An imagined frame is
the last output of the predictor's whole forward over every frame so far, the earlier ones
teacher-forced from its own predictions: no cache. A candidate's return is ``-mean |z_H -
z_goal|``.

The planner is the program's CEM (truncated normals by inverse CDF around the mean, the variance
capped so that two standard deviations stay inside the bounds, the per-agent top ``num_elite``,
the blend with ``alpha``), with ``planning.py``'s search of the elite sets that rounding allows.
Its draws follow the program's generator: per iteration one ``torch.rand`` of the candidates'
shape. The evaluations draw nothing: the goal is their one input.
"""
from __future__ import annotations

import heapq
import itertools

import torch

from port_bench.reference import matmul
from port_bench.reference.planning import ERF_HI, ERF_LO, NAN_RETURN, SQRT2, _alternatives
from references import vjepa2_ac as plain

__all__ = ["Model", "plan_step", "TIE", "BLOCK"]

# Candidates a block of the predictor's forward: 32 x 516 tokens keep the scores of one head
# stack at 0.55 GB.
BLOCK = 32
# The widest gap between a candidate's return here and in the program, as a share of the
# largest return's magnitude (at least 1), that the search allows for: about 5x the widest
# seen, 1.8e-7 over an evaluation of the cell's 128 candidates on the H100 (PERF.md, section
# 2), where the returns of the 128 candidates span some 1.4e-4 and neighbours lie 7e-7 apart.
TIE = 1e-6
# Rollouts of one step's search: each is a whole evaluation of the candidates (about 1.5 s on
# the card at the cell's size).
MOST_ROLLOUTS = 12


class Model:
    """``config``: the configuration file's dictionary; ``weights``: the run's weights, drawn
    from the seed by the driver, in the layout of ``blackbox_mpc_torch/models/vjepa2_ac.py``."""

    def __init__(self, config: dict, weights: dict, device):
        self.m = config["model"]
        self.weights = weights
        self.dim_u = self.m["action_dim"]
        self.device = device

    def encode(self, images):
        """``images`` [B, 3, H, W] in [0, 1] -> frame latents [B, patches, enc_dim]."""
        return plain.encode(self.weights, self.m, images, matmul)

    def predict(self, z, s, a):
        """The whole forward over F frames, block-causal: ``z`` [B, F, patches, enc_dim],
        ``s`` / ``a`` [B, F, 7] -> [B, F, patches, enc_dim]."""
        return plain.predict(self.weights, self.m, z, s, a, matmul)

    def last_frame(self, z0, s0, plans):
        """``plans`` [B, H, U] from ``z0`` [B, patches, enc_dim], ``s0`` [B, 7] -> the last
        imagined frame's latents, each frame from the forward over every frame before it."""
        return plain.rollout(self.weights, self.m, z0, s0, plans, matmul)[0][:, -1]

    def returns(self, z0, s0, samples, goal):
        """``samples`` [P, A, H, U] from the agents' ``z0`` [A, patches, enc_dim], ``s0`` [A, 7]
        -> ``-mean |z_H - goal|`` [P, A], the rows agent-minor as the program tiles them, in
        blocks of ``BLOCK`` candidates."""
        pop, agents, horizon, dim_u = samples.shape
        plans = samples.reshape(pop * agents, horizon, dim_u)
        rows = BLOCK * agents
        out = []
        for start in range(0, pop * agents, rows):
            block = plans[start:start + rows]
            n = block.shape[0] // agents
            z = self.last_frame(z0.repeat(n, 1, 1), s0.repeat(n, 1), block)
            out.append(-plain.energy(z, goal))
        returns = torch.cat(out).reshape(pop, agents)
        return torch.where(torch.isnan(returns), torch.full_like(returns, NAN_RETURN), returns)

    def lookahead(self, z0, s0, action):
        """The step's report at ``action`` [A, U]: the next planning row, the predicted frame's
        latents and then the state, [A, patches x enc_dim + 7]."""
        z1 = self.predict(z0[:, None], s0[:, None], action[:, None])[:, 0]
        return torch.cat([z1.flatten(1), s0 + action], dim=-1)


def plan_step(model: Model, config: dict, traffic: dict, z0, s0, goal, mean, var, gen_state,
              tie: float = TIE, accept=None):
    """One ``act()``'s CEM from the agents' ``z0``, ``s0`` toward ``goal`` [patches, enc_dim],
    from the carried ``mean`` / ``var`` [A, H, U]: the outcomes found, each ``(action [A, U],
    final mean, the last iteration's elites' mean return [A])``, the reference's own ranking
    first, then those that rounding of the returns by ``tie`` allows, as
    ``planning.plan_step`` searches them, until ``accept(action, final, value)`` holds or
    ``MOST_ROLLOUTS`` rollouts are spent."""
    low, high = (float(x) for x in config["action_bounds"])
    kw, horizon = traffic["solver_kwargs"], traffic["planning_horizon"]
    agents, device = z0.shape[0], z0.device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    shape = (kw["population"], agents, horizon, model.dim_u)
    k, alpha, iterations = kw["num_elite"], kw["alpha"], kw["max_iterations"]
    zs = []
    for _ in range(iterations):
        u = torch.rand(shape, generator=gen, device=device)
        zs.append(torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * u), -2.0, 2.0))
    count = itertools.count()
    heap = [(0.0, 0, next(count), mean, var, None)]
    outcomes, rollouts = [], 0
    while heap:
        cost, depth, _, mean, var, value = heapq.heappop(heap)
        if -depth == iterations:
            outcomes.append((mean[:, 0], mean, value))
            if accept is not None and accept(*outcomes[-1]):
                break
            continue
        if rollouts == MOST_ROLLOUTS:
            continue
        cap = torch.minimum(((mean - low) / 2.0) ** 2, ((high - mean) / 2.0) ** 2)
        samples = mean + zs[-depth] * torch.sqrt(torch.minimum(cap, var))
        returns = model.returns(z0, s0, samples, goal)
        rollouts += 1
        for gap, best in _alternatives(returns, k, tie):
            elites = torch.stack([samples[best[i], i] for i in range(agents)])
            elite_mean = elites.mean(1)
            elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
            value = torch.stack([returns[best[i], i] for i in range(agents)]).mean(1)
            heapq.heappush(heap, (cost + gap, depth - 1, next(count),
                                  alpha * mean + (1.0 - alpha) * elite_mean,
                                  alpha * var + (1.0 - alpha) * elite_var, value))
    return outcomes
