"""DreamerV3's RSSM and one PlaNet planning step through it, written out plainly for the RSSM
cell: a copy of ``references/dreamerv3_rssm.py`` (the plain reference the CPU tests hold the
program to) with every matrix product through :func:`port_bench.reference.matmul`, so the
control can run it in TF32, and the planner of an ``act()``.

The model (Hafner et al., arXiv:2301.04104; ``dreamerv3/rssm.py``): hidden layers Linear,
RMSNorm (a learned scale, eps ``norm_eps``), SiLU; the feature ``[h, z]``, ``z`` the ``stoch``
one-hot codes of ``classes`` classes; the core steps ``h`` as ``rssm.py::_core`` does (inputs
of ``h``, ``z`` and ``a / max(1, |a|)``; each of the ``blocks`` groups reads ``[h_g, x0, x1,
x2]`` through its own weights, written here group by group; a GRU whose update is biased by
-1); the prior over ``h'``, the posterior over ``[h', symlog encoding]``, unimix 0.01; the
reward head's 255 logits decoded as ``symexp(sum(softmax * linspace(-20, 20, 255)))`` (the
released code's ``TwoHot``, summed left to right). A code is drawn by inverse CDF from a
uniform, the law of ``jax.random.categorical``. Departures: the uniforms are the program's
draws, read from its noise generator's state; the planner is the port's CEM.

The planner is PlaNet's (arXiv:1811.04551, section 3) at the traffic's sizes as the port's
CEM runs it, as ``planning.py`` writes it out (truncated normals by inverse CDF around the
mean, the variance capped so that two standard deviations stay inside the bounds, the
per-agent top ``num_elite``, the blend with ``alpha``), and ``planning.py``'s search of the
elite sets that rounding allows. A candidate's value is the sum of the predicted rewards
along one trajectory drawn from the prior, each read at the state a step reaches. Its draws
follow the program's generators: per iteration one ``torch.rand`` of the candidates' shape from
the planner's generator; from the noise generator the posterior's ``torch.rand([A, stoch])``,
then one ``torch.rand([H, P * A, stoch])`` that every evaluation of the step reads (common
random numbers).

**Ties.** The program's probabilities and these lie some rounding apart, so where a uniform
lies that close to a cumulative sum the two may draw different classes, and from there that
row's trajectory goes another way. Given the classes the program drew (read from its own
eager step, ``drivers/rssm_closed_loop.py``), a pick whose uniform lies within ``MARGIN`` of
one of the row's cumulative sums here is a tie, and the program's class is taken there. The
counts: ``ties``, the ties at which the two classes differ; ``picks``, the other picks at which
they differ, which only a fault makes. An evaluation here follows one of the program's only
where its candidates are the program's to ``SAME_PLAN``; elsewhere (another elite set of the
search) its own classes are taken and nothing is counted.
"""
from __future__ import annotations

import heapq
import itertools

import torch
import torch.nn.functional as F

from port_bench.reference import matmul
from port_bench.reference.planning import (
    ERF_HI, ERF_LO, MOST_ROLLOUTS, NAN_RETURN, SQRT2, _alternatives,
)

__all__ = ["Model", "code_uniforms", "observe", "plan_step", "lookahead", "MARGIN", "TIE"]

# A pick's tie margin, in probability: the widest gap between a uniform and a cumulative sum
# here that rounding may bridge to the other side in the program, with room.
MARGIN = 2e-5
# The widest gap between a candidate's return here and in the program, as a share of the
# largest return's magnitude (at least 1), that the elite search allows for, with room.
TIE = 4e-5
# Candidates here and in one of the program's evaluations, each action within this, are the
# same candidates up to rounding (another elite set moves the mean by a share of an elite).
SAME_PLAN = 1e-4


def _no_counts() -> dict:
    return {"ties": 0, "picks": 0, "tie_gap": 0.0}


def _merge(total: dict, part: dict) -> dict:
    return {"ties": total["ties"] + part["ties"], "picks": total["picks"] + part["picks"],
            "tie_gap": max(total["tie_gap"], part["tie_gap"])}


class Model:
    """``config``: the configuration file's dictionary; ``weights``: the run's weights, drawn
    from the seed by the driver, in the layout of ``blackbox_mpc_torch/models/rssm.py``."""

    def __init__(self, config: dict, weights: dict, device):
        self.m = config["model"]
        self.weights = weights
        self.dim_u = self.m["action_dim"]
        self.device = device

    def _rms(self, x, scale):
        return x / torch.sqrt((x * x).mean(-1, keepdim=True) + self.m["norm_eps"]) * scale

    def _hidden(self, x, layer):
        h = self._rms(matmul(x, layer["w"]) + layer["b"], layer["scale"])
        return h * torch.sigmoid(h)

    def _head(self, layers, x):
        for layer in layers[:-1]:
            x = self._hidden(x, layer)
        return matmul(x, layers[-1]["w"]) + layers[-1]["b"]

    @staticmethod
    def _blocks(x, layer):
        """Group ``g`` of ``x`` [B, blocks * in] through its own weights, side by side."""
        w, b = layer["w"], layer["b"]
        k = w.shape[1]
        return torch.cat([matmul(x[:, g * k:(g + 1) * k], w[g]) + b[g]
                          for g in range(w.shape[0])], -1)

    def split(self, feat):
        return feat[:, :self.m["deter"]], feat[:, self.m["deter"]:]

    def core(self, h, z, a):
        blocks = self.m["blocks"]
        k = self.m["deter"] // blocks
        a = a / torch.clamp(torch.abs(a), min=1.0)
        x = torch.cat([self._hidden(v, layer)
                       for v, layer in zip((h, z, a), self.weights["core_in"])], -1)
        x = torch.cat([torch.cat([h[:, g * k:(g + 1) * k], x], -1) for g in range(blocks)], -1)
        for layer in self.weights["core_hidden"]:
            x = self._rms(self._blocks(x, layer), layer["scale"])
            x = x * torch.sigmoid(x)
        gates = self._blocks(x, self.weights["core_gru"][0])
        new = []
        for g in range(blocks):
            r, c, v = gates[:, 3 * k * g:3 * k * (g + 1)].split(k, -1)
            update = torch.sigmoid(v - 1)
            new.append(update * torch.tanh(torch.sigmoid(r) * c)
                       + (1 - update) * h[:, g * k:(g + 1) * k])
        return torch.cat(new, -1)

    def _probs(self, logits):
        m = self.m
        p = torch.softmax(logits.reshape(logits.shape[0], m["stoch"], m["classes"]), -1)
        return (1 - m["unimix"]) * p + m["unimix"] / m["classes"]

    def prior(self, h):
        return self._probs(self._head(self.weights["prior"], h))

    def posterior(self, h, e):
        return self._probs(self._head(self.weights["posterior"], torch.cat([h, e], -1)))

    def encode(self, obs):
        x = torch.sign(obs) * torch.log(1 + torch.abs(obs))
        for layer in self.weights["encoder"]:
            x = self._hidden(x, layer)
        return x

    def reward(self, feat):
        m = self.m
        bins = torch.linspace(m["vmin"], m["vmax"], m["num_bins"], device=feat.device)
        x = (torch.softmax(self._head(self.weights["reward"], feat), -1) * bins).sum(-1)
        return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)

    def one_hot(self, index):
        return F.one_hot(index, self.m["classes"]).float().reshape(index.shape[0], -1)


def pick(probs, u, program=None, margin: float = MARGIN):
    """The classes [B, stoch] drawn by inverse CDF from ``probs`` [B, stoch, classes] with the
    uniforms ``u`` [B, stoch], and the counts (the module's notes) against the program's
    classes ``program`` [B, stoch] (None: its own everywhere, nothing counted). ``tie_gap``:
    the widest distance from a uniform to its nearest cumulative sum at a tie whose classes
    differ, the rounding that a tie bridged."""
    cdf = torch.cumsum(probs, -1)
    own = torch.clamp((cdf <= u[..., None]).sum(-1), max=probs.shape[-1] - 1)
    if program is None:
        return own, _no_counts()
    program = program.to(own.dtype)
    gap = torch.abs(cdf[..., :-1] - u[..., None]).amin(-1)
    near, differ = gap < margin, own != program
    tied = near & differ
    counts = {"ties": int(tied.sum()), "picks": int((differ & ~near).sum()),
              "tie_gap": float(gap[tied].max()) if bool(tied.any()) else 0.0}
    return torch.where(near, program, own), counts


def code_uniforms(noise_state, agents: int, rows: int, horizon: int, stoch: int, device):
    """The program's uniforms of one ``act()`` from its noise generator's state at the call's
    start: the posterior's ``[agents, stoch]``, then the prior's ``[horizon, rows, stoch]``."""
    gen = torch.Generator(device=device)
    gen.set_state(noise_state)
    u_filter = torch.rand((agents, stoch), generator=gen, device=device)
    return u_filter, torch.rand((horizon, rows, stoch), generator=gen, device=device)


def observe(model: Model, feat, action, obs, u, program=None):
    """The filter step from the carried ``feat`` and ``action`` on ``obs``: ``(feat_t,
    counts)``; ``program``: the program's classes [A, stoch], as :func:`pick`."""
    h, z = model.split(feat)
    h = model.core(h, z, action)
    index, counts = pick(model.posterior(h, model.encode(obs)), u, program)
    return torch.cat([h, model.one_hot(index)], -1), counts


def _imagine(model: Model, feat, a, u, program=None):
    h, z = model.split(feat)
    h = model.core(h, z, a)
    probs = model.prior(h)
    if u is None:
        return torch.cat([h, probs.reshape(h.shape[0], -1)], -1), _no_counts(), None
    index, counts = pick(probs, u, program)
    return torch.cat([h, model.one_hot(index)], -1), counts, index


def _returns(model: Model, feat0, samples, u, program=None):
    """``samples`` [P, A, H, U] from the agents' features ``feat0`` [A, F] -> (the returns [P,
    A], the counts, the classes drawn [H, P * A, stoch]); rows agent-minor, as the program
    tiles them."""
    pop, agents, horizon, dim_u = samples.shape
    actions = samples.reshape(pop * agents, horizon, dim_u)
    feat = feat0.repeat(pop, 1)
    total = torch.zeros(feat.shape[0], device=feat.device)
    counts, picked = _no_counts(), []
    for t in range(horizon):
        feat, c, index = _imagine(model, feat, actions[:, t], u[t],
                                  None if program is None else program[t])
        total = total + model.reward(feat)
        counts = _merge(counts, c)
        picked.append(index)
    returns = total.reshape(pop, agents)
    returns = torch.where(torch.isnan(returns), torch.full_like(returns, NAN_RETURN), returns)
    return returns, counts, torch.stack(picked)


def plan_step(model: Model, config: dict, traffic: dict, feat0, mean, var, gen_state, u,
              program=None, tie: float = TIE, accept=None):
    """One ``act()``'s CEM from the filtered features ``feat0`` [A, F] and the carried ``mean``
    / ``var`` [A, H, U], the prior's uniforms ``u`` [H, P * A, stoch] read by every
    evaluation. ``program``: the program's evaluations of the step, one ``(candidates [H, P *
    A, U], classes [H, P * A, stoch], returns [P * A])`` an iteration (None: its own classes
    everywhere). Returns ``(outcomes, counts, evals)``: the outcomes found, each ``(action [A,
    U], final mean)``, the reference's own ranking first, then those that rounding of the
    returns by ``tie`` allows, as ``planning.plan_step`` searches them; the counts over the
    evaluations that followed the program's (with ``followed``, how many, and ``return_gap``,
    the widest gap of their returns from the program's); and the reference's own first
    path's evaluations in ``program``'s form."""
    low, high = (float(x) for x in config["action_bounds"])
    kw, horizon = traffic["solver_kwargs"], traffic["planning_horizon"]
    agents, dim_u, device = feat0.shape[0], model.dim_u, feat0.device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    shape = (kw["population"], agents, horizon, dim_u)
    k, alpha, iterations = kw["num_elite"], kw["alpha"], kw["max_iterations"]
    zs = []
    for _ in range(iterations):
        draw = torch.rand(shape, generator=gen, device=device)
        zs.append(torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * draw),
                              -2.0, 2.0))
    count = itertools.count()
    heap = [(0.0, 0, next(count), mean, var)]
    outcomes, rollouts, followed, evals = [], 0, {}, []
    while heap:
        cost, depth, _, mean, var = heapq.heappop(heap)
        if -depth == iterations:
            outcomes.append((mean[:, 0], mean))
            if accept is not None and accept(*outcomes[-1]):
                break
            continue
        if rollouts == MOST_ROLLOUTS:
            continue
        i = -depth
        cap = torch.minimum(((mean - low) / 2.0) ** 2, ((high - mean) / 2.0) ** 2)
        samples = mean + zs[i] * torch.sqrt(torch.minimum(cap, var))
        candidates = samples.reshape(-1, horizon, dim_u).transpose(0, 1)  # [H, P * A, U]
        theirs = None
        if program is not None and i < len(program):
            if float((program[i][0] - candidates).abs().max()) <= SAME_PLAN:
                theirs = program[i]
        returns, counts, picked = _returns(model, feat0, samples, u,
                                           None if theirs is None else theirs[1])
        rollouts += 1
        if theirs is not None and i not in followed:
            scale = max(1.0, float(returns.abs().max()))
            gap = float((returns.reshape(-1) - theirs[2]).abs().max()) / scale
            followed[i] = {**counts, "return_gap": gap}
        if len(evals) == i:
            evals.append((candidates, picked, returns.reshape(-1)))
        for gap, best in _alternatives(returns, k, tie):
            elites = torch.stack([samples[best[j], j] for j in range(agents)])
            elite_mean = elites.mean(1)
            elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
            heapq.heappush(heap, (cost + gap, depth - 1, next(count),
                                  alpha * mean + (1.0 - alpha) * elite_mean,
                                  alpha * var + (1.0 - alpha) * elite_var))
    counts = _no_counts()
    for c in followed.values():
        counts = _merge(counts, c)
    counts["followed"] = len(followed)
    counts["return_gap"] = max((c["return_gap"] for c in followed.values()), default=0.0)
    return outcomes, counts, evals


def lookahead(model: Model, feat0, action):
    """The step's report at ``action``: the next feature with the prior's probabilities in the
    codes' place, and the decoded reward there."""
    feat, _, _ = _imagine(model, feat0, action, None)
    return feat, model.reward(feat)

