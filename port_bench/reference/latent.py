"""TD-MPC2's world model and one planning step through it, written out plainly for the latent
cell: a copy of ``references/tdmpc2_world_model.py`` (the plain reference the CPU tests hold the
program to) with every matrix product through :func:`port_bench.reference.matmul`, so the
control can run it in TF32, and the planner of an ``act()``.

The model (Hansen, Su and Wang, ICLR 2024, arXiv:2310.16828; ``common/world_model.py``,
``layers.py``, ``math.py``): hidden layers Linear, LayerNorm (eps 1e-5), Mish; the encoder's and
the dynamics' last layer Linear, LayerNorm, SimNorm (a softmax over each group of
``simnorm_dim`` units); the reward and Q heads' ``num_bins`` logits decoded as ``symexp`` of
the softmax's expectation over ``linspace(vmin, vmax, num_bins)``; ``pi``'s action
``tanh(mean + eps * exp(log_std))`` with ``log_std`` squashed into its bounds; the heads read
``[z, task, a]``. A candidate's return from the encoded observation ``z_0`` is ``sum_{t<H}
gamma^t r(z_t, a_t) + gamma^H (Q_i + Q_j)(z_H, pi(z_H)) / 2`` (``tdmpc2.py::_estimate_value``),
the discount carried by repeated multiplication. Departures: ``pi``'s normals and the pair
``(i, j)`` are the program's draws, read from its generator's state; dropout is off, as in
TD-MPC2's planning.

The planner is the program's CEM at the traffic's sizes, as ``planning.py`` writes it out
(truncated normals by inverse CDF around the mean, the variance capped so that two standard
deviations stay inside the bounds, the per-agent top ``num_elite``, the blend with ``alpha``),
and ``planning.py``'s search of the elite sets that rounding allows. Its draws follow the
program's generators: per iteration one ``torch.rand`` of the candidates' shape from the
planner's generator, and from the noise generator the value's draws of that iteration's
evaluation, ``torch.randn([P * A, U])`` and ``torch.rand(num_q).argsort()[:2]``.
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

__all__ = ["Model", "plan_step", "lookahead", "TIE"]

LN_EPS = 1e-5
# The widest gap between a candidate's return here and in the program, as a share of the
# largest return's magnitude (at least 1), that the search allows for: twice the widest seen,
# 2.0e-5 over 40 evaluations of 512 candidates at the cell's size on the H100 (PERF.md, section
# 2), where the fused LayerNorm, Mish and bias-add and cuBLAS's sums differ from these plain
# ones and symexp's exponential carries a logit's rounding into the reward.
TIE = 4e-5


def _layer_norm(x, scale, shift_):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + shift_


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _dense(x, layer):
    return matmul(x, layer["w"]) + layer["b"]


class Model:
    """``config``: the configuration file's dictionary; ``weights``: the run's weights, drawn
    from the seed by the driver, in the layout of ``blackbox_mpc_torch/models/latent.py``."""

    def __init__(self, config: dict, weights: dict, device):
        self.m = config["model"]
        self.weights = weights
        self.dim_u = self.m["action_dim"]
        self.device = device

    def _head(self, layers, x, latent_out=False):
        for layer in layers[:-1]:
            x = _mish(_layer_norm(_dense(x, layer), layer["ln_w"], layer["ln_b"]))
        last = layers[-1]
        if not latent_out:
            return _dense(x, last)
        h = _layer_norm(_dense(x, last), last["ln_w"], last["ln_b"])
        g = h.reshape(*h.shape[:-1], -1, self.m["simnorm_dim"])
        e = torch.exp(g - g.max(-1, keepdim=True).values)
        return (e / e.sum(-1, keepdim=True)).reshape(h.shape)

    def _decode(self, logits):
        m = self.m
        bins = torch.linspace(m["vmin"], m["vmax"], m["num_bins"], device=logits.device)
        x = (torch.softmax(logits, dim=-1) * bins).sum(-1)
        return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)

    def _with_task(self, x):
        task = self.weights.get("task")
        return x if task is None else torch.cat([x, task.expand(x.shape[0], -1)], dim=-1)

    def encode(self, obs):
        return self._head(self.weights["encoder"], self._with_task(obs), latent_out=True)

    def next(self, z, a):
        return self._head(self.weights["dynamics"], torch.cat([self._with_task(z), a], -1),
                          latent_out=True)

    def reward(self, z, a):
        return self._decode(self._head(self.weights["reward"],
                                       torch.cat([self._with_task(z), a], -1)))

    def pi(self, z, eps):
        mean, x = self._head(self.weights["pi"], self._with_task(z)).chunk(2, dim=-1)
        low, high = self.m["log_std_min"], self.m["log_std_max"]
        log_std = low + 0.5 * (high - low) * (torch.tanh(x) + 1)
        return torch.tanh(mean + eps * torch.exp(log_std))

    def q(self, z, a, i: int):
        layers = [{k: v[i] for k, v in layer.items()} for layer in self.weights["q"]]
        return self._decode(self._head(layers, torch.cat([self._with_task(z), a], -1)))

    def value(self, z, eps, pair):
        a = self.pi(z, eps)
        i, j = (int(k) for k in pair)
        return (self.q(z, a, i) + self.q(z, a, j)) / 2

    def returns(self, z0, samples, eps, pair, discount: float):
        """``samples`` [P, A, H, U] from the agents' latents ``z0`` [A, L] -> [P, A]: the rows
        agent-minor, as the program tiles them."""
        pop, agents, horizon, dim_u = samples.shape
        actions = samples.reshape(pop * agents, horizon, dim_u)
        z = z0.repeat(pop, 1)
        total = torch.zeros(z.shape[0], device=z.device)
        gamma = torch.ones((), device=z.device)
        for t in range(horizon):
            a = actions[:, t]
            total = total + gamma * self.reward(z, a)
            z = self.next(z, a)
            gamma = gamma * discount
        total = total + gamma * self.value(z, eps, pair)
        returns = total.reshape(pop, agents)
        return torch.where(torch.isnan(returns), torch.full_like(returns, NAN_RETURN), returns)


def plan_step(model: Model, config: dict, traffic: dict, z0, mean, var, gen_state,
              noise_state, tie: float = TIE, accept=None):
    """One ``act()``'s CEM from the encoded observation ``z0`` [A, L] and the carried ``mean``
    / ``var`` [A, H, U]: the outcomes found, each ``(action [A, U], final mean)``, the
    reference's own ranking first, then those that rounding of the returns by ``tie`` allows,
    as ``planning.plan_step`` searches them."""
    low, high = (float(x) for x in config["action_bounds"])
    kw, horizon = traffic["solver_kwargs"], traffic["planning_horizon"]
    agents, dim_u, device = z0.shape[0], model.dim_u, z0.device
    gen, noise = torch.Generator(device=device), torch.Generator(device=device)
    gen.set_state(gen_state)
    noise.set_state(noise_state)
    shape = (kw["population"], agents, horizon, dim_u)
    k, alpha, iterations = kw["num_elite"], kw["alpha"], kw["max_iterations"]
    draws = []  # one set an iteration, the same on every path
    for _ in range(iterations):
        u = torch.rand(shape, generator=gen, device=device)
        zs = torch.clamp(SQRT2 * torch.erfinv(ERF_LO + (ERF_HI - ERF_LO) * u), -2.0, 2.0)
        eps = torch.randn((kw["population"] * agents, dim_u), generator=noise, device=device)
        pair = torch.rand(model.m["num_q"], generator=noise, device=device).argsort()[:2]
        draws.append((zs, eps, pair))
    count = itertools.count()
    heap = [(0.0, 0, next(count), mean, var)]
    outcomes, rollouts = [], 0
    while heap:
        cost, depth, _, mean, var = heapq.heappop(heap)
        if -depth == iterations:
            outcomes.append((mean[:, 0], mean))
            if accept is not None and accept(*outcomes[-1]):
                break
            continue
        if rollouts == MOST_ROLLOUTS:
            continue
        zs, eps, pair = draws[-depth]
        cap = torch.minimum(((mean - low) / 2.0) ** 2, ((high - mean) / 2.0) ** 2)
        samples = mean + zs * torch.sqrt(torch.minimum(cap, var))
        returns = model.returns(z0, samples, eps, pair, traffic["discount"])
        rollouts += 1
        for gap, best in _alternatives(returns, k, tie):
            elites = torch.stack([samples[best[i], i] for i in range(agents)])
            elite_mean = elites.mean(1)
            elite_var = ((elites - elite_mean[:, None]) ** 2).mean(1)
            heapq.heappush(heap, (cost + gap, depth - 1, next(count),
                                  alpha * mean + (1.0 - alpha) * elite_mean,
                                  alpha * var + (1.0 - alpha) * elite_var))
    return outcomes


def lookahead(model: Model, z0, action):
    """The step's report at ``action``: the next latent and the decoded reward."""
    return model.next(z0, action), model.reward(z0, action)

