"""The dynamics ensemble's first optimizer steps written out plainly.

Each member fits the normalized state delta of its own minibatch. The normalizer is the
per-column mean and population standard deviation of the training rows' states, actions and
deltas. A member's loss is the Gaussian negative log-likelihood of PETS,
``mean((mu - target)^2 exp(-logvar) + logvar)`` over its rows and state dimensions, with the
log-variance soft-bounded by the learned bounds (or the mean squared error for a
deterministic head); the objective is the members' sum plus ``0.01 (mean(lv_max) -
mean(lv_min))``. Adam (Kingma and Ba, with bias correction; beta 0.9 and 0.999, eps 1e-8)
steps every tensor, in the order: each layer's weight and bias, then ``lv_min`` and
``lv_max``.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.model import Model

__all__ = ["fit_stats", "leaves", "member_losses", "adam_steps"]

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BAND = 0.01


def fit_stats(states: np.ndarray, actions: np.ndarray, next_states: np.ndarray) -> dict:
    """Float32 statistics, computed in float64 from the training rows."""
    out = {}
    for name, x in (("states", states), ("actions", actions),
                    ("targets", next_states.astype(np.float64) - states)):
        x = np.asarray(x, np.float64)
        out[f"mean_{name}"] = x.mean(0).astype(np.float32)
        out[f"std_{name}"] = x.std(0).astype(np.float32)
    return out


def leaves(weights) -> list:
    """The trained tensors in the optimizer's order."""
    flat = [t for pair in weights.layers for t in pair]
    if weights.lv_min is not None:
        flat += [weights.lv_min, weights.lv_max]
    return flat


class _Trainable:
    """The weights of ``Model`` from a flat list of leaves."""

    def __init__(self, flat, learned_bounds: bool):
        n = len(flat) - (2 if learned_bounds else 0)
        self.layers = [(flat[i], flat[i + 1]) for i in range(0, n, 2)]
        self.lv_min, self.lv_max = (flat[n], flat[n + 1]) if learned_bounds else (None, None)


def member_losses(config: dict, model: Model, s, a, ns, half: bool = False):
    """Each member's loss on its minibatch ``[E, B, .]`` (``half``: over the first half of
    the rows only, the fault of a step that leaves out half its batch)."""
    if half:
        cut = s.shape[1] // 2
        s, a, ns = s[:, :cut], a[:, :cut], ns[:, :cut]
    st = model.stats
    target = (ns - s - st["mean_targets"]) / (st["std_targets"] + 1e-7)
    raw = model.net(model.net_input(s, a))
    mean = raw[..., :model.dim_s]
    if not model.probabilistic:
        return ((mean - target) ** 2).mean(dim=(1, 2))
    logvar = model.bounded_logvar(raw[..., model.dim_s:])
    return ((mean - target) ** 2 * torch.exp(-logvar) + logvar).mean(dim=(1, 2))


def adam_steps(config: dict, weights, stats: dict, batches, learning_rate: float,
               half: bool = False):
    """Adam over ``batches`` (a list of ``(s, a, ns)`` ``[E, B, .]``) from ``weights``.
    Returns ``(losses [steps, E], the first gradient by leaf, the leaves after the last
    step)``."""
    learned = weights.lv_min is not None
    params = [t.detach().clone().requires_grad_(True) for t in leaves(weights)]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first_grad = [], None
    for step, (s, a, ns) in enumerate(batches, start=1):
        model = Model(config, _Trainable(params, learned), stats, s.device)
        per_member = member_losses(config, model, s, a, ns, half=half)
        objective = per_member.sum()
        if learned:
            objective = objective + BAND * (params[-1].mean() - params[-2].mean())
        grads = torch.autograd.grad(objective, params)
        if first_grad is None:
            first_grad = [g.detach().clone() for g in grads]
        losses.append(per_member.detach())
        with torch.no_grad():
            c1, c2 = 1.0 - BETAS[0] ** step, 1.0 - BETAS[1] ** step
            for p, g, m_i, v_i in zip(params, grads, m, v):
                m_i.mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v_i.mul_(BETAS[1]).add_(g * g, alpha=1.0 - BETAS[1])
                p.sub_(learning_rate * (m_i / c1) / (torch.sqrt(v_i / c2) + ADAM_EPS))
    return torch.stack(losses), first_grad, [p.detach() for p in params]
