"""Dynamics-model training: Adam over the stacked parameters of an MLP ensemble.

Counterpart of ``blackbox_mpc_tpu/learning/trainer.py``. The JAX package ``vmap``s one
member's loss over the ensemble; here every member runs in one batched forward over ``[E]``
(:func:`~blackbox_mpc_torch.models.mlp.ensemble_forward` under autograd, with the cast order of
``models/mlp.py`` in bfloat16; the head stays float32). A member's loss is its mean squared
error on normalized delta targets, or with ``probabilistic=True`` the Gaussian NLL
``mean((mean - target)^2 * exp(-logvar) + logvar)`` with the bounded logvar. The loss is the
sum over members, so each member's gradient is the one it would get if trained alone, plus
with learned logvar bounds the band regularizer ``0.01 * (mean(lv_max) - mean(lv_min))``; the
shared ``[S]`` bounds get every member's gradient. The default optimizer is
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` on the stacked tensors: optax ``adam``
with ``eps_root=0``, elementwise; ``make_trainer(optimizer=)`` takes another.

A step's losses stay on the device: the caller decides when to read them.

Data-parallel training (``mesh``, JAX's minibatch sharding): each rank computes the loss on its
block of the minibatch axis B of ``[E, B, .]``, weighted by its share of the global B, and the
band regularizer divided by D; the gradients and the losses are then summed over the ranks in
one flat buffer, and every rank takes the same optimizer step, so the weights stay replicated.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from blackbox_mpc_torch.models import transforms
from blackbox_mpc_torch.models.dynamics import (
    LearnedDynamicsConfig,
    bound_logvar,
    check_config,
    logvar_bounds,
    map_params,
    net_layers,
)
from blackbox_mpc_torch.models.mlp import ensemble_forward
from blackbox_mpc_torch.models.normalizer import NormalizerStats
from blackbox_mpc_torch.parallel.mesh import all_reduce_sum
from blackbox_mpc_torch.parallel.sharding import shard_population

__all__ = ["TrainState", "flat_params", "make_trainer"]

# optax.adam's defaults.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# PETS' weight of the logvar band regularizer, on per-dim means (JAX trainer.py:86-95).
BOUND_REGULARIZER = 0.01


@dataclasses.dataclass
class TrainState:
    """``params``: the layer list ``{"w": [E, in, out], "b": [E, out]}`` (or the learned-bounds
    dict around it) of leaf tensors that require grad; ``optimizer``: the optimizer over them
    (in :func:`flat_params` order), Adam by default; ``step``: the number of steps taken."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int = 0

    def replace(self, **changes) -> "TrainState":
        """A copy with the given fields changed, as JAX's flax struct ``TrainState`` has; an
        unknown field raises ``TypeError``.

        With ``params=`` and no ``optimizer=``, the copy trains trainable copies of the new
        tensors, as ``init`` does, so the caller's tensors are never stepped: an optimizer of
        the old one's class, ``defaults`` and group sizes over them (in :func:`flat_params`
        order), loaded with a copy of the old one's state, so each leaf's moments carry over
        by position, as JAX's ``opt_state`` does when ``params`` is replaced. This state keeps
        its own optimizer and tensors."""
        if "params" in changes and "optimizer" not in changes:
            params = map_params(lambda v: v.detach().clone().requires_grad_(True),
                                changes["params"])
            changes["params"] = params
            changes["optimizer"] = _rebound(self.optimizer, flat_params(params))
        return dataclasses.replace(self, **changes)


def _rebound(old: torch.optim.Optimizer, tensors: List[torch.Tensor]) -> torch.optim.Optimizer:
    """An optimizer like ``old`` over ``tensors``, with a copy of ``old``'s state by position."""
    sizes = [len(group["params"]) for group in old.param_groups]
    if sum(sizes) != len(tensors):
        raise ValueError(f"params has {len(tensors)} tensors; the optimizer steps {sum(sizes)}")
    groups, start = [], 0
    for size in sizes:
        groups.append({"params": tensors[start:start + size]})
        start += size
    new = type(old)(groups, **old.defaults)
    new.load_state_dict(copy.deepcopy(old.state_dict()))
    return new


def flat_params(params) -> List[torch.Tensor]:
    """The tensors of ``params`` in the optimizer's order: w then b, layer by layer, then
    ``lv_min`` and ``lv_max`` in the learned-bounds layout."""
    flat = [layer[k] for layer in net_layers(params) for k in ("w", "b")]
    lv_min, lv_max = logvar_bounds(params)
    if lv_min is not None:
        flat += [lv_min, lv_max]
    return flat


def make_trainer(config: LearnedDynamicsConfig, learning_rate: float = 1e-3,
                 optimizer: Optional[Callable[[List[torch.Tensor]], torch.optim.Optimizer]] = None,
                 mesh=None):
    """Returns ``(init, train_step, eval_step)``.

    * ``init(params) -> TrainState``: trainable copies of ``params`` and a fresh optimizer;
    * ``train_step(ts, stats, s, a, ns) -> (ts, member_losses [E])``: batches shaped
      ``[E, B, .]`` on the parameters' device; ``ts`` is updated in place and returned;
    * ``eval_step(params, stats, s, a, ns) -> member_losses [E]``, without autograd.

    ``optimizer``: a callable that takes the trainable tensors in :func:`flat_params` order
    and returns a ``torch.optim.Optimizer`` over them (JAX's ``optimizer=`` takes an optax
    transformation); None: ``Adam(lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)``, optax's
    ``adam(learning_rate)``.

    ``mesh`` (a :class:`~blackbox_mpc_torch.parallel.mesh.PopMesh`): ``train_step`` is
    data-parallel over it, every rank passing the same whole minibatch; the losses it returns
    are the global ones. ``eval_step`` is not sharded.
    """
    check_config(config)
    mlp_cfg = config.mlp
    dim_s = config.dim_s
    transform = (transforms.delta_transform if config.predict_delta
                 else transforms.identity_transform)

    def losses(params, stats: NormalizerStats, s, a, ns) -> torch.Tensor:
        target = transform(s, ns)
        if config.normalized:
            x = torch.cat([stats.normalize_states(s), stats.normalize_actions(a)], dim=-1)
            target = stats.normalize_targets(target)
        else:
            x = torch.cat([s, a], dim=-1)
        pred = ensemble_forward([(layer["w"], layer["b"]) for layer in net_layers(params)], x,
                                mlp_cfg.activation, mlp_cfg.compute_dtype)
        if config.probabilistic:
            mean = pred[..., :dim_s]
            logvar = bound_logvar(pred[..., dim_s:], *logvar_bounds(params))
            return (torch.square(mean - target) * torch.exp(-logvar) + logvar).mean(dim=(1, 2))
        return torch.square(pred - target).mean(dim=(1, 2))  # [E]

    def bound_regularizer(params):
        lv_min, lv_max = logvar_bounds(params)
        if lv_min is None:
            return 0.0
        return BOUND_REGULARIZER * (lv_max.mean() - lv_min.mean())

    def init(params) -> TrainState:
        trainable = map_params(lambda v: v.detach().clone().requires_grad_(True), params)
        tensors = flat_params(trainable)
        opt = (torch.optim.Adam(tensors, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)
               if optimizer is None else optimizer(tensors))
        return TrainState(params=trainable, optimizer=opt)

    def train_step(ts: TrainState, stats: NormalizerStats, s, a, ns
                   ) -> Tuple[TrainState, torch.Tensor]:
        ts.optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            member_losses = losses(ts.params, stats, s, a, ns)
            (member_losses.sum() + bound_regularizer(ts.params)).backward()
        else:
            member_losses = sharded_backward(ts.params, stats, s, a, ns)
        ts.optimizer.step()
        ts.step += 1
        return ts, member_losses.detach()

    def sharded_backward(params, stats, s, a, ns) -> torch.Tensor:
        """This rank's share of the loss, backward, then one sum all-reduce of the gradients
        and the member losses; the global gradients are left in ``.grad``."""
        batch = s.shape[1]
        block = [shard_population(mesh, x, axis=1) for x in (s, a, ns)]
        share = block[0].shape[1] / batch
        tensors = flat_params(params)
        member_losses = torch.zeros(config.ensemble_size, device=s.device)
        if share:
            member_losses = losses(params, stats, *block) * share
        total = member_losses.sum() + bound_regularizer(params) / mesh.size
        if total.requires_grad:
            total.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in tensors]
        flat = all_reduce_sum(mesh, torch.cat([g.reshape(-1) for g in grads]
                                              + [member_losses.detach()]))
        for p, g in zip(tensors, torch.split(flat[:-config.ensemble_size],
                                             [g.numel() for g in grads])):
            p.grad = g.view_as(p).clone()
        return flat[-config.ensemble_size:]

    @torch.no_grad()
    def eval_step(params, stats: NormalizerStats, s, a, ns) -> torch.Tensor:
        return losses(params, stats, s, a, ns)

    return init, train_step, eval_step
