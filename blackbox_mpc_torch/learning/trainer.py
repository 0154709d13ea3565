"""Dynamics-model training: Adam over the stacked parameters of an MLP ensemble.

Counterpart of ``blackbox_mpc_tpu/learning/trainer.py``. The JAX package ``vmap``s one
member's loss over the ensemble; here every member runs in one batched forward over ``[E]``
(:func:`~blackbox_mpc_torch.models.mlp.ensemble_forward` under autograd, with the cast order of
``models/mlp.py`` in bfloat16). The loss is the sum over members of each member's mean squared
error on normalized delta targets, so each member's gradient is the one it would get if trained
alone. The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` on the stacked
``[E, ...]`` tensors: optax ``adam`` with ``eps_root=0``, elementwise.

A step's losses stay on the device: the caller decides when to read them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from blackbox_mpc_torch.models import transforms
from blackbox_mpc_torch.models.dynamics import LearnedDynamicsConfig, check_config
from blackbox_mpc_torch.models.mlp import ensemble_forward
from blackbox_mpc_torch.models.normalizer import NormalizerStats

__all__ = ["TrainState", "flat_params", "make_trainer"]

# optax.adam's defaults.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """``params``: list of ``{"w": [E, in, out], "b": [E, out]}`` leaf tensors that require
    grad; ``optimizer``: the Adam over them (in :func:`flat_params` order); ``step``: the
    number of steps taken."""

    params: List[dict]
    optimizer: torch.optim.Adam
    step: int = 0


def flat_params(params) -> List[torch.Tensor]:
    """The tensors of ``params`` in the optimizer's order: w then b, layer by layer."""
    return [layer[k] for layer in params for k in ("w", "b")]


def make_trainer(config: LearnedDynamicsConfig, learning_rate: float = 1e-3, mesh=None):
    """Returns ``(init, train_step, eval_step)``.

    * ``init(params) -> TrainState``: trainable copies of ``params`` and a fresh Adam;
    * ``train_step(ts, stats, s, a, ns) -> (ts, member_losses [E])``: batches shaped
      ``[E, B, .]`` on the parameters' device; ``ts`` is updated in place and returned;
    * ``eval_step(params, stats, s, a, ns) -> member_losses [E]``, without autograd.

    ``probabilistic=True`` (the Gaussian NLL) and ``mesh`` are not ported yet and raise.
    """
    check_config(config)
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is not ported yet (ROADMAP Queue 1 item 9)")
    mlp_cfg = config.mlp
    transform = (transforms.delta_transform if config.predict_delta
                 else transforms.identity_transform)

    def losses(params, stats: NormalizerStats, s, a, ns) -> torch.Tensor:
        target = transform(s, ns)
        if config.normalized:
            x = torch.cat([stats.normalize_states(s), stats.normalize_actions(a)], dim=-1)
            target = stats.normalize_targets(target)
        else:
            x = torch.cat([s, a], dim=-1)
        pred = ensemble_forward([(layer["w"], layer["b"]) for layer in params], x,
                                mlp_cfg.activation, mlp_cfg.compute_dtype)
        return torch.square(pred - target).mean(dim=(1, 2))  # [E]

    def init(params) -> TrainState:
        trainable = [{k: v.detach().clone().requires_grad_(True) for k, v in layer.items()}
                     for layer in params]
        optimizer = torch.optim.Adam(flat_params(trainable), lr=learning_rate,
                                     betas=ADAM_BETAS, eps=ADAM_EPS)
        return TrainState(params=trainable, optimizer=optimizer)

    def train_step(ts: TrainState, stats: NormalizerStats, s, a, ns
                   ) -> Tuple[TrainState, torch.Tensor]:
        ts.optimizer.zero_grad(set_to_none=True)
        member_losses = losses(ts.params, stats, s, a, ns)
        member_losses.sum().backward()
        ts.optimizer.step()
        ts.step += 1
        return ts, member_losses.detach()

    @torch.no_grad()
    def eval_step(params, stats: NormalizerStats, s, a, ns) -> torch.Tensor:
        return losses(params, stats, s, a, ns)

    return init, train_step, eval_step
