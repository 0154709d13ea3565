"""DynamicsHandler, planning side: owns the dynamics model the MPC policy plans through.

Counterpart of the planning half of ``blackbox_mpc_tpu/learning/handler.py`` (``:41-160``):
the config, the ``DynamicsParams`` and the dynamics functions, for a learned ensemble or a
true (analytic) model. Parameters are set through :meth:`DynamicsHandler.set_params`, for
example from JAX weights carried by :func:`blackbox_mpc_torch.models.convert.
dynamics_params_from_numpy`. Training and checkpoints are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.models.dynamics import (
    DynamicsParams,
    LearnedDynamicsConfig,
    make_learned_dynamics,
)

__all__ = ["DynamicsHandler"]

_TRAINING_TODO = "is not ported yet (ROADMAP Queue 1 item 7, learning)"


class DynamicsHandler:
    """Owns dynamics params for learned models, or wraps a true model."""

    def __init__(
        self,
        config: Optional[LearnedDynamicsConfig] = None,
        true_model: Optional[Callable] = None,
        seed: int = 0,
        device=None,
    ):
        """Exactly one of ``config`` (learned) / ``true_model`` (a torch
        ``(state [B,S], action [B,U]) -> next_state`` function) must be given. Learned
        weights start as a Glorot init drawn from ``seed``."""
        if (config is None) == (true_model is None):
            raise ValueError("provide exactly one of config= or true_model=")
        self._device = resolve_device(device)
        if true_model is not None:
            self._is_true_model = True
            self._config = None
            self._dynamics_fn = lambda dp, state, action: true_model(state, action)
            self._mean_dynamics_fn = self._dynamics_fn
            self._params = None
            return
        self._is_true_model = False
        self._config = config
        init, self._dynamics_fn = make_learned_dynamics(config)
        if config.propagation == "mean":
            self._mean_dynamics_fn = self._dynamics_fn
        else:
            # Posterior-mean variant for the one-step lookahead: a [num_agents, S] probe
            # batch need not divide the ensemble.
            _, self._mean_dynamics_fn = make_learned_dynamics(
                dataclasses.replace(config, propagation="mean")
            )
        self._params = init(torch.Generator().manual_seed(seed)).to(self._device)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_true_model(self) -> bool:
        return self._is_true_model

    @property
    def config(self) -> Optional[LearnedDynamicsConfig]:
        return self._config

    @property
    def dynamics_fn(self) -> Callable:
        """``(DynamicsParams, state [B,S], action [B,U]) -> next_state [B,S]``."""
        return self._dynamics_fn

    @property
    def mean_dynamics_fn(self) -> Callable:
        """Posterior-mean dynamics (ensemble-averaged) for diagnostics; equals
        :attr:`dynamics_fn` unless propagation is member-partitioned (``ts1``)."""
        return self._mean_dynamics_fn

    @property
    def dynamics_params(self) -> Optional[DynamicsParams]:
        return self._params

    def set_params(self, dp: DynamicsParams) -> None:
        """Replaces the learned model's parameters (shapes must match the config)."""
        if self._is_true_model:
            raise RuntimeError("a true-model handler has no parameters")
        old = self._params
        if len(dp.params) != len(old.params) or any(
            new[k].shape != cur[k].shape for new, cur in zip(dp.params, old.params) for k in cur
        ):
            raise ValueError("parameter shapes do not match the handler's config")
        self._params = dp.to(self._device)

    def train(self, *args, **kwargs):
        raise NotImplementedError(f"DynamicsHandler.train {_TRAINING_TODO}")

    def save(self, directory: str) -> None:
        raise NotImplementedError(f"DynamicsHandler.save {_TRAINING_TODO}")

    @classmethod
    def load(cls, directory: str, **kwargs) -> "DynamicsHandler":
        raise NotImplementedError(f"DynamicsHandler.load {_TRAINING_TODO}")
