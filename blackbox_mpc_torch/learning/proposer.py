"""POPLIN-style plan proposer: a policy network that seeds the trajectory solver.

Counterpart of ``blackbox_mpc_tpu/learning/proposer.py``. A small MLP ``obs -> action``,
squashed into the bounds as ``mid + half * tanh(mlp)``, is behaviour-cloned on the MPC's own
replayed (state, action) pairs. At solve time it is unrolled through the posterior-mean
dynamics for the planning horizon (:func:`make_plan_proposal_fn`), and the resulting plan
replaces the solver's carried plan (``MPCPolicy(proposer=...)``).

The network is a one-member ensemble of :mod:`~blackbox_mpc_torch.models.mlp` (params
``{"w": [1, in, out], "b": [1, out]}`` per layer); training is optax's ``adam`` written out
(:func:`~blackbox_mpc_torch.solvers.base.adam_update`), the minibatch order the JAX
package's ``np.random.default_rng(seed)`` permutations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from blackbox_mpc_torch.core.device import per_device, resolve_device
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.models.mlp import MLPConfig, mlp_apply, mlp_init
from blackbox_mpc_torch.solvers.base import AdamState, adam_update

__all__ = ["ProposerConfig", "PolicyProposer", "make_plan_proposal_fn", "make_proposer_apply"]


@dataclasses.dataclass(frozen=True)
class ProposerConfig:
    dim_s: int
    dim_u: int
    hidden: Sequence[int] = (64, 64)
    activation: str = "tanh"
    learning_rate: float = 1e-3

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(in_dim=self.dim_s, out_dim=self.dim_u, hidden=tuple(self.hidden),
                         activation=self.activation)


def make_proposer_apply(config: ProposerConfig, bounds: Bounds) -> Callable:
    """``(params, obs [B,S]) -> action [B,U]`` squashed into the action bounds."""
    mlp_cfg = config.mlp
    # mid and half, float32 as the JAX package computes them, on each device once.
    squash = per_device(lambda device: tuple(
        torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in ((bounds.lower + bounds.upper) / 2.0, (bounds.upper - bounds.lower) / 2.0)))

    def apply(params, obs: torch.Tensor) -> torch.Tensor:
        mid, half = squash(obs.device)
        return mid + half * torch.tanh(mlp_apply(params, obs, config=mlp_cfg))

    return apply


def make_plan_proposal_fn(
    config: ProposerConfig, bounds: Bounds, mean_dynamics_fn: Callable, horizon: int
) -> Callable:
    """``(proposer_params, dynamics_params, obs [A,S]) -> plan [A,H,U]``: the policy net
    unrolled through the posterior-mean dynamics for ``horizon`` steps."""
    apply = make_proposer_apply(config, bounds)

    def propose(proposer_params, dynamics_params, obs: torch.Tensor) -> torch.Tensor:
        s, actions = obs, []
        for _ in range(horizon):
            a = apply(proposer_params, s)
            s = mean_dynamics_fn(dynamics_params, s, a)
            actions.append(a)
        return torch.stack(actions, dim=1)

    return propose


def _flat(params):
    return [layer[k] for layer in params for k in ("w", "b")]


class PolicyProposer:
    """The proposer's params, its Adam state and behaviour-cloning training, on ``device``
    (default ``"cuda"``). The initial params are a Glorot init drawn from ``seed``; the
    minibatch order draws from ``np.random.default_rng(seed)``, as in the JAX package."""

    def __init__(self, config: ProposerConfig, bounds: Bounds, seed: int = 0, device=None):
        self.config = config
        self.bounds = bounds
        self.device = resolve_device(device)
        self._apply = make_proposer_apply(config, bounds)
        generator = torch.Generator().manual_seed(seed)
        self.params = [{k: v.to(self.device) for k, v in layer.items()}
                       for layer in mlp_init(generator, config.mlp)]
        self._adam = AdamState.zeros_like(_flat(self.params))
        self._rng = np.random.default_rng(seed)

    def _train_step(self, obs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        flat = [p.detach().requires_grad_(True) for p in _flat(self.params)]
        leaves = [{"w": w, "b": b} for w, b in zip(flat[0::2], flat[1::2])]
        with torch.enable_grad():
            loss = torch.mean(torch.square(self._apply(leaves, obs) - target))
            grads = torch.autograd.grad(loss, flat)
        self._adam, updates = adam_update(self._adam, grads, self.config.learning_rate)
        new = [p.detach() + u for p, u in zip(flat, updates)]
        self.params = [{"w": w, "b": b} for w, b in zip(new[0::2], new[1::2])]
        return loss.detach()

    @torch.no_grad()
    def act(self, observations) -> np.ndarray:
        """The distilled reactive policy: one forward pass, no planning."""
        obs = torch.as_tensor(np.atleast_2d(np.asarray(observations, np.float32)),
                              device=self.device)
        return self._apply(self.params, obs).cpu().numpy()

    def train(self, replay, epochs: int = 20, batch_size: int = 256) -> dict:
        """Behaviour cloning on the replay's (state, action) pairs (the MPC's own actions).

        Targets are clipped to the bounds (exploration noise can exceed them). A minibatch
        goes to the device in one pinned copy; the loss of an epoch's last minibatch is read
        once per epoch, as JAX reads it."""
        states, actions, _ = replay.arrays(validation=False)
        n = states.shape[0]
        if n == 0:
            return {"bc_loss": float("nan"), "num_pairs": 0}
        actions = np.clip(actions, self.bounds.lower, self.bounds.upper)
        pairs = np.concatenate([states, actions], axis=-1).astype(np.float32)
        dim_s = self.config.dim_s
        batch_size = min(batch_size, n)
        loss = float("nan")
        for _ in range(epochs):
            order = self._rng.permutation(n)
            last = None
            for start in range(0, n - batch_size + 1, batch_size):
                packed = torch.from_numpy(pairs[order[start:start + batch_size]])
                if self.device.type == "cuda":
                    packed = packed.pin_memory().to(self.device, non_blocking=True)
                last = self._train_step(packed[:, :dim_s], packed[:, dim_s:])
            if last is not None:
                loss = float(last)
        return {"bc_loss": loss, "num_pairs": int(n)}

    # --- checkpointing ---

    def state_dict(self) -> dict:
        """``params`` (the layer list, tensors) and ``adam`` (``step``, ``exp_avg``,
        ``exp_avg_sq``, in the order w, b layer by layer); copies."""
        return {
            "params": [{k: v.detach().clone() for k, v in layer.items()}
                       for layer in self.params],
            "adam": {"step": self._adam.step,
                     "exp_avg": [t.clone() for t in self._adam.exp_avg],
                     "exp_avg_sq": [t.clone() for t in self._adam.exp_avg_sq]},
        }

    def load_state_dict(self, state: dict) -> None:
        """Restores :meth:`state_dict` (shapes checked) on the proposer's device."""
        params = [{k: torch.as_tensor(v, dtype=torch.float32, device=self.device).clone()
                   for k, v in layer.items()} for layer in state["params"]]
        want = [tuple(p.shape) for p in _flat(self.params)]
        if [tuple(p.shape) for p in _flat(params)] != want:
            raise ValueError(f"proposer parameter shapes {[tuple(p.shape) for p in _flat(params)]}"
                             f" do not match the config's {want}")
        adam = state["adam"]
        moments = [[torch.as_tensor(t, dtype=torch.float32, device=self.device).clone()
                    for t in adam[name]] for name in ("exp_avg", "exp_avg_sq")]
        self.params = params
        self._adam = AdamState(int(adam["step"]), *moments)
