"""Learned-dynamics wrappers: from MLP params and normalizer stats to a rollout-ready
``dynamics_fn(dp, state, action, noise=None) -> next_state``.

Counterpart of ``blackbox_mpc_tpu/models/dynamics.py``, with its four propagations:

* ``"mean"``: average the member predictions each step;
* ``"ts1"``: row ``i`` runs member ``ts_member_ids(B, E)[i]`` (a balanced, seeded shuffle)
  for the whole horizon; batches not divisible by E are edge-padded by fewer than E rows;
* ``"ts_inf"``: the same member assignment, plus a Gaussian sample from the probabilistic head
  at every step, ``mean + exp(logvar / 2) * noise`` (PETS TS-inf);
* ``"mm"``: every member on every row, the E Gaussians moment-matched into one
  (``E[var] + Var[mean]``) and sampled once (PETS MM).

The randomness is an argument: ``noise`` is a ``[B, S]`` tensor of standard normals (JAX
passes a key instead), and ``noise=None`` gives the head means, as ``key=None`` does in JAX.

Unlike the JAX package, the member stacks always carry the leading ``[E]`` axis, also for
``ensemble_size=1`` (the weight bridge adds it). With ``probabilistic=True`` and
``learn_logvar_bounds=True`` the params are ``{"net": <layers>, "lv_min": [S], "lv_max": [S]}``,
the bounds shared by every member; otherwise they are the layer list itself.
:func:`net_layers`, :func:`logvar_bounds` and :func:`map_params` read either layout.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from collections.abc import Mapping
from typing import Any, Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from blackbox_mpc_torch.models import transforms
from blackbox_mpc_torch.models.mlp import MLPConfig, ensemble_apply, ensemble_init
from blackbox_mpc_torch.models.normalizer import NormalizerStats, identity_stats

__all__ = [
    "DynamicsParams", "LearnedDynamicsConfig", "RowBlock", "bound_logvar", "global_rows",
    "logvar_bounds", "make_learned_dynamics", "make_penalized_dynamics", "map_params",
    "member_permutation", "net_layers", "true_model_dynamics", "ts_member_ids",
]

# Soft logvar bounds of the probabilistic head (PETS): keep the NLL well-conditioned.
_MAX_LOGVAR = 0.5
_MIN_LOGVAR = -10.0


def ts_member_ids(n: int, ensemble: int) -> np.ndarray:
    """Balanced member assignment for TS propagation: row ``i`` runs member ``ids[i]``.

    A seeded static shuffle of ``[0..E)`` tiled to ``n`` rows, the same numbers as
    ``blackbox_mpc_tpu.models.dynamics.ts_member_ids``: ``i % E`` would alias with the
    agent stride of the agent-minor batch layout.
    """
    if n % ensemble:
        raise ValueError(f"n ({n}) must be a multiple of ensemble ({ensemble})")
    ids = np.tile(np.arange(ensemble, dtype=np.int32), n // ensemble)
    np.random.default_rng(0x75B007).shuffle(ids)
    return ids


@functools.lru_cache(maxsize=None)
def member_permutation(n: int, ensemble: int, device: torch.device):
    """``(perm, inv)`` on ``device``: ``perm`` groups the rows of ``ts_member_ids(n, E)``
    member-major in equal blocks, ``inv`` undoes it. Made once per ``(n, E, device)``, as
    JAX makes them compile-time constants: a copy from numpy at every step would make the
    host wait for the stream twice a step."""
    perm = np.argsort(ts_member_ids(n, ensemble), kind="stable")
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(np.argsort(perm), device=device))


class RowBlock:
    """The rows ``row_ids`` ([B] ints, numpy) of a batch of ``total`` rows: the block that one
    rank rolls out (``parallel/sharding.py``). Under :func:`global_rows`, ts1/ts_inf give the
    batch's row ``i`` the member of row ``row_ids[i]`` of the whole batch, as JAX's partitioner
    keeps the whole batch's assignment."""

    def __init__(self, total: int, row_ids: np.ndarray):
        self.total = total
        self.row_ids = np.asarray(row_ids, dtype=np.int64)
        self._partitions = {}

    def partition(self, ensemble: int, device: torch.device):
        """``(perm, inv, width)`` on ``device``, made once per ``(E, device)``: ``perm``
        ([E * width]) lays the block's rows out member-major, each member's group padded to
        the largest (``width``) with row 0, and ``inv`` ([B]) takes each row's output back.
        The block's members need not be balanced: the padding is all the extra work."""
        key = (ensemble, device)
        if key not in self._partitions:
            total = self.total + (-self.total) % ensemble
            members = ts_member_ids(total, ensemble)[self.row_ids]
            counts = np.bincount(members, minlength=ensemble)
            width = max(int(counts.max(initial=0)), 1)
            order = np.argsort(members, kind="stable")
            starts = np.cumsum(counts) - counts
            perm = np.zeros((ensemble, width), dtype=np.int64)
            inv = np.empty(len(members), dtype=np.int64)
            for e in range(ensemble):
                rows = order[starts[e]:starts[e] + counts[e]]
                perm[e, :counts[e]] = rows
                inv[rows] = e * width + np.arange(counts[e])
            self._partitions[key] = (torch.as_tensor(perm.reshape(-1), device=device),
                                     torch.as_tensor(inv, device=device), width)
        return self._partitions[key]


# The RowBlock of the batch being rolled out, set by global_rows. A context, because the
# evaluator's dynamics contract is (state, action[, noise]): the block reaches the model
# without every dynamics function taking one more argument.
_ROW_BLOCK = contextvars.ContextVar("global_rows", default=None)


@contextlib.contextmanager
def global_rows(block: RowBlock):
    """Within the block, ts1/ts_inf assign members by the rows of the whole batch
    (:class:`RowBlock`)."""
    token = _ROW_BLOCK.set(block)
    try:
        yield
    finally:
        _ROW_BLOCK.reset(token)


def net_layers(params) -> list:
    """The MLP layer stack of ``params`` (the list itself, or ``params["net"]``)."""
    return params["net"] if isinstance(params, Mapping) else params


def logvar_bounds(params):
    """``(lv_min, lv_max)``, the learned ``[S]`` bounds, or ``(None, None)`` for the fixed
    ones."""
    if isinstance(params, Mapping):
        return params["lv_min"], params["lv_max"]
    return None, None


def map_params(fn: Callable, params):
    """``params`` with ``fn`` applied to every tensor, in the same layout."""
    layers = [{k: fn(v) for k, v in layer.items()} for layer in net_layers(params)]
    if isinstance(params, Mapping):
        return {"net": layers, "lv_min": fn(params["lv_min"]), "lv_max": fn(params["lv_max"])}
    return layers


@dataclasses.dataclass(frozen=True)
class DynamicsParams:
    """Everything the dynamics function needs at call time."""

    params: Any  # list of {"w": [E, in, out], "b": [E, out]}, or the learned-bounds dict
    stats: NormalizerStats

    def replace(self, **changes) -> "DynamicsParams":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "DynamicsParams":
        return DynamicsParams(params=map_params(lambda v: v.to(device), self.params),
                              stats=self.stats.to(device))


@dataclasses.dataclass(frozen=True)
class LearnedDynamicsConfig:
    dim_s: int
    dim_u: int
    hidden: tuple = (32, 32, 32)
    activation: str = "tanh"
    ensemble_size: int = 1
    propagation: str = "mean"  # "mean" | "ts1" | "ts_inf" | "mm"
    # ts_inf/mm only: each candidate is rolled out this many times and the returns averaged
    # (rollout/evaluator.py).
    num_particles: int = 1
    normalized: bool = True
    predict_delta: bool = True
    # Gaussian head: the network predicts (mean, logvar) per state dim and trains with the
    # Gaussian NLL; "mean" and "ts1" plan on the means.
    probabilistic: bool = False
    # With probabilistic=True: the logvar bounds are [S] parameters shared by the members,
    # trained with the band regularizer 0.01 * (mean(lv_max) - mean(lv_min)). Ignored without
    # probabilistic=True, as in JAX.
    learn_logvar_bounds: bool = False
    # Pessimistic planning: each rollout step subtracts lambda * mean_S(std_E(member means)),
    # in normalized-target space. Needs an ensemble and propagation "mean" or "mm".
    plan_uncertainty_penalty: float = 0.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.dim_s + self.dim_u,
            out_dim=self.dim_s * (2 if self.probabilistic else 1),
            hidden=tuple(self.hidden),
            activation=self.activation,
            compute_dtype=self.compute_dtype,
        )


def bound_logvar(logvar: torch.Tensor, lv_min=None, lv_max=None) -> torch.Tensor:
    """Soft-bounds the raw logvar head into ``[lv_min, lv_max]`` (default: the fixed PETS
    constants; the learned ``[S]`` bounds broadcast over the batch).

    JAX's softplus is ``logaddexp(x, 0)``; torch's returns ``x`` above 20, where the two
    differ by less than ``log1p(exp(-20)) = 2e-9``, below float32's resolution there.
    """
    lo = _MIN_LOGVAR if lv_min is None else lv_min
    hi = _MAX_LOGVAR if lv_max is None else lv_max
    logvar = hi - F.softplus(hi - logvar)
    return lo + F.softplus(logvar - lo)


def check_config(config: LearnedDynamicsConfig) -> None:
    """Raises the JAX package's ``ValueError`` for a configuration it refuses."""
    if config.propagation not in ("mean", "ts1", "ts_inf", "mm"):
        raise ValueError(f"unknown propagation {config.propagation!r}")
    if config.propagation in ("ts_inf", "mm") and not config.probabilistic:
        raise ValueError(
            f"propagation={config.propagation!r} samples the Gaussian head: set probabilistic=True"
        )
    if config.plan_uncertainty_penalty < 0:
        raise ValueError(
            f"plan_uncertainty_penalty must be >= 0, got {config.plan_uncertainty_penalty}"
        )
    if config.plan_uncertainty_penalty > 0:
        if config.ensemble_size <= 1:
            raise ValueError(
                "plan_uncertainty_penalty needs an ensemble (ensemble_size > 1): the "
                "penalty is the members' disagreement"
            )
        if config.propagation not in ("mean", "mm"):
            raise ValueError(
                "plan_uncertainty_penalty requires propagation 'mean' or 'mm' (ts1/ts_inf "
                "run a single member per row — no per-row disagreement is available); got "
                f"{config.propagation!r}"
            )


def make_learned_dynamics(
    config: LearnedDynamicsConfig, return_penalized: bool = False,
) -> Tuple[Callable[[torch.Generator], DynamicsParams], Callable]:
    """Returns ``(init, dynamics_fn)``.

    ``init(generator) -> DynamicsParams``: Glorot weights drawn from ``generator`` on its
    device, identity stats, and with learned bounds the fixed constants as their start.
    ``dynamics_fn(dp, state [B,S], action [B,U], noise=None) -> next_state [B,S]`` runs
    normalize -> MLP -> head -> denormalize -> inverse transform; ``noise`` ([B, S] standard
    normals) is read by ``ts_inf`` and ``mm`` only.

    ``return_penalized=True`` appends the uncertainty-penalized step
    ``fn(dp, state, action, noise=None) -> (next_state, penalty [B])`` (prefer
    :func:`make_penalized_dynamics`).
    """
    check_config(config)
    mlp_cfg = config.mlp
    ensemble = config.ensemble_size
    dim_s = config.dim_s
    learn_lv = config.probabilistic and config.learn_logvar_bounds
    inverse = (
        transforms.delta_inverse_transform
        if config.predict_delta
        else transforms.identity_inverse_transform
    )

    def init(generator: torch.Generator) -> DynamicsParams:
        device = generator.device
        params = ensemble_init(generator, mlp_cfg, ensemble)
        if learn_lv:
            params = {
                "net": params,
                "lv_min": torch.full((dim_s,), _MIN_LOGVAR, device=device),
                "lv_max": torch.full((dim_s,), _MAX_LOGVAR, device=device),
            }
        return DynamicsParams(params=params,
                              stats=identity_stats(dim_s, config.dim_u, device=device))

    def _net_input(dp: DynamicsParams, state, action):
        if config.normalized:
            return torch.cat(
                [dp.stats.normalize_states(state), dp.stats.normalize_actions(action)], dim=-1
            )
        return torch.cat([state, action], dim=-1)

    def _target_to_state(dp: DynamicsParams, state, raw_target):
        target = dp.stats.denormalize_targets(raw_target) if config.normalized else raw_target
        return inverse(state, target)

    def _head(raw: torch.Tensor, noise, lv) -> torch.Tensor:
        """The prediction in normalized-target space: the means, or with ``noise`` one
        Gaussian sample per row."""
        if not config.probabilistic:
            return raw
        mean = raw[..., :dim_s]
        if noise is None:
            return mean
        logvar = bound_logvar(raw[..., dim_s:], *lv)
        return mean + torch.exp(0.5 * logvar) * noise

    def _mm_head(raw_all: torch.Tensor, noise, lv) -> torch.Tensor:
        """Moment-matches the E Gaussians ``[E, B, 2S]`` into one and samples it:
        mu = mean_e(mu_e), var = mean_e(var_e + mu_e^2) - mu^2."""
        mu_e = raw_all[..., :dim_s]
        mu = mu_e.mean(0)
        if noise is None:
            return mu
        var_e = torch.exp(bound_logvar(raw_all[..., dim_s:], *lv))
        var = torch.clamp((var_e + torch.square(mu_e)).mean(0) - torch.square(mu), min=0.0)
        return mu + torch.sqrt(var) * noise

    def _member_partitioned(layers, x: torch.Tensor) -> torch.Tensor:
        """Row i of x through member ts_member_ids(B, E)[i] (see the JAX counterpart); inside
        :func:`global_rows`, through the member of its row of the whole batch."""
        batch = x.shape[0]
        block = _ROW_BLOCK.get()
        if block is not None:
            if len(block.row_ids) != batch:
                raise ValueError(f"global_rows names {len(block.row_ids)} rows, the batch has "
                                 f"{batch}")
            perm, inv, width = block.partition(ensemble, x.device)
            raw_groups = ensemble_apply(layers, x[perm].reshape(ensemble, width, -1),
                                        config=mlp_cfg)
            return raw_groups.reshape(ensemble * width, -1)[inv]
        pad = (-batch) % ensemble
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, -1)], dim=0)
        n = batch + pad
        perm, inv = member_permutation(n, ensemble, x.device)
        x_groups = x[perm].reshape(ensemble, n // ensemble, -1)
        raw_groups = ensemble_apply(layers, x_groups, config=mlp_cfg)
        return raw_groups.reshape(n, -1)[inv][:batch]

    def dynamics_fn(dp: DynamicsParams, state: torch.Tensor, action: torch.Tensor,
                    noise: torch.Tensor | None = None):
        x = _net_input(dp, state, action)
        layers, lv = net_layers(dp.params), logvar_bounds(dp.params)
        if config.propagation == "mm":
            raw_all = ensemble_apply(layers, x, config=mlp_cfg)
            return _target_to_state(dp, state, _mm_head(raw_all, noise, lv))
        if ensemble <= 1:
            raw = ensemble_apply(layers, x, config=mlp_cfg)[0]
        elif config.propagation == "mean":
            raw = ensemble_apply(layers, x, config=mlp_cfg).mean(0)
        else:  # "ts1" | "ts_inf": fixed per-row member assignment
            raw = _member_partitioned(layers, x)
        sample = noise if config.propagation == "ts_inf" else None
        return _target_to_state(dp, state, _head(raw, sample, lv))

    def penalized_dynamics_fn(dp: DynamicsParams, state: torch.Tensor, action: torch.Tensor,
                              noise: torch.Tensor | None = None):
        """``(next_state, penalty [B])``: the step of ``dynamics_fn`` ("mean" or "mm") and
        ``lambda * mean_S(std_E(member means))`` in normalized-target space (population
        std, as ``jnp.std``)."""
        x = _net_input(dp, state, action)
        layers, lv = net_layers(dp.params), logvar_bounds(dp.params)
        raw_all = ensemble_apply(layers, x, config=mlp_cfg)  # [E, B, .]
        mu_e = raw_all[..., :dim_s] if config.probabilistic else raw_all
        disagreement = torch.std(mu_e.float(), dim=0, correction=0).mean(-1)
        penalty = config.plan_uncertainty_penalty * disagreement
        if config.propagation == "mm":
            next_state = _target_to_state(dp, state, _mm_head(raw_all, noise, lv))
        else:  # "mean"
            next_state = _target_to_state(dp, state, _head(raw_all.mean(0), None, lv))
        return next_state, penalty

    if return_penalized:
        return init, dynamics_fn, penalized_dynamics_fn
    return init, dynamics_fn


def make_penalized_dynamics(config: LearnedDynamicsConfig) -> Callable:
    """The uncertainty-penalized planning step for ``plan_uncertainty_penalty > 0``:
    ``fn(dp, state, action, noise=None) -> (next_state, penalty [B])``, for the evaluator's
    ``dynamics_returns_penalty=True``; ``MPCPolicy`` wires it when the handler's config sets
    the penalty."""
    if config.plan_uncertainty_penalty <= 0:
        raise ValueError("make_penalized_dynamics needs plan_uncertainty_penalty > 0")
    return make_learned_dynamics(config, return_penalized=True)[2]


def true_model_dynamics(analytic_fn: Callable) -> Callable:
    """An analytic ``(state, action) -> next_state`` in the learned models' calling
    convention ``(dp, state, action, noise=None)``."""

    def dynamics_fn(dp, state, action, noise=None):
        del dp, noise
        return analytic_fn(state, action)

    return dynamics_fn
