"""The fused solver family sharded over a population mesh: CEM (with iCEM's population decay),
PI2/MPPI, RandomSearch and sep-CMA-ES.

Counterpart of ``blackbox_mpc_tpu/ops/fused_sharded.py``. Each rank runs the single-device
kernels of :mod:`~blackbox_mpc_torch.ops.fused_cem` (K4 :func:`fused_rollout`, K6
:func:`elite_moments`, K3 :func:`draw_rows`) on its block of ``P / D`` candidates, drawn from
its own seed, so a D-rank mesh plans over D times the population one card holds, none of it
stored. Per iteration the only traffic between ranks is:

* the ``[P, A]`` rewards (4 bytes a candidate), all-gathered, after which every rank runs the
  top-k, softmax or argsort on the whole vector alike;
* one sum all-reduce of the two ``[A, H*U]`` moment tensors in one buffer, after each rank
  reduced its block of the weights with K6.

The update rules are the single-device solvers', reused through their kernel hooks, so the
state stays replicated. Rank ``r`` draws from ``seed + r * 0x7F4A7C15`` (wrapped to int32 as
JAX's int32 add wraps; :func:`device_seed`): distinct keys of the keyed counter RNG, whose
streams share no run. Any candidate can be drawn again from its owner's seed: RandomSearch's
winner is. On a mesh of one device every seed is the unsharded one and the results are the
single-device solver's bit for bit.

The injected-candidate features (``keep_elites``, ``mean_as_candidate``, ``execute_best``)
are refused, as in JAX, and so is a population the mesh does not divide.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from blackbox_mpc_torch.core.types import Bounds, Solver
from blackbox_mpc_torch.models.dynamics import DynamicsParams, LearnedDynamicsConfig
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.parallel.mesh import POP_AXIS, PopMesh, all_gather_rows, all_reduce_sum
from blackbox_mpc_torch.solvers.cem import CEMConfig
from blackbox_mpc_torch.solvers.pi2 import PI2Config
from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig

__all__ = [
    "device_seed",
    "make_sharded_fused_cem",
    "make_sharded_fused_pi2",
    "make_sharded_fused_random_search",
    "make_sharded_fused_sep_cma",
]

# Makes the D per-rank seeds distinct; the streams' independence comes from the keyed mix of
# the counter RNG, not from this stride.
_SEED_STRIDE = 0x7F4A7C15

DynamicsArg = Union[DynamicsParams, Callable[[], DynamicsParams]]


def device_seed(seed: torch.Tensor, rank: int) -> torch.Tensor:
    """THE per-rank seed, for every kernel call and every row drawn again:
    ``seed + rank * 0x7F4A7C15`` in int32 two's complement, as an int32 ``[1]`` tensor on the
    seed's device (computed in int64 there: no host round trip)."""
    wide = seed.to(torch.int64) + rank * _SEED_STRIDE
    return (((wide + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _local_population(population: int, mesh: PopMesh) -> int:
    if population % mesh.size:
        raise ValueError(
            f"population ({population}) must divide the mesh's {POP_AXIS} axis ({mesh.size})")
    return population // mesh.size


def _reject_injection(config, what: str) -> None:
    if getattr(config, "keep_elites", 0) or getattr(config, "mean_as_candidate", False) \
            or getattr(config, "execute_best", False):
        raise ValueError(
            f"{what} does not support keep_elites/mean_as_candidate/execute_best yet; use the "
            "single-device fused solver or the eager backend")
    if not 0.0 < getattr(config, "population_decay", 1.0) <= 1.0:
        raise ValueError(f"population_decay ({config.population_decay}) must be in (0, 1]")


def _sharded_pair(kernels, mesh: PopMesh, aux_dot: bool = False):
    """``(rollout_rewards, moments)`` over the global population from the pair
    :func:`fc.make_fused_cem_kernels` built at this rank's block of it: K4 on the block with
    the rank's seed, the rewards (and MPPI's dots) gathered; K6 on the block of the weights,
    the two sums reduced over the ranks in one buffer."""
    rollout_local, moments_local = kernels
    rank = mesh.rank

    def rollout_rewards(dp, s0, mean, std, seed, extra=None, gvec=None):
        del extra
        out = rollout_local(dp, s0, mean, std,
                            device_seed(fc._seed_tensor(seed, mean.device), rank), gvec=gvec)
        if aux_dot:  # (rewards, dots), each [P/D, A]: one gather for both
            return all_gather_rows(mesh, torch.stack(out, dim=1)).unbind(1)
        return all_gather_rows(mesh, out)

    def moments(mean, std, seed, weights, extra=None):
        del extra
        p_loc = weights.shape[0] // mesh.size
        rank_seed = device_seed(fc._seed_tensor(seed, std.device), rank)
        csum, csumsq = moments_local(mean, std, rank_seed, weights.narrow(0, rank * p_loc, p_loc))
        total = all_reduce_sum(mesh, torch.stack([csum, csumsq]))
        return total[0], total[1]

    rollout_rewards.local = rollout_local  # this rank's own rewards, at its seed
    return rollout_rewards, moments


def make_sharded_fused_cem(
    config: CEMConfig, bounds: Bounds, dyn_config: LearnedDynamicsConfig, dp: DynamicsArg,
    reward_fn: Callable, mesh: PopMesh, *, tile: int = 256,
) -> Solver:
    """CEM over each rank's fused kernels, the population sharded over ``mesh``: the update of
    :func:`fc.make_fused_cem`, colored noise, ts1 (each rank assigns the members of its own
    block, as JAX's per-device kernels do) and ``population_decay``, each decayed population
    rounded up to a multiple of D (the identity on one device)."""
    _reject_injection(config, "sharded fused CEM")

    def kernels_at(population: int):
        return _sharded_pair(fc.make_fused_cem_kernels(
            dyn_config, reward_fn, horizon=config.planning_horizon, agents=config.num_agents,
            population=_local_population(population, mesh), tile=tile,
            colored_noise_beta=config.colored_noise_beta,
        ), mesh)

    solver = fc.make_fused_cem(config, bounds, dyn_config, dp, reward_fn, tile=tile,
                               _kernels=kernels_at, _round_to=mesh.size)
    return solver._replace(name="CEM-Fused-Sharded")


def make_sharded_fused_pi2(
    config: PI2Config, bounds: Bounds, dyn_config: LearnedDynamicsConfig, dp: DynamicsArg,
    reward_fn: Callable, mesh: PopMesh, *, tile: int = 256,
) -> Solver:
    """PI2/MPPI over each rank's fused kernels: the softmax over the gathered rewards (MPPI's
    control cost from the gathered dots), the weighted moments reduced over the ranks."""
    kernels = fc.make_fused_cem_kernels(
        dyn_config, reward_fn, horizon=config.planning_horizon, agents=config.num_agents,
        population=_local_population(config.population, mesh), tile=tile,
        colored_noise_beta=config.colored_noise_beta, aux_dot=config.control_cost,
        clip_bounds=(bounds.lower, bounds.upper),
    )
    solver = fc.make_fused_pi2(config, bounds, dyn_config, dp, reward_fn, tile=tile,
                               _kernels=_sharded_pair(kernels, mesh, config.control_cost))
    return solver._replace(name=f"{solver.name}-Sharded")


def make_sharded_fused_random_search(
    config: RandomSearchConfig, bounds: Bounds, dyn_config: LearnedDynamicsConfig,
    dp: DynamicsArg, reward_fn: Callable, mesh: PopMesh, *, tile: int = 256,
) -> Solver:
    """Single-shot RandomSearch over each rank's fused kernels: the solve of
    :func:`fc.make_fused_random_search` through its ``_kernels`` hook, the argmax of the
    gathered rewards, its row drawn again from its owner's seed. ``draw_rows`` takes one seed,
    and the owner differs per agent: so each rank draws, with its own seed, the local row every
    agent's winner has in its block, the ``[A, H*U]`` draws are gathered, and each agent keeps
    its owner's (the bits of JAX's ``_mirror_z(owner_seed, ...)``)."""
    fc.check_candidate_layout(config)
    agents, n_flat = config.num_agents, config.planning_horizon * bounds.dim
    p_loc = _local_population(config.population, mesh)
    rollout_rewards, _ = _sharded_pair(fc.make_fused_cem_kernels(
        dyn_config, reward_fn, horizon=config.planning_horizon, agents=agents,
        population=p_loc, tile=tile, sampling="uniform",
    ), mesh)

    def draw_winners(seed, best_idx, agent_ids):  # best_idx: global candidate indices
        local_rows = (best_idx % p_loc) * agents + agent_ids
        drawn = all_gather_rows(mesh, fc.draw_rows(device_seed(seed, mesh.rank), local_rows,
                                                   n_flat, sampling="uniform"))
        return drawn.reshape(mesh.size, agents, n_flat)[best_idx // p_loc, agent_ids]

    return fc.make_fused_random_search(config, bounds, dyn_config, dp, reward_fn, tile=tile,
                                       _kernels=(rollout_rewards, draw_winners),
                                       _name="RandomSearch-Fused-Sharded")


def make_sharded_fused_sep_cma(
    config, bounds: Bounds, dyn_config: LearnedDynamicsConfig, dp: DynamicsArg,
    reward_fn: Callable, mesh: PopMesh, *, tile: int = 256,
) -> Solver:
    """sep-CMA-ES over each rank's fused kernels: the diagonal update of
    :func:`fc.make_fused_sep_cma` through its ``_kernels`` hook, the log-rank weights
    scattered by the order of the gathered rewards. Requires ``config.diagonal=True``."""
    kernels = fc.make_fused_cem_kernels(
        dyn_config, reward_fn, horizon=config.planning_horizon, agents=config.num_agents,
        population=_local_population(config.population, mesh), tile=tile,
        clip_bounds=(bounds.lower, bounds.upper),
    )
    return fc.make_fused_sep_cma(config, bounds, dyn_config, dp, reward_fn, tile=tile,
                                 _kernels=_sharded_pair(kernels, mesh),
                                 _name="sep-CMA-Fused-Sharded")
