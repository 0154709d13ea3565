"""Population sharding of the eager evaluator: each rank rolls out its block of the candidates
and the rewards are all-gathered.

Counterpart of ``blackbox_mpc_tpu/parallel/sharding.py``. JAX constrains the candidate tensor
to be sharded and lets the partitioner split the rollout; here every rank holds the whole,
replicated candidate tensor (drawn from identically seeded generators), rolls out its own
contiguous block of the population (or of the agents) and all-gathers the ``[P, A]`` rewards.
The solvers then reduce over the gathered rewards on every rank alike, so their state stays
replicated. What the partitioner keeps global is kept global here too:

* the rollout noise ``[H, P*K*A, S]`` of sampled propagation is drawn whole and sliced by the
  block's rows;
* ts1/ts_inf give each row the member of its row of the whole batch
  (``models/dynamics.py::global_rows``); the block's rows are grouped by member, each group
  padded to the largest, so a rank runs each member on its own rows only.

First-order solvers differentiate through the evaluator: the gather's backward keeps this
rank's block of the (replicated) reward gradient, and the candidates' gradient, which then
holds only this rank's block, is summed over the ranks, so every rank's Adam sees the whole
gradient.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from blackbox_mpc_torch.core.types import DynamicsFn, RewardFn, TrajectoryEvaluator
from blackbox_mpc_torch.models.dynamics import RowBlock, global_rows
from blackbox_mpc_torch.parallel.mesh import PopMesh, all_gather_rows, all_reduce_sum
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator

__all__ = ["make_sharded_evaluator", "shard_population"]

SHARD_AXES = ("population", "agents")


def shard_population(mesh: PopMesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis`` (:meth:`PopMesh.block`)."""
    start, stop = mesh.block(x.shape[axis])
    return x.narrow(axis, start, stop - start)


class _GatherKeepBlock(torch.autograd.Function):
    """The all-gather of equal blocks along dim 0; its backward keeps this rank's block of the
    output's gradient, which every rank holds alike."""

    @staticmethod
    def forward(ctx, mesh: PopMesh, x: torch.Tensor) -> torch.Tensor:
        ctx.rank, ctx.rows = mesh.rank, x.shape[0]
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return None, grad.narrow(0, ctx.rank * ctx.rows, ctx.rows)


class _SumGradient(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, mesh: PopMesh, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return None, all_reduce_sum(ctx.mesh, grad)


def _block_plan(mesh: PopMesh, n: int, pop: int, k: int, agents: int, by_agents: bool,
                device):
    """``(index, rows, block)`` for this rank: ``index`` the ``ceil(n / D)`` indices of its
    block along the split axis (a short block repeats its last item; the rewards of those
    repeats are dropped after the gather), ``rows`` the global ids of the block's rollout
    rows, row ``(p*K + j)*A + a`` as the evaluator lays them out, and ``block`` their
    :class:`RowBlock`."""
    per = -(-n // mesh.size)
    index = np.minimum(np.arange(mesh.rank * per, (mesh.rank + 1) * per), n - 1)
    if by_agents:
        rows = np.arange(pop * k)[:, None] * agents + index[None, :]
    else:
        rows = (index[:, None, None] * k + np.arange(k)[None, :, None]) * agents \
            + np.arange(agents)[None, None, :]
    rows = rows.reshape(-1)
    return (torch.as_tensor(index, device=device), torch.as_tensor(rows, device=device),
            RowBlock(pop * k * agents, rows))


def make_sharded_evaluator(
    dynamics_fn: DynamicsFn,
    reward_fn: RewardFn,
    mesh: PopMesh,
    *,
    discount: float = 1.0,
    nan_guard: bool = True,
    shard_axis: str = "population",
    num_particles: int = 1,
    remat: bool = False,
    action_smoothness_weight: float = 0.0,
    dynamics_returns_penalty: bool = False,
    time_major: bool = False,
) -> TrajectoryEvaluator:
    """A drop-in for :func:`~blackbox_mpc_torch.rollout.evaluator.make_trajectory_evaluator`
    on ``mesh.device``: ``evaluate(initial_states [A, S], action_sequences [P, A, H, U],
    noise=None) -> rewards [P, A]``, every argument and the result whole on every rank.

    ``shard_axis="population"`` splits the candidates; ``"agents"`` gives each rank whole
    agents. ``time_major``: candidates ``[H, P, A, U]``, the split axis one to the right.
    """
    if shard_axis not in SHARD_AXES:
        raise ValueError(f"shard_axis must be 'population' or 'agents', got {shard_axis!r}")
    by_agents = shard_axis == "agents"
    axis = int(by_agents) + int(time_major)
    base = make_trajectory_evaluator(
        dynamics_fn, reward_fn, discount=discount, nan_guard=nan_guard,
        num_particles=num_particles, remat=remat,
        action_smoothness_weight=action_smoothness_weight,
        dynamics_returns_penalty=dynamics_returns_penalty, time_major=time_major,
        device=mesh.device,
    )

    plans = {}  # _block_plan by shape and device

    def evaluate(initial_states: torch.Tensor, action_sequences: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        grad = torch.is_grad_enabled() and action_sequences.requires_grad

        def gather(rewards):
            return (_GatherKeepBlock.apply(mesh, rewards) if grad
                    else all_gather_rows(mesh, rewards))

        if mesh.size == 1:
            return gather(base(initial_states, action_sequences, noise))
        if grad:
            action_sequences = _SumGradient.apply(mesh, action_sequences)
        pop_axis = 1 if time_major else 0
        n = action_sequences.shape[axis]
        pop, agents = action_sequences.shape[pop_axis], initial_states.shape[0]
        k = num_particles if noise is not None else 1
        key = (n, pop, k, agents, action_sequences.device)
        if key not in plans:
            plans[key] = _block_plan(mesh, n, pop, k, agents, by_agents, key[-1])
        index, rows, block = plans[key]
        local = action_sequences.index_select(axis, index)
        if by_agents:
            initial_states = initial_states.index_select(0, index)
        if noise is not None:
            noise = noise.index_select(1, rows)
        with global_rows(block):
            rewards = base(initial_states, local, noise)  # [P_block, A] or [P, A_block]
        if by_agents:
            rewards = rewards.T.contiguous()
        gathered = gather(rewards)[:n]
        return gathered.T if by_agents else gathered

    return evaluate
