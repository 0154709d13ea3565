"""The population mesh: which ranks of a ``torch.distributed`` group share a solve, and the two
collectives the sharded paths use.

Counterpart of ``blackbox_mpc_tpu/parallel/mesh.py``. JAX builds a 1-D device mesh with the
axis ``"pop"`` and lets XLA's partitioner insert the collectives; here the mesh is a process
group of ranks, one device each, and the sharded paths call the collectives themselves
(``parallel/sharding.py``, ``ops/fused_sharded.py``, ``learning/trainer.py``).

A mesh of one device needs no process group, and its collectives are the identity (JAX's
``make_pop_mesh(1)`` also runs without ``jax.distributed``). A group of one rank (a 1-rank
NCCL world) runs them for real. Both collectives are one functional sum all-reduce
(``torch.distributed._functional_collectives``): on NCCL it is queued on the stream without a
host wait, and ``torch.export`` records it in a program (``deploy/export.py``'s sharded
artifact). The all-gather is that all-reduce over each rank's block set among zeros, which is
exact (``x + 0 == x``): the functional all-gather itself crashes a ``gloo`` group on CUDA
tensors (torch 2.11, ranks sharing one card), and this form runs on every backend.

JAX's ``pop_sharding``/``replicated_sharding`` have no counterpart: they describe where XLA
places an array, and nothing here places one (ROADMAP: not ported, by decision).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from blackbox_mpc_torch.core.device import resolve_device

__all__ = ["POP_AXIS", "PopMesh", "all_gather_rows", "all_reduce_sum", "make_pop_mesh"]

POP_AXIS = "pop"


@dataclasses.dataclass(frozen=True)
class PopMesh:
    """``size`` ranks of ``group`` (None: one device, no collectives), this process's
    ``rank`` and its ``device``."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return (POP_AXIS,)

    @property
    def shape(self) -> dict:
        return {POP_AXIS: self.size}

    @property
    def group_name(self) -> Optional[str]:
        return None if self.group is None else self.group.group_name

    def block(self, n: int) -> tuple[int, int]:
        """``(start, stop)`` of this rank's contiguous block of ``n`` items: blocks of
        ``ceil(n / size)``, the last ones short or empty when ``size`` does not divide ``n``."""
        per = -(-n // self.size)
        return min(self.rank * per, n), min((self.rank + 1) * per, n)


def make_pop_mesh(num_devices: Optional[int] = None, *, group=None, device=None) -> PopMesh:
    """The mesh over ``group`` (default: the default group), axis name ``"pop"``.

    ``num_devices=None`` means the group's size; another size raises (a mesh spans its
    group: pass ``group=`` for a subset). Without an initialized process group only a mesh of
    one device exists. ``device=None`` is ``cuda:<rank % cards>``: one card per rank, or ranks
    sharing the cards in turn (two ranks on one card need the ``gloo`` backend: NCCL refuses
    them).
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        if num_devices not in (None, 1):
            raise ValueError(f"a mesh of {num_devices} devices needs an initialized process "
                             "group (parallel.initialize_multihost)")
        return PopMesh(group=None, size=1, rank=0, device=resolve_device(device))
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}, but the process group has {size} ranks")
    if device is None:
        device = torch.device("cuda", rank % torch.cuda.device_count()) \
            if torch.cuda.is_available() else resolve_device(None)
    return PopMesh(group=group, size=size, rank=rank, device=resolve_device(device))


def _waited(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_gather_rows(mesh: PopMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along dim 0 in rank order."""
    if mesh.group is None:
        return x
    rows, rest = x.shape[0], x.shape[1:]
    return all_reduce_sum(mesh, torch.cat([x.new_zeros((mesh.rank * rows, *rest)), x,
                                           x.new_zeros(((mesh.size - 1 - mesh.rank) * rows,
                                                        *rest))]))


def all_reduce_sum(mesh: PopMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, a new tensor."""
    if mesh.group is None:
        return x
    return _waited(funcol.all_reduce(x.contiguous(), "sum", mesh.group))
