"""Multi-process initialization and data-exchange helpers.

Counterpart of ``blackbox_mpc_tpu/parallel/multihost.py``. The same program runs in every
process (one rank per device): call :func:`initialize_multihost` first, build the mesh with
:func:`~blackbox_mpc_torch.parallel.mesh.make_pop_mesh`, and give every rank the same
observations and the same seeds. The sharded paths then keep the solver state, the actions and
the trained weights replicated: every rank runs the same collectives in the same order.

A 2-rank world on the CPU, e.g. in two processes::

    initialize_multihost("file:///tmp/bbmpc-store", 2, rank, device="cpu")
    mesh = make_pop_mesh(device="cpu")

and under ``torchrun --nproc-per-node=N`` with no arguments at all.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from blackbox_mpc_torch.core.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "initialize_multihost",
    "is_multihost",
    "local_agent_slice",
    "fetch_replicated",
    "replicate_to_global",
]

# torchrun's environment: with it, init_process_group reads the rest from env://.
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> None:
    """Initializes the default ``torch.distributed`` process group.

    ``coordinator_address`` is ``host:port`` (``tcp://`` is prepended) or an init URL such as
    ``file:///path/store``. ``backend=None`` takes ``nccl`` when ``device`` (None: ``cuda``)
    is a CUDA device and ``gloo`` otherwise; ranks that share a card must pass ``"gloo"``.

    With explicit arguments a failure propagates: the caller asked for a distributed run, and
    going on alone would be wrong. With none, the environment ``torchrun`` sets is used if
    present, and otherwise the process logs and stays single-process.
    """
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize_multihost needs coordinator_address, num_processes "
                             "and process_id together")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is outside [0, {num_processes})")
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=init, world_size=num_processes, rank=process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        kwargs = dict(init_method="env://")
    else:
        logger.info("no coordinator and no torchrun environment; continuing single-process")
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, **kwargs)
    logger.info("torch.distributed initialized (%s): rank %d of %d", backend,
                dist.get_rank(), dist.get_world_size())


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return _rank_and_size()[1] > 1


def local_agent_slice(num_agents: int) -> slice:
    """The agents this process owns when env stepping is split per process: even blocks, the
    last process taking the remainder (the MPC solve itself is global)."""
    rank, size = _rank_and_size()
    per = num_agents // size
    start = rank * per
    return slice(start, start + per if rank < size - 1 else num_agents)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """The host value of a replicated tensor: every rank holds all of it."""
    return x.detach().cpu().numpy()


def replicate_to_global(x, mesh) -> torch.Tensor:
    """A host value that every rank holds alike, on this rank's device of ``mesh``."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)
