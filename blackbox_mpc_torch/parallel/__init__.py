"""Sharding over ``torch.distributed``: the population mesh, multi-process set-up and the
sharded evaluator (counterpart of ``blackbox_mpc_tpu/parallel``). The sharded fused solvers are
in :mod:`blackbox_mpc_torch.ops.fused_sharded`."""
from blackbox_mpc_torch.parallel.mesh import POP_AXIS, PopMesh, make_pop_mesh
from blackbox_mpc_torch.parallel.multihost import (
    fetch_replicated,
    initialize_multihost,
    is_multihost,
    local_agent_slice,
    replicate_to_global,
)
from blackbox_mpc_torch.parallel.sharding import make_sharded_evaluator, shard_population

__all__ = [
    "POP_AXIS",
    "PopMesh",
    "make_pop_mesh",
    "make_sharded_evaluator",
    "shard_population",
    "initialize_multihost",
    "is_multihost",
    "local_agent_slice",
    "fetch_replicated",
    "replicate_to_global",
]
