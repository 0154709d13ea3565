from blackbox_mpc_torch.core.device import resolve_device
from blackbox_mpc_torch.core.spaces import BoxSpace, as_box_space
from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, truncated_normal

__all__ = [
    "Bounds", "BoxSpace", "Solver", "SolverAux", "as_box_space", "resolve_device",
    "truncated_normal",
]
