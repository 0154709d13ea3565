"""Solver registry: one factory per trajectory optimizer, keyed by name.

Counterpart of ``blackbox_mpc_tpu/solvers/__init__.py``. Only CEM is ported so far; the other
names of the JAX registry raise ``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers.base import SolverConfig
from blackbox_mpc_torch.solvers.cem import CEMConfig, CEMState, make_cem

SOLVER_REGISTRY: Dict[str, Tuple[Type[SolverConfig], Callable]] = {
    "CEM": (CEMConfig, make_cem),
}

# Solvers of the JAX package that the port does not have yet.
UNPORTED_SOLVERS = frozenset(
    {"CEM-GD", "CMA-ES", "Gradient", "MPPI", "PI2", "PSO", "RandomSearch", "SPSA"}
)


def lookup(name: str):
    """``(ConfigClass, factory)`` of ``name``; raises for unported and unknown names."""
    if name in UNPORTED_SOLVERS:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet (ROADMAP Queue 1 item 10); "
            f"ported: {sorted(SOLVER_REGISTRY)}"
        )
    try:
        return SOLVER_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; available: {sorted(SOLVER_REGISTRY)}") from None


def make_solver(
    name: str, bounds: Bounds, evaluate: TrajectoryEvaluator, **config_kwargs
) -> Solver:
    """Builds a solver by registry name, forwarding kwargs into its config dataclass."""
    config_cls, factory = lookup(name)
    return factory(config_cls(**config_kwargs), bounds, evaluate)


__all__ = [
    "SOLVER_REGISTRY", "UNPORTED_SOLVERS", "lookup", "make_solver", "Solver", "SolverAux",
    "SolverConfig", "CEMConfig", "CEMState", "make_cem",
]
