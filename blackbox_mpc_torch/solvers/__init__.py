"""Solver registry: one factory per trajectory optimizer, keyed by name.

Counterpart of ``blackbox_mpc_tpu/solvers/__init__.py``. Ported: CEM (with the iCEM options),
PI2, MPPI, RandomSearch and CMA-ES, the solvers the fused kernels of ``ops/fused_cem.py`` back.
The other names of the JAX registry (``UNPORTED_SOLVERS``) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers.base import SolverConfig
from blackbox_mpc_torch.solvers.cem import CEMConfig, CEMState, make_cem
from blackbox_mpc_torch.solvers.cma_es import CMAESConfig, CMAESState, make_cma_es
from blackbox_mpc_torch.solvers.pi2 import MPPIConfig, PI2Config, PI2State, make_pi2
from blackbox_mpc_torch.solvers.random_search import (
    RandomSearchConfig,
    RandomSearchState,
    make_random_search,
)

SOLVER_REGISTRY: Dict[str, Tuple[Type[SolverConfig], Callable]] = {
    "CEM": (CEMConfig, make_cem),
    "CMA-ES": (CMAESConfig, make_cma_es),
    "MPPI": (MPPIConfig, make_pi2),
    "PI2": (PI2Config, make_pi2),
    "RandomSearch": (RandomSearchConfig, make_random_search),
}

# Solvers of the JAX package that the port does not have yet.
UNPORTED_SOLVERS = frozenset({"CEM-GD", "Gradient", "PSO", "SPSA"})


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
    "SolverConfig", "CEMConfig", "CEMState", "make_cem", "CMAESConfig", "CMAESState",
    "make_cma_es", "MPPIConfig", "PI2Config", "PI2State", "make_pi2", "RandomSearchConfig",
    "RandomSearchState", "make_random_search",
]
