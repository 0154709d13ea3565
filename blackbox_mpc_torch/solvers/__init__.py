"""Solver registry: one factory per trajectory optimizer, keyed by name.

Counterpart of ``blackbox_mpc_tpu/solvers/__init__.py``, with all nine of its names: CEM (with
the iCEM options), CEM-GD, CMA-ES, Gradient, MPPI, PI2, PSO, RandomSearch and SPSA. Each
factory takes ``(config, bounds, evaluate)``; the sampled solvers also take the time-major
candidate layout (``time_major=True``) with a time-major evaluator.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers.base import SolverConfig
from blackbox_mpc_torch.solvers.cem import CEMConfig, CEMState, make_cem
from blackbox_mpc_torch.solvers.cem_gd import CEMGDConfig, CEMGDState, make_cem_gd
from blackbox_mpc_torch.solvers.cma_es import CMAESConfig, CMAESState, make_cma_es
from blackbox_mpc_torch.solvers.gradient import GradientConfig, GradientState, make_gradient
from blackbox_mpc_torch.solvers.pi2 import MPPIConfig, PI2Config, PI2State, make_pi2
from blackbox_mpc_torch.solvers.pso import PSOConfig, PSOState, make_pso
from blackbox_mpc_torch.solvers.random_search import (
    RandomSearchConfig,
    RandomSearchState,
    make_random_search,
)
from blackbox_mpc_torch.solvers.spsa import SPSAConfig, SPSAState, make_spsa

SOLVER_REGISTRY: Dict[str, Tuple[Type[SolverConfig], Callable]] = {
    "CEM": (CEMConfig, make_cem),
    "CEM-GD": (CEMGDConfig, make_cem_gd),
    "CMA-ES": (CMAESConfig, make_cma_es),
    "Gradient": (GradientConfig, make_gradient),
    "MPPI": (MPPIConfig, make_pi2),
    "PI2": (PI2Config, make_pi2),
    "PSO": (PSOConfig, make_pso),
    "RandomSearch": (RandomSearchConfig, make_random_search),
    "SPSA": (SPSAConfig, make_spsa),
}


def lookup(name: str):
    """``(ConfigClass, factory)`` of ``name``; raises ``KeyError`` for an unknown name."""
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
    "SOLVER_REGISTRY", "lookup", "make_solver", "Solver", "SolverAux", "SolverConfig",
    "CEMConfig", "CEMState", "make_cem", "CEMGDConfig", "CEMGDState", "make_cem_gd",
    "CMAESConfig", "CMAESState", "make_cma_es", "GradientConfig", "GradientState",
    "make_gradient", "MPPIConfig", "PI2Config", "PI2State", "make_pi2", "PSOConfig", "PSOState",
    "make_pso", "RandomSearchConfig", "RandomSearchState", "make_random_search", "SPSAConfig",
    "SPSAState", "make_spsa",
]
