"""Core types shared by every solver and the rollout engine.

Counterpart of ``blackbox_mpc_tpu/core/types.py``. Solver state is an explicit dataclass
threaded through plain functions, as in the JAX package; randomness comes from an explicit
``torch.Generator`` in place of a ``jax.random`` key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from blackbox_mpc_torch.core.spaces import BoxSpace

__all__ = [
    "Bounds",
    "SolverAux",
    "Solver",
    "TrajectoryEvaluator",
    "DynamicsFn",
    "RewardFn",
    "truncated_normal",
]

# (state [B, S], action [B, U]) -> next_state [B, S]
DynamicsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (state [B, S], action [B, U], next_state [B, S]) -> reward [B]; the argument order is
# (s, a, s') everywhere, as in the JAX package.
RewardFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (initial_states [A, S], action_sequences [P, A, H, U]) -> rewards [P, A]
TrajectoryEvaluator = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Per-dimension action bounds (host numpy arrays) and the quantities solvers derive.

    ``on(device)`` returns the bounds, and ``constant(name, device)`` a derived quantity, as
    tensors on ``device``, made once per device: a solve then makes no copy from the host,
    which would wait for the stream. The cache belongs to the instance: a ``replace``d, copied
    or unpickled ``Bounds`` starts with an empty one, so it never reads another box's tensors.
    """

    lower: np.ndarray  # [U]
    upper: np.ndarray  # [U]
    _tensors: dict = dataclasses.field(init=False, default_factory=dict, compare=False,
                                       repr=False)

    def replace(self, **changes) -> "Bounds":
        """A copy with the given fields changed (``dataclasses.replace``), as JAX's flax
        struct ``Bounds`` has; its device cache starts empty."""
        return dataclasses.replace(self, **changes)

    def __getstate__(self):
        return {"lower": self.lower, "upper": self.upper}

    def __setstate__(self, state):
        for name, value in (*state.items(), ("_tensors", {})):
            object.__setattr__(self, name, value)

    @classmethod
    def from_space(cls, space: BoxSpace, dtype=np.float32) -> "Bounds":
        return cls(
            lower=np.asarray(space.low, dtype=dtype), upper=np.asarray(space.high, dtype=dtype)
        )

    @classmethod
    def of(cls, lower, upper, dim: Optional[int] = None, dtype=np.float32) -> "Bounds":
        space = BoxSpace.of(np.asarray(lower), np.asarray(upper), dim=dim)
        return cls.from_space(space, dtype=dtype)

    @property
    def dim(self) -> int:
        return int(self.lower.shape[-1])

    @property
    def midpoint(self) -> np.ndarray:
        return (self.lower + self.upper) / 2.0

    @property
    def range(self) -> np.ndarray:
        return self.upper - self.lower

    @property
    def default_variance(self) -> np.ndarray:
        # (range/4)^2: the init variance of every reference solver.
        return np.square(self.range) / 16.0

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(lower, upper)`` as float32 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = (
                torch.as_tensor(self.lower, dtype=torch.float32, device=device),
                torch.as_tensor(self.upper, dtype=torch.float32, device=device),
            )
        return self._tensors[device]

    def constant(self, name: str, device) -> torch.Tensor:
        """``midpoint`` or ``default_variance`` as a float32 tensor on ``device`` (None: the
        CPU)."""
        key = (name, torch.device("cpu" if device is None else device))
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(getattr(self, name), dtype=torch.float32,
                                                 device=key[1])
        return self._tensors[key]

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        lower, upper = self.on(x.device)
        return torch.clamp(x, lower.to(x.dtype), upper.to(x.dtype))


class SolverAux(NamedTuple):
    """Diagnostics returned by one solve call."""

    expected_reward: torch.Tensor  # [A]
    plan: torch.Tensor  # [A, H, U]


class Solver(NamedTuple):
    """A derivative-free trajectory optimizer as a triple of plain functions.

    init:  (generator) -> state
    solve: (state, obs [A,S], t, generator) -> (action [A,U], state, SolverAux)
    reset: (state, generator) -> state
    """

    init: Callable[[torch.Generator], Any]
    solve: Callable[[Any, torch.Tensor, Any, torch.Generator], tuple]
    reset: Callable[[Any, torch.Generator], Any]
    name: str = "solver"
    plan_field: Any = None


_SQRT2 = math.sqrt(2.0)
_ERF_LO = math.erf(-2.0 / _SQRT2)
_ERF_HI = math.erf(2.0 / _SQRT2)


def truncated_normal(
    generator: torch.Generator, mean: torch.Tensor, stddev: torch.Tensor, shape
) -> torch.Tensor:
    """Samples N(mean, stddev^2) truncated to +/-2 stddev.

    The draw is the truncated normal itself (the law of resampling until inside +/-2 sigma,
    with no mass piled on the edges), taken by inverse-CDF as ``jax.random.truncated_normal``
    takes it, so it needs no data-dependent resampling loop and no host synchronisation.
    It is not the clip rule of the fused kernel family.
    """
    u = torch.rand(shape, generator=generator, device=mean.device, dtype=torch.float32)
    z = _SQRT2 * torch.erfinv(_ERF_LO + (_ERF_HI - _ERF_LO) * u)
    z = torch.clamp(z, -2.0, 2.0).to(mean.dtype)
    return mean + z * stddev
