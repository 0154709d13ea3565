"""Lightweight action/observation space descriptions.

A copy of ``blackbox_mpc_tpu/core/spaces.py`` (numpy only): the PyTorch port imports nothing
of the JAX package, so it keeps its own framework-neutral ``BoxSpace``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["BoxSpace", "as_box_space"]


@dataclasses.dataclass(frozen=True)
class BoxSpace:
    """A bounded box in R^n, the only space kind the framework needs.

    Attributes:
      low: lower bound per dimension, shape ``[n]``.
      high: upper bound per dimension, shape ``[n]``.
    """

    low: np.ndarray
    high: np.ndarray

    def __post_init__(self):
        low = np.asarray(self.low, dtype=np.float32).reshape(-1)
        high = np.asarray(self.high, dtype=np.float32).reshape(-1)
        if low.shape != high.shape:
            raise ValueError(f"low/high shape mismatch: {low.shape} vs {high.shape}")
        object.__setattr__(self, "low", low)
        object.__setattr__(self, "high", high)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.low.shape

    @property
    def dim(self) -> int:
        return int(self.low.shape[0])

    @classmethod
    def of(cls, low, high, dim: int | None = None) -> "BoxSpace":
        """Builds a box from scalars or vectors; scalars broadcast to ``dim``."""
        low = np.asarray(low, dtype=np.float32)
        high = np.asarray(high, dtype=np.float32)
        if low.ndim == 0:
            if dim is None:
                raise ValueError("dim required when bounds are scalars")
            low = np.full((dim,), low, dtype=np.float32)
        if high.ndim == 0:
            high = np.full_like(low, high)
        return cls(low=low, high=high)


def as_box_space(space) -> BoxSpace:
    """Converts a gymnasium ``Box`` (or anything with .low/.high) into a :class:`BoxSpace`."""
    if isinstance(space, BoxSpace):
        return space
    low = getattr(space, "low", None)
    high = getattr(space, "high", None)
    if low is None or high is None:
        raise TypeError(f"cannot interpret {type(space)!r} as a box space")
    return BoxSpace(low=np.asarray(low), high=np.asarray(high))
