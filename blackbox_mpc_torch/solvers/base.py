"""Shared configuration and helpers for the derivative-free trajectory solvers.

Counterpart of ``blackbox_mpc_tpu/solvers/base.py``: bounds bookkeeping, midpoint/variance
initialization, warm-start time shifting, the bound-violation penalty, the iCEM colored noise
(with the spectral-synthesis basis the fused kernels contract) and the exploration-noise rule.
The time-major colored noise and ``adam_polish`` are not ported yet (ROADMAP Queue 1 items 4
and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, truncated_normal

__all__ = [
    "SolverConfig",
    "with_state_dtype",
    "init_solution_mean",
    "init_solution_variance",
    "constrain_variance",
    "shift_time",
    "bound_violation_penalty",
    "colored_noise",
    "colored_spectrum",
    "colored_synthesis_basis",
    "exploration_noise",
]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration common to all solvers (defaults of the reference CEM signature)."""

    planning_horizon: int = 50
    population: int = 500
    num_agents: int = 1
    max_iterations: int = 5
    # Storage dtype of the solver state between solves; the update math stays float32.
    dtype: torch.dtype = torch.float32


def _cast_state(state, dtype):
    changes = {
        f.name: getattr(state, f.name).to(dtype)
        for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name))
        and torch.is_floating_point(getattr(state, f.name))
    }
    return dataclasses.replace(state, **changes)


def with_state_dtype(solver: Solver, dtype) -> Solver:
    """Stores the persistent solver state in ``dtype`` between solves.

    Identity for float32. Otherwise the floating tensors of the state dataclass are cast to
    ``dtype`` by init/reset and after each solve, and upcast to float32 before the update.
    """
    if dtype == torch.float32:
        return solver

    def init(generator):
        return _cast_state(solver.init(generator), dtype)

    def solve(state, obs, t, generator):
        action, next_state, aux = solver.solve(_cast_state(state, torch.float32), obs, t, generator)
        return action, _cast_state(next_state, dtype), aux

    def reset(state, generator):
        return _cast_state(solver.reset(_cast_state(state, torch.float32), generator), dtype)

    return Solver(init=init, solve=solve, reset=reset, name=solver.name,
                  plan_field=solver.plan_field)


def init_solution_mean(
    bounds: Bounds, horizon: int, num_agents: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Midpoint-of-action-space initial plan, [A, H, U]."""
    mid = torch.as_tensor(bounds.midpoint, dtype=dtype, device=device)
    return mid.expand(num_agents, horizon, bounds.dim).clone()


def init_solution_variance(
    bounds: Bounds, horizon: int, num_agents: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(range/4)^2 initial variance, [A, H, U]."""
    var = torch.as_tensor(bounds.default_variance, dtype=dtype, device=device)
    return var.expand(num_agents, horizon, bounds.dim).clone()


def constrain_variance(
    mean: torch.Tensor, variance: torch.Tensor, bounds: Bounds
) -> torch.Tensor:
    """Caps the sampling variance so +/-2 sigma stays inside the bounds:
    min(((m-lb)/2)^2, ((ub-m)/2)^2, var)."""
    lower, upper = bounds.on(mean.device)
    lower_dist = mean - lower
    upper_dist = upper - mean
    return torch.minimum(
        torch.minimum(torch.square(lower_dist / 2.0), torch.square(upper_dist / 2.0)), variance
    )


def shift_time(plan: torch.Tensor) -> torch.Tensor:
    """Warm-start shift: drop step 0, repeat the final step. plan=[..., H, U]."""
    return torch.cat([plan[..., 1:, :], plan[..., -1:, :]], dim=-2)


def bound_violation_penalty(
    samples: torch.Tensor, bounds: Bounds
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clips samples ``[P, A, H, U]`` to bounds; returns (feasible samples, squared-violation
    penalty ``[P, A]``)."""
    feasible = bounds.clip(samples)
    violation = torch.square(samples - feasible)
    return feasible, violation.reshape(samples.shape[0], samples.shape[1], -1).sum(-1)


def colored_spectrum(generator: torch.Generator, shape, dtype=torch.float32):
    """The white complex spectrum of :func:`colored_noise`: (real, imaginary), each
    ``[..., U, F]`` standard normals, F = H // 2 + 1, for ``shape = [..., H, U]``."""
    *lead, horizon, dim_u = shape
    size = (*lead, dim_u, horizon // 2 + 1)
    real = torch.randn(size, generator=generator, device=generator.device, dtype=dtype)
    imag = torch.randn(size, generator=generator, device=generator.device, dtype=dtype)
    return real, imag


def colored_noise(generator: torch.Generator, beta: float, shape,
                  dtype=torch.float32) -> torch.Tensor:
    """Temporally colored (power-law) noise along the horizon axis, the iCEM sampler.

    ``shape`` is ``[..., H, U]``; the spectrum over the H axis is scaled ``f^(-beta/2)``
    (beta=0: white noise). The signal is normalized to unit standard deviation over each
    whole ``(H, U)`` action sequence, not per step.
    """
    horizon = shape[-2]
    nfreq = horizon // 2 + 1
    real, imag = colored_spectrum(generator, shape, dtype)
    freqs = torch.arange(1, nfreq + 1, dtype=dtype, device=real.device)  # avoids f=0 blowup
    spectrum = torch.complex(real, imag) * freqs ** (-beta / 2.0)
    signal = torch.fft.irfft(spectrum, n=horizon, dim=-1).transpose(-1, -2)  # [..., H, U]
    std = torch.std(signal, dim=(-2, -1), keepdim=True, unbiased=False) + 1e-8
    return signal / std


def colored_synthesis_basis(horizon: int, beta: float) -> np.ndarray:
    """Static ``[2F, H]`` spectral-synthesis basis (numpy, float64), F = H // 2 + 1.

    Row 2k / 2k+1 is the irfft of the ``(k+1)^(-beta/2)``-scaled unit real / imaginary impulse
    at frequency k, so ``coeffs [.., 2F] @ basis -> [.., H]`` reproduces
    ``irfft(spectrum * f^(-beta/2))`` for ``spectrum = re + i*im``. The fused kernels contract
    it per action dim (``ops/fused_cem.py``).
    """
    nfreq = horizon // 2 + 1
    scale = np.arange(1, nfreq + 1, dtype=np.float64) ** (-beta / 2.0)
    basis = np.zeros((2 * nfreq, horizon), np.float64)
    for k in range(nfreq):
        spec = np.zeros(nfreq, np.complex128)
        spec[k] = scale[k]
        basis[2 * k] = np.fft.irfft(spec, n=horizon)
        spec[k] = 1j * scale[k]
        basis[2 * k + 1] = np.fft.irfft(spec, n=horizon)
    return basis


def exploration_noise(
    generator: torch.Generator, action: torch.Tensor, bounds: Bounds, scale: float = 0.05
) -> torch.Tensor:
    """Adds truncated-normal exploration noise to an [A, U] action and clips to bounds.

    Keeps the reference quirk: the noise is centered at the action-space midpoint, not 0.
    """
    mid = torch.as_tensor(bounds.midpoint, dtype=action.dtype, device=action.device)
    std = torch.as_tensor(
        (bounds.default_variance * scale) ** 0.5, dtype=action.dtype, device=action.device
    )
    noise = truncated_normal(generator, mid, std, action.shape)
    return bounds.clip(action + noise)
