"""Shared configuration and helpers for the derivative-free trajectory solvers.

Counterpart of ``blackbox_mpc_tpu/solvers/base.py``: bounds bookkeeping, midpoint/variance
initialization, warm-start time shifting, the bound-violation penalty, the iCEM colored noise
in both candidate layouts (with the spectral-synthesis basis the fused kernels contract), the
exploration-noise rule, and the projected Adam ascent the first-order solvers share
(:func:`adam_polish`, over :func:`adam_update`, optax's ``adam`` written out, or over a
``torch.optim`` optimizer).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from blackbox_mpc_torch.core.types import Bounds, Solver, truncated_normal

__all__ = [
    "SolverConfig",
    "StateReplace",
    "AdamState",
    "adam_polish",
    "adam_update",
    "with_state_dtype",
    "init_solution_mean",
    "init_solution_variance",
    "constrain_variance",
    "shift_time",
    "bound_violation_penalty",
    "colored_noise",
    "colored_noise_time_major",
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


class StateReplace:
    """``state.replace(**changes)``: a copy of a solver state with the given fields changed
    (``dataclasses.replace``), as JAX's flax struct states have. A low-level caller warm-starts
    a plan with ``state.replace(mean=...)``."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


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
    mid = bounds.constant("midpoint", device).to(dtype)
    return mid.expand(num_agents, horizon, bounds.dim).clone()


def init_solution_variance(
    bounds: Bounds, horizon: int, num_agents: int, dtype=torch.float32, device=None
) -> torch.Tensor:
    """(range/4)^2 initial variance, [A, H, U]."""
    var = bounds.constant("default_variance", device).to(dtype)
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
    samples: torch.Tensor, bounds: Bounds, time_major: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clips samples ``[P, A, H, U]`` to bounds; returns (feasible samples, squared-violation
    penalty ``[P, A]``). ``time_major``: samples are ``[H, P, A, U]`` (the penalty stays
    ``[P, A]``)."""
    feasible = bounds.clip(samples)
    violation = torch.square(samples - feasible)
    if time_major:
        return feasible, violation.sum(dim=(0, 3))
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


def colored_noise_time_major(generator: torch.Generator, beta: float, shape,
                             dtype=torch.float32) -> torch.Tensor:
    """:func:`colored_noise` for the time-major candidate layout: ``shape`` is
    ``(H, *lead, U)``, the power-law correlation along axis 0.

    The spectrum is drawn as :func:`colored_noise` draws it, so from the same generator state
    the result is ``colored_noise(generator, beta, (*lead, H, U))`` moved to H-major, up to
    rounding; the synthesis is one contraction with the ``[2F, H]`` basis
    (:func:`colored_synthesis_basis`) that writes the output H-major.
    """
    horizon, *lead, dim_u = shape
    real, imag = colored_spectrum(generator, (*lead, horizon, dim_u), dtype)
    coeffs = torch.stack([real, imag], dim=-1).reshape(*lead, dim_u, -1)  # [*lead, U, 2F]
    basis = _basis_tensor(horizon, float(beta), coeffs.device, dtype)
    signal = torch.einsum("fh,...f->h...", basis, coeffs)  # [H, *lead, U]
    std = torch.std(signal, dim=(0, signal.dim() - 1), keepdim=True, unbiased=False) + 1e-8
    return signal / std


@functools.lru_cache(maxsize=None)
def _basis_tensor(horizon: int, beta: float, device: torch.device, dtype) -> torch.Tensor:
    """The synthesis basis on ``device``, copied there once (a copy per solve would make the
    host wait)."""
    return torch.as_tensor(colored_synthesis_basis(horizon, beta), dtype=dtype, device=device)


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
    The bounds' constants are on the device already, so the host waits for nothing.
    """
    mid = bounds.constant("midpoint", action.device).to(action.dtype)
    std = torch.sqrt(bounds.constant("default_variance", action.device) * scale).to(action.dtype)
    noise = truncated_normal(generator, mid, std, action.shape)
    return bounds.clip(action + noise)


# optax.adam's defaults.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState`` in PyTorch's names: ``step`` is optax's ``count`` (a host
    int: the bias corrections are host scalars, so no step reads the device), ``exp_avg`` and
    ``exp_avg_sq`` its ``mu`` and ``nu``, one tensor per parameter."""

    step: int
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]

    @classmethod
    def zeros_like(cls, params: Sequence[torch.Tensor]) -> "AdamState":
        return cls(0, [torch.zeros_like(p) for p in params],
                   [torch.zeros_like(p) for p in params])


def adam_update(state: AdamState, grads: Sequence[torch.Tensor], lr: float
                ) -> Tuple[AdamState, List[torch.Tensor]]:
    """One step of ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) in optax's
    order of operations: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the
    bias-corrected moments, ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr``. Returns the
    new state and the updates to add to the parameters."""
    step = state.step + 1
    mus = [(1.0 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, state.exp_avg)]
    nus = [(1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v for g, v in zip(grads, state.exp_avg_sq)]
    c1, c2 = 1.0 - ADAM_B1 ** step, 1.0 - ADAM_B2 ** step
    updates = [(m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) * -lr for m, v in zip(mus, nus)]
    return AdamState(step, mus, nus), updates


def adam_polish(evaluate, bounds: Bounds, optimizer, plans: torch.Tensor,
                iterations: int) -> torch.Tensor:
    """Projected Adam ascent of ``evaluate`` over a batch of plans ``[P, A, H, U]``.

    Shared by the first-order solvers (``gradient.py``, ``cem_gd.py``). The objective is
    ``-mean(evaluate(plans))``: each plan's reward depends only on its own actions, so the
    gradient decomposes per plan, and the mean (not the sum) keeps its scale where Adam's
    ``eps`` expects it. The plans are clipped to the bounds after every step. Gradients flow
    into the plans only (the planning parameters carry none), also when the caller runs
    under ``torch.no_grad()``; the result is detached.

    ``optimizer`` (JAX's takes an optax transformation): a float is the learning rate of
    ``optax.adam`` (:func:`adam_update`); a callable takes the list ``[plans]`` (a leaf that
    requires grad) and returns a ``torch.optim.Optimizer`` over it, which steps the plans in
    place before each clip.
    """
    plans = plans.detach()
    if callable(optimizer):
        return _optimizer_polish(evaluate, bounds, optimizer, plans, iterations)
    lr = float(optimizer)
    state = AdamState.zeros_like([plans])
    with torch.enable_grad():
        for _ in range(iterations):
            leaf = plans.requires_grad_(True)
            objective = -torch.mean(evaluate(leaf))
            (grad,) = torch.autograd.grad(objective, leaf)
            state, (update,) = adam_update(state, [grad], lr)
            plans = bounds.clip(leaf.detach() + update)
    return plans


def _optimizer_polish(evaluate, bounds: Bounds, make_optimizer, plans: torch.Tensor,
                      iterations: int) -> torch.Tensor:
    leaf = plans.clone().requires_grad_(True)
    opt = make_optimizer([leaf])
    lower, upper = bounds.on(leaf.device)
    with torch.enable_grad():
        for _ in range(iterations):
            (leaf.grad,) = torch.autograd.grad(-torch.mean(evaluate(leaf)), leaf)
            opt.step()
            with torch.no_grad():
                leaf.clamp_(lower.to(leaf.dtype), upper.to(leaf.dtype))
    return leaf.detach()
