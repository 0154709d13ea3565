"""CMA-ES trajectory solver (per-agent covariance adaptation).

Counterpart of ``blackbox_mpc_tpu/solvers/cma_es.py``: the Hansen update rules with rank-based
recombination weights, the step-size path ``p_sigma``, the covariance path and the rank-mu
update, one independent CMA-ES of ``n = H*U`` per agent. Candidates are drawn through the
Cholesky factor of C; the eigendecomposition serves only the ``C^(-1/2)`` whitening, refreshed
every ``eigen_update_every`` iterations. ``diagonal=True`` selects sep-CMA-ES: C restricted to
its diagonal, O(n) updates, no factorization, learning rates scaled by ``(n + 2) / 3``. That is
the mode the fused solver (``ops/fused_cem.py::make_fused_sep_cma``) runs.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from blackbox_mpc_torch.core.device import per_device
from blackbox_mpc_torch.core.types import Bounds, Solver, SolverAux, TrajectoryEvaluator
from blackbox_mpc_torch.solvers import base

__all__ = ["CMAESConfig", "CMAESState", "cma_constants", "make_cma_es"]


@dataclasses.dataclass(frozen=True)
class CMAESConfig(base.SolverConfig):
    """Defaults match the reference except ``persist_across_solves``."""

    num_elite: int = 50
    alpha_cov: float = 2.0
    h_sigma: float = 1.0
    # Hansen's state-dependent stall indicator in place of the constant above: gates the p_cov
    # input and adds the variance-loss correction (1 - h) * cc * (2 - cc) * C.
    adaptive_h_sigma: bool = False
    # False: every solve restarts sigma/C/paths and warm-starts only the time-shifted mean.
    persist_across_solves: bool = False
    # Floor and ceiling of the per-coordinate step size, as multiples of the initial sigma.
    sigma_floor: float = 1e-6
    sigma_ceil: float = 1e3
    diagonal: bool = False  # sep-CMA-ES
    # Full mode: refresh the Cholesky / C^(-1/2) factors every this many iterations; 0 = the
    # Hansen gap max(1, 0.5 / (n * (c1 + c_mu))).
    eigen_update_every: int = 1


@dataclasses.dataclass(frozen=True)
class CMAESState(base.StateReplace):
    mean: torch.Tensor  # [A, n]
    sigma: torch.Tensor  # [A, n] per-coordinate step size
    cov: torch.Tensor  # [A, n, n]; diagonal mode: [A, n]
    p_sigma: torch.Tensor  # [A, n]
    p_cov: torch.Tensor  # [A, n]
    chol: torch.Tensor  # [A, n, n] lower Cholesky of cov; diagonal mode: [A, n] (sqrt(C))
    inv_sqrt: torch.Tensor  # [A, n, n] C^(-1/2); diagonal mode: [A, n]
    gen: int = 0  # generations since the adaptation state was (re)initialized


def cma_constants(config: CMAESConfig, bounds: Bounds, horizon: int, pop: int, k: int):
    """Hansen strategy constants (numpy/python), shared by :func:`make_cma_es` and the fused
    sep-CMA solver so the two cannot drift."""
    n = horizon * bounds.dim
    # Log-rank recombination weights for the top k, zero after.
    w = np.concatenate(
        [np.log(k + 0.5) - np.log(np.arange(1, k + 1)), np.zeros(pop - k)]
    ).astype(np.float32)
    w = w / w.sum()
    mu_eff = float(1.0 / np.sum(w**2))
    nf = float(n)
    c_sigma = (mu_eff + 2.0) / (nf + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (nf + 1.0)) - 1.0) + c_sigma
    cc = (4.0 + mu_eff / nf) / (nf + 4.0 + 2.0 * mu_eff / nf)
    c1 = config.alpha_cov / ((nf + 1.3) ** 2 + mu_eff)
    c_mu = min(
        1.0 - c1,
        config.alpha_cov * (mu_eff - 2.0 + 1.0 / mu_eff)
        / ((nf + 2.0) ** 2 + config.alpha_cov * mu_eff / 2.0),
    )
    if config.diagonal:
        # sep-CMA-ES: n (not n^2 / 2) free parameters, so the rates can be (n + 2) / 3 larger.
        scale = (nf + 2.0) / 3.0
        c1 = min(1.0, c1 * scale)
        c_mu = min(1.0 - c1, c_mu * scale)
    expectation_of_normal = float(np.sqrt(nf) * (1.0 - 1.0 / (4.0 * nf) + 1.0 / (21.0 * nf**2)))
    if config.eigen_update_every < 0:
        raise ValueError(f"eigen_update_every must be >= 0, got {config.eigen_update_every}")
    eigen_gap = config.eigen_update_every or max(1, int(0.5 / (nf * (c1 + c_mu))))
    sigma0 = np.tile(
        (np.asarray(bounds.upper, np.float32) - np.asarray(bounds.lower, np.float32))
        .reshape(-1) / 4.0, horizon
    )  # [n]: range / 4, the reference init sigma
    return types.SimpleNamespace(
        n=n, weights=w, mu_eff=mu_eff, nf=nf, c_sigma=c_sigma, d_sigma=d_sigma, cc=cc,
        c1=c1, c_mu=c_mu, expectation_of_normal=expectation_of_normal,
        eigen_gap=eigen_gap, sigma0=sigma0,
        weights_on=per_device(lambda device: torch.as_tensor(w, device=device)),
        sigma0_on=per_device(lambda device: torch.as_tensor(sigma0, device=device)),
    )


def init_state(bounds: Bounds, horizon: int, agents: int, diagonal: bool, device) -> CMAESState:
    """The float32 state every solve (or reset) starts from: midpoint mean, sigma = range / 4,
    C = I, zero paths."""
    n = horizon * bounds.dim
    mean = base.init_solution_mean(bounds, horizon, agents, device=device).reshape(agents, n)
    var = base.init_solution_variance(bounds, horizon, agents, device=device).reshape(agents, n)
    if diagonal:
        eye = torch.ones((agents, n), dtype=torch.float32, device=device)  # diag(C) = 1
    else:
        eye = torch.eye(n, dtype=torch.float32, device=device).expand(agents, n, n).contiguous()
    zeros = torch.zeros((agents, n), dtype=torch.float32, device=device)
    return CMAESState(mean=mean, sigma=torch.sqrt(var), cov=eye, p_sigma=zeros, p_cov=zeros,
                      chol=eye, inv_sqrt=eye)


def standard_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """N(0, 1) draws on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)


def step_size_update(config: CMAESConfig, C, s: CMAESState, y_mean: torch.Tensor,
                     whitened: torch.Tensor):
    """The step-size path and its consequences, shared with the fused sep-CMA:
    ``(p_sigma, sigma, p_cov, delta)``; ``delta [A, 1]`` is the variance-loss correction of
    the adaptive stall indicator, or None."""
    p_sigma = (1.0 - C.c_sigma) * s.p_sigma + float(
        np.sqrt(C.c_sigma * (2.0 - C.c_sigma) * C.mu_eff)) * whitened
    norm = torch.linalg.norm(p_sigma, dim=-1)
    sigma = s.sigma * torch.exp(
        (C.c_sigma / C.d_sigma) * (norm / C.expectation_of_normal - 1.0))[:, None]
    sigma0 = C.sigma0_on(sigma.device)
    sigma = torch.clamp(sigma, config.sigma_floor * sigma0, config.sigma_ceil * sigma0)
    if config.adaptive_h_sigma:
        warmup = 1.0 - (1.0 - C.c_sigma) ** (2.0 * (float(s.gen) + 1.0))
        h = (norm / float(np.sqrt(warmup))
             < (1.4 + 2.0 / (C.nf + 1.0)) * C.expectation_of_normal).to(s.mean.dtype)[:, None]
        delta = (1.0 - h) * C.cc * (2.0 - C.cc)
    else:
        h, delta = config.h_sigma, None
    p_cov = (1.0 - C.cc) * s.p_cov + h * float(np.sqrt(C.cc * (2.0 - C.cc) * C.mu_eff)) * y_mean
    return p_sigma, sigma, p_cov, delta


def diagonal_cov_update(C, s: CMAESState, p_cov, delta, rank_mu_d):
    """sep-CMA's covariance update from the diagonal rank-mu term: ``(cov, chol, inv_sqrt)``."""
    rank_one_d = torch.square(p_cov)
    if delta is not None:
        rank_one_d = rank_one_d + delta * s.cov
    cov = (1.0 - C.c1 - C.c_mu) * s.cov + C.c1 * rank_one_d + C.c_mu * rank_mu_d
    cov = torch.clamp_min(cov, 1e-20)
    chol = torch.sqrt(cov)
    return cov, chol, 1.0 / chol


def make_cma_es(config: CMAESConfig, bounds: Bounds, evaluate: TrajectoryEvaluator) -> Solver:
    horizon, agents, pop = config.planning_horizon, config.num_agents, config.population
    dim_u = bounds.dim
    C = cma_constants(config, bounds, horizon, pop, config.num_elite)
    n, diagonal = C.n, config.diagonal

    def init(generator: torch.Generator) -> CMAESState:
        return init_state(bounds, horizon, agents, diagonal, generator.device)

    def factors(cov):
        # C^(-1/2) as a matrix function of C: invariant to the eigenbasis ambiguities.
        eigvals, eigvecs = torch.linalg.eigh(cov)
        inv_sqrt = torch.einsum("aij,aj,akj->aik", eigvecs,
                                1.0 / torch.sqrt(torch.clamp_min(eigvals, 1e-20)), eigvecs)
        jitter = 1e-10 * torch.eye(n, dtype=cov.dtype, device=cov.device)
        return torch.linalg.cholesky(cov + jitter), inv_sqrt

    def solve(state: CMAESState, obs: torch.Tensor, t, generator: torch.Generator):
        del t
        s = state
        if not config.persist_across_solves:
            # Fresh adaptation state each solve; only the (already time-shifted) mean carries.
            s = dataclasses.replace(init(generator), mean=state.mean)
        weights = C.weights_on(s.mean.device)
        for i in range(config.max_iterations):
            z = standard_normal(generator, (agents, pop, n))
            # y_i = L z_i ~ N(0, C) through the Cholesky factor.
            y = z * s.chol[:, None, :] if diagonal else torch.einsum("apk,ank->apn", z, s.chol)
            flat_samples = s.mean[:, None, :] + s.sigma[:, None, :] * y  # [A, P, n]
            samples = flat_samples.transpose(0, 1).reshape(pop, agents, horizon, dim_u)
            samples, penalty = base.bound_violation_penalty(samples, bounds)
            rewards = evaluate(obs, samples) - penalty  # [P, A]
            order = torch.argsort(-rewards.T, dim=1, stable=True)  # [A, P], best first
            feasible_flat = samples.reshape(pop, agents, n).transpose(0, 1)  # [A, P, n]
            x_sorted = torch.gather(feasible_flat, 1, order[:, :, None].expand(agents, pop, n))
            x_diff = x_sorted - s.mean[:, None, :]
            x_mean = torch.einsum("p,apn->an", weights, x_diff)
            y_mean = x_mean / s.sigma
            whitened = (s.inv_sqrt * y_mean if diagonal
                        else torch.einsum("aik,ak->ai", s.inv_sqrt, y_mean))
            p_sigma, sigma, p_cov, delta = step_size_update(config, C, s, y_mean, whitened)
            y_unweighted = x_diff / s.sigma[:, None, :]
            if diagonal:
                rank_mu_d = torch.einsum("p,apn->an", weights, torch.square(y_unweighted))
                cov, chol, inv_sqrt = diagonal_cov_update(C, s, p_cov, delta, rank_mu_d)
            else:
                rank_mu = torch.einsum("p,apn,apm->anm", weights, y_unweighted, y_unweighted)
                rank_one = p_cov[:, :, None] * p_cov[:, None, :]
                if delta is not None:
                    rank_one = rank_one + delta[:, :, None] * s.cov
                cov = (1.0 - C.c1 - C.c_mu) * s.cov + C.c1 * rank_one + C.c_mu * rank_mu
                cov = (cov + cov.transpose(-1, -2)) / 2.0
                # Lazy refresh: between refreshes sampling and whitening use the last factors.
                chol, inv_sqrt = factors(cov) if i % C.eigen_gap == 0 else (s.chol, s.inv_sqrt)
            s = CMAESState(mean=s.mean + x_mean, sigma=sigma, cov=cov, p_sigma=p_sigma,
                           p_cov=p_cov, chol=chol, inv_sqrt=inv_sqrt, gen=s.gen + 1)
        plan = s.mean.reshape(agents, horizon, dim_u)
        if not config.persist_across_solves:
            s = dataclasses.replace(s, mean=base.shift_time(plan).reshape(agents, n))
        aux = SolverAux(expected_reward=rewards.max(dim=0).values, plan=plan)
        return plan[:, 0], s, aux

    def reset(state: CMAESState, generator: torch.Generator) -> CMAESState:
        del state
        return init(generator)

    return base.with_state_dtype(
        Solver(init=init, solve=solve, reset=reset, name="CMA-ES", plan_field="mean"), config.dtype
    )
