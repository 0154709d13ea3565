"""The time-major candidate layout of the port (``time_major=True``: candidates ``[H, P, A, U]``
with a time-major evaluator) against the standard layout, as ``tests/test_time_major.py`` holds
the JAX package's, and ``colored_noise_time_major`` against JAX's on the same spectrum.

Colored noise draws the same spectrum in both layouts, so CEM and PI2 with colored noise are
compared with the same generator seed. The other draws associate elements differently per
layout; the solvers' seams (``truncated_normal``, ``unit_uniform``, ``rademacher``,
``velocity_coefficients``) are patched with a canonical draw that each layout receives in its
own order. Tolerance: rtol/atol 2e-6 (the reductions run over other axes), 1e-5 for colored
noise (a dense contraction against an inverse FFT).
"""
import jax
import numpy as np
import pytest
import torch

import blackbox_mpc_torch.solvers.cem as tcem
import blackbox_mpc_torch.solvers.pi2 as tpi2
import blackbox_mpc_torch.solvers.pso as tpso
import blackbox_mpc_torch.solvers.random_search as trs
import blackbox_mpc_torch.solvers.spsa as tspsa
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.ops import fused_cem as fc
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.solvers import make_solver

H, A, U, P, S = 5, 3, 2, 11, 4  # all distinct: the fake draws tell the layouts apart
TOL = 2e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dynamics(s, a):
    return s + 0.1 * torch.nn.functional.pad(a, (0, S - U)) - 0.05 * torch.tanh(s)


def reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


EV = make_trajectory_evaluator(dynamics, reward, device="cpu")
EV_TM = make_trajectory_evaluator(dynamics, reward, device="cpu", time_major=True)
BOUNDS = Bounds.of(-1.5, 1.5, dim=U)
OBS = torch.linspace(-0.5, 0.5, A * S).reshape(A, S)


def canonical(n, offset=0.0):
    """A fixed draw ``[n, A, H, U]`` in [-1, 1), different for each n."""
    z = torch.arange(n * A * H * U, dtype=torch.float32).reshape(n, A, H, U)
    return (z % 7 - 3.0 + offset) / (3.0 + n)


def in_layout(shape, offset=0.0):
    """The canonical draw for ``shape``, in the shape's layout."""
    if shape[2] == H:  # [n, A, H, U]
        return canonical(shape[0], offset)
    assert shape[0] == H, shape  # [H, n, A, U]
    return canonical(shape[1], offset).permute(2, 0, 1, 3)


def fake_truncated_normal(generator, mean, std, shape):
    return mean + in_layout(shape) * std


def solve(name, time_major, generator_seed=0, **kw):
    s = make_solver(name, BOUNDS, EV_TM if time_major else EV, planning_horizon=H,
                    num_agents=A, population=P, time_major=time_major, **kw)
    g = torch.Generator().manual_seed(generator_seed)
    return s.solve(s.init(g), OBS, 0, g)


def assert_same(out_std, out_tm, tol=TOL):
    (a_s, st_s, aux_s), (a_t, st_t, aux_t) = out_std, out_tm
    for got, want in ((a_t, a_s), (aux_t.plan, aux_s.plan),
                      (aux_t.expected_reward, aux_s.expected_reward)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_evaluator_time_major_bitmatches_standard():
    cands = torch.rand((P, A, H, U), generator=torch.Generator().manual_seed(1)) * 2 - 1
    np.testing.assert_array_equal(EV(OBS, cands).numpy(),
                                  EV_TM(OBS, cands.permute(2, 0, 1, 3)).numpy())


def test_colored_noise_time_major_matches_jax_on_the_same_spectrum(monkeypatch):
    beta, shape = 2.0, (9, 4, 3, 2)  # (H, P, A, U)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jbase.colored_noise_time_major(key, beta, shape))
    real_key, imag_key = jax.random.split(key)
    spectrum_shape = (4, 3, 2, 9 // 2 + 1)
    spectrum = tuple(torch.as_tensor(np.array(jax.random.normal(k, spectrum_shape)))
                     for k in (real_key, imag_key))
    monkeypatch.setattr(tbase, "colored_spectrum", lambda g, shape, dtype=None: spectrum)
    got = tbase.colored_noise_time_major(torch.Generator(), beta, shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # From one generator state, the time-major draw is the standard one moved to H-major.
    monkeypatch.undo()
    tm = tbase.colored_noise_time_major(torch.Generator().manual_seed(3), beta, shape)
    std = tbase.colored_noise(torch.Generator().manual_seed(3), beta, (4, 3, 9, 2))
    np.testing.assert_allclose(tm.numpy(), std.permute(2, 0, 1, 3).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bound_violation_penalty_time_major():
    x = torch.rand((P, A, H, U), generator=torch.Generator().manual_seed(2)) * 5 - 2.5
    f, p = tbase.bound_violation_penalty(x, BOUNDS)
    f_t, p_t = tbase.bound_violation_penalty(x.permute(2, 0, 1, 3), BOUNDS, time_major=True)
    np.testing.assert_array_equal(f_t.numpy(), f.permute(2, 0, 1, 3).numpy())
    np.testing.assert_allclose(p_t.numpy(), p.numpy(), rtol=1e-6)


@pytest.mark.parametrize("options", [
    dict(colored_noise_beta=2.0),
    dict(colored_noise_beta=2.0, mean_as_candidate=True, keep_elites=2, execute_best=True,
         population_decay=0.8),
    dict(keep_elites=2, mean_as_candidate=True),  # white: the fake draw
])
def test_cem_time_major_matches_standard(options, monkeypatch):
    if "colored_noise_beta" not in options or options.get("keep_elites"):
        monkeypatch.setattr(tcem, "truncated_normal", fake_truncated_normal)
    kw = dict(num_elite=4, max_iterations=3, **options)
    assert_same(solve("CEM", False, **kw), solve("CEM", True, **kw))


@pytest.mark.parametrize("options", [dict(colored_noise_beta=1.5),
                                     dict(colored_noise_beta=1.5, adapt_variance=True),
                                     dict(control_cost=True, adapt_variance=True)])
def test_pi2_time_major_matches_standard(options, monkeypatch):
    if "colored_noise_beta" not in options:
        monkeypatch.setattr(tpi2, "truncated_normal", fake_truncated_normal)
    kw = dict(max_iterations=3, lamda=0.5, **options)
    assert_same(solve("PI2", False, **kw), solve("PI2", True, **kw))


def test_random_search_time_major_matches_standard(monkeypatch):
    monkeypatch.setattr(trs, "unit_uniform", lambda g, shape: (in_layout(shape) + 1) / 2)
    assert_same(solve("RandomSearch", False), solve("RandomSearch", True))


def test_spsa_time_major_matches_standard(monkeypatch):
    monkeypatch.setattr(tspsa, "rademacher",
                        lambda g, shape: torch.where(in_layout(shape) < 0, -1.0, 1.0))
    assert_same(solve("SPSA", False, max_iterations=3), solve("SPSA", True, max_iterations=3))


@pytest.mark.parametrize("elementwise", [False, True])
def test_pso_time_major_matches_standard(elementwise, monkeypatch):
    monkeypatch.setattr(tpso, "truncated_normal", fake_truncated_normal)
    coefficients = (torch.tensor(0.7), torch.tensor(-0.4))
    monkeypatch.setattr(tpso, "velocity_coefficients", lambda g, shape, e: (
        ((in_layout(shape) + 1) / 2, (in_layout(shape, 1.0) + 1) / 2) if e else coefficients))
    outs = []
    for tm in (False, True):
        s = make_solver("PSO", BOUNDS, EV_TM if tm else EV, planning_horizon=H, num_agents=A,
                        population=P, max_iterations=3, elementwise_random=elementwise,
                        time_major=tm)
        state = s.init(torch.Generator().manual_seed(0))
        lay = (lambda x: x.permute(2, 0, 1, 3)) if tm else (lambda x: x)
        positions = lay(canonical(P) * 2.0)  # partly out of bounds
        state = tpso.PSOState(positions=positions, velocities=lay(canonical(P, 1.0) * 0.1),
                              best_positions=positions, best_rewards=state.best_rewards,
                              global_best_position=state.global_best_position,
                              global_best_reward=state.global_best_reward)
        outs.append(s.solve(state, OBS, 0, torch.Generator()))
    assert_same(*outs)


def test_cem_gd_time_major_matches_standard(monkeypatch):
    monkeypatch.setattr(tcem, "truncated_normal", fake_truncated_normal)
    kw = dict(num_elite=4, max_iterations=2, gd_candidates=2, gd_iterations=3)
    assert_same(solve("CEM-GD", False, **kw), solve("CEM-GD", True, **kw), tol=1e-5)


@pytest.mark.parametrize("factory,config", [
    ("make_fused_cem", tcem.CEMConfig(time_major=True)),
    ("make_fused_pi2", tpi2.PI2Config(time_major=True)),
    ("make_fused_random_search", trs.RandomSearchConfig(time_major=True)),
])
def test_fused_factories_refuse_time_major(factory, config):
    with pytest.raises(ValueError, match=r"candidate contract is \[P, A, H, U\]"):
        getattr(fc, factory)(config, BOUNDS, None, None, reward)
