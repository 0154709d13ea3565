"""Port parity for CEM: one ``cem_iteration`` of blackbox_mpc_torch against the JAX one on
identical injected candidates (rtol 1e-5), with each iCEM option, and the port's truncated
normal by distribution; the helpers of ``solvers/base.py`` against the JAX ones.

``jax.random`` and ``torch.Generator`` cannot give the same draws, so both modules'
``truncated_normal`` and ``colored_noise`` are replaced, test-side only, by ones that return
the same numpy z (its first ``shape[0]`` candidates)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.solvers.cem as jcem
import blackbox_mpc_torch.solvers.cem as tcem
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_torch.core.types import Bounds as TBounds
from blackbox_mpc_torch.core.types import truncated_normal
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.solvers import make_solver

P, A, H, U = 32, 2, 6, 3


def inject(monkeypatch, z):
    """Both packages' CEM draw ``mean + z * stddev`` (and colored noise ``z``) with the same z."""
    monkeypatch.setattr(jcem, "truncated_normal",
                        lambda key, mean, std, shape: mean + jnp.asarray(z)[:shape[0]] * std)
    monkeypatch.setattr(tcem, "truncated_normal",
                        lambda gen, mean, std, shape: mean + torch.as_tensor(z)[:shape[0]] * std)
    monkeypatch.setattr(jbase, "colored_noise",
                        lambda key, beta, shape, dtype=None: jnp.asarray(z)[:shape[0]])
    monkeypatch.setattr(tbase, "colored_noise",
                        lambda gen, beta, shape, dtype=None: torch.as_tensor(z)[:shape[0]])


TARGET = np.linspace(-0.5, 0.5, H * U, dtype=np.float32).reshape(H, U)


def j_evaluate(obs, samples):  # [P, A, H, U] -> [P, A]
    return -jnp.sum(jnp.square(samples - TARGET), axis=(2, 3)) + jnp.sum(obs, axis=-1)


def t_evaluate(obs, samples):
    return -torch.sum(torch.square(samples - torch.as_tensor(TARGET)), dim=(2, 3)) + obs.sum(-1)


@pytest.mark.parametrize("alpha,num_elite", [(0.25, 5), (0.0, 1), (0.6, 32)])
def test_cem_iteration_matches_jax(alpha, num_elite, monkeypatch, rng):
    z = np.clip(rng.normal(size=(P, A, H, U)), -2, 2).astype(np.float32)
    inject(monkeypatch, z)
    lo, hi = np.array([-1.0, -2.0, 0.0], np.float32), np.array([1.0, 0.5, 3.0], np.float32)
    mean = rng.uniform(-0.5, 0.5, (A, H, U)).astype(np.float32) + (lo + hi) / 2
    var = rng.uniform(0.05, 0.5, (A, H, U)).astype(np.float32)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    kw = dict(planning_horizon=H, population=P, num_agents=A, num_elite=num_elite, alpha=alpha)

    jm, jv, _, _, _, jvals = jcem.cem_iteration(
        jcem.CEMConfig(**kw), JBounds.of(lo, hi), j_evaluate, jnp.asarray(obs),
        jnp.asarray(mean), jnp.asarray(var), jax.random.PRNGKey(0),
        jnp.zeros((A, 0, H, U)),
    )
    tm, tv, _, telites, tvals = tcem.cem_iteration(
        tcem.CEMConfig(**kw), TBounds.of(lo, hi), t_evaluate, torch.as_tensor(obs),
        torch.as_tensor(mean), torch.as_tensor(var), torch.Generator(),
    )
    assert telites.shape == (A, num_elite, H, U)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-5, atol=1e-6)


def test_cem_solve_matches_jax(monkeypatch, rng):
    z = np.clip(rng.normal(size=(P, A, H, U)), -2, 2).astype(np.float32)
    inject(monkeypatch, z)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    kw = dict(planning_horizon=H, population=P, num_agents=A, num_elite=4, max_iterations=3)
    js = jcem.make_cem(jcem.CEMConfig(**kw), JBounds.of(-1.0, 1.0, dim=U), j_evaluate)
    ja, jstate, jaux = js.solve(js.init(jax.random.PRNGKey(0)), jnp.asarray(obs), 0,
                                jax.random.PRNGKey(1))
    ts = make_solver("CEM", TBounds.of(-1.0, 1.0, dim=U), t_evaluate, **kw)
    state0 = ts.init(torch.Generator())
    ta, tstate, taux = ts.solve(state0, torch.as_tensor(obs), 0, torch.Generator())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.plan.numpy(), np.asarray(jaux.plan), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.expected_reward.numpy(), np.asarray(jaux.expected_reward),
                               rtol=1e-5, atol=1e-6)
    # warm_start=False: the state is returned unchanged
    assert tstate is state0
    np.testing.assert_allclose(tstate.mean.numpy(), np.asarray(jstate.mean))


def test_truncated_normal_distribution():
    gen = torch.Generator().manual_seed(0)
    mean = torch.tensor([0.5, -1.0])
    std = torch.tensor([2.0, 0.1])
    x = truncated_normal(gen, mean, std, (200_000, 2))
    z = (x - mean) / std
    assert float(z.abs().max()) <= 2.0 + 1e-5
    # N(0,1) truncated to [-2, 2]: mean 0, variance 1 - 2*2*phi(2)/(Phi(2)-Phi(-2)).
    phi2 = np.exp(-2.0) / np.sqrt(2 * np.pi)
    mass = 0.9544997361036416
    var = 1.0 - 4.0 * phi2 / mass
    np.testing.assert_allclose(z.mean(0).numpy(), 0.0, atol=0.01)
    np.testing.assert_allclose(z.var(0).numpy(), var, rtol=0.01)
    # resampled, not clipped: no mass piled at the edges
    assert float((z.abs() > 1.999).float().mean()) < 1e-3


def test_base_helpers_match_jax(rng):
    lo, hi = np.array([-1.0, 0.0], np.float32), np.array([1.0, 4.0], np.float32)
    jb, tb = JBounds.of(lo, hi), TBounds.of(lo, hi)
    mean = rng.uniform(-1, 4, (2, 5, 2)).astype(np.float32)
    var = rng.uniform(0, 3, (2, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tbase.constrain_variance(torch.as_tensor(mean), torch.as_tensor(var), tb).numpy(),
        np.asarray(jbase.constrain_variance(jnp.asarray(mean), jnp.asarray(var), jb)),
        rtol=1e-6)
    np.testing.assert_array_equal(tbase.shift_time(torch.as_tensor(mean)).numpy(),
                                  np.asarray(jbase.shift_time(jnp.asarray(mean))))
    np.testing.assert_array_equal(tbase.init_solution_mean(tb, 5, 2).numpy(),
                                  np.asarray(jbase.init_solution_mean(jb, 5, 2)))
    np.testing.assert_array_equal(tbase.init_solution_variance(tb, 5, 2).numpy(),
                                  np.asarray(jbase.init_solution_variance(jb, 5, 2)))
    noisy = tbase.exploration_noise(torch.Generator(), torch.zeros(64, 2), tb)
    assert bool(((noisy >= torch.as_tensor(lo)) & (noisy <= torch.as_tensor(hi))).all())


def test_with_state_dtype_bf16_roundtrip():
    s = make_solver("CEM", TBounds.of(-1.0, 1.0, dim=U), t_evaluate, planning_horizon=H,
                    population=P, num_agents=A, num_elite=4, max_iterations=1,
                    dtype=torch.bfloat16)
    state = s.init(torch.Generator())
    assert state.mean.dtype == torch.bfloat16
    action, state, aux = s.solve(state, torch.zeros(A, 4), 0, torch.Generator())
    assert state.mean.dtype == torch.bfloat16 and action.dtype == torch.float32


@pytest.mark.parametrize("solver", ["CEM", "PI2", "MPPI", "RandomSearch"])
def test_unported_cem_options_raise(solver):
    """The time-major candidate layout is what is left of the options that raise."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        make_solver(solver, TBounds.of(-1.0, 1.0, dim=U), t_evaluate, time_major=True)


@pytest.mark.parametrize("options,match", [
    (dict(keep_elites=51), "keep_elites"), (dict(keep_elites=-1), "keep_elites"),
    (dict(population=8, num_elite=8, keep_elites=7, mean_as_candidate=True), "population - 2"),
    (dict(population_decay=0.0), "population_decay"), (dict(population_decay=1.5), "decay"),
])
def test_cem_option_ranges_raise_as_in_jax(options, match):
    with pytest.raises(ValueError, match=match):
        jcem.make_cem(jcem.CEMConfig(**options), JBounds.of(-1.0, 1.0, dim=U), j_evaluate)
    with pytest.raises(ValueError, match=match):
        make_solver("CEM", TBounds.of(-1.0, 1.0, dim=U), t_evaluate, **options)


ICEM_OPTIONS = {
    "colored": dict(colored_noise_beta=2.0),
    "keep_elites": dict(keep_elites=3),
    "mean_as_candidate": dict(mean_as_candidate=True),
    "decay": dict(population_decay=0.7),
    "execute_best": dict(execute_best=True),
    "all": dict(colored_noise_beta=1.0, keep_elites=2, mean_as_candidate=True,
                population_decay=0.8, execute_best=True, warm_start=True),
}


@pytest.mark.parametrize("name", sorted(ICEM_OPTIONS))
def test_icem_solve_matches_jax(name, monkeypatch, rng):
    """make_cem with each iCEM option over three iterations, both sides drawing the same z."""
    z = np.clip(rng.normal(size=(P, A, H, U)), -2, 2).astype(np.float32)
    inject(monkeypatch, z)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    kw = dict(planning_horizon=H, population=P, num_agents=A, num_elite=4, max_iterations=3,
              **ICEM_OPTIONS[name])
    js = jcem.make_cem(jcem.CEMConfig(**kw), JBounds.of(-1.0, 1.0, dim=U), j_evaluate)
    ja, jstate, jaux = js.solve(js.init(jax.random.PRNGKey(0)), jnp.asarray(obs), 0,
                                jax.random.PRNGKey(1))
    ts = make_solver("CEM", TBounds.of(-1.0, 1.0, dim=U), t_evaluate, **kw)
    ta, tstate, taux = ts.solve(ts.init(torch.Generator()), torch.as_tensor(obs), 0,
                                torch.Generator())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.plan.numpy(), np.asarray(jaux.plan), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.expected_reward.numpy(), np.asarray(jaux.expected_reward),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tstate.mean.numpy(), np.asarray(jstate.mean), rtol=1e-5, atol=1e-6)


def test_icem_iteration_matches_jax(monkeypatch, rng):
    """One cem_iteration with carried elites, the mean as a candidate, colored noise and a
    decayed population: the update, the carried block and the ranked elites."""
    z = np.clip(rng.normal(size=(P, A, H, U)), -2, 2).astype(np.float32)
    inject(monkeypatch, z)
    mean = rng.uniform(-0.5, 0.5, (A, H, U)).astype(np.float32)
    var = rng.uniform(0.05, 0.5, (A, H, U)).astype(np.float32)
    carried = rng.uniform(-1, 1, (A, 3, H, U)).astype(np.float32)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    kw = dict(planning_horizon=H, population=P, num_agents=A, num_elite=5, keep_elites=3,
              mean_as_candidate=True, colored_noise_beta=2.0)
    jm, jv, _, jcar, jel, jvals = jcem.cem_iteration(
        jcem.CEMConfig(**kw), JBounds.of(-1.0, 1.0, dim=U), j_evaluate, jnp.asarray(obs),
        jnp.asarray(mean), jnp.asarray(var), jax.random.PRNGKey(0), jnp.asarray(carried),
        population=20, n_extract=1)
    tm, tv, tcar, tel, tvals = tcem.cem_iteration(
        tcem.CEMConfig(**kw), TBounds.of(-1.0, 1.0, dim=U), t_evaluate, torch.as_tensor(obs),
        torch.as_tensor(mean), torch.as_tensor(var), torch.Generator(),
        torch.as_tensor(carried), population=20, n_extract=1)
    assert tel.shape == (A, 3, H, U) == jel.shape  # max(n_extract, keep_elites)
    for t, j in ((tm, jm), (tv, jv), (tcar, jcar), (tel, jel), (tvals, jvals)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_iteration_populations_and_init_carried_match_jax():
    for kw in (dict(), dict(population_decay=0.5), dict(population_decay=0.9, keep_elites=10),
               dict(population=60, num_elite=30, population_decay=0.3, mean_as_candidate=True)):
        assert tcem.iteration_populations(tcem.CEMConfig(**kw)) == jcem.iteration_populations(
            jcem.CEMConfig(**kw))
    state = tcem.CEMState(mean=torch.zeros(A, H, U), variance=torch.ones(A, H, U))
    bounds = TBounds.of(-1.0, 1.0, dim=U)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    empty = tcem.init_carried(tcem.CEMConfig(num_agents=A, planning_horizon=H), bounds, state, gen)
    assert empty.shape == (A, 0, H, U) and torch.equal(gen.get_state(), before)  # no draw
    carried = tcem.init_carried(tcem.CEMConfig(num_agents=A, planning_horizon=H, keep_elites=4),
                                bounds, state, gen)
    assert carried.shape == (A, 4, H, U) and float(carried.abs().max()) <= 2.0


def test_colored_noise_matches_jax_on_the_same_spectrum(monkeypatch, rng):
    shape = (5, A, 50, U)
    re, im = (rng.normal(size=(5, A, U, 26)).astype(np.float32) for _ in range(2))
    draws = iter([jnp.asarray(re), jnp.asarray(im)])
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: next(draws))
    monkeypatch.setattr(tbase, "colored_spectrum",
                        lambda gen, shape, dtype=None: (torch.as_tensor(re), torch.as_tensor(im)))
    for beta in (0.0, 2.0):
        draws = iter([jnp.asarray(re), jnp.asarray(im)])
        ref = np.asarray(jbase.colored_noise(jax.random.PRNGKey(0), beta, shape))
        got = tbase.colored_noise(torch.Generator(), beta, shape).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_colored_noise_is_unit_std_and_smooth():
    z = tbase.colored_noise(torch.Generator().manual_seed(0), 3.0, (64, 2, 50, 3))
    assert z.shape == (64, 2, 50, 3)
    np.testing.assert_allclose(z.std(dim=(-2, -1), unbiased=False).numpy(), 1.0, rtol=1e-4)
    white = tbase.colored_noise(torch.Generator().manual_seed(0), 0.0, (64, 2, 50, 3))
    rough = lambda x: float((x[..., 1:, :] - x[..., :-1, :]).square().mean())  # noqa: E731
    assert rough(z) < 0.2 * rough(white)


def test_colored_synthesis_basis_and_penalty_match_jax(rng):
    for horizon, beta in ((50, 2.0), (7, 0.5), (6, 4.0)):
        np.testing.assert_array_equal(tbase.colored_synthesis_basis(horizon, beta),
                                      jbase.colored_synthesis_basis(horizon, beta))
    lo, hi = np.array([-1.0, 0.0], np.float32), np.array([1.0, 4.0], np.float32)
    samples = rng.uniform(-3, 6, (9, A, H, 2)).astype(np.float32)
    jf, jp = jbase.bound_violation_penalty(jnp.asarray(samples), JBounds.of(lo, hi))
    tf, tp = tbase.bound_violation_penalty(torch.as_tensor(samples), TBounds.of(lo, hi))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    assert tp.shape == (9, A) and float(tp.min()) >= 0.0 and float(tp.max()) > 0.0


def test_registry_errors():
    with pytest.raises(KeyError, match="available"):
        make_solver("bogus", TBounds.of(-1.0, 1.0, dim=U), t_evaluate)
    for name in ("PSO", "SPSA", "Gradient", "CEM-GD"):
        with pytest.raises(NotImplementedError, match="item 10"):
            make_solver(name, TBounds.of(-1.0, 1.0, dim=U), t_evaluate)
