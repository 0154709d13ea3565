"""Port parity for CEM: one ``cem_iteration`` of blackbox_mpc_torch against the JAX one on
identical injected candidates (rtol 1e-5), and the port's truncated normal by distribution.

``jax.random`` and ``torch.Generator`` cannot give the same draws, so both modules'
``truncated_normal`` is replaced, test-side only, by one that returns the same numpy z."""
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
    """Both packages' CEM draw ``mean + z * stddev`` with the same z."""
    monkeypatch.setattr(jcem, "truncated_normal",
                        lambda key, mean, std, shape: mean + jnp.asarray(z) * std)
    monkeypatch.setattr(tcem, "truncated_normal",
                        lambda gen, mean, std, shape: mean + torch.as_tensor(z) * std)


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
    tm, tv, tvals = tcem.cem_iteration(
        tcem.CEMConfig(**kw), TBounds.of(lo, hi), t_evaluate, torch.as_tensor(obs),
        torch.as_tensor(mean), torch.as_tensor(var), torch.Generator(),
    )
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


@pytest.mark.parametrize("option,value", [
    ("colored_noise_beta", 2.0), ("keep_elites", 2), ("population_decay", 0.5),
    ("mean_as_candidate", True), ("execute_best", True), ("time_major", True),
])
def test_unported_cem_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        make_solver("CEM", TBounds.of(-1.0, 1.0, dim=U), t_evaluate, **{option: value})


def test_registry_errors():
    with pytest.raises(KeyError, match="available"):
        make_solver("bogus", TBounds.of(-1.0, 1.0, dim=U), t_evaluate)
    with pytest.raises(NotImplementedError, match="not ported"):
        make_solver("PI2", TBounds.of(-1.0, 1.0, dim=U), t_evaluate)
