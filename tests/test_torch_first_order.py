"""Port parity for the rest of the solver registry: ``adam_polish``, Gradient, CEM-GD, PSO and
SPSA of blackbox_mpc_torch against the JAX package, ``remat`` against the plain rollout, and
the pendulum swing-up budgets of ``tests/test_solvers.py`` for the four solvers.

``jax.random`` and ``torch.Generator`` cannot give the same draws: the port's draws go through
its seams (``gradient.restart_noise``, ``cem.truncated_normal``, ``pso.velocity_coefficients``,
``spsa.rademacher``), patched test-side to return JAX's own draws, made from the key as JAX
makes them. Tolerances: the polish, after every step, rtol 1e-5 (atol 1e-6); Gradient and
CEM-GD action, plan and expected reward 1e-5; PSO and SPSA 1e-5; remat gradients 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import blackbox_mpc_tpu.solvers.cem as jcem
import blackbox_mpc_torch.solvers.cem as tcem
import blackbox_mpc_torch.solvers.gradient as tgrad
import blackbox_mpc_torch.solvers.pso as tpso
import blackbox_mpc_torch.solvers.spsa as tspsa
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.models import dynamics as jdyn
from blackbox_mpc_tpu.models.analytic import pendulum_dynamics as j_pendulum
from blackbox_mpc_tpu.models.analytic import pendulum_reward as j_pendulum_reward
from blackbox_mpc_tpu.rollout.evaluator import make_trajectory_evaluator as j_evaluator
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_tpu.solvers import make_solver as j_make_solver
from blackbox_mpc_torch.core.types import Bounds as TBounds
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.rollout.evaluator import make_trajectory_evaluator
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.solvers import make_solver

TOL = 1e-5
REMAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def pendulum_evaluators(**kw):
    return (j_evaluator(j_pendulum, j_pendulum_reward, **kw),
            make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device="cpu", **kw))


def learned_evaluators(rng):
    """A 2-member 16x16 tanh ensemble (mean) with non-trivial stats, the same weights on both
    sides, and the pendulum reward."""
    cfg = jdyn.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2)
    init, jfn = jdyn.make_learned_dynamics(cfg)
    jdp = init(jax.random.PRNGKey(4))
    stats = {f: np.asarray(getattr(jdp.stats, f)) for f in STATS_FIELDS}
    stats["std_states"] = rng.uniform(0.5, 2.0, 3).astype(np.float32)
    stats["mean_states"] = rng.normal(0, 0.3, 3).astype(np.float32)
    jdp = jdp.replace(stats=type(jdp.stats)(**{f: jnp.asarray(v) for f, v in stats.items()}))
    tcfg = tdyn.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2)
    tdp = dynamics_params_from_numpy(jax.tree_util.tree_map(np.asarray, jdp.params), stats, tcfg,
                                     device="cpu")
    tfn = tdyn.make_learned_dynamics(tcfg)[1]
    return (j_evaluator(lambda s, a: jfn(jdp, s, a), j_pendulum_reward),
            make_trajectory_evaluator(lambda s, a: tfn(tdp, s, a), pendulum_reward, device="cpu"))


# --- adam_polish ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["analytic", "learned"])
def test_adam_polish_matches_jax_each_step(model, rng):
    P, A, H = 4, 2, 6
    jev, tev = pendulum_evaluators() if model == "analytic" else learned_evaluators(rng)
    obs = rng.normal(0, 0.5, (A, 3)).astype(np.float32)
    plans = rng.uniform(-1.5, 1.5, (P, A, H, 1)).astype(np.float32)
    jb, tb = JBounds.of(-2.0, 2.0, dim=1), TBounds.of(-2.0, 2.0, dim=1)
    for steps in range(1, 6):
        want = jbase.adam_polish(lambda p: jev(jnp.asarray(obs), p), jb, optax.adam(0.1),
                                 jnp.asarray(plans), steps)
        got = tbase.adam_polish(lambda p: tev(torch.as_tensor(obs), p), tb, 0.1,
                                torch.as_tensor(plans), steps)
        assert not got.requires_grad
        close(got, want)


def test_adam_polish_runs_under_no_grad_and_clips():
    tb = TBounds.of(-0.3, 0.3, dim=1)
    plans = torch.zeros((3, 1, 4, 1))
    with torch.no_grad():  # act() and plan() run so
        out = tbase.adam_polish(lambda p: torch.sum(p, dim=(2, 3)), tb, 0.5, plans, 4)
    assert float(out.max()) == pytest.approx(0.3) and float(out.min()) >= -0.3


# --- remat ----------------------------------------------------------------------------------


@pytest.mark.parametrize("stochastic", [False, True])
def test_remat_gradients_match_plain(stochastic, rng):
    cfg = tdyn.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=3,
                                     probabilistic=stochastic,
                                     propagation="ts_inf" if stochastic else "mean")
    init, fn = tdyn.make_learned_dynamics(cfg)
    dp = init(torch.Generator().manual_seed(0))
    P, A, H, K = 5, 2, 7, 3 if stochastic else 1
    plans = torch.as_tensor(rng.uniform(-1, 1, (P, A, H, 1)), dtype=torch.float32)
    obs = torch.as_tensor(rng.normal(0, 1, (A, 3)), dtype=torch.float32)
    noise = torch.randn((H, P * K * A, 3), generator=torch.Generator().manual_seed(1))
    grads = {}
    for remat in (False, True):
        ev = make_trajectory_evaluator(
            (lambda s, a, n: fn(dp, s, a, n)) if stochastic else (lambda s, a: fn(dp, s, a)),
            pendulum_reward, num_particles=K, remat=remat, device="cpu")
        leaf = plans.clone().requires_grad_(True)
        out = ev(obs, leaf, noise) if stochastic else ev(obs, leaf)
        (grads[remat],) = torch.autograd.grad(-out.mean(), leaf)
    scale = float(grads[False].abs().max())
    assert scale > 0
    assert float((grads[True] - grads[False]).abs().max()) <= REMAT_TOL * scale


# --- Gradient and CEM-GD --------------------------------------------------------------------


def test_gradient_matches_jax_with_its_restarts(monkeypatch, rng):
    P, A, H = 6, 2, 8
    jev, tev = pendulum_evaluators()
    kw = dict(planning_horizon=H, num_agents=A, population=P, max_iterations=5,
              learning_rate=0.2)
    jb, tb = JBounds.of(-2.0, 2.0, dim=1), TBounds.of(-2.0, 2.0, dim=1)
    js = j_make_solver("Gradient", jb, jev, **kw)
    ts = make_solver("Gradient", tb, tev, **kw)
    mean = rng.uniform(-1, 1, (A, H, 1)).astype(np.float32)
    obs = np.asarray([[-1.0, 0.0, 0.0], [0.5, 0.8, 1.0]], np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (P, A, H, 1)))
    monkeypatch.setattr(tgrad, "restart_noise", lambda g, shape, device: torch.as_tensor(noise))
    ja, jst, jaux = js.solve(js.init(key).replace(mean=jnp.asarray(mean)), jnp.asarray(obs),
                             jnp.asarray(0), key)
    ta, tst, taux = ts.solve(tgrad.GradientState(mean=torch.as_tensor(mean)),
                             torch.as_tensor(obs), 0, torch.Generator())
    close(ta, ja)
    close(taux.plan, jaux.plan)
    close(taux.expected_reward, jaux.expected_reward)
    close(tst.mean, jst.mean)


def fake_truncated_normal(z):
    return lambda gen, mean, std, shape: mean + torch.as_tensor(z)[:shape[0]] * std


def j_fake_truncated_normal(z):
    return lambda key, mean, std, shape: mean + jnp.asarray(z)[:shape[0]] * std


@pytest.mark.parametrize("options", [{}, dict(keep_elites=2, mean_as_candidate=True),
                                     dict(warm_start=True, population_decay=0.7)])
def test_cem_gd_matches_jax_with_its_candidates(options, monkeypatch, rng):
    P, A, H = 24, 2, 6
    z = np.clip(rng.normal(size=(P, A, H, 1)), -2, 2).astype(np.float32)
    monkeypatch.setattr(jcem, "truncated_normal", j_fake_truncated_normal(z))
    monkeypatch.setattr(tcem, "truncated_normal", fake_truncated_normal(z))
    jev, tev = pendulum_evaluators()
    kw = dict(planning_horizon=H, num_agents=A, population=P, num_elite=6, max_iterations=3,
              gd_candidates=3, gd_iterations=4, **options)
    jb, tb = JBounds.of(-2.0, 2.0, dim=1), TBounds.of(-2.0, 2.0, dim=1)
    js, ts = j_make_solver("CEM-GD", jb, jev, **kw), make_solver("CEM-GD", tb, tev, **kw)
    obs = np.asarray([[-1.0, 0.0, 0.0], [0.5, 0.8, 1.0]], np.float32)
    key = jax.random.PRNGKey(0)
    ja, jst, jaux = js.solve(js.init(key), jnp.asarray(obs), jnp.asarray(0), key)
    ta, tst, taux = ts.solve(ts.init(torch.Generator()), torch.as_tensor(obs), 0,
                             torch.Generator())
    close(ta, ja)
    close(taux.plan, jaux.plan)
    close(taux.expected_reward, jaux.expected_reward)
    close(tst.mean, jst.mean)


@pytest.mark.parametrize("options,match", [
    (dict(gd_candidates=0), "gd_candidates"), (dict(gd_candidates=60), "gd_candidates"),
    (dict(population=10, num_elite=20, gd_candidates=3), "num_elite"),
    (dict(keep_elites=51), "keep_elites"), (dict(population_decay=0.0), "population_decay"),
    (dict(execute_best=True), "execute_best"),
])
def test_cem_gd_refuses_as_jax(options, match):
    jb, tb = JBounds.of(-1.0, 1.0, dim=1), TBounds.of(-1.0, 1.0, dim=1)
    with pytest.raises(ValueError, match=match) as want:
        j_make_solver("CEM-GD", jb, lambda o, p: None, **options)
    with pytest.raises(ValueError, match=match) as got:
        make_solver("CEM-GD", tb, lambda o, p: None, **options)
    assert str(got.value) == str(want.value)


# --- PSO and SPSA ---------------------------------------------------------------------------


def pso_coefficients(key, iterations, shape, elementwise):
    """JAX's r1, r2 per iteration, made from the solve key as make_pso makes them."""
    out = []
    for _ in range(iterations):
        key, k1, k2 = jax.random.split(key, 3)
        if elementwise:
            out.append(tuple(np.asarray(jax.random.uniform(k, shape)) for k in (k1, k2)))
        else:
            out.append(tuple(np.asarray(jax.random.normal(k, ())) for k in (k1, k2)))
    return out


@pytest.mark.parametrize("elementwise", [False, True])
def test_pso_matches_jax_with_its_swarm_and_coefficients(elementwise, monkeypatch, rng):
    P, A, H, iters = 16, 2, 5, 2
    jev, tev = pendulum_evaluators()
    kw = dict(planning_horizon=H, num_agents=A, population=P, max_iterations=iters,
              elementwise_random=elementwise)
    jb, tb = JBounds.of(-2.0, 2.0, dim=1), TBounds.of(-2.0, 2.0, dim=1)
    js, ts = j_make_solver("PSO", jb, jev, **kw), make_solver("PSO", tb, tev, **kw)
    key = jax.random.PRNGKey(5)
    jstate = js.init(jax.random.PRNGKey(1))
    # Positions partly out of bounds so the penalty counts.
    jstate = jstate.replace(positions=jnp.asarray(rng.uniform(-2.5, 2.5, (P, A, H, 1)),
                                                  jnp.float32))
    tstate = tpso.PSOState(**{f: torch.as_tensor(np.asarray(getattr(jstate, f)))
                              for f in ("positions", "velocities", "best_positions",
                                        "best_rewards", "global_best_position",
                                        "global_best_reward")})
    coefficients = iter(pso_coefficients(key, iters, (P, A, H, 1), elementwise))
    monkeypatch.setattr(tpso, "velocity_coefficients",
                        lambda g, shape, e: tuple(map(torch.as_tensor, next(coefficients))))
    obs = np.asarray([[-1.0, 0.0, 0.0], [0.5, 0.8, 1.0]], np.float32)
    ja, _, jaux = js.solve(jstate, jnp.asarray(obs), jnp.asarray(0), key)
    ta, _, taux = ts.solve(tstate, torch.as_tensor(obs), 0, torch.Generator())
    close(ta, ja)
    close(taux.plan, jaux.plan)
    close(taux.expected_reward, jaux.expected_reward)


def spsa_deltas(key, iterations, shape):
    out = []
    for _ in range(iterations):
        key, delta_key = jax.random.split(key)
        out.append(np.asarray(jax.random.rademacher(delta_key, shape, dtype=jnp.float32)))
    return out


def quad_eval(xp, target=0.4):
    return lambda obs, a: -xp.sum(xp.square(a - target), axis=(2, 3))


@pytest.mark.parametrize("iterations", [1, 3])
def test_spsa_matches_jax_with_its_deltas(iterations, monkeypatch):
    P, A, H = 32, 2, 3
    kw = dict(planning_horizon=H, num_agents=A, population=P, max_iterations=iterations)
    jb, tb = JBounds.of(-1.0, 1.0, dim=1), TBounds.of(-1.0, 1.0, dim=1)
    js = j_make_solver("SPSA", jb, quad_eval(jnp), **kw)
    ts = make_solver("SPSA", tb, quad_eval(torch), **kw)
    key = jax.random.PRNGKey(3)
    deltas = iter(spsa_deltas(key, iterations, (P, A, H, 1)))
    monkeypatch.setattr(tspsa, "rademacher", lambda g, shape: torch.as_tensor(next(deltas)))
    obs = np.zeros((A, 3), np.float32)
    ja, jst, jaux = js.solve(js.init(key), jnp.asarray(obs), jnp.asarray(0), key)
    ta, tst, taux = ts.solve(ts.init(torch.Generator()), torch.as_tensor(obs), 0,
                             torch.Generator())
    close(ta, ja)
    close(taux.plan, jaux.plan)
    close(taux.expected_reward, jaux.expected_reward)
    close(tst.solution, jst.solution)


def test_spsa_single_iteration_matches_numpy_golden(monkeypatch):
    """The golden of ``tests/test_golden_updates.py::test_spsa_single_iteration_matches_numpy``
    computed in numpy from the same Rademacher draw."""
    pop, agents, horizon = 32, 1, 3
    tb = TBounds.of(-1.0, 1.0, dim=1)
    s = make_solver("SPSA", tb, quad_eval(torch, 0.3), planning_horizon=horizon,
                    num_agents=agents, population=pop, max_iterations=1)
    delta = np.where(np.random.default_rng(3).random((pop, agents, horizon, 1)) < 0.5, -1.0,
                     1.0).astype(np.float32)
    monkeypatch.setattr(tspsa, "rademacher", lambda g, shape: torch.as_tensor(delta))
    action, _, _ = s.solve(s.init(torch.Generator()), torch.zeros(agents, 3), 0,
                           torch.Generator())
    sol0 = np.zeros((agents, horizon, 1), np.float32)
    ak = 0.01 / (0.0 + 1.0 + 1 / 10.0) ** 0.602
    ck = 0.3 / (0.0 + 1.0) ** 0.101
    plus_raw, minus_raw = sol0 + ck * delta, sol0 - ck * delta
    plus, minus = np.clip(plus_raw, -1, 1), np.clip(minus_raw, -1, 1)
    p_pen = np.sum((plus_raw - plus).reshape(pop, agents, -1) ** 2, axis=-1)
    m_pen = np.sum((minus_raw - minus).reshape(pop, agents, -1) ** 2, axis=-1)
    r_plus = -np.sum((plus - 0.3) ** 2, axis=(2, 3)) - p_pen
    r_minus = -np.sum((minus - 0.3) ** 2, axis=(2, 3)) - m_pen
    ghat = np.mean((r_plus - r_minus)[:, :, None, None] / (2.0 * ck * delta), axis=0)
    expected = np.clip(sol0 + ak * ghat, -1, 1)
    np.testing.assert_allclose(action.numpy(), expected[:, 0], rtol=1e-5, atol=1e-6)


# --- swing-up budgets (tests/test_solvers.py) -----------------------------------------------

SWINGUP_BUDGET = {"PSO": (120, 0.6), "SPSA": (200, -0.2), "Gradient": (120, 0.9),
                  "CEM-GD": (80, 0.9)}


@pytest.mark.parametrize("name", sorted(SWINGUP_BUDGET))
def test_pendulum_swingup(name):
    steps, threshold = SWINGUP_BUDGET[name]
    bounds = TBounds.of(-2.0, 2.0, dim=1)
    evaluate = make_trajectory_evaluator(pendulum_dynamics, pendulum_reward, device="cpu")
    kwargs = dict(planning_horizon=25, num_agents=1, population=256, max_iterations=5)
    if name == "CEM-GD":
        kwargs["num_elite"] = 25
    if name == "Gradient":
        kwargs = dict(planning_horizon=25, num_agents=1, population=64, max_iterations=30,
                      learning_rate=0.2)
    s = make_solver(name, bounds, evaluate, **kwargs)
    generator = torch.Generator().manual_seed(42)
    state = s.init(generator)
    obs = torch.tensor([[-1.0, 0.0, 0.0]])  # hanging straight down, at rest
    with torch.no_grad():
        for t in range(steps):
            action, state, _ = s.solve(state, obs, t, generator)
            obs = pendulum_dynamics(obs, action)
    assert float(obs[0, 0]) > threshold, f"{name}: final cos(theta)={float(obs[0, 0]):.3f}"
