"""Port parity for the PETS probabilistic stack: Gaussian heads, ``bound_logvar`` with fixed and
learned bounds, ``ts_inf``/``mm`` propagation fed JAX's own normal draws, the particle
evaluator, pessimistic planning, the NLL trainer with the band regularizer, calibration, the
handler and the policy, each against the JAX package on the same numpy inputs and weights
(carried over with ``dynamics_params_from_numpy``). Mirrors ``tests/test_probabilistic.py``
and ``tests/test_uncertainty_penalty.py``.

Tolerances: ``bound_logvar`` 1e-6; head means and one sampled step 1e-5; an evaluation over
H steps and K particles 1e-4; NLL losses, the regularizer and one Adam step 1e-5 in float32
and 1e-2 in bfloat16; several epochs of training 1e-4 (``tests/test_torch_learning.py``);
calibration 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.solvers.cem as jcem
import blackbox_mpc_torch as tpkg
import blackbox_mpc_torch.policies.mpc_policy as tpolicy
import blackbox_mpc_torch.solvers.cem as tcem
from blackbox_mpc_tpu.core.spaces import BoxSpace as JBox
from blackbox_mpc_tpu.learning.calibration import calibration_summary as j_calibration
from blackbox_mpc_tpu.learning.calibration import head_moments as j_head_moments
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.learning.trainer import make_trainer as j_make_trainer
from blackbox_mpc_tpu.models import dynamics as jdyn
from blackbox_mpc_tpu.models.normalizer import NormalizerStats as JStats
from blackbox_mpc_tpu.policies.mpc_policy import MPCPolicy as JPolicy
from blackbox_mpc_tpu.rollout import evaluator as jev
from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds, truncated_normal
from blackbox_mpc_torch.envs import NativePendulumVecEnv
from blackbox_mpc_torch.learning.calibration import calibration_summary, head_moments
from blackbox_mpc_torch.learning.trainer import flat_params, make_trainer
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy, handler_from_numpy
from blackbox_mpc_torch.models.mlp import ensemble_apply
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.rollout import evaluator as tev
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.utils.metrics import MetricsWriter

S, U, E = 3, 2, 3
STEP_TOL, EVAL_TOL, BOUND_TOL = 1e-5, 1e-4, 1e-6
LOSS_TOL, BF16_TOL = 1e-5, 1e-2
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-4  # several epochs: as tests/test_torch_learning.py


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tensors here are small: one intra-op thread is faster, and the suite's workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(dim_s=S, dim_u=U, dtype="float32", **changes):
    fields = dict(dim_s=dim_s, dim_u=dim_u, hidden=(16, 16), ensemble_size=E,
                  probabilistic=True)
    fields.update(changes)
    return (jdyn.LearnedDynamicsConfig(**fields, compute_dtype=getattr(jnp, dtype)),
            tdyn.LearnedDynamicsConfig(**fields, compute_dtype=getattr(torch, dtype)))


def np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def np_stats(stats):
    return {f: np.asarray(getattr(stats, f)) for f in STATS_FIELDS}


def jax_dynamics(jcfg, rng, seed=1):
    """JAX params with non-trivial stats and, in the learned-bounds layout, bounds moved off
    the constants (so a swapped lv_min/lv_max would show)."""
    dp = jdyn.make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(seed))
    dim_s, dim_u = jcfg.dim_s, jcfg.dim_u
    stats = JStats(*(jnp.asarray(v, jnp.float32) for v in (
        rng.normal(0, 0.3, dim_s), rng.uniform(0.5, 2.0, dim_s), rng.normal(0, 0.3, dim_u),
        rng.uniform(0.5, 2.0, dim_u), rng.normal(0, 0.1, dim_s), rng.uniform(0.2, 1.0, dim_s))))
    params = dp.params
    if isinstance(params, dict):
        params = dict(params, lv_min=jnp.asarray(rng.uniform(-6, -3, dim_s), jnp.float32),
                      lv_max=jnp.asarray(rng.uniform(-1.5, 0.3, dim_s), jnp.float32))
    return dp.replace(params=params, stats=stats)


def bridged(jcfg, tcfg, rng, seed=1):
    jdp = jax_dynamics(jcfg, rng, seed)
    return jdp, dynamics_params_from_numpy(np_params(jdp.params), np_stats(jdp.stats), tcfg,
                                           device="cpu")


def inputs(rng, batch, dim_s=S, dim_u=U):
    return (rng.normal(0, 1, (batch, dim_s)).astype(np.float32),
            rng.uniform(-1, 1, (batch, dim_u)).astype(np.float32))


def jax_normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def jax_step_noise(key, horizon, rows, dim_s):
    """JAX's per-step draws of ``rollout_trajectories``: split(key, H), one normal per step."""
    return np.stack([jax_normal(k, (rows, dim_s)) for k in jax.random.split(key, horizon)])


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("bounds", ["fixed", "learned"])
def test_bound_logvar_matches_jax(bounds, rng):
    x = np.array([-1e4, -100.0, -30.0, -21.0, -20.0, -10.5, -10.0, -1.0, 0.0, 0.5, 1.0, 19.9,
                  20.0, 20.1, 25.0, 100.0, 1e4], np.float32)
    x = np.stack([x, -x, x * 0.01])  # [3, 17]; the bounds broadcast over the last axis
    x = np.ascontiguousarray(x.T)  # [17, 3]
    lv = (None, None) if bounds == "fixed" else (
        rng.uniform(-8, -4, 3).astype(np.float32), rng.uniform(-1, 0.5, 3).astype(np.float32))
    want = jdyn.bound_logvar(jnp.asarray(x), *(None if v is None else jnp.asarray(v) for v in lv))
    got = tdyn.bound_logvar(t(x), *(None if v is None else t(v) for v in lv))
    close(got, want, BOUND_TOL)


@pytest.mark.parametrize("propagation,ensemble,learn_lv,batch", [
    ("mean", 3, False, 8), ("ts1", 3, False, 10), ("ts_inf", 3, True, 10), ("mm", 3, True, 7),
    ("mm", 1, False, 5), ("ts_inf", 1, False, 5)])
def test_head_means_match_jax(propagation, ensemble, learn_lv, batch, rng):
    """Without noise (``key=None`` in JAX) every propagation plans on the head means."""
    jcfg, tcfg = configs(propagation=propagation, ensemble_size=ensemble,
                         learn_logvar_bounds=learn_lv)
    jdp, tdp = bridged(jcfg, tcfg, rng)
    s, a = inputs(rng, batch)
    want = jdyn.make_learned_dynamics(jcfg)[1](jdp, jnp.asarray(s), jnp.asarray(a))
    got = tdyn.make_learned_dynamics(tcfg)[1](tdp, t(s), t(a))
    assert got.shape == (batch, S)
    close(got, want, STEP_TOL)


@pytest.mark.parametrize("propagation,learn_lv,batch", [
    ("ts_inf", False, 9), ("ts_inf", True, 10), ("mm", False, 7), ("mm", True, 6)])
def test_sampled_step_matches_jax(propagation, learn_lv, batch, rng):
    """One ts_inf/mm step fed JAX's own ``normal(key, [B, S])`` draws (batch 10 pads ts_inf)."""
    jcfg, tcfg = configs(propagation=propagation, learn_logvar_bounds=learn_lv)
    jdp, tdp = bridged(jcfg, tcfg, rng)
    s, a = inputs(rng, batch)
    key = jax.random.PRNGKey(7)
    want = jdyn.make_learned_dynamics(jcfg)[1](jdp, jnp.asarray(s), jnp.asarray(a), key)
    _, tfn = tdyn.make_learned_dynamics(tcfg)
    got = tfn(tdp, t(s), t(a), t(jax_normal(key, (batch, S))))
    close(got, want, STEP_TOL)
    assert not torch.allclose(got, tfn(tdp, t(s), t(a)))  # it does sample


def test_learn_logvar_bounds_layout_and_ignored_without_probabilistic():
    _, tcfg = configs(learn_logvar_bounds=True)
    dp = tdyn.make_learned_dynamics(tcfg)[0](torch.Generator().manual_seed(0))
    assert set(dp.params) == {"net", "lv_min", "lv_max"}
    assert torch.equal(dp.params["lv_min"], torch.full((S,), -10.0))
    assert torch.equal(dp.params["lv_max"], torch.full((S,), 0.5))
    assert dp.to("cpu").params.keys() == dp.params.keys()
    _, det = configs(probabilistic=False, learn_logvar_bounds=True)  # JAX ignores it
    assert isinstance(tdyn.make_learned_dynamics(det)[0](torch.Generator()).params, list)


@pytest.mark.parametrize("changes", [
    dict(propagation="ts_inf", probabilistic=False), dict(propagation="mm", probabilistic=False),
    dict(plan_uncertainty_penalty=0.5, ensemble_size=1),
    dict(plan_uncertainty_penalty=0.5, propagation="ts1"),
    dict(plan_uncertainty_penalty=0.5, propagation="ts_inf"),
    dict(plan_uncertainty_penalty=-0.1), dict(propagation="x")])
def test_validation_errors_match_jax(changes):
    jcfg, tcfg = configs(**changes)
    with pytest.raises(ValueError) as jerr:
        jdyn.make_learned_dynamics(jcfg)
    with pytest.raises(ValueError) as terr:
        tdyn.make_learned_dynamics(tcfg)
    assert str(terr.value) == str(jerr.value)


def test_member_permutation_cached_and_outputs_unchanged(rng):
    """ts1/ts_inf index with device-resident permutations made once per (n, E, device); the
    outputs are the bits of the former per-call numpy permutation."""
    jcfg, tcfg = configs(propagation="ts_inf", ensemble_size=5)
    _, tdp = bridged(jcfg, tcfg, rng)
    s, a = inputs(rng, 23)  # padded to 25
    noise = torch.randn(23, S, generator=torch.Generator().manual_seed(3))
    _, tfn = tdyn.make_learned_dynamics(tcfg)
    tdyn.member_permutation.cache_clear()
    out = tfn(tdp, t(s), t(a), noise)
    first = tdyn.member_permutation(25, 5, torch.device("cpu"))
    again = tfn(tdp, t(s), t(a), noise)
    assert tdyn.member_permutation(25, 5, torch.device("cpu"))[0] is first[0]
    assert tdyn.member_permutation.cache_info().misses == 1
    # The former code: numpy argsort and two host copies at every call.
    perm = np.argsort(tdyn.ts_member_ids(25, 5), kind="stable")
    x = torch.cat([tdp.stats.normalize_states(t(s)), tdp.stats.normalize_actions(t(a))], -1)
    x = torch.cat([x, x[-1:].expand(2, -1)])
    raw = ensemble_apply(tdp.params, x[torch.as_tensor(perm)].reshape(5, 5, -1),
                         config=tcfg.mlp).reshape(25, -1)
    raw = raw[torch.as_tensor(np.argsort(perm))][:23]
    want = tdp.stats.denormalize_targets(
        raw[:, :S] + torch.exp(0.5 * tdyn.bound_logvar(raw[:, S:])) * noise) + t(s)
    assert torch.equal(out, again) and torch.equal(out, want)


def test_sampling_statistics(rng):
    """ts_inf draws centre on the head means and spread; mm's draws hold the law of total
    variance: at least the members' disagreement (mirrors tests/test_probabilistic.py)."""
    s = torch.as_tensor([[1.0, 0.0, 2.0], [0.0, -1.0, -2.0]])
    a = torch.as_tensor([[1.5, -0.5], [-1.5, 0.5]])
    g = torch.Generator().manual_seed(0)
    for propagation in ("ts_inf", "mm"):
        _, tcfg = configs(propagation=propagation, ensemble_size=2)
        init, fn = tdyn.make_learned_dynamics(tcfg)
        dp = init(torch.Generator().manual_seed(7))
        draws = torch.stack([fn(dp, s, a, torch.randn(2, S, generator=g)) for _ in range(800)])
        close(draws.mean(0), fn(dp, s, a), 0.15)
        assert float(draws.std(0).min()) > 0.0
    members = [tdyn.make_learned_dynamics(configs(propagation="mean", ensemble_size=1)[1])[1](
        dp.replace(params=[{k: v[e:e + 1] for k, v in layer.items()} for layer in dp.params]),
        s, a) for e in range(2)]
    epistemic = torch.stack(members).var(0, correction=0)
    assert bool((draws.var(0, correction=0) >= 0.7 * epistemic).all())


# ------------------------------------------------------------------ pessimistic planning


def disagreeing(jcfg, rng):
    """JAX params whose members disagree: member 1 perturbed."""
    dp = jax_dynamics(jcfg, rng)
    noisy = jax.tree_util.tree_map(
        lambda p: p + 0.5 * jax.random.normal(jax.random.PRNGKey(7), p.shape, p.dtype), dp.params)
    mixed = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a[:1], b[1:2], a[2:]]) if a.ndim > 1 else a,
        dp.params, noisy)
    return dp.replace(params=mixed)


@pytest.mark.parametrize("propagation", ["mean", "mm"])
def test_penalized_step_matches_jax(propagation, rng):
    jcfg, tcfg = configs(propagation=propagation, plan_uncertainty_penalty=0.5,
                         learn_logvar_bounds=propagation == "mm")
    jdp = disagreeing(jcfg, rng)
    tdp = dynamics_params_from_numpy(np_params(jdp.params), np_stats(jdp.stats), tcfg,
                                     device="cpu")
    s, a = inputs(rng, 6)
    key = jax.random.PRNGKey(3) if propagation == "mm" else None
    jns, jpen = jdyn.make_penalized_dynamics(jcfg)(jdp, jnp.asarray(s), jnp.asarray(a), key)
    noise = None if key is None else t(jax_normal(key, (6, S)))
    tns, tpen = tdyn.make_penalized_dynamics(tcfg)(tdp, t(s), t(a), noise)
    close(tns, jns, STEP_TOL)
    close(tpen, jpen, STEP_TOL)
    assert bool((tpen > 0).all())
    # the same next state as the plain step under the same noise
    assert torch.equal(tns, tdyn.make_learned_dynamics(tcfg)[1](tdp, t(s), t(a), noise))


def test_identical_members_zero_penalty(rng):
    _, tcfg = configs(plan_uncertainty_penalty=0.5)
    dp = tdyn.make_learned_dynamics(tcfg)[0](torch.Generator().manual_seed(0))
    clone = dp.replace(params=tdyn.map_params(lambda v: v[:1].expand_as(v).clone(), dp.params))
    s, a = inputs(rng, 4)
    _, penalty = tdyn.make_penalized_dynamics(tcfg)(clone, t(s), t(a))
    assert torch.equal(penalty, torch.zeros(4))  # ddof 0: the std of equal values is 0
    with pytest.raises(ValueError, match="plan_uncertainty_penalty > 0"):
        tdyn.make_penalized_dynamics(configs()[1])


def test_rollout_accumulates_discounted_penalty_like_jax(rng):
    jcfg, tcfg = configs(plan_uncertainty_penalty=0.5)
    jdp = disagreeing(jcfg, rng)
    tdp = dynamics_params_from_numpy(np_params(jdp.params), np_stats(jdp.stats), tcfg,
                                     device="cpu")
    jpen, tpen = jdyn.make_penalized_dynamics(jcfg), tdyn.make_penalized_dynamics(tcfg)
    s0, _ = inputs(rng, 3)
    acts = rng.uniform(-1, 1, (3, 5, U)).astype(np.float32)
    want = jev.rollout_trajectories(
        lambda s, a: jpen(jdp, s, a), lambda s, a, ns: jnp.sum(ns, -1), jnp.asarray(s0),
        jnp.asarray(acts), discount=0.9, dynamics_returns_penalty=True)
    got = tev.rollout_trajectories(
        lambda s, a: tpen(tdp, s, a), lambda s, a, ns: ns.sum(-1), t(s0), t(acts),
        discount=0.9, dynamics_returns_penalty=True)
    close(got, want, EVAL_TOL)
    plain = tev.rollout_trajectories(
        lambda s, a: tdyn.make_learned_dynamics(tcfg)[1](tdp, s, a), lambda s, a, ns: ns.sum(-1),
        t(s0), t(acts), discount=0.9)
    assert bool((got < plain).all())


# ------------------------------------------------------------------ evaluator


@pytest.mark.parametrize("propagation,particles,smoothness,discount", [
    ("ts_inf", 20, 0.1, 0.9), ("mm", 20, 0.0, 1.0), ("ts_inf", 1, 0.0, 1.0)])
def test_evaluate_with_particles_matches_jax(propagation, particles, smoothness, discount, rng):
    """K particles per candidate, fed JAX's per-step draws: the returns and their mean over
    the particles; without noise K is ignored."""
    jcfg, tcfg = configs(propagation=propagation, learn_logvar_bounds=True,
                         num_particles=particles)
    jdp, tdp = bridged(jcfg, tcfg, rng)
    _, jfn = jdyn.make_learned_dynamics(jcfg)
    _, tfn = tdyn.make_learned_dynamics(tcfg)
    pop, agents, horizon = 6, 2, 5
    s0, _ = inputs(rng, agents)
    acts = rng.uniform(-1, 1, (pop, agents, horizon, U)).astype(np.float32)
    kwargs = dict(num_particles=particles, action_smoothness_weight=smoothness,
                  discount=discount)
    j_eval = jev.make_trajectory_evaluator(lambda s, a, k=None: jfn(jdp, s, a, k),
                                           lambda s, a, ns: ns[:, 0] - 0.1 * jnp.sum(a * a, -1),
                                           **kwargs)
    t_eval = tev.make_trajectory_evaluator(lambda s, a, n=None: tfn(tdp, s, a, n),
                                           lambda s, a, ns: ns[:, 0] - 0.1 * (a * a).sum(-1),
                                           device="cpu", **kwargs)
    key = jax.random.PRNGKey(11)
    want = j_eval(jnp.asarray(s0), jnp.asarray(acts), key)
    noise = t(jax_step_noise(key, horizon, pop * particles * agents, S))
    got = t_eval(t(s0), t(acts), noise)
    assert got.shape == (pop, agents)
    close(got, want, EVAL_TOL)
    close(t_eval(t(s0), t(acts)), j_eval(jnp.asarray(s0), jnp.asarray(acts)), EVAL_TOL)
    with pytest.raises(ValueError, match="noise must be"):
        t_eval(t(s0), t(acts), noise[:, 1:])


def test_evaluator_penalty_matches_jax_and_lowers_rewards(rng):
    jcfg, tcfg = configs(plan_uncertainty_penalty=0.5)
    jdp = disagreeing(jcfg, rng)
    tdp = dynamics_params_from_numpy(np_params(jdp.params), np_stats(jdp.stats), tcfg,
                                     device="cpu")
    jpen, tpen = jdyn.make_penalized_dynamics(jcfg), tdyn.make_penalized_dynamics(tcfg)
    s0, _ = inputs(rng, 2)
    acts = rng.uniform(-1, 1, (5, 2, 4, U)).astype(np.float32)
    want = jev.make_trajectory_evaluator(lambda s, a: jpen(jdp, s, a),
                                         lambda s, a, ns: jnp.sum(ns, -1),
                                         dynamics_returns_penalty=True)(jnp.asarray(s0),
                                                                        jnp.asarray(acts))
    t_pess = tev.make_trajectory_evaluator(lambda s, a: tpen(tdp, s, a),
                                           lambda s, a, ns: ns.sum(-1),
                                           dynamics_returns_penalty=True, device="cpu")
    t_plain = tev.make_trajectory_evaluator(
        lambda s, a: tdyn.make_learned_dynamics(tcfg)[1](tdp, s, a), lambda s, a, ns: ns.sum(-1),
        device="cpu")
    got = t_pess(t(s0), t(acts))
    close(got, want, EVAL_TOL)
    assert bool((got < t_plain(t(s0), t(acts))).all())


# ------------------------------------------------------------------ trainer


def transitions(n, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    s = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], -1).astype(np.float32)
    a = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    ns = pendulum_dynamics(t(s), t(a)).numpy()
    return s, a, (ns + rng.normal(0, noise, ns.shape)).astype(np.float32)


def assert_params_close(tparams, jparams, tol):
    tflat = tdyn.map_params(lambda v: v, tparams)
    for tl, jl in zip(tdyn.net_layers(tflat), jparams["net"] if isinstance(jparams, dict)
                      else jparams):
        for k in ("w", "b"):
            want = np.asarray(jl[k])
            close(tl[k].reshape(want.shape), want, tol)
    if isinstance(jparams, dict):
        for k in ("lv_min", "lv_max"):
            close(tparams[k], jparams[k], tol)


@pytest.mark.parametrize("learn_lv,dtype,ensemble", [
    (False, "float32", 5), (True, "float32", 5), (True, "bfloat16", 5), (True, "float32", 1)])
def test_nll_step_matches_jax(learn_lv, dtype, ensemble, rng):
    """The Gaussian NLL of every member, the band regularizer and one Adam step."""
    jcfg, tcfg = configs(dim_s=3, dim_u=1, dtype=dtype, ensemble_size=ensemble,
                         learn_logvar_bounds=learn_lv)
    jdp, tdp = bridged(jcfg, tcfg, rng)
    s, a, ns = transitions(5 * 32)
    batch = [x.reshape(5, 32, -1)[:ensemble] for x in (s, a, ns)]
    j_init, j_step, j_eval = j_make_trainer(jcfg, learning_rate=1e-3)
    t_init, t_step, t_eval = make_trainer(tcfg, learning_rate=1e-3)
    tol = BF16_TOL if dtype == "bfloat16" else LOSS_TOL
    want = np.atleast_1d(np.asarray(j_eval(jdp.params, jdp.stats, *batch)))
    close(t_eval(tdp.params, tdp.stats, *map(t, batch)), want, tol)
    jts, jl = j_step(j_init(jdp.params), jdp.stats, *batch)
    tts, tl = t_step(t_init(tdp.params), tdp.stats, *map(t, batch))
    close(tl, np.atleast_1d(np.asarray(jl)), tol)
    if learn_lv:  # the regularizer on the bounds: JAX's, 0.01 * (mean(max) - mean(min))
        lv_min, lv_max = tdyn.logvar_bounds(tdp.params)
        close(0.01 * (lv_max.mean() - lv_min.mean()),
              0.01 * (jnp.mean(jdp.params["lv_max"]) - jnp.mean(jdp.params["lv_min"])), 1e-7)
    if dtype == "float32":
        assert_params_close(tts.params, np_params(jts.params), LOSS_TOL)
    assert tts.step == int(jts.step) == 1


@pytest.mark.parametrize("learn_lv,ensemble,patience", [
    (False, 3, None), (True, 3, 2), (True, 1, 2)])
def test_handler_train_matches_jax(learn_lv, ensemble, patience):
    """Two ``train()`` calls: losses, the calibration ratio, epochs, the planning params
    (per-member bests that carry the current bounds) and the writer's tags."""
    jcfg, tcfg = configs(dim_s=3, dim_u=1, ensemble_size=ensemble, learn_logvar_bounds=learn_lv,
                         hidden=(32, 32))
    jh = JHandler(config=jcfg, seed=3, learning_rate=3e-3)
    writer = MetricsWriter()
    th = DynamicsHandler(tcfg, seed=3, learning_rate=3e-3, device="cpu", metrics_writer=writer)
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(np_params(dp.params), np_stats(dp.stats), tcfg,
                                             device="cpu"))
    for call in range(2):
        s, a, ns = transitions(300, seed=call, noise=0.05)
        jh.replay.add_transitions(s, a, ns)
        th.replay.add_transitions(s, a, ns)
        jm = jh.train(epochs=4, batch_size=64, patience=patience)
        tm = th.train(epochs=4, batch_size=64, patience=patience)
        assert set(tm) == set(jm)
        for k in ("train_loss", "val_loss", "val_calibration_ratio"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=TRAIN_RTOL)
        assert tm["epochs_ran"] == jm["epochs_ran"]
        assert_params_close(th.dynamics_params.params, np_params(jh.dynamics_params.params),
                            TRAIN_ATOL)
    ratios = [v for _, v in writer.history["system_model/val_calibration_ratio"]]
    assert len(ratios) == 2 and ratios[-1] == tm["val_calibration_ratio"]
    if learn_lv:  # the bounds are trained
        assert not torch.equal(th.dynamics_params.params["lv_max"], torch.full((3,), 0.5))


@pytest.mark.parametrize("learn_lv", [False, True])
def test_calibration_matches_jax(learn_lv, rng):
    jcfg, tcfg = configs(dim_s=3, dim_u=1, learn_logvar_bounds=learn_lv)
    jdp, tdp = bridged(jcfg, tcfg, rng)
    jh = JHandler(config=jcfg, seed=0, validation_fraction=0.3)
    th = DynamicsHandler(tcfg, seed=0, validation_fraction=0.3, device="cpu")
    jh._params = jdp
    th.set_params(tdp)
    s, a, ns = transitions(400, noise=0.1)
    jh.replay.add_transitions(s, a, ns)
    th.replay.add_transitions(s, a, ns)
    for want, got in zip(j_head_moments(jh), head_moments(th)):
        assert got.dtype == np.float64
        close(got, want, STEP_TOL)
    want, got = j_calibration(jh), calibration_summary(th)
    assert set(got) == set(want) and got["val_points"] == want["val_points"]
    for k in ("variance_ratio", "per_dim_variance_ratio"):
        close(got[k], want[k], STEP_TOL)
    for k in ("coverage_1sigma", "coverage_2sigma"):  # counts of |z| <= c: a tie may move one
        assert abs(got[k] - want[k]) <= 1.0 / (3 * E * want["val_points"]) + 1e-12


def test_calibration_near_one_on_gaussian_targets():
    """A converged NLL head on honestly Gaussian targets reports a variance ratio near 1
    (mirrors tests/test_probabilistic.py::test_train_reports_calibration_ratio)."""
    g = np.random.default_rng(0)
    n = 4000
    s = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    a = g.uniform(-1, 1, (n, 1)).astype(np.float32)
    sigma = np.asarray([0.05, 0.1, 0.2], np.float32)
    ns = (0.8 * s + 0.3 * a + sigma * g.standard_normal((n, 3))).astype(np.float32)
    _, tcfg = configs(dim_s=3, dim_u=1, hidden=(64, 64), ensemble_size=2,
                      learn_logvar_bounds=True)
    th = DynamicsHandler(tcfg, seed=0, learning_rate=3e-3, device="cpu")
    th.replay.add_transitions(s, a, ns)
    ratio = th.train(epochs=60, batch_size=256)["val_calibration_ratio"]
    assert 0.5 < ratio < 2.0, ratio
    summary = calibration_summary(th)
    assert summary["variance_ratio"] == ratio
    assert 0.3 < summary["coverage_1sigma"] < 0.95
    assert summary["per_dim_variance_ratio"].shape == (3,)


def test_deterministic_handler_has_no_calibration():
    th = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(8,)), device="cpu")
    th.replay.add_transitions(*transitions(200))
    assert "val_calibration_ratio" not in th.train(epochs=1)
    assert calibration_summary(th) is None and head_moments(th) is None


# ------------------------------------------------------------------ checkpoints


def test_learned_bounds_checkpoint_round_trip_then_training_continues(tmp_path):
    _, tcfg = configs(dim_s=3, dim_u=1, learn_logvar_bounds=True, propagation="ts_inf")
    th = DynamicsHandler(tcfg, seed=0, device="cpu")
    th.replay.add_transitions(*transitions(300))
    th.train(epochs=2, batch_size=64)
    th.save(str(tmp_path / "ckpt"))
    loaded = DynamicsHandler.load(str(tmp_path / "ckpt"), device="cpu")
    for name in ("lv_min", "lv_max"):
        assert torch.equal(loaded.dynamics_params.params[name], th.dynamics_params.params[name])
    a, b = th.train_state.optimizer.state_dict(), loaded.train_state.optimizer.state_dict()
    assert len(a["state"]) == 2 * 3 + 2  # w, b of three layers, then the two bounds
    for i in a["state"]:
        for k in a["state"][i]:
            assert torch.equal(a["state"][i][k], b["state"][i][k])
    more = transitions(100, seed=4)
    th.replay.add_transitions(*more)
    loaded.replay.add_transitions(*more)
    assert th.train(epochs=2, batch_size=64) == loaded.train(epochs=2, batch_size=64)
    for x, y in zip(flat_params(th.dynamics_params.params),
                    flat_params(loaded.dynamics_params.params)):
        assert torch.equal(x, y)


def test_learned_bounds_jax_checkpoint_crosses_over(tmp_path):
    """The dict layout and its Adam moments map by key (JAX flattens lv_max, lv_min, net)."""
    jcfg, _ = configs(dim_s=3, dim_u=1, learn_logvar_bounds=True, propagation="ts_inf")
    jh = JHandler(config=jcfg, seed=0, learning_rate=3e-3)
    jh.replay.add_transitions(*transitions(300))
    jh.train(epochs=2, batch_size=64)
    jh.save(str(tmp_path / "jax"))
    jl = JHandler.load(str(tmp_path / "jax"), learning_rate=3e-3)
    meta = json.loads((tmp_path / "jax" / "config.json").read_text())
    ts = jl._train_state
    th = handler_from_numpy(meta, np_params(ts.params), np_params(ts.opt_state),
                            np.asarray(ts.step), np_stats(jl.dynamics_params.stats),
                            jl.replay.state_dict(), device="cpu", learning_rate=3e-3)
    adam = th.train_state.optimizer.state_dict()["state"]
    close(adam[6]["exp_avg"], ts.opt_state[0].mu["lv_min"], 0)
    close(adam[7]["exp_avg_sq"], ts.opt_state[0].nu["lv_max"], 0)
    more = transitions(100, seed=4)
    jl.replay.add_transitions(*more)
    th.replay.add_transitions(*more)
    jm, tm = jl.train(epochs=2, batch_size=64), th.train(epochs=2, batch_size=64)
    for k in ("train_loss", "val_loss", "val_calibration_ratio"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=TRAIN_RTOL)
    assert_params_close(th.dynamics_params.params, np_params(jl.dynamics_params.params),
                        TRAIN_ATOL)


# ------------------------------------------------------------------ policy


SOLVER = dict(planning_horizon=5, population=16, num_elite=4, max_iterations=3)


def j_reward(s, a, ns):
    return ns[:, 0] - 0.1 * jnp.sum(jnp.square(a), axis=-1)


def t_reward(s, a, ns):
    return ns[:, 0] - 0.1 * torch.sum(torch.square(a), dim=-1)


@pytest.mark.parametrize("changes", [
    dict(propagation="ts_inf", num_particles=4, learn_logvar_bounds=True),
    dict(propagation="mm", num_particles=2),
    dict(propagation="mean", plan_uncertainty_penalty=1.0, learn_logvar_bounds=True)])
def test_policy_plan_matches_jax_on_injected_candidates_and_noise(changes, monkeypatch, rng):
    """The whole slice: the JAX and the port policy plan alike when both draw the same
    candidates and the port's rollout noise is JAX's per-step draws of the solve's key."""
    z = np.clip(rng.normal(size=(SOLVER["population"], 2, 5, U)), -2, 2).astype(np.float32)
    monkeypatch.setattr(jcem, "truncated_normal",
                        lambda key, mean, std, shape: mean + jnp.asarray(z) * std)
    monkeypatch.setattr(tcem, "truncated_normal",
                        lambda gen, mean, std, shape: mean + torch.as_tensor(z) * std)
    jcfg, tcfg = configs(**changes)
    jdp = disagreeing(jcfg, rng)
    jh = JHandler(config=jcfg, seed=0)
    jh._params = jdp
    th = DynamicsHandler(tcfg, device="cpu")
    th.set_params(dynamics_params_from_numpy(np_params(jdp.params), np_stats(jdp.stats), tcfg,
                                             device="cpu"))
    jp = JPolicy(JBox.of(-1.0, 1.0, dim=U), j_reward, jh, num_agents=2, **SOLVER)
    tp = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, num_agents=2, device="cpu",
                   **SOLVER)
    rollout_key = jax.random.split(jax.random.fold_in(jp._key, 0x504C4E), 3)[2]
    drawn = []

    def jax_noise(generator, shape, device):
        drawn.append(shape)
        return t(jax_step_noise(rollout_key, *shape))

    monkeypatch.setattr(tpolicy, "rollout_noise", jax_noise)
    obs = rng.normal(size=(2, S)).astype(np.float32)
    jplan, jexp = jp.plan(obs)
    tplan, texp = tp.plan(obs)
    np.testing.assert_allclose(tplan, jplan, rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_allclose(texp, jexp, rtol=EVAL_TOL, atol=EVAL_TOL)
    k = tcfg.num_particles if tcfg.propagation in ("ts_inf", "mm") else 0
    assert drawn == ([(5, SOLVER["population"] * k * 2, S)] * SOLVER["max_iterations"]
                     if k else [])
    # act(): the one-step lookahead runs on the unpenalized head means
    action, next_obs, reward = tp.act(obs)
    want = th.mean_dynamics_fn(th.dynamics_params, t(obs), t(action))
    close(next_obs, want, 0)
    assert np.all(np.abs(action) <= 1.0) and np.all(np.isfinite(reward))


def test_rollout_noise_common_within_a_solve_and_new_at_the_next(monkeypatch):
    _, tcfg = configs(propagation="ts_inf", num_particles=3)
    th = DynamicsHandler(tcfg, device="cpu")
    tp = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, device="cpu",
                   **dict(SOLVER, population_decay=1.0))
    drawn = []
    original = tpolicy.rollout_noise
    monkeypatch.setattr(tpolicy, "rollout_noise",
                        lambda *args: drawn.append(original(*args)) or drawn[-1])
    obs = np.zeros(S, np.float32)
    tp.plan(obs)  # a read-only query: it advances neither generator
    tp.act(obs)
    tp.act(obs)
    plan_draws, first, second = (drawn[i:i + 3] for i in (0, 3, 6))
    for solve in (plan_draws, first, second):
        assert all(torch.equal(solve[0], d) for d in solve[1:])
    assert torch.equal(plan_draws[0], first[0])
    assert not torch.allclose(first[0], second[0])


def test_rollout_noise_leaves_the_solver_draws():
    """The noise generator is the policy's own: a stochastic model leaves the solver's
    generator where a deterministic one does."""
    states = []
    for changes in (dict(propagation="ts1"), dict(propagation="ts_inf", num_particles=4)):
        th = DynamicsHandler(configs(**changes)[1], device="cpu")
        tp = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, seed=5, device="cpu",
                       **SOLVER)
        tp.act(np.zeros(S, np.float32), exploration_noise=True)
        states.append(tp._generator.get_state())
    assert torch.equal(*states)


@pytest.mark.parametrize("changes,match", [
    (dict(propagation="ts_inf"), "propagation='ts_inf'"),
    (dict(propagation="mm"), "propagation='mm'"),
    (dict(plan_uncertainty_penalty=1.0), "plan_uncertainty_penalty"),
    (dict(propagation="mean"), "deterministic heads only")])
def test_kernel_backends_refuse_pets_configs(changes, match):
    """Both kernel backends refuse mm, the penalty and a probabilistic head with mean
    propagation; ts_inf is refused by "fused" and taken by "kernel" (K2 samples it)."""
    th = DynamicsHandler(configs(**changes)[1], device="cpu")
    for backend in ("kernel", "fused"):
        if backend == "kernel" and changes == dict(propagation="ts_inf"):
            policy = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th,
                               rollout_backend=backend, device="cpu", **SOLVER)
            assert policy.rollout_backend == "kernel"
            continue
        with pytest.raises(ValueError, match=match):
            MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, rollout_backend=backend,
                      device="cpu", **SOLVER)


def test_exploration_noise_draws_unchanged():
    """The midpoint and std now come from ``Bounds.constant``: the same bits as the former
    numpy copies."""
    bounds = Bounds.of(np.array([-1.0, 0.0], np.float32), np.array([1.0, 4.0], np.float32))
    action = torch.zeros(64, 2)
    got = tbase.exploration_noise(torch.Generator().manual_seed(9), action, bounds, 0.05)
    mid = torch.as_tensor(bounds.midpoint)
    std = torch.as_tensor((bounds.default_variance * 0.05) ** 0.5)
    want = bounds.clip(action + truncated_normal(torch.Generator().manual_seed(9), mid, std,
                                                 action.shape))
    assert torch.equal(got, want)


def test_iterative_mbrl_runs_a_pets_config(tmp_path):
    """learn_dynamics_iteratively_w_mpc with learned bounds, ts_inf and particles, unchanged:
    the calibration ratio reaches the writer, the bounds move, and resume continues."""
    env = NativePendulumVecEnv(num_envs=2, seed=1, max_episode_steps=15)
    writer = MetricsWriter()
    cfg = tdyn.LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(32, 32), ensemble_size=3,
                                     probabilistic=True, learn_logvar_bounds=True,
                                     propagation="ts_inf", num_particles=4)
    common = dict(solver_name="CEM", planning_horizon=5, rollout_horizon=15, batch_size=64,
                  population=16, num_elite=4, max_iterations=2, seed=0,
                  checkpoint_dir=str(tmp_path), device="cpu")
    handler, policy = tpkg.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_initial_rollouts=2, number_of_refinement_steps=1,
        dynamics_config=cfg, epochs=3, metrics_writer=writer, **common)
    ratios = [v for _, v in writer.history["system_model/val_calibration_ratio"]]
    assert len(ratios) == 2 and np.all(np.isfinite(ratios))
    assert not torch.equal(handler.dynamics_params.params["lv_min"], torch.full((3,), -10.0))
    resumed, _ = tpkg.learn_dynamics_iteratively_w_mpc(
        env, pendulum_reward, number_of_refinement_steps=2, epochs=1, resume=True,
        **dict(common, rollout_horizon=4))
    assert json.loads((tmp_path / "loop_state.json").read_text()) == {
        "completed_refinements": 2}
    assert len(resumed.replay) == len(handler.replay) + 8
    assert isinstance(resumed.dynamics_params.params, dict)
