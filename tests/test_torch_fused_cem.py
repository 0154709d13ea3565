"""Port parity for the fused CEM (K3-K6): the plain versions behind the CUDA kernels' wrappers
(what runs on CPU tensors) against ``blackbox_mpc_tpu/ops/pallas_cem.py`` with its Pallas
kernels in interpret mode, on the same weights and seeds.

Tolerances: the RNG's integer stage bit for bit; the draws z at rtol/atol 1e-6 (log and cos
of XLA and torch differ in the last ulp); rewards at rtol/atol 1e-4, as the rollout kernel's
parity; moments at rtol 1e-5 (atol 1e-6 for sums that cancel to near 0: the two sum in other
orders); the CEM update at 1e-5 after one iteration and 1e-4 after three. The kernels
themselves are held against these plain versions on the card in test_torch_cuda_kernels.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.pallas_cem as jc
import blackbox_mpc_torch.ops.fused_cem as tc
from blackbox_mpc_tpu.core.spaces import BoxSpace as JBox
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_tpu.models.normalizer import NormalizerStats
from blackbox_mpc_tpu.policies.mpc_policy import MPCPolicy as JPolicy
from blackbox_mpc_tpu.solvers.cem import CEMConfig as JCEMConfig
from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds as TBounds
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.ops import rollout_kernel as rk
from blackbox_mpc_torch.solvers.cem import CEMConfig as TCEMConfig

S, U = 3, 2


def j_reward(s, a, ns):
    return -jnp.sum(jnp.square(ns), axis=-1) - 0.01 * jnp.sum(jnp.square(a), axis=-1)


def t_reward(s, a, ns):
    return -torch.sum(torch.square(ns), dim=-1) - 0.01 * torch.sum(torch.square(a), dim=-1)


STATS = NormalizerStats(
    mean_states=jnp.asarray([0.1, -0.2, 0.3]),
    std_states=jnp.asarray([1.1, 0.9, 2.0]),
    mean_actions=jnp.asarray([0.05, -0.05]),
    std_actions=jnp.asarray([1.5, 0.7]),
    mean_targets=jnp.asarray([0.0, 0.01, -0.01]),
    std_targets=jnp.asarray([0.5, 0.5, 1.2]),
)


def bridged(propagation="mean", hidden=(16, 16), ensemble=2):
    """The same ensemble in both packages: (JAX config, JAX params, port config, port params)."""
    jcfg = LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=hidden, ensemble_size=ensemble,
                                 propagation=propagation)
    dp = make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(0)).replace(stats=STATS)
    tcfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=hidden, ensemble_size=ensemble,
                                      propagation=propagation)
    tdp = dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu")
    return jcfg, dp, tcfg, tdp


def plan_inputs(rng, agents, horizon):
    s0 = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, (agents, horizon, U)).astype(np.float32)
    std = rng.uniform(0.1, 0.6, (agents, horizon, U)).astype(np.float32)
    return s0, mean, std


# ------------------------------------------------------------------------ K3


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 2, 2**31 - 1])
def test_rng_integer_stage_bit_for_bit(seed, rng):
    """fmix32, the keyed counter hash and the top-24-bit uniform, for seeds whose
    ``seed + 0x632BE5AB`` wraps and for int32 counters on both sides of 2**31."""
    values = np.concatenate([
        rng.integers(0, 2**32, 2000, dtype=np.uint64), [0, 1, 2**31 - 1, 2**31, 2**32 - 1],
    ]).astype(np.uint32)
    np.testing.assert_array_equal(
        tc._mix(torch.as_tensor(values.astype(np.int64))).numpy(),
        np.asarray(jc._mix(jnp.asarray(values))).astype(np.int64))
    counters = np.concatenate([
        rng.integers(-2**31, 2**31, 2000), np.arange(2**31 - 8, 2**31),
        np.arange(-2**31, -2**31 + 8),
    ]).astype(np.int32)
    tcount = torch.as_tensor(counters.astype(np.int64))
    for s in (seed, seed + 0x632BE5AB):  # Box-Muller's second stream
        j_seed = jnp.asarray(seed, jnp.int32) + (jnp.int32(0x632BE5AB) if s != seed else 0)
        j_bits = jc._mix((jnp.asarray(counters).astype(jnp.uint32) * jnp.uint32(0x9E3779B1))
                         ^ jc._mix(j_seed.astype(jnp.uint32)))
        np.testing.assert_array_equal(tc._keyed_bits(tcount, s).numpy(),
                                      np.asarray(j_bits).astype(np.int64))
        np.testing.assert_array_equal(
            tc._uniform(tcount, s).numpy().view(np.uint32),
            np.asarray(jc._uniform(jnp.asarray(counters), j_seed)).view(np.uint32))


def test_mirror_z_and_tile_counter_match_jax(rng):
    rows = rng.integers(0, 2_000_000, 300)
    for seed in (7, 2**31 - 1):
        np.testing.assert_allclose(
            tc._mirror_z(seed, torch.as_tensor(rows), 300).numpy(),
            np.asarray(jc._mirror_z(seed, jnp.asarray(rows), 300)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tc._tile_counter(40, 8, 14).numpy(),
                                  np.asarray(jc._tile_counter(40, 8, 14)))
    z = tc._gen_z(tc._tile_counter(0, 64, 50), 3).numpy()
    assert np.abs(z).max() <= 2.0 and np.any(np.abs(z) == 2.0)  # clipped, not resampled


# ------------------------------------------------------------------------ K4, K5, K6

H, A, P = 7, 3, 90  # 270 rows: ragged against the CUDA tile's 4 and the logical tile's 8


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_rollout_rewards_match_jax(propagation, rng):
    jcfg, dp, tcfg, tdp = bridged(propagation)
    s0, mean, std = plan_inputs(rng, A, H)
    kw = dict(horizon=H, agents=A, population=P, tile=8)
    j_rr, _ = jc.make_fused_cem_kernels(jcfg, j_reward, interpret=True, **kw)
    t_rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, **kw)
    ref = np.asarray(j_rr(dp, jnp.asarray(s0), jnp.asarray(mean), jnp.asarray(std), 2**31 - 2))
    launches = tc.fused_rollout.launches
    out = t_rr(tdp, torch.as_tensor(s0), torch.as_tensor(mean), torch.as_tensor(std),
               2**31 - 2)
    assert out.shape == (P, A)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert tc.fused_rollout.launches == launches  # CPU tensors take the plain version
    if propagation == "ts1":
        np.testing.assert_array_equal(t_rr.tile_member_ids, j_rr.tile_member_ids)
        assert t_rr.tile_rows == j_rr.tile_rows == 8


def test_rollout_rewards_streamed_match_jax(rng):
    jcfg, dp, tcfg, tdp = bridged("mean", hidden=(16,))
    s0, mean, std = plan_inputs(rng, A, H)
    kw = dict(horizon=H, agents=A, population=P, streamed=True)
    j_rr, _ = jc.make_fused_cem_kernels(jcfg, j_reward, interpret=True, **kw)
    t_rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, **kw)
    ref = np.asarray(j_rr(dp, jnp.asarray(s0), jnp.asarray(mean), jnp.asarray(std), 99))
    out = t_rr(tdp, torch.as_tensor(s0), torch.as_tensor(mean), torch.as_tensor(std), 99)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_plain_block_and_streamed_draw_the_same_actions(rng):
    _, _, tcfg, tdp = bridged("mean", hidden=(16,))
    ops = rk.make_operands(tdp, tcfg)
    s0, mean, std = (torch.as_tensor(x) for x in plan_inputs(rng, A, H))
    args = (tcfg, ops, s0, mean.reshape(A, -1), std.reshape(A, -1), torch.tensor([5]), 272)
    block = tc.fused_rollout_plain(*args)
    streamed = tc.fused_rollout_plain(*args, streamed=True)
    for a, b in zip(block, streamed):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # row r starts from agent r % A's state and draws mean + std * z of its counters
    z = tc._mirror_z(5, torch.tensor([0, 4, 271]), H * U)
    want = mean.reshape(A, -1)[[0, 1, 1]] + std.reshape(A, -1)[[0, 1, 1]] * z
    torch.testing.assert_close(block[1][:, [0, 4, 271]].transpose(0, 1).reshape(3, -1), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("weights", ["elite_mask", "softmax"])
def test_elite_moments_match_jax(weights, rng):
    jcfg, _, tcfg, _ = bridged("mean", hidden=(16,))
    _, mean, std = plan_inputs(rng, A, H)
    if weights == "elite_mask":
        w = np.zeros((P, A), np.float32)
        for a in range(A):
            w[rng.choice(P, 10, replace=False), a] = 1.0
    else:
        logits = rng.normal(size=(P, A))
        w = (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)
    kw = dict(horizon=H, agents=A, population=P, tile=8)
    _, j_em = jc.make_fused_cem_kernels(jcfg, j_reward, interpret=True, **kw)
    _, t_em = tc.make_fused_cem_kernels(tcfg, t_reward, **kw)
    ref = j_em(jnp.asarray(mean), jnp.asarray(std), 321, jnp.asarray(w))
    launches = tc.elite_moments.launches
    out = t_em(torch.as_tensor(mean), torch.as_tensor(std), 321, torch.as_tensor(w))
    assert tc.elite_moments.launches == launches
    for o, r in zip(out, ref):
        assert o.shape == (A, H * U)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------------ the fused CEM


def record_moments_calls(monkeypatch, module, log, jax_side):
    """Wraps ``module.make_fused_cem_kernels`` so the moments call of every iteration logs the
    sampling mean and std it gets, and the rollout call its rewards."""
    real = module.make_fused_cem_kernels

    def wrapped(*args, **kwargs):
        rollout, moments = real(*args, **kwargs)

        def rollout_logged(*a):
            rewards = rollout(*a)
            if jax_side:
                jax.debug.callback(lambda r: log["rewards"].append(np.asarray(r)), rewards,
                                   ordered=True)
            else:
                log["rewards"].append(rewards.numpy())
            return rewards

        def moments_logged(mean, std, *rest):
            if jax_side:
                jax.debug.callback(
                    lambda m, s: log["iterates"].append((np.asarray(m), np.asarray(s))),
                    mean, std, ordered=True)
            else:
                log["iterates"].append((mean.numpy(), std.numpy()))
            return moments(mean, std, *rest)

        return rollout_logged, moments_logged

    monkeypatch.setattr(module, "make_fused_cem_kernels", wrapped)


SEED = 2**31 - 3


@pytest.mark.parametrize("iterations,tol", [(1, 1e-5), (3, 1e-4)])
def test_fused_cem_matches_jax(iterations, tol, monkeypatch, rng):
    """The mean and the sampling std (the variance through constrain_variance) that iteration
    ``iterations + 1`` starts from, with the per-iteration seed patched to one value on both
    sides; plus the plan after the last iteration and the expected reward."""
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(SEED))
    monkeypatch.setattr(tc, "draw_seed", lambda generator: torch.tensor([SEED], dtype=torch.int32))
    j_log, t_log = {"rewards": [], "iterates": []}, {"rewards": [], "iterates": []}
    record_moments_calls(monkeypatch, jc, j_log, jax_side=True)
    record_moments_calls(monkeypatch, tc, t_log, jax_side=False)
    jcfg, dp, tcfg, tdp = bridged("mean", hidden=(16,))
    agents, horizon, pop, k = 2, 5, 64, 8
    kw = dict(planning_horizon=horizon, num_agents=agents, population=pop, num_elite=k,
              max_iterations=iterations + 1, alpha=0.25)
    obs = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
    js = jc.make_fused_cem(JCEMConfig(**kw), JBounds.of(-3.0, 3.0, dim=U), jcfg, dp, j_reward,
                           tile=8, interpret=True)
    ja, _, jaux = js.solve(js.init(jax.random.PRNGKey(0)), jnp.asarray(obs), 0,
                           jax.random.PRNGKey(1))
    jax.effects_barrier()
    ts = tc.make_fused_cem(TCEMConfig(**kw), TBounds.of(-3.0, 3.0, dim=U), tcfg, tdp, t_reward,
                           tile=8)
    state0 = ts.init(torch.Generator())
    ta, tstate, taux = ts.solve(state0, torch.as_tensor(obs), 0, torch.Generator())
    assert tstate is state0  # warm_start=False keeps the state
    assert len(j_log["iterates"]) == len(t_log["iterates"]) == iterations + 1
    for r in t_log["rewards"]:  # no near-ties at the elite cut, or top-k could differ
        ranked = -np.sort(-r, axis=0)
        assert np.all(ranked[k - 1] - ranked[k] > 1e-3)
    for (jm, jstd), (tm, tstd) in zip(j_log["iterates"], t_log["iterates"]):
        np.testing.assert_allclose(tm, jm, rtol=tol, atol=tol)
        np.testing.assert_allclose(tstd, jstd, rtol=tol, atol=tol)
    np.testing.assert_allclose(taux.plan.numpy(), np.asarray(jaux.plan), rtol=tol, atol=tol)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=tol, atol=tol)
    np.testing.assert_allclose(taux.expected_reward.numpy(), np.asarray(jaux.expected_reward),
                               rtol=tol, atol=tol)


def test_fused_cem_warm_start_and_nan_guard():
    _, _, tcfg, tdp = bridged("mean", hidden=(8,))
    cfg = TCEMConfig(planning_horizon=4, num_agents=2, population=16, num_elite=4,
                     max_iterations=2, warm_start=True)
    solver = tc.make_fused_cem(cfg, TBounds.of(-1.0, 1.0, dim=U), tcfg, lambda: tdp, t_reward)
    obs = torch.tensor([[0.1, 0.2, 0.3], [float("nan"), 0.0, 0.0]])
    action, state, aux = solver.solve(solver.init(torch.Generator()), obs, 0,
                                      torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(action).all()) and bool((action.abs() <= 1.0).all())
    assert float(aux.expected_reward[1]) == -1e6 and bool(torch.isfinite(aux.expected_reward[0]))
    torch.testing.assert_close(state.mean[:, :-1], aux.plan[:, 1:])  # shifted one step


def test_policy_fused_matches_jax_policy(monkeypatch, rng):
    """The slice as a whole: both packages' MPCPolicy(rollout_backend="fused") over one
    ensemble, with the per-iteration seed patched to one value."""
    jcfg, _, tcfg, _ = bridged("mean", hidden=(16,))
    jh = JHandler(config=jcfg, seed=3)
    th = DynamicsHandler(tcfg, device="cpu")
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu"))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(SEED))
    monkeypatch.setattr(tc, "draw_seed", lambda generator: torch.tensor([SEED], dtype=torch.int32))
    solver = dict(planning_horizon=5, population=48, num_elite=6, max_iterations=2)
    jp = JPolicy(JBox.of(-1.0, 1.0, dim=U), j_reward, jh, rollout_backend="fused", **solver)
    tp = MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), t_reward, th, rollout_backend="fused",
                   device="cpu", **solver)
    obs = rng.uniform(-1, 1, S).astype(np.float32)
    jplan, jexp = jp.plan(obs)
    tplan, texp = tp.plan(obs)
    np.testing.assert_allclose(tplan, jplan, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(texp, jexp, rtol=1e-4, atol=1e-4)


def test_policy_fused_closed_loop_on_cpu():
    th = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=4, dim_u=U, hidden=(16,),
                                                     ensemble_size=2), device="cpu")
    tp = MPCPolicy(BoxSpace.of(-0.5, 0.5, dim=U), t_reward, th, rollout_backend="fused_cem",
                   num_agents=3, device="cpu", planning_horizon=6, population=32, num_elite=4,
                   max_iterations=3)
    counts = (tc.fused_rollout.launches, tc.elite_moments.launches)
    obs = np.zeros((3, 4), np.float32)
    for t in range(3):
        action, obs, reward = tp.act(obs, t, exploration_noise=(t == 1))
        assert action.shape == (3, U) and obs.shape == (3, 4) and reward.shape == (3,)
        assert np.all(np.isfinite(action)) and np.all(np.abs(action) <= 0.5)
        assert np.all(np.isfinite(obs)) and np.all(np.isfinite(reward))
    assert (tc.fused_rollout.launches, tc.elite_moments.launches) == counts
    tp.reset()
    tp.switch_solver("CEM", population=16, num_elite=2)
    assert tp.act(obs)[0].shape == (3, U)


# ------------------------------------------------------------------------ errors


def test_policy_fused_constructor_errors():
    space = BoxSpace.of(-1.0, 1.0, dim=U)
    th = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,)),
                         device="cpu")

    def build(handler=th, **kw):
        return MPCPolicy(space, t_reward, handler, device="cpu", rollout_backend="fused", **kw)

    with pytest.raises(ValueError, match="learned MLP"):
        build(DynamicsHandler(true_model=lambda s, a: s, device="cpu"))
    with pytest.raises(ValueError, match="action_smoothness_weight"):
        build(action_smoothness_weight=0.1)
    with pytest.raises(ValueError, match="undiscounted"):
        build(discount=0.99)
    with pytest.raises(ValueError, match="time_major"):
        build(time_major=True)
    for name in ("SPSA", "PSO", "Gradient", "CEM-GD"):
        with pytest.raises(ValueError, match="fused"):
            build(solver_name=name)
    with pytest.raises(ValueError, match="sep-CMA only"):
        build(solver_name="CMA-ES")  # diagonal=False, as in the JAX package
    with pytest.raises(KeyError, match="available"):
        build(solver_name="bogus")
    with pytest.raises(ValueError, match="keep_elites"):
        build(keep_elites=60)
    with pytest.raises(NotImplementedError, match="item 9"):
        MPCPolicy(space, t_reward, th, device="cpu", rollout_backend="auto")
    # ts1 at 4 tiles of 256 rows for 5 members raises, as in the JAX package
    ts1 = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(8,),
                                                      ensemble_size=5, propagation="ts1"),
                          device="cpu")
    with pytest.raises(ValueError, match="ts1 fused CEM needs >= 5 tiles"):
        build(ts1, population=1000)


BOX = (np.zeros(U), np.ones(U))


@pytest.mark.parametrize("flags,match", [
    (dict(clip_bounds=BOX, extra_slots=2), "mutually exclusive"),
    (dict(colored_noise_beta=2.0, sampling="uniform"), "normal sampling only"),
    (dict(extra_slots=16), "fresh candidate"),
    (dict(streamed=True, colored_noise_beta=2.0), "streamed"),
    (dict(streamed=True, extra_slots=2), "streamed"),
    (dict(streamed=True, sampling="uniform"), "streamed"),
    (dict(streamed=True, aux_dot=True), "streamed"),
    (dict(streamed=True, clip_bounds=BOX), "streamed"),
    # 14e6 rows of 50 steps x 6 dims: 4.2e9 white counters, but 4.37e9 (>= 2**32) colored ones
    (dict(colored_noise_beta=2.0, population=14_000_000, horizon=50, agents=1), "2\\^32"),
])
def test_kernels_flag_errors_kept_from_jax(flags, match):
    """The option combinations that the JAX package refuses raise its ValueErrors here."""
    jcfg, _, tcfg, _ = bridged("mean", hidden=(8,))
    kw = {**dict(horizon=4, agents=1, population=16), **flags}
    if kw["horizon"] == 50:  # the flagship's action width, for the counter bound
        jcfg, tcfg = (dataclasses.replace(c, dim_u=6) for c in (jcfg, tcfg))
        tc.make_fused_cem_kernels(tcfg, t_reward, **{**kw, "colored_noise_beta": 0.0})
    with pytest.raises(ValueError, match=match):
        jc.make_fused_cem_kernels(jcfg, j_reward, **kw)
    with pytest.raises(ValueError, match=match):
        tc.make_fused_cem_kernels(tcfg, t_reward, **kw)


def test_kernels_errors_kept_from_jax():
    _, _, tcfg, _ = bridged("mean", hidden=(8,))
    _, _, ts1cfg, _ = bridged("ts1", hidden=(8,), ensemble=5)
    kw = dict(horizon=50, agents=1, population=1000)
    with pytest.raises(ValueError, match="sampling"):
        tc.make_fused_cem_kernels(tcfg, t_reward, sampling="sobol", **kw)
    with pytest.raises(ValueError, match="2\\^32"):
        tc.make_fused_cem_kernels(tcfg, t_reward, horizon=50, agents=1, population=2**26)
    with pytest.raises(ValueError, match="ts1 fused CEM needs >= 5 tiles"):
        tc.make_fused_cem_kernels(ts1cfg, t_reward, **kw)  # 4 tiles of 256
    rr, _ = tc.make_fused_cem_kernels(ts1cfg, t_reward, tile=128, **kw)  # 8 tiles
    assert sorted(set(rr.tile_member_ids)) == list(range(5))
    with pytest.raises(ValueError, match="multiple of the CUDA row tile"):
        tc.make_fused_cem_kernels(tcfg, t_reward, tile=6, **kw)
    with pytest.raises(ValueError, match="streamed"):
        tc.make_fused_cem_kernels(ts1cfg, t_reward, streamed=True, tile=128, **kw)
    with pytest.raises(ValueError, match="num_elite"):
        tc.make_fused_cem(TCEMConfig(population=10, num_elite=20), TBounds.of(-1.0, 1.0, dim=U),
                          tcfg, None, t_reward)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tc.make_fused_cem(TCEMConfig(time_major=True), TBounds.of(-1.0, 1.0, dim=U), tcfg, None,
                          t_reward)
    for option, value in (("keep_elites", 51), ("population_decay", 0.0)):
        with pytest.raises(ValueError, match=option):
            tc.make_fused_cem(dataclasses.replace(TCEMConfig(), **{option: value}),
                              TBounds.of(-1.0, 1.0, dim=U), tcfg, None, t_reward)
    bad = dataclasses.replace(tcfg, activation="swish")
    with pytest.raises(ValueError, match="activation"):
        tc.make_fused_cem_kernels(bad, t_reward, **kw)
