"""Port parity for the rest of the generate-in-kernel family: every option of K3, K4 and K6
(colored and uniform sampling, the bounds clip with its penalty, injected candidates, the MPPI
dot) and the solvers over them (iCEM, PI2/MPPI, RandomSearch, sep-CMA), against
``blackbox_mpc_tpu/ops/pallas_cem.py`` with its Pallas kernels in interpret mode; and the eager
PI2, RandomSearch and CMA-ES against the JAX ones on identical injected noise.

On CPU tensors the port's wrappers take their plain versions, which is what is compared here;
the CUDA kernels are held against those plain versions on the card (test_torch_cuda_kernels.py).

Tolerances: the RNG's integer stage and the uniform draw bit for bit; colored z at 1e-5 (the
matmul and the row statistics of XLA and torch sum in other orders); rewards at 1e-4 relative
and dots at 1e-4; moments at 1e-5; a fused solver's plan and expected reward at 1e-4 after one
iteration and 1e-3 after three; the eager solvers at 1e-5 (the full-covariance CMA-ES, whose
eigendecomposition and Cholesky come from two LAPACKs, at 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.pallas_cem as jc
import blackbox_mpc_tpu.solvers.cma_es as jcma
import blackbox_mpc_tpu.solvers.pi2 as jpi2
import blackbox_mpc_tpu.solvers.random_search as jrs
import blackbox_mpc_torch.ops.fused_cem as tc
import blackbox_mpc_torch.solvers.cma_es as tcma
import blackbox_mpc_torch.solvers.pi2 as tpi2
import blackbox_mpc_torch.solvers.random_search as trs
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig, make_learned_dynamics
from blackbox_mpc_tpu.models.normalizer import NormalizerStats
from blackbox_mpc_tpu.solvers import base as jbase
from blackbox_mpc_tpu.solvers.cem import CEMConfig as JCEMConfig
from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds as TBounds
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.policies import RandomPolicy
from blackbox_mpc_torch.solvers import base as tbase
from blackbox_mpc_torch.solvers import make_solver
from blackbox_mpc_torch.solvers.cem import CEMConfig as TCEMConfig

S, U, H, A, P, TILE = 3, 2, 5, 2, 16, 8
LOWER, UPPER = np.array([-1.0, -0.5], np.float32), np.array([0.5, 1.0], np.float32)
SEED = 2**31 - 3


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


def bridged(propagation="mean", hidden=(16,), ensemble=2):
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


def plan_inputs(rng, agents=A, horizon=H):
    s0 = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, (agents, horizon, U)).astype(np.float32)
    std = rng.uniform(0.1, 0.6, (agents, horizon, U)).astype(np.float32)
    return s0, mean, std


def both(fn_j, fn_t, *arrays, **named):
    """Calls the JAX function on jnp copies and the port's on torch copies of numpy inputs."""
    to_j = lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x  # noqa: E731
    to_t = lambda x: torch.as_tensor(x) if isinstance(x, np.ndarray) else x  # noqa: E731
    ref = fn_j(*map(to_j, arrays), **{k: to_j(v) for k, v in named.items()})
    got = fn_t(*map(to_t, arrays), **{k: to_t(v) for k, v in named.items()})
    return got, ref


# ------------------------------------------------------------------------ K3


def test_colored_basis2_equals_jax():
    for horizon, dim_u, beta in ((50, 6, 2.0), (5, 2, 1.0), (6, 3, 0.5)):
        ours = tc._colored_basis2(horizon, dim_u, beta)
        assert ours.dtype == np.float32 and ours.shape == (dim_u * 2 * (horizon // 2 + 1),
                                                           horizon * dim_u)
        np.testing.assert_array_equal(ours, jc._colored_basis2(horizon, dim_u, beta))


@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_mirror_z_uniform_bit_for_bit(seed, rng):
    rows = rng.integers(0, 2_000_000, 200)
    got = tc._mirror_z(seed, torch.as_tensor(rows), 300, sampling="uniform").numpy()
    ref = np.asarray(jc._mirror_z(seed, jnp.asarray(rows), 300, sampling="uniform"))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert -1.0 < got.min() < -0.99 and 0.99 < got.max() < 1.0


@pytest.mark.parametrize("horizon,dim_u,beta", [(50, 6, 2.0), (5, 2, 1.0), (8, 3, 3.0)])
def test_mirror_z_colored_matches_jax(horizon, dim_u, beta, rng):
    """The counters run over U*2F columns, not H*U: rows far apart in both streams."""
    basis2 = jc._colored_basis2(horizon, dim_u, beta)
    rows = rng.integers(0, 1_000_000, 64)
    n_flat = horizon * dim_u
    for seed in (11, 2**31 - 2):
        got = tc._mirror_z(seed, torch.as_tensor(rows), n_flat, torch.as_tensor(basis2)).numpy()
        ref = np.asarray(jc._mirror_z(seed, jnp.asarray(rows), n_flat, jnp.asarray(basis2)))
        assert got.shape == (64, n_flat)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        # unit std per row, which the clip at +/-2 can only lower
        assert np.all(got.std(axis=1) <= 1.0 + 1e-5) and np.all(got.std(axis=1) > 0.6)
        assert np.abs(got).max() <= 2.0
    counter = tc._tile_counter(40, 8, basis2.shape[0])
    np.testing.assert_allclose(
        tc._gen_z(counter, 5, torch.as_tensor(basis2)).numpy(),
        np.asarray(jc._gen_z(jnp.asarray(counter.numpy().astype(np.int32)), jnp.int32(5),
                             jnp.asarray(basis2))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampling", ["normal", "uniform"])
@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_draw_rows_matches_the_jax_mirror(sampling, seed, rng):
    """K3 on its own: on CPU tensors draw_rows is the plain ``_mirror_z``. Uniform draws are
    the JAX mirror's bits; normal ones agree to 1e-6 (torch's and XLA's logf and cosf may
    differ in an ulp; the integer stage is bit for bit, test_torch_fused_cem.py). A tensor
    seed and an int seed give the same bits."""
    rows = rng.integers(0, 2_000_000, 50)
    launches = tc.draw_rows.launches
    got = tc.draw_rows(seed, torch.as_tensor(rows), 300, sampling=sampling).numpy()
    again = tc.draw_rows(torch.tensor([seed], dtype=torch.int32),
                         torch.as_tensor(rows, dtype=torch.int32), 300, sampling=sampling)
    assert tc.draw_rows.launches == launches  # CPU tensors take the plain version
    np.testing.assert_array_equal(again.numpy().view(np.uint32), got.view(np.uint32))
    ref = np.asarray(jc._mirror_z(seed, jnp.asarray(rows), 300, sampling=sampling))
    if sampling == "uniform":
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("horizon,dim_u,beta", [(50, 6, 2.0), (5, 2, 1.0), (8, 3, 3.0)])
def test_draw_rows_colored_from_the_basis_block(horizon, dim_u, beta, rng):
    """draw_rows takes the kernels' [2F, H] block; on the CPU it expands it to the dense matrix
    the plain version multiplies by, which is the JAX package's to the bit."""
    basis2 = jc._colored_basis2(horizon, dim_u, beta)
    block = tc._basis_block(torch.as_tensor(basis2), dim_u)
    assert block.shape == (2 * (horizon // 2 + 1), horizon)
    np.testing.assert_array_equal(tc._dense_basis(block, dim_u).numpy(), basis2)
    rows = rng.integers(0, 1_000_000, 32)
    got = tc.draw_rows(11, torch.as_tensor(rows), horizon * dim_u, block).numpy()
    ref = np.asarray(jc._mirror_z(11, jnp.asarray(rows), horizon * dim_u, jnp.asarray(basis2)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_draw_rows_rejects_rows_on_another_device():
    with pytest.raises(ValueError, match="row_ids is on meta"):
        tc.draw_rows(5, torch.arange(4, device="meta"), 12)
    with pytest.raises(ValueError, match="row_ids is on cpu"):
        tc.draw_rows(torch.tensor([5], dtype=torch.int32, device="meta"), torch.arange(4), 12)


def counting_draws(monkeypatch):
    """Replaces draw_rows by a wrapper that records each call's row count."""
    calls = []
    draw = tc.draw_rows

    def counted(seed, row_ids, *args, **kwargs):
        calls.append(row_ids.numel())
        return draw(seed, row_ids, *args, **kwargs)

    monkeypatch.setattr(tc, "draw_rows", counted)
    return calls


@pytest.mark.parametrize("iterations", [1, 3])
def test_fused_cem_reads_candidates_through_draw_rows(iterations, monkeypatch):
    """The carried elites' placeholders (once per solve) and the elite values of each
    iteration (keep_elites, execute_best) come from draw_rows, K3's wrapper."""
    _, _, tcfg, tdp = bridged()
    calls = counting_draws(monkeypatch)
    cfg = TCEMConfig(planning_horizon=H, num_agents=A, population=32, num_elite=4,
                     max_iterations=iterations, keep_elites=3, execute_best=True,
                     colored_noise_beta=2.0)
    solver = tc.make_fused_cem(cfg, TBounds.of(LOWER, UPPER), tcfg, tdp, t_reward, tile=TILE)
    solver.solve(solver.init(torch.Generator()), torch.zeros(A, S), 0, torch.Generator())
    assert calls == [3 * A] + [3 * A] * iterations


def test_fused_random_search_reads_its_argmax_through_draw_rows(monkeypatch):
    _, _, tcfg, tdp = bridged()
    calls = counting_draws(monkeypatch)
    cfg = trs.RandomSearchConfig(planning_horizon=H, num_agents=A, population=40)
    solver = tc.make_fused_random_search(cfg, TBounds.of(LOWER, UPPER), tcfg, tdp, t_reward,
                                         tile=TILE)
    for t in range(2):
        solver.solve(solver.init(torch.Generator()), torch.zeros(A, S), t, torch.Generator())
    assert calls == [A, A]


# ------------------------------------------------------------------------ K4 and K6

BOX =(np.array([-0.4, -0.3], np.float32), np.array([0.5, 0.35], np.float32))  # many draws clip
FLAGS = {
    "colored": dict(colored_noise_beta=2.0),
    "uniform": dict(sampling="uniform"),
    "extra": dict(extra_slots=3),
    "clip": dict(clip_bounds=BOX),
    "clip+dot": dict(clip_bounds=BOX, aux_dot=True),
    "dot": dict(aux_dot=True),
    "colored+extra": dict(colored_noise_beta=2.0, extra_slots=3),
    "colored+clip+dot": dict(colored_noise_beta=1.0, clip_bounds=BOX, aux_dot=True),
    "extra+dot": dict(extra_slots=2, aux_dot=True),
}


def kernel_pair(flags, propagation="mean", population=P + 2):
    """Both packages' (rollout_rewards, elite_moments) at 36 rows: ragged against the JAX tile
    of 8, so injected slots sit right before padding rows."""
    jcfg, dp, tcfg, tdp = bridged(propagation)
    kw = dict(horizon=H, agents=A, population=population, tile=TILE, **flags)
    return (jc.make_fused_cem_kernels(jcfg, j_reward, interpret=True, **kw), dp,
            tc.make_fused_cem_kernels(tcfg, t_reward, **kw), tdp)


def operands(flags, rng, for_rollout):
    named = {}
    if flags.get("extra_slots"):
        named["extra"] = rng.uniform(-1, 1, (flags["extra_slots"], A, H * U)).astype(np.float32)
    if for_rollout and flags.get("aux_dot"):
        named["gvec"] = rng.normal(size=(A, H * U)).astype(np.float32)
    return named


@pytest.mark.parametrize("name,propagation", [(n, "mean") for n in sorted(FLAGS)]
                         + [("colored+extra", "ts1"), ("clip+dot", "ts1")])
def test_rollout_rewards_flags_match_jax(name, propagation, rng):
    flags = FLAGS[name]
    (j_rr, _), dp, (t_rr, _), tdp = kernel_pair(flags, propagation,
                                                population=24 if propagation == "ts1" else P + 2)
    s0, mean, std = plan_inputs(rng)
    named = operands(flags, rng, for_rollout=True)
    launches = tc.fused_rollout.launches
    got, ref = both(lambda *a, **k: j_rr(dp, *a, **k), lambda *a, **k: t_rr(tdp, *a, **k),
                    s0, mean, std, 2**31 - 2, **named)
    assert tc.fused_rollout.launches == launches  # CPU tensors take the plain version
    if flags.get("aux_dot"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-4)
        got, ref = got[0], ref[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    colored = flags.get("colored_noise_beta", 0.0) > 0.0
    assert (t_rr.basis2 is not None) == colored == (j_rr.basis2 is not None)
    if colored:
        np.testing.assert_array_equal(t_rr.basis2.numpy(), np.asarray(j_rr.basis2))


def test_rollout_penalty_and_dot_are_the_eager_ones(rng):
    """rewards = evaluate(clipped) - bound_violation_penalty and dots = <gvec, clipped - mean>,
    from the candidates the mirror regenerates."""
    _, _, tcfg, tdp = bridged()
    rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, horizon=H, agents=A, population=P,
                                      tile=TILE, clip_bounds=BOX, aux_dot=True)
    plain_rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, horizon=H, agents=A, population=P,
                                            tile=TILE, extra_slots=P - 1)
    s0, mean, std = (torch.as_tensor(x) for x in plan_inputs(rng))
    gvec = torch.as_tensor(rng.normal(size=(A, H * U)).astype(np.float32))
    rewards, dots = rr(tdp, s0, mean, std, 5, gvec=gvec)
    z = tc._mirror_z(5, torch.arange(P * A), H * U).reshape(P, A, H, U)
    samples, penalty = tbase.bound_violation_penalty(mean + std * z, TBounds.of(*BOX))
    assert float(penalty.max()) > 0.01
    # roll the clipped candidates out by injecting all but one of them
    injected = plain_rr(tdp, s0, mean, std, 5, extra=samples[1:].reshape(P - 1, A, H * U))
    torch.testing.assert_close(rewards[1:], injected[1:] - penalty[1:], rtol=1e-5, atol=1e-5)
    want = torch.einsum("ahu,pahu->pa", gvec.reshape(A, H, U), samples - mean[None])
    torch.testing.assert_close(dots, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["colored", "uniform", "extra", "clip", "colored+extra",
                                  "colored+clip+dot"])
def test_elite_moments_flags_match_jax(name, rng):
    flags = {k: v for k, v in FLAGS[name].items() if k != "aux_dot"}
    (_, j_em), _, (_, t_em), _ = kernel_pair(flags)
    _, mean, std = plan_inputs(rng)
    logits = rng.normal(size=(P + 2, A))
    weights = (np.exp(logits) / np.exp(logits).sum(0)).astype(np.float32)  # not a 0/1 mask
    launches = tc.elite_moments.launches
    got, ref = both(j_em, t_em, mean, std, 321, weights, **operands(flags, rng, False))
    assert tc.elite_moments.launches == launches
    for o, r in zip(got, ref):
        assert o.shape == (A, H * U)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_kernels_flags_need_their_operands():
    _, _, tcfg, tdp = bridged()
    kw = dict(horizon=H, agents=A, population=P, tile=TILE)
    s0, mean, std = (torch.zeros(A, S), torch.zeros(A, H, U), torch.ones(A, H, U))
    rr, em = tc.make_fused_cem_kernels(tcfg, t_reward, extra_slots=2, **kw)
    with pytest.raises(ValueError, match="pass extra"):
        rr(tdp, s0, mean, std, 1)
    with pytest.raises(ValueError, match="pass extra"):
        em(mean, std, 1, torch.ones(P, A))
    rr, _ = tc.make_fused_cem_kernels(tcfg, t_reward, aux_dot=True, **kw)
    with pytest.raises(ValueError, match="pass gvec"):
        rr(tdp, s0, mean, std, 1)
    with pytest.raises(ValueError, match="needs mean"):
        tc.elite_moments(std.reshape(A, -1), torch.ones(P * A), torch.tensor([1]), None,
                         tc.Features(clip=torch.zeros(2, U)))


# ------------------------------------------------------------------------ the fused solvers


def patch_seeds(monkeypatch):
    """One seed for every iteration on both sides (``jax.random`` and ``torch.Generator``
    cannot agree on a draw)."""
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(SEED))
    monkeypatch.setattr(tc, "draw_seed", lambda generator: torch.tensor([SEED], dtype=torch.int32))


def solve_both(j_solver, t_solver, obs):
    ja, jstate, jaux = j_solver.solve(j_solver.init(jax.random.PRNGKey(0)), jnp.asarray(obs), 0,
                                      jax.random.PRNGKey(1))
    ta, tstate, taux = t_solver.solve(t_solver.init(torch.Generator()), torch.as_tensor(obs), 0,
                                      torch.Generator())
    return (ja, jstate, jaux), (ta, tstate, taux)


def assert_solves_agree(j_out, t_out, tol):
    (ja, jstate, jaux), (ta, tstate, taux) = j_out, t_out
    np.testing.assert_allclose(taux.plan.numpy(), np.asarray(jaux.plan), rtol=tol, atol=tol)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=tol, atol=tol)
    np.testing.assert_allclose(taux.expected_reward.numpy(), np.asarray(jaux.expected_reward),
                               rtol=tol, atol=tol)
    if hasattr(jstate, "mean"):
        np.testing.assert_allclose(tstate.mean.numpy(), np.asarray(jstate.mean), rtol=tol,
                                   atol=tol)


ICEM = {
    "colored": dict(colored_noise_beta=2.0),
    "keep_elites": dict(keep_elites=3),
    "mean_as_candidate": dict(mean_as_candidate=True),
    "decay": dict(population_decay=0.6),
    "execute_best": dict(execute_best=True),
    "all": dict(colored_noise_beta=1.0, keep_elites=2, mean_as_candidate=True,
                population_decay=0.7, execute_best=True, warm_start=True),
}


@pytest.mark.parametrize("iterations,tol", [(1, 1e-4), (3, 1e-3)])
@pytest.mark.parametrize("name", sorted(ICEM))
def test_fused_icem_matches_jax(name, iterations, tol, monkeypatch, rng):
    patch_seeds(monkeypatch)
    jcfg, dp, tcfg, tdp = bridged()
    kw = dict(planning_horizon=H, num_agents=A, population=32, num_elite=4,
              max_iterations=iterations, alpha=0.25, **ICEM[name])
    obs = rng.uniform(-1, 1, (A, S)).astype(np.float32)
    js = jc.make_fused_cem(JCEMConfig(**kw), JBounds.of(LOWER, UPPER), jcfg, dp, j_reward,
                           tile=TILE, interpret=True)
    ts = tc.make_fused_cem(TCEMConfig(**kw), TBounds.of(LOWER, UPPER), tcfg, tdp, t_reward,
                           tile=TILE)
    assert_solves_agree(*solve_both(js, ts, obs), tol)


PI2 = {
    "PI2": (jpi2.PI2Config, tpi2.PI2Config, dict(lamda=0.5)),
    "PI2-CMA colored": (jpi2.PI2Config, tpi2.PI2Config,
                        dict(adapt_variance=True, colored_noise_beta=2.0, lamda=0.5)),
    "MPPI": (jpi2.MPPIConfig, tpi2.MPPIConfig, dict(lamda=0.5)),
}


@pytest.mark.parametrize("iterations,tol", [(1, 1e-4), (3, 1e-3)])
@pytest.mark.parametrize("name", sorted(PI2))
def test_fused_pi2_matches_jax(name, iterations, tol, monkeypatch, rng):
    patch_seeds(monkeypatch)
    jcfg, dp, tcfg, tdp = bridged()
    j_cls, t_cls, options = PI2[name]
    kw = dict(planning_horizon=H, num_agents=A, population=32, max_iterations=iterations,
              **options)
    obs = rng.uniform(-1, 1, (A, S)).astype(np.float32)
    js = jc.make_fused_pi2(j_cls(**kw), JBounds.of(LOWER, UPPER), jcfg, dp, j_reward, tile=TILE,
                           interpret=True)
    ts = tc.make_fused_pi2(t_cls(**kw), TBounds.of(LOWER, UPPER), tcfg, tdp, t_reward, tile=TILE)
    assert ts.name == js.name
    assert_solves_agree(*solve_both(js, ts, obs), tol)


def test_fused_random_search_matches_jax(monkeypatch, rng):
    patch_seeds(monkeypatch)
    jcfg, dp, tcfg, tdp = bridged()
    kw = dict(planning_horizon=H, num_agents=A, population=40)
    obs = rng.uniform(-1, 1, (A, S)).astype(np.float32)
    js = jc.make_fused_random_search(jrs.RandomSearchConfig(**kw), JBounds.of(LOWER, UPPER), jcfg,
                                     dp, j_reward, tile=TILE, interpret=True)
    ts = tc.make_fused_random_search(trs.RandomSearchConfig(**kw), TBounds.of(LOWER, UPPER), tcfg,
                                     tdp, t_reward, tile=TILE)
    j_out, t_out = solve_both(js, ts, obs)
    assert_solves_agree(j_out, t_out, 1e-4)
    plan = t_out[2].plan.numpy()
    assert np.all(plan >= LOWER) and np.all(plan <= UPPER)


CMA = {
    "default": dict(),
    "adaptive_h_sigma": dict(adaptive_h_sigma=True),
    "persist": dict(persist_across_solves=True, num_elite=6),
}


@pytest.mark.parametrize("iterations,tol", [(1, 1e-4), (3, 1e-3)])
@pytest.mark.parametrize("name", sorted(CMA))
def test_fused_sep_cma_matches_jax(name, iterations, tol, monkeypatch, rng):
    patch_seeds(monkeypatch)
    jcfg, dp, tcfg, tdp = bridged()
    kw = dict(planning_horizon=H, num_agents=A, population=32, num_elite=8,
              max_iterations=iterations, diagonal=True)
    kw.update(CMA[name])
    obs = rng.uniform(-1, 1, (A, S)).astype(np.float32)
    js = jc.make_fused_sep_cma(jcma.CMAESConfig(**kw), JBounds.of(LOWER, UPPER), jcfg, dp,
                               j_reward, tile=TILE, interpret=True)
    ts = tc.make_fused_sep_cma(tcma.CMAESConfig(**kw), TBounds.of(LOWER, UPPER), tcfg, tdp,
                               t_reward, tile=TILE)
    j_out, t_out = solve_both(js, ts, obs)
    assert_solves_agree(j_out, t_out, tol)
    for field in ("sigma", "cov", "p_sigma", "p_cov", "chol", "inv_sqrt"):
        np.testing.assert_allclose(getattr(t_out[1], field).numpy(),
                                   np.asarray(getattr(j_out[1], field)), rtol=tol, atol=tol)
    assert t_out[1].gen == int(j_out[1].gen)


def test_fused_sep_cma_kernels_hook_and_errors():
    _, _, tcfg, tdp = bridged()
    bounds = TBounds.of(LOWER, UPPER)
    with pytest.raises(ValueError, match="sep-CMA only"):
        tc.make_fused_sep_cma(tcma.CMAESConfig(), bounds, tcfg, tdp, t_reward)
    cfg = tcma.CMAESConfig(planning_horizon=H, num_agents=A, population=P, num_elite=4,
                           max_iterations=2, diagonal=True, dtype=torch.bfloat16)
    calls = []
    kernels = tc.make_fused_cem_kernels(tcfg, t_reward, horizon=H, agents=A, population=P,
                                        tile=TILE, clip_bounds=(LOWER, UPPER))

    def rollout(*args):
        calls.append("rollout")
        return kernels[0](*args)

    solver = tc.make_fused_sep_cma(cfg, bounds, None, lambda: tdp, None,
                                   _kernels=(rollout, kernels[1]), _name="hooked")
    state = solver.init(torch.Generator())
    assert solver.name == "hooked" and state.mean.dtype == torch.bfloat16
    action, state, aux = solver.solve(state, torch.zeros(A, S), 0, torch.Generator())
    assert calls == ["rollout"] * 2 and state.sigma.dtype == torch.bfloat16
    assert action.dtype == torch.float32 and bool(torch.isfinite(aux.plan).all())


# ------------------------------------------------------------------------ the eager solvers

PE = 24
TARGET = np.linspace(-0.5, 0.5, H * U, dtype=np.float32).reshape(H, U)


def j_evaluate(obs, samples):  # [P, A, H, U] -> [P, A]
    return -jnp.sum(jnp.square(samples - TARGET), axis=(2, 3)) + jnp.sum(obs, axis=-1)


def t_evaluate(obs, samples):
    return -torch.sum(torch.square(samples - torch.as_tensor(TARGET)), dim=(2, 3)) + obs.sum(-1)


@pytest.mark.parametrize("name", ["PI2", "MPPI", "PI2-CMA colored"])
def test_eager_pi2_matches_jax(name, monkeypatch, rng):
    z = np.clip(rng.normal(size=(PE, A, H, U)), -2, 2).astype(np.float32)
    monkeypatch.setattr(jpi2, "truncated_normal",
                        lambda key, mean, std, shape: mean + jnp.asarray(z) * std)
    monkeypatch.setattr(tpi2, "truncated_normal",
                        lambda gen, mean, std, shape: mean + torch.as_tensor(z) * std)
    monkeypatch.setattr(jbase, "colored_noise", lambda key, beta, shape: jnp.asarray(z))
    monkeypatch.setattr(tbase, "colored_noise", lambda gen, beta, shape: torch.as_tensor(z))
    j_cls, t_cls, options = PI2[name]
    kw = dict(planning_horizon=H, num_agents=A, population=PE, max_iterations=3, **options)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    js = jpi2.make_pi2(j_cls(**kw), JBounds.of(LOWER, UPPER), j_evaluate)
    ts = make_solver("MPPI" if name == "MPPI" else "PI2", TBounds.of(LOWER, UPPER), t_evaluate,
                     **kw)
    assert ts.name == js.name
    assert_solves_agree(*solve_both(js, ts, obs), 1e-5)


def test_eager_random_search_matches_jax(monkeypatch, rng):
    u = rng.uniform(size=(PE, A, H, U)).astype(np.float32)
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape, dtype, minval, maxval: minval + jnp.asarray(u) * (maxval - minval))
    monkeypatch.setattr(trs, "unit_uniform", lambda gen, shape: torch.as_tensor(u))
    kw = dict(planning_horizon=H, num_agents=A, population=PE)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    js = jrs.make_random_search(jrs.RandomSearchConfig(**kw), JBounds.of(LOWER, UPPER), j_evaluate)
    ts = make_solver("RandomSearch", TBounds.of(LOWER, UPPER), t_evaluate, **kw)
    assert_solves_agree(*solve_both(js, ts, obs), 1e-6)


@pytest.mark.parametrize("name,options,tol", [
    ("diagonal", dict(diagonal=True), 1e-5),
    ("diagonal adaptive", dict(diagonal=True, adaptive_h_sigma=True), 1e-5),
    ("diagonal persist", dict(diagonal=True, persist_across_solves=True), 1e-5),
    ("full", dict(), 1e-4),
    ("full lazy", dict(eigen_update_every=2, adaptive_h_sigma=True), 1e-4),
])
def test_eager_cma_es_matches_jax(name, options, tol, monkeypatch, rng):
    z = rng.normal(size=(A, PE, H * U)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(z))
    monkeypatch.setattr(tcma, "standard_normal", lambda gen, shape: torch.as_tensor(z))
    kw = dict(planning_horizon=H, num_agents=A, population=PE, num_elite=6, max_iterations=3,
              **options)
    obs = rng.normal(size=(A, 4)).astype(np.float32)
    js = jcma.make_cma_es(jcma.CMAESConfig(**kw), JBounds.of(LOWER, UPPER), j_evaluate)
    ts = make_solver("CMA-ES", TBounds.of(LOWER, UPPER), t_evaluate, **kw)
    j_out, t_out = solve_both(js, ts, obs)
    assert_solves_agree(j_out, t_out, tol)
    for field in ("sigma", "cov", "p_sigma", "p_cov"):
        np.testing.assert_allclose(getattr(t_out[1], field).numpy(),
                                   np.asarray(getattr(j_out[1], field)), rtol=tol, atol=tol)


def test_cma_constants_match_jax():
    for kw in (dict(), dict(diagonal=True), dict(alpha_cov=1.0, eigen_update_every=0)):
        ours = tcma.cma_constants(tcma.CMAESConfig(**kw), TBounds.of(LOWER, UPPER), 50, 1000, 50)
        theirs = jcma.cma_constants(jcma.CMAESConfig(**kw), JBounds.of(LOWER, UPPER), 50, 1000, 50)
        for key, value in vars(theirs).items():
            np.testing.assert_array_equal(getattr(ours, key), value, err_msg=key)
    with pytest.raises(ValueError, match="eigen_update_every"):
        make_solver("CMA-ES", TBounds.of(LOWER, UPPER), t_evaluate, eigen_update_every=-1)


# ------------------------------------------------------------------------ the policy

POLICY_SOLVERS = {
    "CEM": dict(population=32, num_elite=4, max_iterations=2, colored_noise_beta=2.0,
                keep_elites=2, mean_as_candidate=True, execute_best=True),
    "PI2": dict(population=32, max_iterations=2),
    "MPPI": dict(population=32, max_iterations=2),
    "RandomSearch": dict(population=32),
    "CMA-ES": dict(population=32, num_elite=4, max_iterations=2, diagonal=True),
}


@pytest.mark.parametrize("backend", ["fused", "eager"])
@pytest.mark.parametrize("solver", sorted(POLICY_SOLVERS))
def test_policy_acts_with_every_family_solver(solver, backend):
    handler = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=4, dim_u=U, hidden=(16,),
                                                          ensemble_size=2), device="cpu")
    policy = MPCPolicy(BoxSpace.of(LOWER, UPPER), t_reward, handler, solver_name=solver,
                       rollout_backend=backend, num_agents=3, device="cpu", planning_horizon=6,
                       **POLICY_SOLVERS[solver])
    counts = (tc.fused_rollout.launches, tc.elite_moments.launches)
    obs = np.zeros((3, 4), np.float32)
    for t in range(2):
        action, obs, reward = policy.act(obs, t)
        assert action.shape == (3, U) and obs.shape == (3, 4) and reward.shape == (3,)
        assert np.all(np.isfinite(action)) and np.all(np.isfinite(obs))
        assert np.all(action >= LOWER - 1e-6) and np.all(action <= UPPER + 1e-6)
    plan, expected = policy.plan(obs)
    assert plan.shape == (3, 6, U) and np.all(np.isfinite(expected))
    assert (tc.fused_rollout.launches, tc.elite_moments.launches) == counts  # CPU: plain
    policy.reset()
    assert policy.act(obs)[0].shape == (3, U)


def test_policy_switches_between_family_solvers_on_fused():
    handler = DynamicsHandler(tdyn.LearnedDynamicsConfig(dim_s=4, dim_u=U, hidden=(8,)),
                              device="cpu")
    policy = MPCPolicy(BoxSpace.of(LOWER, UPPER), t_reward, handler, rollout_backend="fused",
                       device="cpu", planning_horizon=4, population=16, num_elite=4,
                       max_iterations=1)
    obs = np.zeros(4, np.float32)
    for name, kw in (("MPPI", dict(population=16)), ("RandomSearch", dict(population=16)),
                     ("CMA-ES", dict(population=16, num_elite=4, diagonal=True)), ("CEM", {})):
        policy.switch_solver(name, **kw)
        assert policy.solver_name == name and policy.act(obs)[0].shape == (U,)
    with pytest.raises(ValueError, match="sep-CMA only"):
        policy.switch_solver("CMA-ES", population=16, num_elite=4)
    with pytest.raises(ValueError, match="generate-in-kernel solver family"):
        policy.switch_solver("PSO")


def test_random_policy():
    policy = RandomPolicy(BoxSpace.of(LOWER, UPPER), num_agents=3, seed=1)
    single = policy.act(np.zeros(4))
    batch = policy.act(np.zeros((5, 4)))
    assert single.shape == (U,) and batch.shape == (5, U) and batch.dtype == np.float32
    assert np.all(batch >= LOWER) and np.all(batch <= UPPER)
    again = RandomPolicy(BoxSpace.of(LOWER, UPPER), num_agents=3, seed=1)
    np.testing.assert_array_equal(again.act(np.zeros(4)), single)
    policy.reset()


def test_config_dataclasses_carry_the_jax_defaults():
    for ours, theirs in ((tpi2.PI2Config, jpi2.PI2Config), (tpi2.MPPIConfig, jpi2.MPPIConfig),
                         (trs.RandomSearchConfig, jrs.RandomSearchConfig),
                         (tcma.CMAESConfig, jcma.CMAESConfig), (TCEMConfig, JCEMConfig)):
        mine = {f.name: f.default for f in dataclasses.fields(ours) if f.name != "dtype"}
        ref = {f.name: f.default for f in dataclasses.fields(theirs) if f.name != "dtype"}
        assert mine == ref, ours.__name__
