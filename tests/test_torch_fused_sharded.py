"""Port parity for the sharded fused solvers (``blackbox_mpc_torch/ops/fused_sharded.py``),
mirroring ``tests/test_fused_sharded.py``: a 2-rank ``gloo`` world of the port on the CPU (the
kernels' plain versions) against ``blackbox_mpc_tpu/ops/fused_sharded.py`` on JAX's
``make_pop_mesh(2)`` with its Pallas kernels in interpret mode, and a mesh of one device
against the single-device fused solvers bit for bit.

Every fused iteration draws the seed ``2**31 - 2`` on both sides (``draw_seed`` and
``jax.random.randint`` patched), so rank 1's seed ``seed + 0x7F4A7C15`` wraps in int32.
Tolerances: rewards and moments 1e-5, the solves (actions, plans, expected rewards, the state
mean) 1e-4. One world serves the module (suite ``fused`` of
``tests/_torch_multiproc_worker.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.ops.fused_sharded as jfs
import blackbox_mpc_tpu.ops.pallas_cem as jc
import blackbox_mpc_torch.ops.backend_select as tsel
import blackbox_mpc_torch.ops.fused_cem as tc
import blackbox_mpc_torch.ops.fused_sharded as tfs
from blackbox_mpc_tpu.core.spaces import BoxSpace as JBox
from blackbox_mpc_tpu.core.types import Bounds as JBounds
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_tpu.parallel import make_pop_mesh as j_make_pop_mesh
from blackbox_mpc_tpu.policies.mpc_policy import MPCPolicy as JPolicy
from blackbox_mpc_tpu.solvers.cem import CEMConfig as JCEMConfig
from blackbox_mpc_tpu.solvers.cma_es import CMAESConfig as JCMAESConfig
from blackbox_mpc_tpu.solvers.pi2 import MPPIConfig as JMPPIConfig
from blackbox_mpc_tpu.solvers.pi2 import PI2Config as JPI2Config
from blackbox_mpc_tpu.solvers.random_search import RandomSearchConfig as JRSConfig
from blackbox_mpc_torch import DynamicsHandler, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.parallel import PopMesh, make_pop_mesh
from blackbox_mpc_torch.solvers.cem import CEMConfig
from blackbox_mpc_torch.solvers.cma_es import CMAESConfig
from blackbox_mpc_torch.solvers.pi2 import MPPIConfig, PI2Config
from blackbox_mpc_torch.solvers.random_search import RandomSearchConfig
from tests import _torch_multiproc_worker as worker

S, U = 3, 2
H, A, P, TILE = worker.FUSED_H, worker.FUSED_A, worker.FUSED_POPULATION, worker.FUSED_TILE
SEED = 2**31 - 2
KERNEL_TOL, SOLVE_TOL = 1e-5, 1e-4
LOWER, UPPER = np.array([-1.0, -1.0], np.float32), np.array([1.0, 1.0], np.float32)
KERNEL_OPTIONS = {
    "white": {},
    "colored": {"colored_noise_beta": 2.0},
    "MPPI": {"aux_dot": True, "clip_bounds": (LOWER, UPPER)},
    "uniform": {"sampling": "uniform"},
}
# The JAX package's config class of each of the port's.
J_CONFIGS = {CEMConfig: JCEMConfig, PI2Config: JPI2Config, MPPIConfig: JMPPIConfig,
             RandomSearchConfig: JRSConfig, CMAESConfig: JCMAESConfig}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def j_reward(s, a, ns):
    return -jnp.sum(jnp.square(ns), axis=-1) - 0.01 * jnp.sum(jnp.square(a), axis=-1)


def j_case(propagation: str):
    """A JAX handler's weights as an input case, and the handler."""
    fields = dict(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=2, propagation=propagation)
    jh = JHandler(config=JConfig(**fields), seed=3)
    dp = jh.dynamics_params
    return {"config": fields, "params": jax.tree_util.tree_map(np.asarray, dp.params),
            "stats": {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}}, jh


def patch_jax_seed(monkeypatch):
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.int32(SEED))


def jax_kernels(jh, inp, options):
    """JAX's per-device recomputation: the kernels at P/2 with each device's seed, rewards
    concatenated and moments summed, as the sharded program computes them."""
    f = inp["fused"]
    options = dict(options)
    rr, mm = jc.make_fused_cem_kernels(jh.config, j_reward, horizon=H, agents=A,
                                       population=P // 2, tile=TILE, interpret=True, **options)
    dp = jh.dynamics_params
    s0, mean, std = (jnp.asarray(f[k]) for k in ("s0", "mean", "std"))
    rewards, dots, sums = [], [], None
    for d in range(2):
        seed = jnp.int32(SEED) + jnp.int32(d) * jnp.int32(jfs._SEED_STRIDE)
        if options.get("aux_dot"):
            r, dot = rr(dp, s0, mean, std, seed, gvec=jnp.asarray(f["gvec"]))
            dots.append(np.asarray(dot))
        else:
            r = rr(dp, s0, mean, std, seed)
        rewards.append(np.asarray(r))
        block = jnp.asarray(f["weights"][d * (P // 2):(d + 1) * (P // 2)])
        m = [np.asarray(x) for x in mm(mean, std, seed, block)]
        sums = m if sums is None else [a + b for a, b in zip(sums, m)]
    return rewards, dots, sums


def jax_solve(label, jh, jcase_ts1, monkeypatch, obs):
    factory, config_cls, kwargs = worker.FUSED[label]
    handler = jcase_ts1 if label == "CEM ts1" else jh
    config = J_CONFIGS[config_cls](planning_horizon=H, num_agents=A, population=P, **kwargs)
    patch_jax_seed(monkeypatch)
    solver = getattr(jfs, factory)(config, JBounds.of(LOWER, UPPER), handler.config,
                                   handler.dynamics_params, j_reward, j_make_pop_mesh(2),
                                   tile=TILE, interpret=True)
    action, state, aux = solver.solve(solver.init(jax.random.PRNGKey(0)), jnp.asarray(obs), 0,
                                      jax.random.PRNGKey(1))
    return solver.name, action, state, aux


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(rank results, inputs, JAX handler, JAX ts1 handler)`` of one 2-rank world."""
    rng = np.random.default_rng(0)
    model, jh = j_case("mean")
    model_ts1, jh_ts1 = j_case("ts1")
    weights = np.zeros((P, A), np.float32)  # sparse weights with rows on both ranks
    for a in range(A):
        weights[rng.choice(P, 6, replace=False), a] = rng.uniform(0.1, 1.0, 6)
    inputs = {"fused": {
        "model": model, "model ts1": model_ts1, "seed": SEED, "weights": weights,
        "s0": rng.uniform(-1, 1, (A, S)).astype(np.float32),
        "mean": rng.uniform(-0.5, 0.5, (A, H, U)).astype(np.float32),
        "std": rng.uniform(0.1, 0.6, (A, H, U)).astype(np.float32),
        "gvec": rng.normal(0, 1, (A, H * U)).astype(np.float32),
        "obs": rng.uniform(-1, 1, (A, S)).astype(np.float32),
    }, "kernel_options": KERNEL_OPTIONS}
    ranks = worker.run_world("fused", inputs, tmp_path_factory.mktemp("fused"))
    return ranks, inputs, jh, jh_ts1


def test_ranks_agree_bit_for_bit(world):
    ranks = world[0]
    for scenario in ("fused_solves", "fused_policy"):
        a, b = (jax.tree_util.tree_leaves(r[scenario]) for r in ranks)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=scenario)
    for label in KERNEL_OPTIONS:  # the gathered rewards and the reduced moments
        a, b = (r["fused_kernels"][label] for r in ranks)
        for x, y in zip(jax.tree_util.tree_leaves((a["rewards"], a["moments"])),
                        jax.tree_util.tree_leaves((b["rewards"], b["moments"]))):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("label", sorted(KERNEL_OPTIONS))
def test_rewards_and_moments_match_the_per_seed_recomputation(world, label):
    """The gathered rewards are each rank's own rewards at its seed, in rank order (the port's
    per-seed recomputation, bit for bit), and JAX's kernels at each device's wrapped seed give
    the same rewards, dots and moments."""
    ranks, inputs, jh, _ = world
    got = ranks[0]["fused_kernels"][label]
    aux = KERNEL_OPTIONS[label].get("aux_dot", False)
    gathered = got["rewards"][0] if aux else got["rewards"]
    for r, rank in enumerate(ranks):
        local = rank["fused_kernels"][label]["local"]
        np.testing.assert_array_equal(gathered[r * (P // 2):(r + 1) * (P // 2)],
                                      local[0] if aux else local)
    rewards, dots, sums = jax_kernels(jh, inputs, KERNEL_OPTIONS[label])
    np.testing.assert_allclose(gathered, np.concatenate(rewards), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    if aux:
        np.testing.assert_allclose(got["rewards"][1], np.concatenate(dots), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
    for x, y in zip(got["moments"], sums):
        np.testing.assert_allclose(x, y, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("label", list(worker.FUSED))
def test_sharded_solve_matches_jax(world, label, monkeypatch):
    ranks, inputs, jh, jh_ts1 = world
    got = ranks[0]["fused_solves"][label]
    name, action, state, aux = jax_solve(label, jh, jh_ts1, monkeypatch, inputs["fused"]["obs"])
    assert got["name"] == name
    for key, want in (("action", action), ("plan", aux.plan),
                      ("expected_reward", aux.expected_reward),
                      ("mean", getattr(state, "mean", None))):
        if want is None:
            assert got[key] is None
            continue
        np.testing.assert_allclose(got[key], np.asarray(want), rtol=SOLVE_TOL, atol=SOLVE_TOL,
                                   err_msg=key)


def test_sharded_fused_policy_matches_jax(world, monkeypatch):
    """``MPCPolicy(rollout_backend="fused", mesh=...)`` in both packages, over one ensemble:
    the plan at the patched seed; then the port's own draws act alike on both ranks."""
    ranks, inputs, jh, _ = world
    got = ranks[0]["fused_policy"]
    assert got["name"] == "CEM-Fused-Sharded"
    patch_jax_seed(monkeypatch)
    jp = JPolicy(JBox.of(-1.0, 1.0, dim=U), j_reward, jh, rollout_backend="fused",
                 mesh=j_make_pop_mesh(2), planning_horizon=5, population=48, num_elite=6,
                 max_iterations=2)
    plan, expected = jp.plan(inputs["fused"]["obs"][0])
    np.testing.assert_allclose(got["plan"], plan, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(got["expected"], expected, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert np.all(np.isfinite(got["actions"])) and np.all(np.abs(got["actions"]) <= 1.0)


# ------------------------------------------------------------------ one device, validations


def port_model(propagation="mean"):
    case, _ = j_case(propagation)
    return worker.learned(case)


OBS = torch.tensor([[0.5, 0.5, 0.5], [-0.5, -0.5, 0.5]])
ONE_DEVICE = {
    "CEM": (tc.make_fused_cem, tfs.make_sharded_fused_cem,
            CEMConfig(planning_horizon=H, num_agents=A, population=P, num_elite=4,
                      max_iterations=3)),
    "CEM decay": (tc.make_fused_cem, tfs.make_sharded_fused_cem,
                  CEMConfig(planning_horizon=H, num_agents=A, population=P, num_elite=4,
                            max_iterations=3, population_decay=0.6, colored_noise_beta=1.0)),
    "MPPI": (tc.make_fused_pi2, tfs.make_sharded_fused_pi2,
             MPPIConfig(planning_horizon=H, num_agents=A, population=P, max_iterations=3)),
    "PI2": (tc.make_fused_pi2, tfs.make_sharded_fused_pi2,
            PI2Config(planning_horizon=H, num_agents=A, population=P, max_iterations=3)),
    "RandomSearch": (tc.make_fused_random_search, tfs.make_sharded_fused_random_search,
                     RandomSearchConfig(planning_horizon=H, num_agents=A, population=P)),
    "sep-CMA-ES": (tc.make_fused_sep_cma, tfs.make_sharded_fused_sep_cma,
                   CMAESConfig(planning_horizon=H, num_agents=A, population=P, num_elite=8,
                               max_iterations=3, diagonal=True)),
}


@pytest.mark.parametrize("label", sorted(ONE_DEVICE))
def test_one_device_mesh_is_the_single_device_solver_bit_for_bit(label):
    """D=1: rank 0's seed is the seed itself and the collectives are the identity."""
    single, sharded, config = ONE_DEVICE[label]
    tcfg, tdp = port_model()
    bounds = Bounds.of(-1.0, 1.0, dim=U)
    mesh = make_pop_mesh(device="cpu")
    outs = []
    for solver in (single(config, bounds, tcfg, tdp, worker.fused_reward, tile=TILE),
                   sharded(config, bounds, tcfg, lambda: tdp, worker.fused_reward, mesh,
                           tile=TILE)):
        outs.append(solver.solve(solver.init(torch.Generator()), OBS, 0,
                                 torch.Generator().manual_seed(5)))
    (a1, s1, x1), (a2, s2, x2) = outs
    assert torch.equal(a1, a2) and torch.equal(x1.plan, x2.plan)
    assert torch.equal(x1.expected_reward, x2.expected_reward)
    for t1, t2 in zip(jax.tree_util.tree_leaves(dataclasses.asdict(s1)),
                      jax.tree_util.tree_leaves(dataclasses.asdict(s2))):
        assert torch.equal(torch.as_tensor(t1), torch.as_tensor(t2))


@pytest.mark.parametrize("rank", range(8))
def test_device_seed_wraps_as_int32(rank):
    seeds = np.array([0, 1, 11_895_786, 11_895_787, 2**31 - 2], np.int64)
    want = (seeds + rank * tfs._SEED_STRIDE + 2**31) % 2**32 - 2**31
    got = [int(tfs.device_seed(torch.tensor([s], dtype=torch.int32), rank)) for s in seeds]
    assert got == want.tolist()
    with np.errstate(over="ignore"):
        assert got == (seeds.astype(np.int32)
                       + np.int32(rank) * np.int32(tfs._SEED_STRIDE)).tolist()


def test_sharded_fused_validations():
    tcfg, tdp = port_model()
    bounds = Bounds.of(-1.0, 1.0, dim=U)
    two = PopMesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    kw = dict(planning_horizon=H, num_agents=A, num_elite=4, max_iterations=2)
    with pytest.raises(ValueError, match="must divide"):
        tfs.make_sharded_fused_cem(CEMConfig(population=31, **kw), bounds, tcfg, tdp,
                                   worker.fused_reward, two, tile=TILE)
    for flag in (dict(keep_elites=2), dict(mean_as_candidate=True), dict(execute_best=True)):
        with pytest.raises(ValueError, match="keep_elites/mean_as_candidate/execute_best"):
            tfs.make_sharded_fused_cem(CEMConfig(population=P, **kw, **flag), bounds, tcfg,
                                       tdp, worker.fused_reward, two, tile=TILE)
    with pytest.raises(ValueError, match="population_decay"):
        tfs.make_sharded_fused_cem(CEMConfig(population=P, population_decay=1.5, **kw), bounds,
                                   tcfg, tdp, worker.fused_reward, two, tile=TILE)
    with pytest.raises(ValueError, match="must divide"):
        tfs.make_sharded_fused_pi2(PI2Config(planning_horizon=H, num_agents=A, population=33),
                                   bounds, tcfg, tdp, worker.fused_reward, two, tile=TILE)
    with pytest.raises(ValueError, match="must divide"):
        tfs.make_sharded_fused_random_search(
            RandomSearchConfig(planning_horizon=H, num_agents=A, population=33), bounds, tcfg,
            tdp, worker.fused_reward, two, tile=TILE)
    with pytest.raises(ValueError, match="sep-CMA only"):
        tfs.make_sharded_fused_sep_cma(
            CMAESConfig(planning_horizon=H, num_agents=A, population=P), bounds, tcfg, tdp,
            worker.fused_reward, two, tile=TILE)


def policy(mesh, **kw):
    tcfg, tdp = port_model()
    h = DynamicsHandler(tcfg, device="cpu")
    h.set_params(tdp)
    kw = dict(dict(planning_horizon=H, population=P, num_elite=4, max_iterations=2), **kw)
    return MPCPolicy(BoxSpace.of(-1.0, 1.0, dim=U), worker.fused_reward, h, mesh=mesh,
                     device="cpu", **kw)


def test_policy_with_a_one_device_mesh(monkeypatch):
    """The policy's fused and eager paths on a mesh of one device are the unsharded ones."""
    mesh = make_pop_mesh(device="cpu")
    obs = np.array([0.1, -0.2, 0.3], np.float32)
    for backend in ("fused", "eager"):
        sharded, single = policy(mesh, rollout_backend=backend), policy(None,
                                                                        rollout_backend=backend)
        assert sharded.mesh is mesh and sharded.shard_axis == "population"
        if backend == "fused":
            assert sharded._solver.name == "CEM-Fused-Sharded"
        for t in range(2):
            for x, y in zip(sharded.act(obs, t), single.act(obs, t)):
                np.testing.assert_array_equal(x, y)


def test_policy_mesh_refusals(monkeypatch):
    two = PopMesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        policy(two, rollout_backend="kernel")
    with pytest.raises(ValueError, match="shard the population axis"):
        policy(two, rollout_backend="fused", shard_axis="agents")
    with pytest.raises(ValueError, match="shard_axis must be"):
        policy(two, shard_axis="time")
    with pytest.raises(ValueError, match="device of the mesh"):
        policy(PopMesh(group=None, size=1, rank=0, device=torch.device("cuda", 0)))
    # auto: a fused pick with agent sharding is refused at construction, as in JAX
    monkeypatch.setattr(tsel, "choose_backend", lambda *a, **k: "fused")
    with pytest.raises(ValueError, match="shards the agents"):
        policy(two, rollout_backend="auto", shard_axis="agents")
    assert policy(two, rollout_backend="auto")._solver.name == "CEM-Fused-Sharded"


def test_auto_is_mesh_aware():
    """With a mesh: never "kernel"; the capacity threshold on the whole candidate tensor,
    which every rank of a sharded eager solve holds; past it, a population the mesh does not
    divide and the injection features stay eager with a warning."""
    tcfg, _ = port_model()
    horizon, dim_u = 50, 6
    kw = dict(platform="cuda", horizon=horizon, dim_u=dim_u, solver_name="CEM")
    two = PopMesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    rows = -(-tsel.FUSED_MIN_BYTES // (horizon * dim_u * 4))  # one device's threshold
    rows += rows % 2
    assert tsel.choose_backend(tcfg, 64, 1, **kw) == "kernel"
    assert tsel.choose_backend(tcfg, 64, 1, mesh=two, **kw) == "eager"
    assert tsel.choose_backend(tcfg, 65, 1, mesh=two, **kw) == "eager"
    assert tsel.choose_backend(tcfg, rows, 1, **kw) == "fused"
    assert tsel.choose_backend(tcfg, rows, 1, mesh=two, **kw) == "fused"  # not halved
    assert tsel.choose_backend(tcfg, rows - 2, 1, mesh=two, **kw) == "eager"
    with pytest.warns(RuntimeWarning, match="devices divide"):
        assert tsel.choose_backend(tcfg, rows + 1, 1, mesh=two, **kw) == "eager"
    for flag in ("keep_elites", "mean_as_candidate", "execute_best"):
        config = CEMConfig(population=rows, **{flag: 2 if flag == "keep_elites" else True})
        with pytest.warns(RuntimeWarning, match="refuse keep_elites"):
            assert tsel.choose_backend(tcfg, rows, 1, mesh=two, solver_config=config,
                                       **kw) == "eager"
        assert tsel.choose_backend(tcfg, rows, 1, solver_config=config, **kw) == "fused"
