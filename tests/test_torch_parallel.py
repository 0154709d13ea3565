"""Port parity for the parallel layer (``blackbox_mpc_torch/parallel``, the policy's and the
trainer's ``mesh=``): a 2-rank ``gloo`` world of the port on the CPU against JAX's
``make_pop_mesh(2)`` on the 8-device virtual CPU mesh (``tests/conftest.py``), and against the
unsharded port.

One world serves the module: its fixture runs every scenario of
``tests/_torch_multiproc_worker.py`` (suite ``parallel``) in two processes and the cases compare
the results. Tolerances: the sharded evaluator 1e-5 against JAX's (mean, ts1, particles,
agents); the eight solvers of ``tests/test_parallel.py`` 2-rank against 1-rank at JAX's own
tolerances there (CMA-ES 1e-3, the rest rtol 1e-4 / atol 1e-5); data-parallel training 1e-5
against JAX's ``make_trainer(mesh=...)``. Both ranks agree bit for bit everywhere.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackbox_mpc_tpu.models.dynamics as jdyn
from blackbox_mpc_tpu.learning.trainer import make_trainer as j_make_trainer
from blackbox_mpc_tpu.models.normalizer import NormalizerStats as JStats
from blackbox_mpc_tpu.parallel import make_pop_mesh as j_make_pop_mesh
from blackbox_mpc_tpu.parallel import make_sharded_evaluator as j_make_sharded_evaluator
from blackbox_mpc_tpu.rollout import make_trajectory_evaluator as j_make_trajectory_evaluator
from blackbox_mpc_torch.models import dynamics as tdyn
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS
from blackbox_mpc_torch.parallel import (
    PopMesh,
    initialize_multihost,
    local_agent_slice,
    make_pop_mesh,
    make_sharded_evaluator,
    shard_population,
)
from tests import _torch_multiproc_worker as worker

S, U = 3, 1
EVAL_TOL = 1e-5
TRAIN_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def case_of(rng, seed=0, **fields):
    """A learned-dynamics input case: the config's fields, JAX's weights (learned bounds moved
    off their constants) and non-trivial stats."""
    fields = dict(dict(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=2), **fields)
    jcfg = jdyn.LearnedDynamicsConfig(**fields)
    dp = jdyn.make_learned_dynamics(jcfg)[0](jax.random.PRNGKey(seed))
    params = dp.params
    if isinstance(params, dict):
        params = dict(params, lv_min=jnp.asarray(rng.uniform(-6, -3, S), jnp.float32),
                      lv_max=jnp.asarray(rng.uniform(-1.5, 0.3, S), jnp.float32))
    stats = JStats(*(jnp.asarray(v, jnp.float32) for v in (
        rng.normal(0, 0.3, S), rng.uniform(0.5, 2.0, S), rng.normal(0, 0.3, U),
        rng.uniform(0.5, 2.0, U), rng.normal(0, 0.1, S), rng.uniform(0.2, 1.0, S))))
    dp = dp.replace(params=params, stats=stats)
    return {"config": fields, "params": np_tree(dp.params),
            "stats": {f: np.asarray(getattr(stats, f)) for f in STATS_FIELDS}}, jcfg, dp


def jax_step_noise(key, horizon, rows):
    """JAX's per-step draws of its evaluator: split(key, H), one normal per step."""
    return np.stack([np.asarray(jax.random.normal(k, (rows, S), jnp.float32))
                     for k in jax.random.split(key, horizon)])


# The evaluator cases: (config changes, population, agents, particles, shard axis).
EVAL_CASES = {
    "mean": (dict(), 10, 2, 1, "population"),
    "mean, population 9": (dict(), 9, 2, 1, "population"),
    "ts1": (dict(ensemble_size=3, propagation="ts1"), 10, 2, 1, "population"),
    "particles": (dict(ensemble_size=3, propagation="ts_inf", probabilistic=True,
                       learn_logvar_bounds=True, num_particles=3), 10, 2, 3, "population"),
    "agents": (dict(), 6, 4, 1, "agents"),
}
EVAL_H = 6
TRAIN_CASES = {
    "mse": dict(),
    "nll, learned bounds": dict(probabilistic=True, learn_logvar_bounds=True),
}


def j_reward(s, a, ns):
    return ns[:, 0] - 0.1 * jnp.sum(a * a, axis=-1)


def make_inputs():
    """Every input of the world, and what JAX computes from it."""
    rng = np.random.default_rng(0)
    inputs = {"evaluator": {}, "training": {}}
    want = {"evaluator": {}, "training": {}}
    jmesh = j_make_pop_mesh(2)
    for label, (changes, pop, agents, particles, axis) in EVAL_CASES.items():
        case, jcfg, jdp = case_of(rng, **changes)
        s0 = rng.uniform(-1, 1, (agents, S)).astype(np.float32)
        acts = rng.uniform(-1, 1, (pop, agents, EVAL_H, U)).astype(np.float32)
        key = jax.random.PRNGKey(11) if particles > 1 else None
        case.update(s0=s0, acts=acts, particles=particles, shard_axis=axis)
        if key is not None:
            case["noise"] = jax_step_noise(key, EVAL_H, pop * particles * agents)
        inputs["evaluator"][label] = case
        step = partial(jdyn.make_learned_dynamics(jcfg)[1], jdp)
        if pop % 2:  # JAX shards evenly only: its unsharded evaluator is the same function
            evaluate = j_make_trajectory_evaluator(step, j_reward, num_particles=particles)
        else:
            evaluate = j_make_sharded_evaluator(step, j_reward, jmesh, num_particles=particles,
                                                shard_axis=axis)
        want["evaluator"][label] = np.asarray(evaluate(jnp.asarray(s0), jnp.asarray(acts), key))
    for label, changes in TRAIN_CASES.items():
        case, jcfg, jdp = case_of(rng, seed=2, **changes)
        s = rng.uniform(-1, 1, (2, 64, S)).astype(np.float32)
        a = rng.uniform(-2, 2, (2, 64, U)).astype(np.float32)
        ns = (s + 0.1 * a.repeat(S, axis=-1)).astype(np.float32)
        case["batch"] = (s, a, ns)
        inputs["training"][label] = case
        init, step, _ = j_make_trainer(jcfg, mesh=jmesh)
        ts = init(jdp.params)
        losses = []
        for _ in range(3):
            ts, loss = step(ts, jdp.stats, s, a, ns)
            losses.append(np.asarray(loss))
        want["training"][label] = (np.stack(losses), np_tree(ts.params))
    episodes = []
    for _ in range(4):
        th = rng.uniform(-np.pi, np.pi, 41)
        episodes.append(np.stack([np.cos(th), np.sin(th), rng.uniform(-1, 1, 41)],
                                 -1).astype(np.float32))
    inputs["handler"] = {"config": dict(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=2),
                         "obs": episodes,
                         "acts": [rng.uniform(-2, 2, (40, U)).astype(np.float32)
                                  for _ in episodes]}
    return inputs, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(rank results, inputs, JAX's results)`` of one 2-rank world of the port."""
    inputs, want = make_inputs()
    workdir = tmp_path_factory.mktemp("parallel")
    inputs["artifact_dir"] = str(workdir)
    ranks = worker.run_world("parallel", inputs, workdir)
    return ranks, inputs, want


def assert_ranks_equal(ranks, scenario):
    a, b = (jax.tree_util.tree_leaves(r[scenario]) for r in ranks)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=scenario)


@pytest.mark.parametrize("scenario", [fn.__name__ for fn in worker.SUITES["parallel"]
                                      if fn not in (worker.multihost, worker.artifact)])
def test_ranks_agree_bit_for_bit(world, scenario):
    """Every result is replicated: both ranks hold the same bits (multihost's agent slices
    and the artifacts' meta are each rank's own)."""
    assert_ranks_equal(world[0], scenario)


@pytest.mark.parametrize("label", sorted(EVAL_CASES))
def test_sharded_evaluator_matches_jax(world, label):
    ranks, inputs, want = world
    got = ranks[0]["evaluator"][label]
    np.testing.assert_allclose(got, want["evaluator"][label], rtol=EVAL_TOL, atol=EVAL_TOL)
    # and the unsharded port on the same inputs
    single = worker.evaluator(None, {"evaluator": {label: inputs["evaluator"][label]}})
    np.testing.assert_allclose(got, single[label], rtol=EVAL_TOL, atol=EVAL_TOL)


def test_ts1_block_takes_the_members_of_the_whole_batch(world):
    """ts1 with a block's own member assignment would differ: the shuffled assignment of the
    whole batch is not the one of each half."""
    _, inputs, want = world
    case = inputs["evaluator"]["ts1"]
    rows = case["acts"].shape[0] * case["acts"].shape[1]
    half = rows // 2
    whole = tdyn.ts_member_ids(rows + (-rows) % 3, 3)[:half]
    own = tdyn.ts_member_ids(half + (-half) % 3, 3)[:half]
    assert not np.array_equal(whole, own)


@pytest.mark.parametrize("propagation", ["ts1", "ts_inf"])
@pytest.mark.parametrize("ranks,rank", [(2, 0), (2, 1), (3, 2)])
def test_row_block_runs_each_row_through_its_global_member(propagation, ranks, rank):
    """Under ``global_rows``, a block's rows come out as the same rows of the whole batch do
    (1e-6), with each member run on a group no wider than the block's largest: the padding
    is the only extra work. The last block of three repeats its last row."""
    rng = np.random.default_rng(7)
    ensemble, total = 4, 46
    cfg = tdyn.LearnedDynamicsConfig(dim_s=S, dim_u=U, hidden=(16,), ensemble_size=ensemble,
                                     probabilistic=True, propagation=propagation)
    init, dyn = tdyn.make_learned_dynamics(cfg)
    dp = init(torch.Generator().manual_seed(3))
    state = torch.as_tensor(rng.normal(size=(total, S)), dtype=torch.float32)
    action = torch.as_tensor(rng.normal(size=(total, U)), dtype=torch.float32)
    noise = torch.as_tensor(rng.normal(size=(total, S)), dtype=torch.float32)
    per = -(-total // ranks)
    rows = np.minimum(np.arange(rank * per, (rank + 1) * per), total - 1)
    block = tdyn.RowBlock(total, rows)
    idx = torch.as_tensor(rows)
    with tdyn.global_rows(block):
        got = dyn(dp, state[idx], action[idx], noise[idx])
    want = dyn(dp, state, action, noise)[idx]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    perm, inv, width = block.partition(ensemble, torch.device("cpu"))
    members = tdyn.ts_member_ids(total + (-total) % ensemble, ensemble)[rows]
    assert width == np.bincount(members, minlength=ensemble).max()
    assert perm.numel() == ensemble * width and sorted(inv.tolist()) == sorted(set(inv.tolist()))


@pytest.mark.parametrize("name", list(worker.SOLVERS) + ["CEM agents"])
def test_sharded_solve_matches_one_rank(world, name):
    a2, r2 = world[0][0]["solvers"][name]
    if name == "CEM agents":
        a1, r1 = worker.pendulum_solve(None, "CEM", **worker.AGENT_SOLVE)
    else:
        a1, r1 = worker.pendulum_solve(None, name, **worker.solver_kwargs(name))
    tol = dict(rtol=1e-3, atol=1e-3) if name == "CMA-ES" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a2, a1, **tol)
    np.testing.assert_allclose(r2, r1, **tol)


def test_sharded_policy_controls_pendulum(world):
    obs = world[0][0]["swing_up"]
    assert obs[0] > 0.85, obs


@pytest.mark.parametrize("label", sorted(TRAIN_CASES))
def test_data_parallel_training_matches_jax(world, label):
    ranks, inputs, want = world
    losses, params = ranks[0]["training"][label]
    j_losses, j_params = want["training"][label]
    np.testing.assert_allclose(losses, np.reshape(j_losses, losses.shape), rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    net = j_params["net"] if isinstance(j_params, dict) else j_params
    flat = [layer[k] for layer in net for k in ("w", "b")]
    if isinstance(j_params, dict):
        flat += [j_params["lv_min"], j_params["lv_max"]]
    assert len(flat) == len(params)
    for got, expect in zip(params, flat):
        np.testing.assert_allclose(got.reshape(np.shape(expect)), expect, rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL)


def test_data_parallel_handler_matches_one_rank(world):
    ranks, inputs, _ = world
    single = worker.handler(None, inputs)
    got = ranks[0]["handler"]
    for key in ("train_loss", "val_loss"):
        for info, ref in zip(got["infos"], single["infos"]):
            np.testing.assert_allclose(info[key], ref[key], rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for x, y in zip(got["params"], single["params"]):
        np.testing.assert_allclose(x, y, rtol=TRAIN_TOL, atol=TRAIN_TOL)


@pytest.mark.parametrize("axis", ["population", "agents"])
def test_sharded_artifact_continues_bit_for_bit(world, axis):
    """Each rank's ServingPolicy continues as its live policy (greedy, noisy, after a reset);
    the artifact is format 2, pinned to 2 ranks, and refused by a world of another size."""
    from blackbox_mpc_torch.deploy import ServingPolicy

    for rank, results in enumerate(world[0]):
        meta, live, served = results["artifact"][axis]
        np.testing.assert_array_equal(live, served)
        np.testing.assert_array_equal(live, world[0][0]["artifact"][axis][1])
        assert meta["format_version"] == 2 and meta["nr_devices"] == 2
        assert meta["mesh_axes"] == {"pop": 2} and meta["shard_axis"] == axis
        assert meta["rank"] == rank and meta["process_group"] == "0"
    with pytest.raises(ValueError, match="topology-pinned to 2 ranks"):
        ServingPolicy.load(f"{world[1]['artifact_dir']}/{axis}.rank0.bbmpc", device="cpu")


def test_sharded_artifact_compiled_cache_per_rank(world):
    """Each rank compiles its own format-2 programs (their all-reduce included) with
    AOTInductor and saves its own cache; the instance loaded from it uses it and acts bit for
    bit as the saving one, and within 1e-5 of the live policy. The fingerprint pins the world
    size and the rank."""
    for rank, results in enumerate(world[0]):
        compiled = results["artifact"]["compiled"]
        live = results["artifact"]["population"][1]
        assert compiled["used"]
        np.testing.assert_array_equal(compiled["cached"], compiled["saver"])
        np.testing.assert_allclose(compiled["saver"], live, rtol=0, atol=1e-5)
        assert compiled["fingerprint"]["nr_devices"] == 2
        assert compiled["fingerprint"]["rank"] == rank


def test_multihost_helpers_in_the_world(world):
    first, second = (r["multihost"] for r in world[0])
    assert first["slice"] == slice(0, 2) and second["slice"] == slice(2, 5)
    assert first["multihost"] and second["multihost"]
    np.testing.assert_array_equal(first["replicated"], np.arange(3.0))


def test_multihost_without_a_world(monkeypatch, tmp_path):
    """Explicit arguments that cannot start a world raise; no arguments and no torchrun
    environment stay single-process."""
    with pytest.raises(ValueError, match="together"):
        initialize_multihost("localhost:1", 2)
    with pytest.raises(ValueError, match="outside"):
        initialize_multihost("localhost:1", 2, 2)
    with pytest.raises(Exception, match="no-such-backend"):  # torch's refusal propagates
        initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="no-such-backend")
    assert not torch.distributed.is_initialized()
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert local_agent_slice(5) == slice(0, 5)


def test_one_device_mesh_is_the_unsharded_evaluator(world):
    """A mesh of one device needs no group; its evaluator gives the unsharded bits."""
    mesh = make_pop_mesh(device="cpu")
    assert mesh == PopMesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    assert mesh.shape == {"pop": 1} and mesh.axis_names == ("pop",)
    with pytest.raises(ValueError, match="process group"):
        make_pop_mesh(2, device="cpu")
    case = world[1]["evaluator"]["ts1"]
    single = worker.evaluator(None, {"evaluator": {"ts1": case}})["ts1"]
    config, dp = worker.learned(case)
    fn = tdyn.make_learned_dynamics(config)[1]
    got = make_sharded_evaluator(lambda s, a, n=None: fn(dp, s, a, n), worker.eval_reward,
                                 mesh)(torch.as_tensor(case["s0"]), torch.as_tensor(case["acts"]))
    np.testing.assert_array_equal(got.numpy(), single)
    with pytest.raises(ValueError, match="shard_axis"):
        make_sharded_evaluator(fn, worker.eval_reward, mesh, shard_axis="time")


def test_blocks_and_shard_population():
    """Contiguous blocks of ceil(n / D), the last short; shard_population narrows to them."""
    blocks = [PopMesh(None, 4, r, torch.device("cpu")).block(10) for r in range(4)]
    assert blocks == [(0, 3), (3, 6), (6, 9), (9, 10)]
    x = torch.arange(20).reshape(2, 10)
    assert shard_population(PopMesh(None, 4, 3, torch.device("cpu")), x, axis=1).tolist() \
        == [[9], [19]]
    assert dataclasses.replace(PopMesh(None, 1, 0, torch.device("cpu")), size=2).shape == \
        {"pop": 2}
