"""The port's deployment subsystem (``blackbox_mpc_torch/deploy``), the counterparts of
``tests/test_deploy.py``'s single-device cases.

The contract: a ``.bbmpc`` artifact written by ``export_policy_artifact`` holds the policy's
solver state and generator states, so a loaded ``ServingPolicy`` on the same device type
continues bit for bit where the exporting ``MPCPolicy`` stood (greedy and exploration actions,
lookahead predictions, resets), with no code of the package (``deploy/serving.py`` is
self-contained). Every comparison with the live policy is exact; the comparisons with JAX
state their tolerance. Small sizes: H <= 10, hidden (16, 16), E = 2, one intra-op thread.
"""
import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import blackbox_mpc_torch.deploy.serving as serving_mod
from blackbox_mpc_tpu.deploy import export_dynamics as j_export_dynamics
from blackbox_mpc_tpu.deploy import serving as j_serving
from blackbox_mpc_tpu.learning.handler import DynamicsHandler as JHandler
from blackbox_mpc_tpu.models.dynamics import LearnedDynamicsConfig as JConfig
from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.core.types import Bounds
from blackbox_mpc_torch.deploy import ServingPolicy, export_dynamics, export_policy_artifact
from blackbox_mpc_torch.models.analytic import pendulum_dynamics, pendulum_reward
from blackbox_mpc_torch.models.convert import dynamics_params_from_numpy
from blackbox_mpc_torch.models.dynamics import map_params
from blackbox_mpc_torch.models.normalizer import STATS_FIELDS

torch.set_num_threads(1)

SPACE = BoxSpace.of(np.array([-2.0]), np.array([2.0]))
OBS = np.array([0.5, 0.1, 0.0], np.float32)


def _true_model_policy(solver="CEM", **kw):
    kwargs = dict(planning_horizon=10, population=64, max_iterations=2, seed=3, device="cpu")
    if solver in ("CEM", "CEM-GD"):
        kwargs["num_elite"] = 8
    kwargs.update(kw)
    return MPCPolicy(SPACE, pendulum_reward,
                     DynamicsHandler(true_model=pendulum_dynamics, device="cpu"),
                     solver_name=solver, **kwargs)


def _learned_policy(**kw):
    handler = DynamicsHandler(
        LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2),
        device="cpu")
    return handler, MPCPolicy(
        SPACE, pendulum_reward, handler, solver_name="CEM", planning_horizon=8,
        population=32, num_elite=4, max_iterations=2, seed=7, device="cpu", **kw,
    )


def _exact(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _continues(pol, srv, steps=((1, False), (2, True), (3, False))):
    for t, explore in steps:
        _exact(pol.act(OBS, t=t, exploration_noise=explore),
               srv.act(OBS, t=t, exploration_noise=explore))


@pytest.mark.parametrize("solver,kw", [
    ("CEM", {}), ("PSO", {}), ("RandomSearch", {}), ("PI2", {}), ("MPPI", {}),
    ("CMA-ES", {"num_elite": 8}), ("SPSA", {}),
    ("Gradient", {"planning_horizon": 4, "population": 4, "max_iterations": 3}),
    ("CEM-GD", {"planning_horizon": 4, "population": 16, "max_iterations": 1,
                "gd_candidates": 2, "gd_iterations": 2}),
])
def test_artifact_continues_bitwise_from_export_point(tmp_path, solver, kw):
    pol = _true_model_policy(solver, **kw)
    pol.act(OBS, t=0)  # advance the state and the stream: the artifact resumes mid-episode
    path = str(tmp_path / "pol.bbmpc")
    meta = export_policy_artifact(pol, path, dim_s=3)
    assert meta["solver_name"] == solver and meta["platforms"] == ["cpu"]
    assert meta["rng_impl"] == "mt19937" and meta["stream_device"] == "cpu"
    srv = ServingPolicy.load(path, device="cpu")
    # greedy, exploration-noise and greedy again: the noise draws advance both streams alike
    _continues(pol, srv)
    pol.reset()
    srv.reset()
    _exact(pol.act(OBS, t=0), srv.act(OBS, t=0))


def test_exploration_noise_differs_and_stays_in_bounds(tmp_path):
    pol = _true_model_policy("CEM", exploration_noise_scale=0.3)
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    greedy, _, _ = ServingPolicy.load(path, device="cpu").act(OBS, t=0)
    noisy, _, _ = ServingPolicy.load(path, device="cpu").act(OBS, t=0, exploration_noise=True)
    assert not np.array_equal(greedy, noisy)
    assert np.all(noisy >= SPACE.low - 1e-6) and np.all(noisy <= SPACE.high + 1e-6)


def test_plan_exposed_after_act(tmp_path):
    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    srv = ServingPolicy.load(path, device="cpu")
    assert srv.plan() == (None, None)
    srv.act(OBS)
    plan, expected = srv.plan()
    assert plan.shape == (1, 10, 1) and expected.shape == (1,)
    want_plan, want_expected = pol.plan(OBS)  # plan() leaves the policy's stream as it was
    np.testing.assert_array_equal(plan, want_plan)
    np.testing.assert_array_equal(expected, want_expected)


def test_learned_policy_roundtrip_and_param_hotswap(tmp_path):
    handler, pol = _learned_policy()
    path = str(tmp_path / "learned.bbmpc")
    export_policy_artifact(pol, path)  # dim_s inferred from the config
    srv = ServingPolicy.load(path, device="cpu")
    a2 = srv.act(OBS, t=0)
    _exact(pol.act(OBS, t=0), a2)
    # hot-swap: perturbed params change the action through the same program, and match a
    # live policy given the same params
    new = handler.dynamics_params.replace(
        params=map_params(lambda v: v + 0.05, handler.dynamics_params.params))
    srv2 = ServingPolicy.load(path, device="cpu")
    srv2.update_dynamics_params(new)
    b2 = srv2.act(OBS, t=0)
    handler.set_params(new)
    pol2 = MPCPolicy(SPACE, pendulum_reward, handler, solver_name="CEM", planning_horizon=8,
                     population=32, num_elite=4, max_iterations=2, seed=7, device="cpu")
    _exact(pol2.act(OBS, t=0), b2)
    assert not np.array_equal(a2[0], b2[0])


def test_param_hotswap_validates_shapes(tmp_path):
    handler, pol = _learned_policy()
    path = str(tmp_path / "learned.bbmpc")
    export_policy_artifact(pol, path)
    srv = ServingPolicy.load(path, device="cpu")
    leaves = serving_mod.tree_leaves(handler.dynamics_params)
    with pytest.raises(ValueError, match="parameter leaves"):
        srv.update_dynamics_params(leaves[:-1])
    with pytest.raises(ValueError, match="artifact expects"):
        srv.update_dynamics_params([np.zeros((2, 2), np.float32) for _ in leaves])
    srv.update_dynamics_params([x.numpy() for x in leaves])  # numpy leaves of the right shape


def test_export_dynamics_polymorphic_batch(tmp_path):
    handler, _ = _learned_policy()
    path = str(tmp_path / "dyn.pt2")
    export_dynamics(handler, path)
    restored = torch.export.load(path).module()
    for b in (1, 3, 17):
        g = np.random.default_rng(b)
        s = torch.as_tensor(g.normal(size=(b, 3)), dtype=torch.float32)
        a = torch.as_tensor(g.normal(size=(b, 1)), dtype=torch.float32)
        want = handler.mean_dynamics_fn(handler.dynamics_params, s, a)
        torch.testing.assert_close(restored(s, a), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("propagation", ["mean", "ts1"])
def test_export_dynamics_matches_jax_on_converted_weights(propagation):
    """The port's exported model on weights converted from a JAX handler against JAX's
    exported model: 1e-5 relative (float32, another order of the same sums)."""
    jcfg = JConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2, propagation=propagation)
    jh = JHandler(config=jcfg, seed=3)
    tcfg = LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2,
                                 propagation=propagation)
    th = DynamicsHandler(tcfg, device="cpu")
    dp = jh.dynamics_params
    th.set_params(dynamics_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, dp.params),
        {f: np.asarray(getattr(dp.stats, f)) for f in STATS_FIELDS}, tcfg, device="cpu"))
    j_prog = j_export_dynamics(jh)
    t_prog = export_dynamics(th).module()
    for b in (3, 17):
        g = np.random.default_rng(b)
        s = g.normal(size=(b, 3)).astype(np.float32)
        a = g.normal(size=(b, 1)).astype(np.float32)
        want = np.asarray(j_prog.call(s, a))
        got = t_prog(torch.as_tensor(s), torch.as_tensor(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_standalone_loader_needs_no_framework(tmp_path):
    """serving.py loads and serves the artifact in a process where the package cannot be
    imported at all."""
    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    expected, _, _ = ServingPolicy.load(path, device="cpu").act(OBS, t=0)
    script = f"""
import importlib.abc, importlib.util, json, sys
import numpy as np

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("blackbox_mpc_torch", "blackbox_mpc_tpu", "jax"):
            raise ImportError(f"{{name}} may not be imported here")
        return None

sys.meta_path.insert(0, Refuse())
spec = importlib.util.spec_from_file_location("bbmpc_serving", {serving_mod.__file__!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
srv = mod.ServingPolicy.load({path!r}, device="cpu")
a, n, r = srv.act(np.array([0.5, 0.1, 0.0], np.float32), t=0)
bad = [m for m in sys.modules if m.split(".")[0] in ("blackbox_mpc_torch", "blackbox_mpc_tpu")]
assert not bad, bad
print(json.dumps({{"action": np.asarray(a).tolist()}}))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    action = json.loads(out.stdout.strip().splitlines()[-1])["action"]
    np.testing.assert_array_equal(np.asarray(action, np.float32), expected)


def test_export_rejects_unexportable_configurations(tmp_path):
    pol = _true_model_policy("CEM")
    with pytest.raises(ValueError, match="dim_s"):
        export_policy_artifact(pol, str(tmp_path / "x.bbmpc"))
    handler, _ = _learned_policy()
    for backend in ("kernel", "fused"):
        kern = MPCPolicy(SPACE, pendulum_reward, handler, solver_name="CEM",
                         planning_horizon=8, population=32, num_elite=4, max_iterations=2,
                         rollout_backend=backend, device="cpu")
        with pytest.raises(ValueError, match="rollout_backend"):
            export_policy_artifact(kern, str(tmp_path / "x.bbmpc"))
    with pytest.raises(ValueError, match="true-model"):
        export_dynamics(DynamicsHandler(true_model=pendulum_dynamics, device="cpu"))
    with pytest.raises(ValueError, match="platforms"):
        export_policy_artifact(pol, str(tmp_path / "x.bbmpc"), dim_s=3, platforms=("tpu",))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA is not available"):
            export_policy_artifact(pol, str(tmp_path / "x.bbmpc"), dim_s=3,
                                   platforms=("cuda", "cpu"))


def _rewrite_meta(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), **changes})
            zout.writestr(name, data)


def test_format_version_gate(tmp_path):
    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    bad = str(tmp_path / "bad.bbmpc")
    _rewrite_meta(path, bad, format_version=999)
    with pytest.raises(ValueError, match="format_version"):
        ServingPolicy.load(bad, device="cpu")
    # JAX's sharded format 2 is read: pinned to 2 ranks, a process outside such a world
    # refuses it (tests/test_torch_parallel.py serves real ones)
    _rewrite_meta(path, bad, format_version=2, nr_devices=2, mesh_axes={"pop": 2}, rank=0,
                  process_group="0")
    with pytest.raises(ValueError, match="topology-pinned to 2 ranks"):
        ServingPolicy.load(bad, device="cpu")


def test_device_type_and_stream_gates(tmp_path):
    """A device type without a program raises before any device is touched; a stream of
    another generator algorithm cannot continue, and seed= starts a fresh one."""
    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    with pytest.raises(ValueError, match="programs for"):
        ServingPolicy.load(path, device="cuda")
    with pytest.raises(ValueError, match="programs for"):
        ServingPolicy.load(path)  # None means cuda
    other = str(tmp_path / "philox.bbmpc")
    _rewrite_meta(path, other, rng_impl="philox4x32-10", stream_device="cuda")
    with pytest.raises(ValueError, match="cannot continue"):
        ServingPolicy.load(other, device="cpu")
    fresh = ServingPolicy.load(other, device="cpu", seed=11)
    _exact(fresh.act(OBS), _true_model_policy("CEM", seed=11).act(OBS))


def test_reseed_starts_the_stream_of_a_policy_with_that_seed(tmp_path):
    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    srv = ServingPolicy.load(path, device="cpu")
    srv.act(OBS)
    srv.reseed(11)
    fresh = _true_model_policy("CEM", seed=11)
    _continues(fresh, srv)


def test_serving_policy_drives_perform_rollouts(tmp_path):
    """ServingPolicy runs in the rollout runner as a model-based policy (a virtual subclass
    registered in deploy/__init__.py)."""
    from blackbox_mpc_torch import perform_rollouts
    from blackbox_mpc_torch.envs import NativePendulumVecEnv
    from blackbox_mpc_torch.policies.base import ModelBasedPolicy

    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    srv = ServingPolicy.load(path, device="cpu")
    assert isinstance(srv, ModelBasedPolicy)
    env = NativePendulumVecEnv(num_envs=1, seed=0)
    result = perform_rollouts(env, srv, number_of_rollouts=1, rollout_horizon=10)
    env.close()
    assert len(result["reward_sum"]) == 1 and np.isfinite(result["reward_sum"][0])
    assert result["latency"]["count"] == 10


def test_overlap_pipelining_rejects_serving_policy(tmp_path):
    from blackbox_mpc_torch import perform_rollouts
    from blackbox_mpc_torch.envs import NativePendulumVecEnv

    pol = _true_model_policy("CEM")
    path = str(tmp_path / "pol.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    srv = ServingPolicy.load(path, device="cpu")
    env = NativePendulumVecEnv(num_envs=1, seed=0)
    try:
        with pytest.raises(TypeError, match="ServingPolicy"):
            perform_rollouts(env, srv, number_of_rollouts=1, rollout_horizon=5, overlap=True)
    finally:
        env.close()


def test_proposer_policy_exports_and_matches(tmp_path):
    """The proposer's params ride in the artifact's proposer group and the served solve
    matches the live one bit for bit."""
    from blackbox_mpc_torch.learning.proposer import PolicyProposer, ProposerConfig

    handler = DynamicsHandler(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16)),
                              device="cpu")
    proposer = PolicyProposer(ProposerConfig(dim_s=3, dim_u=1, hidden=(8, 8)),
                              Bounds.of(-2.0, 2.0, dim=1), device="cpu")
    pol = MPCPolicy(SPACE, pendulum_reward, handler, solver_name="CEM", planning_horizon=8,
                    population=32, num_elite=4, max_iterations=2, seed=7, proposer=proposer,
                    device="cpu")
    path = str(tmp_path / "proposed.bbmpc")
    export_policy_artifact(pol, path)
    srv = ServingPolicy.load(path, device="cpu")
    _continues(pol, srv)


def test_stochastic_propagation_policy_exports_and_matches(tmp_path):
    """TS-inf with particles: the rollout noise is drawn from the serving policy's noise
    generator at the step's start for every evaluation, as MPCPolicy draws it."""
    handler = DynamicsHandler(
        LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2,
                              probabilistic=True, propagation="ts_inf", num_particles=2),
        device="cpu")
    pol = MPCPolicy(SPACE, pendulum_reward, handler, solver_name="CEM", planning_horizon=6,
                    population=16, num_elite=4, max_iterations=2, seed=11, device="cpu")
    pol.act(OBS)
    path = str(tmp_path / "tsinf.bbmpc")
    meta = export_policy_artifact(pol, path)
    assert {d["generator"] for d in meta["draws"]["step"]} == {"solver", "noise"}
    srv = ServingPolicy.load(path, device="cpu")
    _continues(pol, srv)


def test_icem_featured_policy_exports_and_matches(tmp_path):
    """iCEM features (colored noise, population decay, elite persistence) export like
    anything else."""
    pol = _true_model_policy("CEM", colored_noise_beta=2.0, population_decay=0.8,
                             keep_elites=2)
    path = str(tmp_path / "icem.bbmpc")
    export_policy_artifact(pol, path, dim_s=3)
    srv = ServingPolicy.load(path, device="cpu")
    _continues(pol, srv)


def test_export_is_deterministic_per_entry(tmp_path):
    """Two exports of the same policy state are equivalent: every tensor and meta entry is
    byte-identical and the served behavior matches bit for bit."""
    pol = _true_model_policy("CEM")
    p1, p2 = str(tmp_path / "a.bbmpc"), str(tmp_path / "b.bbmpc")
    export_policy_artifact(pol, p1, dim_s=3)
    export_policy_artifact(pol, p2, dim_s=3)
    with zipfile.ZipFile(p1) as z1, zipfile.ZipFile(p2) as z2:
        assert sorted(z1.namelist()) == sorted(z2.namelist())
        for name in z1.namelist():
            if not name.endswith(".pt2"):
                assert z1.read(name) == z2.read(name), name
    _exact(ServingPolicy.load(p1, device="cpu").act(OBS),
           ServingPolicy.load(p2, device="cpu").act(OBS))


LEAVES = [np.arange(6, dtype=np.float32).reshape(2, 3), np.array(7, np.int32),
          np.array([True, False]), np.linspace(-2, 2, 5).astype(ml_dtypes.bfloat16),
          np.zeros((0, 4), np.float32), np.arange(4, dtype=np.uint8)]


def test_tensor_groups_cross_read_with_jax():
    """A group packed by the JAX package reads in the port bit for bit, and the reverse
    (bfloat16 by its name on both sides)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        j_serving.pack_tensors(zf, "g", LEAVES)
    with zipfile.ZipFile(buf) as zf:
        got = serving_mod.unpack_tensors(zf, "g")
    for want, t in zip(LEAVES, got):
        assert list(t.shape) == list(want.shape)
        if want.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        serving_mod.pack_tensors(zf, "g", got)
    with zipfile.ZipFile(buf) as zf:
        back = j_serving.unpack_tensors(zf, "g")
    for want, arr in zip(LEAVES, back):
        assert arr.dtype == want.dtype and arr.shape == want.shape
        assert arr.tobytes() == want.tobytes()
