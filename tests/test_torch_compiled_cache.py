"""The compiled serving cache of the port (``deploy/serving.py``: ``precompile``,
``save_compiled``, ``ServingPolicy.load(compiled_cache=)``), the counterparts of JAX's
``tests/test_deploy.py`` cache cases on the CPU.

The programs are compiled once, in the module fixture (AOTInductor, tens of seconds on the
CPU), from a small learned-dynamics eager CEM (H=5, population 32, 2 iterations). A
cache-loaded instance runs the saving instance's compiled code, so the two agree bit for bit;
the compiled programs against the uncompiled ones (Inductor fuses and reorders reductions)
agree within COMPILED_TOL on the same inputs.
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig, MPCPolicy
from blackbox_mpc_torch.core.spaces import BoxSpace
from blackbox_mpc_torch.deploy import ServingPolicy, export_policy_artifact
from blackbox_mpc_torch.models.analytic import pendulum_reward
from blackbox_mpc_torch.models.dynamics import map_params

torch.set_num_threads(1)

OBS = np.array([0.5, 0.1, 0.0], np.float32)
# (t, exploration_noise) of the act() sequence each instance runs; a reset, then one more.
STEPS = ((1, False), (2, True), (3, False))
# Compiled against uncompiled on the same inputs: absolute, on actions, predictions, rewards
# and the plan.
COMPILED_TOL = 1e-5


def _policy(max_iterations=2):
    handler = DynamicsHandler(
        LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16, 16), ensemble_size=2),
        seed=1, device="cpu")
    policy = MPCPolicy(BoxSpace.of(np.array([-2.0]), np.array([2.0])), pendulum_reward,
                       handler, solver_name="CEM", planning_horizon=5, population=32,
                       num_elite=4, max_iterations=max_iterations, seed=7, device="cpu")
    policy.act(OBS)  # mid-episode: the artifact resumes the state and the stream
    return policy


def _episode(srv) -> list:
    """The outputs of STEPS, a reset and one more act(), each with the plan."""
    out = []
    for t, explore in STEPS:
        out.append(srv.act(OBS, t=t, exploration_noise=explore) + srv.plan())
    srv.reset()
    out.append(srv.act(OBS, t=4) + srv.plan())
    return out


def _assert_episodes(a, b, atol=0.0):
    for step_a, step_b in zip(a, b, strict=True):
        for x, y in zip(step_a, step_b, strict=True):
            if atol:
                np.testing.assert_allclose(x, y, rtol=0, atol=atol)
            else:
                np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The artifact, the cache written by a ServingPolicy that precompiled, and the episodes
    of that instance and of an uncompiled one."""
    work = tmp_path_factory.mktemp("compiled_cache")
    art, cache = str(work / "pol.bbmpc"), str(work / "pol.cache")
    export_policy_artifact(_policy(), art)
    saver = ServingPolicy.load(art, device="cpu")
    assert saver.precompile() is saver
    saver.save_compiled(cache)
    plain = ServingPolicy.load(art, device="cpu")
    return {"dir": work, "artifact": art, "cache": cache, "saver": _episode(saver),
            "plain": _episode(plain)}


@pytest.fixture
def no_compile(monkeypatch):
    """Any AOTInductor compile from here on fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("compiled a program")

    monkeypatch.setattr(torch._inductor, "aoti_compile_and_package", refuse)


def test_round_trip_is_bit_for_bit_and_compiles_nothing(compiled, no_compile):
    """load(compiled_cache=) serves the saving instance's compiled programs bit for bit
    (three act()s, a reset, one more), compiles nothing, and precompile() is then a no-op;
    the cache was published atomically (no temporary file is left)."""
    assert not [p for p in os.listdir(compiled["dir"]) if ".tmp" in p]
    with zipfile.ZipFile(compiled["cache"]) as zf:
        assert sorted(zf.namelist()) == ["fingerprint.json", "reset.pt2", "step.pt2"]
        fingerprint = json.loads(zf.read("fingerprint.json"))
    assert fingerprint["platform"] == "cpu" and fingerprint["solver_name"] == "CEM"
    assert fingerprint["torch_version"] == torch.__version__ and fingerprint["nr_devices"] == 1
    cached = ServingPolicy.load(compiled["artifact"], device="cpu",
                                compiled_cache=compiled["cache"])
    assert cached.used_compiled_cache
    assert cached.precompile() is cached
    _assert_episodes(_episode(cached), compiled["saver"])
    assert not ServingPolicy.load(compiled["artifact"], device="cpu").used_compiled_cache


def test_compiled_matches_uncompiled(compiled):
    """The compiled programs against the uncompiled ones: the same stream, so the same
    inputs at every step, and outputs within COMPILED_TOL."""
    _assert_episodes(compiled["saver"], compiled["plain"], atol=COMPILED_TOL)


def _write_cache(path, fingerprint_change, source):
    with zipfile.ZipFile(source) as zf:
        members = {name: zf.read(name) for name in zf.namelist()}
    fingerprint = json.loads(members["fingerprint.json"])
    fingerprint.update(fingerprint_change)
    members["fingerprint.json"] = json.dumps(fingerprint)
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in members.items():
            zf.writestr(name, data)


@pytest.mark.parametrize("fault", ["missing", "corrupt", "no step", "device kind",
                                   "torch version"])
def test_unusable_cache_warns_and_serves_uncompiled(compiled, no_compile, tmp_path, fault):
    """A missing, corrupt or stale cache is ignored with a RuntimeWarning; the uncompiled
    program serves, bit for bit as an instance loaded without a cache."""
    cache = str(tmp_path / "bad.cache")
    if fault == "corrupt":
        with open(cache, "wb") as f:
            f.write(b"not a zip")
    elif fault == "no step":
        with zipfile.ZipFile(compiled["cache"]) as src, zipfile.ZipFile(cache, "w") as dst:
            for name in ("fingerprint.json", "reset.pt2"):
                dst.writestr(name, src.read(name))
    elif fault == "device kind":
        _write_cache(cache, {"device_kind": "NVIDIA H100 80GB HBM3"}, compiled["cache"])
    elif fault == "torch version":
        _write_cache(cache, {"torch_version": "0.0.0"}, compiled["cache"])
    with pytest.warns(RuntimeWarning, match="ignoring compiled cache"):
        srv = ServingPolicy.load(compiled["artifact"], device="cpu", compiled_cache=cache)
    assert not srv.used_compiled_cache
    _assert_episodes(_episode(srv), compiled["plain"])


def test_save_compiled_from_cache_loaded_instance_raises(compiled, tmp_path):
    cached = ServingPolicy.load(compiled["artifact"], device="cpu",
                                compiled_cache=compiled["cache"])
    with pytest.raises(RuntimeError, match="compiled cache"):
        cached.save_compiled(str(tmp_path / "other.cache"))
    assert not os.path.exists(tmp_path / "other.cache")


def test_cache_refused_after_artifact_reexport(compiled, no_compile, tmp_path):
    """The fingerprint binds the artifact's programs: a re-export with other solver settings
    (the same input shapes) refuses the cache."""
    art = str(tmp_path / "reexported.bbmpc")
    export_policy_artifact(_policy(max_iterations=3), art)
    with pytest.warns(RuntimeWarning, match="fingerprint"):
        srv = ServingPolicy.load(art, device="cpu", compiled_cache=compiled["cache"])
    assert not srv.used_compiled_cache


def test_params_swap_on_a_compiled_instance(compiled, no_compile):
    """update_dynamics_params on a cache-loaded instance needs no compile (the params are
    inputs of the program) and acts as the uncompiled instance given the same params."""
    cached = ServingPolicy.load(compiled["artifact"], device="cpu",
                                compiled_cache=compiled["cache"])
    plain = ServingPolicy.load(compiled["artifact"], device="cpu")
    params = _policy().dynamics_handler.dynamics_params
    params = params.replace(params=map_params(lambda v: v + 0.01, params.params))
    for srv in (cached, plain):
        srv.update_dynamics_params(params)
    _assert_episodes(_episode(cached), _episode(plain), atol=COMPILED_TOL)
