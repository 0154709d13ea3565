"""The port's command line, ``python -m blackbox_mpc_torch``, as a user invokes it: the
counterparts of ``tests/test_cli.py`` with ``--cpu`` (every command runs on cuda without it),
and the JSON keys of each command against the JAX package's on the same command."""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = [0.5, 0.1, 0.0]


def _run(args, timeout=300, package="blackbox_mpc_torch", stdin=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # the test workers share the cores
    return subprocess.run(
        [sys.executable, "-m", package, *args], input=stdin,
        capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env,
    )


def _last_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in: {stdout!r}")


def _export(out, *extra):
    proc = _run(["export", "--env", "pendulum", "--cpu", "-o", out, "--population", "64",
                 "--planning-horizon", "8", "--iterations", "2", *extra])
    assert proc.returncode == 0, proc.stderr[-800:]
    return _last_json(proc.stdout)


def test_solvers_lists_registry():
    proc = _run(["solvers"])
    assert proc.returncode == 0, proc.stderr
    for name in ("CEM", "CMA-ES", "PI2", "PSO", "RandomSearch", "SPSA", "Gradient",
                 "CEM-GD", "MPPI"):
        assert f"{name}:" in proc.stdout, proc.stdout


def test_solve_pendulum_and_cartpole():
    for env_name, reward_floor in (("pendulum", -1500.0), ("cartpole", -50.0)):
        proc = _run(["solve", "--env", env_name, "--cpu", "--steps", "40",
                     "--population", "128", "--planning-horizon", "15"])
        assert proc.returncode == 0, proc.stderr[-800:]
        row = _last_json(proc.stdout)
        assert row["env"] == env_name
        assert row["episode_rewards"][0] > reward_floor
        assert row["act_latency"]["count"] == 40


def test_solve_with_smoothness_and_time_major_flags():
    for flags in (["--smoothness", "0.1"], ["--time-major"]):
        proc = _run(["solve", "--env", "pendulum", "--cpu", "--steps", "30",
                     "--population", "128", "--planning-horizon", "15", *flags])
        assert proc.returncode == 0, proc.stderr[-800:]
        assert _last_json(proc.stdout)["episode_rewards"][0] > -1600.0


def test_clean_errors():
    """Unknown solver, unknown env, and (without CUDA) a command run without --cpu: exit 2,
    one line, no traceback."""
    proc = _run(["solve", "--cpu", "--solver", "NotASolver", "--steps", "5"])
    assert proc.returncode == 2
    assert "error:" in proc.stderr and "NotASolver" in proc.stderr
    assert "Traceback" not in proc.stderr
    proc = _run(["solve", "--cpu", "--env", "warpdrive"])
    assert proc.returncode == 2 and "warpdrive" in proc.stderr
    if not torch.cuda.is_available():
        proc = _run(["solve", "--steps", "5"])
        assert proc.returncode == 2 and "--cpu" in proc.stderr
        assert "Traceback" not in proc.stderr


def test_learn_pendulum_tiny():
    proc = _run(["learn", "--cpu", "--env", "Pendulum-v1", "--steps", "10",
                 "--initial-rollouts", "1", "--refinements", "1", "--epochs", "1",
                 "--hidden", "16", "--population", "128", "--planning-horizon", "5",
                 "--iterations", "1"], timeout=420)
    assert proc.returncode == 0, proc.stderr[-800:]
    row = _last_json(proc.stdout)
    assert row["done"] and row["replay_size"] >= 20  # 2 rollouts x 10 steps
    assert set(row) == {"env", "replay_size", "done"}


def test_learn_unknown_env_reward_warns_loudly():
    proc = _run(["learn", "--cpu", "--env", "MountainCarContinuous-v0", "--steps", "5",
                 "--initial-rollouts", "1", "--refinements", "0", "--epochs", "1",
                 "--hidden", "8", "--population", "64", "--planning-horizon", "4",
                 "--iterations", "1"], timeout=420)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "WARNING" in proc.stderr and "surrogate" in proc.stderr


def test_export_writes_loadable_artifact(tmp_path):
    out = str(tmp_path / "pendulum_cem.bbmpc")
    row = _export(out)
    assert row["artifact"] == out and row["solver_name"] == "CEM"
    assert row["platforms"] == ["cpu"] and row["rng_impl"] == "mt19937"
    from blackbox_mpc_torch.deploy import ServingPolicy

    srv = ServingPolicy.load(out, device="cpu")
    action, next_obs, reward = srv.act(np.array(OBS, np.float32))
    assert action.shape == (1,) and next_obs.shape == (3,) and np.isfinite(reward)


def test_serve_json_lines_protocol(tmp_path):
    """export -> serve: the stdin/stdout action server answers act, reset, a malformed
    request (one error line) and close."""
    art = str(tmp_path / "ctrl.bbmpc")
    _export(art)
    requests = "\n".join([
        json.dumps({"obs": OBS, "t": 0}),
        json.dumps({"cmd": "reset"}),
        json.dumps({"obs": OBS, "t": 0, "explore": True}),
        json.dumps({"not_obs": 1}),
        "[1, 2]",
        json.dumps({"cmd": "close"}),
        json.dumps({"obs": OBS}),  # after close: never read
    ]) + "\n"
    out = _run(["serve", art, "--cpu"], stdin=requests)
    assert out.returncode == 0, out.stderr[-800:]
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert lines[0] == {"ready": True, "solver": "CEM", "num_agents": 1,
                        "used_compiled_cache": False}
    assert set(lines[1]) == {"action", "predicted_next_obs", "predicted_reward"}
    assert len(lines[1]["action"]) == 1 and lines[2] == {"ok": True}
    assert len(lines[3]["action"]) == 1 and "error" in lines[4] and "error" in lines[5]
    assert len(lines) == 6


def test_serve_compiled_cache_round_trip(tmp_path):
    """serve --compiled-cache: the first run compiles the artifact's programs and writes the
    cache (used_compiled_cache false), the second loads it (true); both serve the artifact's
    stream with the same compiled programs, so their actions agree bit for bit, and they
    agree with the uncompiled server within 1e-5."""
    art, cache = str(tmp_path / "ctrl.bbmpc"), str(tmp_path / "ctrl.cache")
    _export(art)
    requests = "\n".join([json.dumps({"obs": OBS, "t": 0}), json.dumps({"cmd": "reset"}),
                          json.dumps({"obs": OBS, "t": 1}), json.dumps({"cmd": "close"})]) + "\n"
    runs = []
    for args in ([], ["--compiled-cache", cache], ["--compiled-cache", cache]):
        out = _run(["serve", art, "--cpu", *args], stdin=requests, timeout=600)
        assert out.returncode == 0, out.stderr[-800:]
        runs.append([json.loads(ln) for ln in out.stdout.strip().splitlines()])
    assert [run[0]["used_compiled_cache"] for run in runs] == [False, False, True]
    assert os.path.getsize(cache) > 0 and not [p for p in os.listdir(tmp_path) if ".tmp" in p]
    assert runs[1][1:] == runs[2][1:] and len(runs[2]) == 4
    for compiled, plain in zip(runs[2][1:], runs[0][1:]):
        for key in ("action", "predicted_next_obs", "predicted_reward"):
            if key in plain:
                np.testing.assert_allclose(compiled[key], plain[key], rtol=0, atol=1e-5)


def test_inspect_prints_artifact_metadata(tmp_path):
    art = str(tmp_path / "ctrl.bbmpc")
    _export(art)
    proc = _run(["inspect", art])
    assert proc.returncode == 0, proc.stderr[-800:]
    row = _last_json(proc.stdout)
    assert row["solver_name"] == "CEM" and row["dim_s"] == 3
    assert row["tensors"]["state"]["leaves"] >= 1 and row["tensors"]["key"]["leaves"] == 2
    assert row["program_bytes"]["cpu/step.pt2"] > 0


def test_json_keys_match_jax(tmp_path):
    """export, inspect and solve print JAX's keys on the same command. By design the port
    names its framework's version (torch_version for jax_version), adds the generator
    device and the draws, and has no StableHLO calling convention."""
    args = ["--env", "pendulum", "--cpu", "--population", "64", "--planning-horizon", "4",
            "--iterations", "1"]
    renamed = {"jax_version": "torch_version"}
    port_only = {"stream_device", "draws"}
    rows = {}
    for package in ("blackbox_mpc_tpu", "blackbox_mpc_torch"):
        art = str(tmp_path / f"{package}.bbmpc")
        rows[package] = {}
        for command in (["export", *args, "-o", art], ["inspect", art],
                        ["solve", *args, "--steps", "3"]):
            proc = _run(command, package=package)
            assert proc.returncode == 0, (package, command, proc.stderr[-800:])
            rows[package][command[0]] = _last_json(proc.stdout)
    for command, j_row in rows["blackbox_mpc_tpu"].items():
        want = {renamed.get(k, k) for k in j_row} - {"calling_convention_version"}
        got = set(rows["blackbox_mpc_torch"][command]) - port_only
        assert got == want, (command, got ^ want)
        if command == "inspect":
            assert set(rows["blackbox_mpc_torch"][command]["tensors"]) == set(j_row["tensors"])


def _learn(ckpt, steps="30"):
    proc = _run(["learn", "--env", "Pendulum-v1", "--cpu", "--steps", steps,
                 "--initial-rollouts", "2", "--refinements", "0", "--epochs", "2",
                 "--population", "64", "--planning-horizon", "8",
                 "--checkpoint-dir", ckpt], timeout=600)
    assert proc.returncode == 0, proc.stderr[-1200:]


def test_learn_checkpoint_export_serve_pipeline(tmp_path):
    """learn dynamics on Pendulum-v1 with a checkpoint, export a learned controller from it
    (the Pendulum-v1 reward and bounds), serve it; an env without built-in bounds needs
    --action-low/--action-high."""
    ckpt = str(tmp_path / "ckpt")
    _learn(ckpt, steps="40")
    art = str(tmp_path / "learned.bbmpc")
    proc = _run(["export", "--env", "Pendulum-v1", "--cpu", "--checkpoint-dir", ckpt,
                 "-o", art, "--population", "64", "--planning-horizon", "10",
                 "--iterations", "2"])
    assert proc.returncode == 0, proc.stderr[-1200:]
    row = _last_json(proc.stdout)
    assert row["dim_s"] == 3 and row["dim_u"] == 1
    req = json.dumps({"obs": OBS, "t": 0}) + "\n" + json.dumps({"cmd": "close"}) + "\n"
    out = _run(["serve", art, "--cpu"], stdin=req)
    assert out.returncode == 0, out.stderr[-1200:]
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    action = lines[1]["action"]
    assert len(action) == 1 and -2.0 <= action[0] <= 2.0  # the real pendulum bounds
    proc = _run(["export", "--env", "SomeOther-v0", "--cpu", "--checkpoint-dir", ckpt,
                 "-o", str(tmp_path / "x.bbmpc"), "--population", "64",
                 "--planning-horizon", "8"])
    assert proc.returncode == 2 and "action-low" in proc.stderr
    proc = _run(["export", "--env", "SomeOther-v0", "--cpu", "--checkpoint-dir", ckpt,
                 "-o", str(tmp_path / "x.bbmpc"), "--population", "64",
                 "--planning-horizon", "8", "--action-low", "-2", "--action-high", "2"])
    assert proc.returncode == 0, proc.stderr[-1200:]


def test_export_checkpoint_dim_mismatch_with_analytic_env(tmp_path):
    """A checkpoint whose dims do not match the analytic --env's reward is refused (exit 2);
    the matching env exports. A cart-pole-shaped (S=4) checkpoint is made with the API."""
    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig

    cfg = LearnedDynamicsConfig(dim_s=4, dim_u=1, hidden=(8,), ensemble_size=1)
    handler = DynamicsHandler(config=cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    s = rng.normal(size=(64, 4)).astype(np.float32)
    a = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    handler.replay.add_transitions(s, a, s + 0.01 * a)
    handler.train(epochs=1, batch_size=32)
    ckpt = str(tmp_path / "ckpt")
    handler.save(ckpt)
    proc = _run(["export", "--env", "pendulum", "--cpu", "--checkpoint-dir", ckpt,
                 "-o", str(tmp_path / "x.bbmpc"), "--population", "64",
                 "--planning-horizon", "8"])
    assert proc.returncode == 2 and "dim_s=4" in proc.stderr, proc.stderr[-800:]
    proc = _run(["export", "--env", "cartpole", "--cpu", "--checkpoint-dir", ckpt,
                 "-o", str(tmp_path / "ok.bbmpc"), "--population", "64",
                 "--planning-horizon", "8"])
    assert proc.returncode == 0, proc.stderr[-800:]


def test_inspect_clean_error_on_foreign_zip(tmp_path):
    foreign = str(tmp_path / "foreign.zip")
    with zipfile.ZipFile(foreign, "w") as zf:
        zf.writestr("readme.txt", "not an artifact")
    for path in (foreign, str(tmp_path / "missing.bbmpc")):
        proc = _run(["inspect", path])
        assert proc.returncode == 2, (proc.returncode, proc.stderr[-400:])
        assert "Traceback" not in proc.stderr
    assert "not a .bbmpc artifact" in _run(["inspect", foreign]).stderr


def test_serve_survives_runtime_error_in_request(tmp_path):
    """A request that fails (the wrong agent count) yields a JSON error line, and the server
    keeps serving."""
    art = str(tmp_path / "ctrl.bbmpc")
    _export(art)
    reqs = "\n".join([
        json.dumps({"obs": [OBS] * 7}),
        json.dumps({"obs": OBS, "t": 0}),
        json.dumps({"cmd": "close"}),
    ]) + "\n"
    out = _run(["serve", art, "--cpu"], stdin=reqs)
    assert out.returncode == 0, out.stderr[-1200:]
    lines = [json.loads(ln) for ln in out.stdout.strip().splitlines()]
    assert "error" in lines[1] and "action" in lines[2]


def test_calibrate_checkpoint(tmp_path):
    """``calibrate`` prints the calibration summary of a probabilistic checkpoint (JAX's
    keys) and refuses deterministic and missing ones with a clean error."""
    from blackbox_mpc_torch import DynamicsHandler, LearnedDynamicsConfig

    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    a = rng.uniform(-1, 1, (600, 1)).astype(np.float32)
    ns = (0.9 * s + 0.2 * a + 0.1 * rng.standard_normal((600, 3))).astype(np.float32)
    prob = tmp_path / "prob"
    h = DynamicsHandler(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(16,), ensemble_size=2,
                                              probabilistic=True, learn_logvar_bounds=True),
                        seed=0, device="cpu")
    h.replay.add_transitions(s, a, ns)
    h.train(epochs=3, batch_size=128)
    h.save(str(prob))
    proc = _run(["calibrate", "--cpu", str(prob)])
    assert proc.returncode == 0, proc.stderr[-800:]
    row = _last_json(proc.stdout)
    assert set(row) == {"checkpoint", "variance_ratio", "coverage_1sigma", "coverage_2sigma",
                        "gaussian_expected", "val_points", "per_dim_variance_ratio",
                        "verdict"}
    assert row["variance_ratio"] > 0 and row["val_points"] > 0
    assert len(row["per_dim_variance_ratio"]) == 3
    assert row["verdict"] in ("approximately calibrated",
                              "overconfident (sampled noise too small)",
                              "underconfident (sampled noise too large)")
    det = tmp_path / "det"
    hd = DynamicsHandler(LearnedDynamicsConfig(dim_s=3, dim_u=1, hidden=(8,)), seed=0,
                         device="cpu")
    hd.replay.add_transitions(s[:100], a[:100], ns[:100])
    hd.train(epochs=1, batch_size=64)
    hd.save(str(det))
    proc = _run(["calibrate", "--cpu", str(det)])
    assert proc.returncode == 2 and "deterministic" in proc.stderr
    proc = _run(["calibrate", "--cpu", str(tmp_path / "missing")])
    assert proc.returncode == 2 and "no checkpoint" in proc.stderr
