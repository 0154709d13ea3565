"""The torch twins of the tutorials (``tutorials_torch/``), run as scripts with ``--cpu``: the
counterpart of ``tests/test_tutorials.py``, with its scaled-down arguments and its ``slow``
mark (the MuJoCo ones are gated on the mujoco import).

Two cases run in the fast suite: the low-level API and the first true-model tutorial, each in
a process where ``jax`` cannot be imported, exiting 0 with a finite reward; and a tutorial
started without ``--cpu`` on a machine without CUDA, which must stop with the port's device
error rather than run on the CPU.
"""
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# script -> extra arguments (every tutorial takes the _common.setup() flags); those of
# tests/test_tutorials.py.
TUTORIALS = {
    "tutorials_torch/true_model_mpc/tutorial_one.py": ["--steps", "40"],
    "tutorials_torch/true_model_mpc/tutorial_two.py": ["--steps", "40"],
    "tutorials_torch/true_model_mpc/tutorial_three.py": [],
    "tutorials_torch/true_model_mpc/tutorial_four.py": ["--steps", "60"],
    "tutorials_torch/low_level_api/tutorial_one.py": [],
    "tutorials_torch/distributed/tutorial_one.py": [],
    "tutorials_torch/distributed/tutorial_two.py": [],
    "tutorials_torch/learn_dynamics/tutorial_one.py": ["--steps", "30"],
    "tutorials_torch/model_based_rl/tutorial_one.py": ["--steps", "30", "--refinements", "1"],
    "tutorials_torch/model_based_rl/tutorial_two.py": ["--steps", "30", "--refinements", "1"],
    "tutorials_torch/model_based_rl/tutorial_three.py": ["--steps", "30"],
    "tutorials_torch/save_load/tutorial_one.py": ["--steps", "30"],
    "tutorials_torch/save_load/tutorial_two.py": ["--steps", "30"],
    "tutorials_torch/probabilistic/tutorial_one.py": ["--steps", "40"],
    "tutorials_torch/probabilistic/tutorial_two.py": ["--steps", "30"],
    "tutorials_torch/gradient_planning/tutorial_one.py": ["--steps", "40"],
    "tutorials_torch/proposer/tutorial_one.py": ["--steps", "30", "--refinements", "1"],
    "tutorials_torch/record_videos/tutorial_one.py": [],
    "tutorials_torch/beyond_hbm/tutorial_one.py": ["--population", "256"],
    "tutorials_torch/deploy/tutorial_one.py": ["--steps", "30"],
}

MUJOCO_TUTORIALS = {
    "tutorials_torch/mujoco/tutorial_one.py": ["--steps", "25"],
    "tutorials_torch/mujoco/tutorial_two.py": ["--steps", "25", "--refinements", "1"],
    "tutorials_torch/mujoco/tutorial_three.py": ["--steps", "20", "--refinements", "1"],
}

# Blocks the JAX stack in the tutorial's process, then runs the script as __main__.
_NO_JAX = ("import runpy, sys\n"
           "for name in ('jax', 'jaxlib', 'flax', 'optax', 'blackbox_mpc_tpu'):\n"
           "    sys.modules[name] = None\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_path(sys.argv[0], run_name='__main__')\n")


def _run(script, extra, tmp_path, timeout=300, cpu=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}:{env.get('PYTHONPATH', '')}"
    env["TMPDIR"] = str(tmp_path)
    env["OMP_NUM_THREADS"] = "1"  # one intra-op thread: the test workers share the cores
    args = list(extra) + (["--cpu"] if cpu else [])
    if "save_load/tutorial_two" in script or "model_based_rl/tutorial_two" in script:
        args += ["--ckpt", str(tmp_path / "ckpt")]
    if "model_based_rl/tutorial_two" in script:
        args += ["--logdir", str(tmp_path / "tb")]
    return subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT / script), *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
    )


def _ok(result, script):
    assert result.returncode == 0, f"{script} failed:\n{result.stdout}\n{result.stderr}"
    return result.stdout


def test_every_tutorial_has_a_twin():
    """A twin of each of the 23 scripts of tutorials/ (and the MuJoCo helpers), at the same
    relative path, none of them importing JAX or the JAX package."""
    jax_scripts = sorted(p.relative_to(ROOT / "tutorials")
                         for p in (ROOT / "tutorials").rglob("*.py"))
    for rel in jax_scripts:
        twin = ROOT / "tutorials_torch" / rel
        assert twin.exists(), rel
        source = twin.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|blackbox_mpc_tpu)\b", source, re.M), rel
    assert len([p for p in jax_scripts if p.name.startswith("tutorial_")]) == 23
    assert set(TUTORIALS) | set(MUJOCO_TUTORIALS) == {
        f"tutorials_torch/{p}" for p in jax_scripts if p.name.startswith("tutorial_")}


@pytest.mark.parametrize("script,extra,pattern", [
    ("tutorials_torch/low_level_api/tutorial_one.py", [],
     r"episode reward (\S+), final cos\(theta\) \S+, expected plan reward (\S+)"),
    ("tutorials_torch/true_model_mpc/tutorial_one.py", ["--steps", "10"],
     r"CEM: episode reward (\S+), act p50 (\S+) ms"),
])
def test_fast_tutorials_without_jax(script, extra, pattern, tmp_path):
    """The fast Tier-1 pair: each exits 0 with a finite reward in a process where jax cannot
    be imported."""
    out = _ok(_run(script, extra, tmp_path, timeout=180), script)
    found = re.search(pattern, out)
    assert found, out
    assert all(math.isfinite(float(x.rstrip(","))) for x in found.groups())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_tutorial_without_cpu_flag_needs_the_card(tmp_path):
    """Without --cpu a tutorial runs on cuda; with no card it stops with the port's device
    error and never moves to the CPU on its own."""
    result = _run("tutorials_torch/true_model_mpc/tutorial_one.py", ["--steps", "2"], tmp_path,
                  timeout=120, cpu=False)
    assert result.returncode != 0
    assert "CUDA is not available" in result.stderr
    assert "episode reward" not in result.stdout


@pytest.mark.slow
@pytest.mark.parametrize("script", sorted(TUTORIALS))
def test_tutorial_runs(script, tmp_path):
    _ok(_run(script, TUTORIALS[script], tmp_path), script)


@pytest.mark.slow
@pytest.mark.parametrize("script", sorted(MUJOCO_TUTORIALS))
def test_mujoco_tutorial_runs(script, tmp_path):
    pytest.importorskip("mujoco")
    _ok(_run(script, MUJOCO_TUTORIALS[script], tmp_path, timeout=900), script)
