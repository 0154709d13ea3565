"""Import hygiene of the PyTorch port: every module of blackbox_mpc_torch, and chip_smoke.py,
import without JAX and without the JAX package (the GPU machine has no JAX), and without
Orbax, tensorstore or zstandard (the port reads JAX checkpoints with its own reader)."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import blackbox_mpc_torch
# __main__ runs the command line when imported; it is imported alone below.
names = [m.name for m in pkgutil.walk_packages(blackbox_mpc_torch.__path__, "blackbox_mpc_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax", "blackbox_mpc_tpu",
                                            "orbax", "tensorstore", "zstandard")))
assert not bad, bad
assert "triton" not in sys.modules
# Optional packages load only where they are used: gymnasium in make_gym_vec_env, imageio in
# record_rollout, tensorboardX in a MetricsWriter with a log_dir.
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("gymnasium", "imageio", "tensorboardX"))
assert not lazy, lazy
print(len(names))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 56  # every module was walked


# The modules of the solver registry's rest and the POPLIN half, the single-card entry points,
# the parallel layer and the Orbax reader and writer, each imported on its own.
NEW_MODULES = ["solvers.gradient", "solvers.cem_gd", "solvers.pso", "solvers.spsa",
               "learning.proposer", "policies.pipeline", "ops.backend_select",
               "utils.profiling", "workflows.device_episode", "deploy", "deploy.export",
               "deploy.serving", "cli", "parallel", "parallel.mesh", "parallel.multihost",
               "parallel.sharding", "ops.fused_sharded", "learning._zstd",
               "learning.orbax_read", "learning.orbax_write"]

_ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax", "blackbox_mpc_tpu",
                                            "orbax", "tensorstore", "zstandard")))
assert not bad, bad
"""


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_no_jax(module):
    out = subprocess.run([sys.executable, "-c", _ALONE, f"blackbox_mpc_torch.{module}"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_main_module_runs_the_cli_without_jax():
    """``python -m blackbox_mpc_torch`` imports no JAX: ``solvers`` prints the registry."""
    probe = ("import runpy, sys\n"
             "sys.argv = ['blackbox_mpc_torch', 'solvers']\n"
             "try:\n"
             "    runpy.run_module('blackbox_mpc_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert e.code == 0, e.code\n"
             "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
             "'blackbox_mpc_tpu')))\n"
             "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CEM:" in out.stdout


_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "blackbox_mpc_tpu", "orbax", "tensorstore",
             "zstandard"):
    sys.modules[name] = None  # any import of these raises ImportError
import blackbox_mpc_torch
from blackbox_mpc_torch import (SOLVER_REGISTRY, BoxSpace, Solver, SolverAux, as_box_space,
                                make_solver, make_trajectory_evaluator)
print(" ".join(blackbox_mpc_torch.__all__))
"""


def test_top_level_names_cover_the_reference_without_jax():
    """Every name of the JAX package's ``__all__`` is exported by the port's top level, which
    imports in a process where ``jax`` cannot be imported."""
    import blackbox_mpc_tpu

    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    port = set(out.stdout.split())
    assert set(blackbox_mpc_tpu.__all__) <= port, set(blackbox_mpc_tpu.__all__) - port


def test_top_level_names_are_the_subpackages_objects():
    import blackbox_mpc_torch as port
    from blackbox_mpc_torch import core, rollout, solvers

    assert port.make_solver is solvers.make_solver
    assert port.SOLVER_REGISTRY is solvers.SOLVER_REGISTRY
    assert port.make_trajectory_evaluator is rollout.make_trajectory_evaluator
    for name in ("BoxSpace", "as_box_space", "Solver", "SolverAux", "Bounds"):
        assert getattr(port, name) is getattr(core, name)


_READ_BLOCKED = r"""
import sys
for name in ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "blackbox_mpc_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
from blackbox_mpc_torch import DynamicsHandler
from blackbox_mpc_torch.learning.orbax_read import named_leaves, restore_pytree
tree = restore_pytree("benchmarks/ckpt_gradient_bc_300/proposer")
handler = DynamicsHandler.load("tests/torch_fixtures/jax_pendulum_loop/handler", device="cpu")
print(len(named_leaves(tree)), len(handler.replay))
"""


def test_jax_checkpoints_read_without_jax_orbax_or_tensorstore():
    """A JAX-written Orbax tree and handler directory load in a process where JAX, Orbax,
    tensorstore and zstandard cannot be imported."""
    out = subprocess.run([sys.executable, "-c", _READ_BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    leaves, replay = map(int, out.stdout.split())
    assert leaves == 20 and replay == 200


_WRITE_BLOCKED = r"""
import sys, tempfile
for name in ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "blackbox_mpc_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
from blackbox_mpc_torch import DynamicsHandler
from blackbox_mpc_torch.learning.orbax_read import leaf_digests, restore_pytree
from blackbox_mpc_torch.models.convert import handler_to_numpy
handler = DynamicsHandler.load("tests/torch_fixtures/jax_pendulum_loop/handler", device="cpu")
with tempfile.TemporaryDirectory() as out:
    handler.save(out)
    same = leaf_digests(restore_pytree(out + "/checkpoint")) == leaf_digests(
        handler_to_numpy(handler)[1])
print(same)
"""


def test_jax_checkpoints_written_without_jax_orbax_or_tensorstore():
    """The port saves a handler in the JAX package's format, and reads it back leaf for leaf,
    in a process where JAX, Orbax, tensorstore and zstandard cannot be imported."""
    out = subprocess.run([sys.executable, "-c", _WRITE_BLOCKED], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"]
