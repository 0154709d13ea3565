"""``run.py`` prints no result and exits with another code than 0 without a card, and in a
directory that holds only ``BENCHMARK.json`` and the benchmark's folder."""
import os
import shutil
import subprocess
import sys

from port_bench import core

ARGS = ["--workload", "cheetah_cem_3x500.cem_closed_loop", "--seed", "2147483700",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    # This sandbox's torch has no CUDA.
    import torch

    assert not torch.cuda.is_available()
    out = subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=core.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    # The dry path, past the look for a card: the program cannot be imported.
    code = ("from port_bench.tests.tiny import dry_run; "
            "dry_run('cheetah_cem_3x500.cem_closed_loop')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "blackbox_mpc_torch" in out.stderr
    run = subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and run.stdout == ""


def test_unknown_workload_is_refused():
    out = subprocess.run([sys.executable, "port_bench/run.py", *ARGS[:1], "nope", *ARGS[2:]],
                         cwd=core.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
