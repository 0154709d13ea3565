"""A new cell needs only new files and a new entry: in a copy of the benchmark, a throwaway
traffic mix, its limits and its cell in ``BENCHMARK.json`` run on the dry path, and no file
that was there changes."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from port_bench import core

MIX = {
    "driver": "closed_loop",
    "about": "A throwaway mix: a small CEM.",
    "agents": 2,
    "solver": "CEM",
    "solver_kwargs": {"population": 24, "num_elite": 4, "max_iterations": 2, "alpha": 0.5,
                      "warm_start": True},
    "planning_horizon": 4,
    "rollout_backend": "auto",
    "stream_rho": 0.9,
    "reset_every": 5,
    "warmup_acts": 2,
    "trace_acts": 2,
    "sample_acts": 3,
}


def digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_from_files_alone(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "port_bench")
    (tmp_path / "port_bench" / "traffic" / "throwaway.json").write_text(json.dumps(MIX))
    name = "cheetah_cem_3x500.throwaway"
    limits = json.loads((core.HERE / "limits" /
                         "cheetah_cem_3x500.cem_closed_loop.json").read_text())
    (tmp_path / "port_bench" / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "cheetah_cem_3x500",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # as the CEM cell reports
        if "cheetah_cem_3x500.cem_closed_loop" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
from port_bench.tests.tiny import dry_run
run, out = dry_run({name!r}, overrides={{"config": {{"model": {{"hidden": [16, 16]}}}}}},
                   bench_path={str(tmp_path / "BENCHMARK.json")!r})
print(json.dumps({{"ok": all(c.ok for c in out.checks.values()), "acts": out.attempted,
                  "metrics": sorted(out.end_to_end), "per_layer": [m["name"] for m in run.per_layer()],
                  "file": __import__("port_bench").__file__}}))
"""
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{core.ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["file"].startswith(str(tmp_path))
    assert result["ok"] and result["acts"] > 0
    assert result["metrics"] == ["act_ms_p50", "act_ms_p95", "agent_plans_per_s"]
    assert "step.act_mfu" in result["per_layer"]
    after = digests(tmp_path / "port_bench")
    assert {k: v for k, v in after.items() if k in before} == before
