"""The harness's dry path: every cell driven on the CPU at a tiny size, as ``run.py`` drives
it after its look for a card, comes out correct, with its end-to-end numbers and, traced,
its per-layer readers' inputs."""
import json
import math

import pytest

from port_bench import core
from port_bench.tests.tiny import TINY, dry_run

CELLS = sorted(TINY)


def test_every_cell_has_a_tiny_size():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    candidates = json.loads((core.HERE / "candidates.json").read_text())
    assert sorted([w["name"] for w in bench["workloads"]] + list(candidates)) == CELLS
    assert not set(candidates) & {w["name"] for w in bench["workloads"]}


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_is_correct(workload):
    run, out = dry_run(workload)
    assert all(c.ok for c in out.checks.values()), out.checks
    assert out.attempted > 0 and out.failed == 0
    want = ({m["name"].split(".", 1)[0] for m in run.end_to_end()} - {"setup_s"}
            or set(run.workload.get("end_to_end", {})))  # a candidate's own
    assert set(out.end_to_end) >= want and want
    assert all(math.isfinite(v) and v > 0 for v in out.end_to_end.values())
    assert run.extra["setup_s"] > 0
    if run.traffic["driver"] == "closed_loop":
        # The rate is every completed call's plans over the whole window, which the last
        # call closes after --seconds.
        assert out.work["window_s"] >= run.seconds
        assert out.end_to_end["agent_plans_per_s"] == pytest.approx(
            out.attempted * run.traffic["agents"] / out.work["window_s"])
        assert out.end_to_end["act_ms_p50"] <= out.end_to_end["act_ms_p95"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_is_correct(workload):
    run, out = dry_run(workload, trace=True)
    assert all(c.ok for c in out.checks.values()), out.checks
    assert out.traced is not None and out.traced.window_s > 0
    if run.traffic["driver"] == "closed_loop":
        assert out.attempted == run.traffic["trace_acts"]
    for m in run.per_layer():
        core.metric_reader(m["name"])({"traced": out.traced, "work": out.work})


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_inputs(workload):
    """Two runs of one seed plan from the same starts and check the same calls."""
    _, a = dry_run(workload, trace=True)
    _, b = dry_run(workload, trace=True)
    assert {k: c.value for k, c in a.checks.items()} == \
        {k: c.value for k, c in b.checks.items()}


def test_result_line_puts_checks_last():
    line = core.result_line(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                            {"platform": "gpu"}, {"action": core.Check(1e-7, 1e-3)},
                            {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"]["action"] == {"value": 1e-7, "limit": 1e-3}


def test_a_nan_fails_its_check():
    assert not core.Check(float("nan"), 1.0).ok
    assert core.Check(0.0, 0.0).ok and not core.Check(1e-30, 0.0).ok


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["cheetah_cem_3x500.cem_closed_loop",
                                      "pets_halfcheetah.ts_inf_closed_loop"])
def test_report_prints_the_cells_metrics(workload, traced, monkeypatch, capsys):
    """``run.py``'s report on the dry path (the card's name stubbed): the last line of
    standard output holds the cell's end-to-end metrics (``--trace 0``) or those of its
    per-layer metrics that the CPU's trace has something for (``--trace 1``), and the checks
    come last; standard error ends with the checks."""
    import time

    import torch

    from port_bench import run as entry
    from port_bench.tests.tiny import SEED, TINY

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "cpu (test)")
    run = core.load_run(workload, SEED, 0.3, traced, "cpu", time.perf_counter(),
                        overrides=TINY[workload])
    torch.set_num_threads(1)
    assert entry.report(run, 1, "test card") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    names = set(line["metrics"])
    if traced:
        assert names <= {m["name"] for m in run.per_layer()}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "breakdown" in line
    else:
        assert names == {m["name"] for m in run.end_to_end()}
    assert err.strip().splitlines()[-1].startswith("check failed_requests")
