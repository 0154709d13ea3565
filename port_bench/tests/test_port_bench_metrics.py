"""Each per-layer metric's reader on a small trace of two ``act()``s (``data/
small_trace.json``, us: a 10 ms window, per act two 2 ms rollout kernels, a 0.1 ms
elementwise kernel, one copy each way and two waits; one kernel after the window) and on
work counts by hand; and a reader finds nothing where the trace has nothing to read."""
import json
from pathlib import Path

import pytest

from port_bench import core, trace

DATA = Path(__file__).resolve().parent / "data" / "small_trace.json"


def small_trace():
    raw = json.loads(DATA.read_text())
    events = [trace.Event(*e) for e in raw["events"]]
    return trace.Traced(events, *raw["window"])


PLAN_WORK = {"acts": 2, "agents": 1, "flops_per_act": 6.7e10, "rollout_least_ms_per_act": 2.0,
             "peak_flops": 67e12}
TRAIN_WORK = {"train_steps": 4, "flops_per_step": 6.7e9, "peak_flops": 67e12}


def read(name, work):
    return core.metric_reader(name)({"traced": small_trace(), "work": work})


def test_busy_time_and_window():
    t = small_trace()
    assert t.window_s == pytest.approx(0.010)
    # Per act: 10 + 2000 + 2000 + 100 + 10 us of device operations.
    assert trace.device_busy_us(t) == pytest.approx(2 * 4120.0)
    assert len(t.device_ops()) == 10


@pytest.mark.parametrize("name, work, want", [
    # 2 ms least time over 4 ms of rollout kernels per act.
    ("kernels.rollout_roofline", PLAN_WORK, 50.0),
    # 2 x 6.7e10 FLOP over 0.010 s x 67 TFLOP/s.
    ("step.act_mfu", PLAN_WORK, 20.0),
    ("device.idle_share.plan", PLAN_WORK, 100.0 * (1 - 8240.0 / 10000.0)),
    ("policy.host_waits_per_act", PLAN_WORK, 2.0),
    ("solver.device_ops_per_act", PLAN_WORK, 5.0),
    ("device.idle_share.train", TRAIN_WORK, 100.0 * (1 - 8240.0 / 10000.0)),
    # 4 x 6.7e9 FLOP over 0.010 s x 67 TFLOP/s.
    ("learning.train_mfu", TRAIN_WORK, 4.0),
    ("learning.h2d_copies_per_step", TRAIN_WORK, 0.5),
])
def test_reader(name, work, want):
    assert read(name, work) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kernels.rollout_roofline", "step.act_mfu",
                                  "policy.host_waits_per_act", "solver.device_ops_per_act"])
def test_planning_readers_need_acts(name):
    assert read(name, {}) is None


@pytest.mark.parametrize("name", ["learning.train_mfu", "learning.h2d_copies_per_step"])
def test_training_readers_need_steps(name):
    assert read(name, {}) is None


def test_no_rollout_kernel_no_roofline():
    t = small_trace()
    t.events = [e for e in t.events if "rollout_kernel" not in e.name]
    assert core.metric_reader("kernels.rollout_roofline")({"traced": t, "work": PLAN_WORK}) \
        is None


@pytest.mark.parametrize("name", ["device.idle_share.plan", "device.idle_share.train"])
def test_no_device_operation_no_idle_share(name):
    t = small_trace()
    t.events = [e for e in t.events if not e.on_device]
    assert core.metric_reader(name)({"traced": t, "work": PLAN_WORK}) is None


def test_breakdown():
    out = trace.breakdown(small_trace())
    assert out["device_ops"][0][0].startswith("void rollout_kernel")
    assert out["device_ops"][0][1] == pytest.approx(0.008)
    assert len(out["device_ops"]) == 4
    # The longest gaps: 400 us in each act between its last kernel and its output copy, and
    # 240 us from the first act's output copy to the second's input copy, each begun while
    # the host waited in cudaStreamSynchronize.
    assert [name for name, _ in out["idle_gaps"][:3]] == ["cudaStreamSynchronize"] * 3
    assert [s for _, s in out["idle_gaps"][:3]] == pytest.approx([0.0004, 0.0004, 0.00024])
    assert len(out["idle_gaps"]) == 10


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(core.metric_reader(m["name"]))
