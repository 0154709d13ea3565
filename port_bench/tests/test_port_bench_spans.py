"""The program spans' readers on a synthetic window (``data/spans_trace.json``, us: one
``act()`` in a 1000 us window, its spans nested as the program opens them, 595 us of device
operations, launch calls in each layer, a launch and 100 us of idle time after the call), held
to values worked out by hand; the split adds up to the window's idle time; a window with no
program span, or no device operation, gives nothing to read."""
import json
from pathlib import Path

import pytest

from port_bench import core, spans, trace

DATA = Path(__file__).resolve().parent / "data" / "spans_trace.json"
WORK = {"acts": 1}

# Idle intervals: [0, 25] [40, 80] [160, 180] [380, 420] [640, 720] [790, 870] [880, 1000].
IDLE_BY_SPAN = {
    "outside": 10.0 + 100.0,  # before policy.act, and after it to the window's end
    "policy.obs_in": 15.0 + 20.0,
    "solver.sample": 20.0,
    "models.step": 20.0 + 40.0 + 10.0,
    "evaluator.evaluate": 10.0 + 10.0,  # around kernels.K2
    "kernels.K2": 30.0,
    "solver.update": 20.0 + 10.0,
    "policy.lookahead": 50.0,
    "policy.wait": 20.0 + 10.0,
    "policy.act": 10.0,  # after policy.wait, before the call returns
}
IDLE_BY_LAYER = {"policy": 125.0, "solver": 50.0, "evaluator": 20.0, "models": 70.0,
                 "kernels": 30.0, "learning": 0.0, "outside": 110.0}


def spans_trace() -> trace.Traced:
    raw = json.loads(DATA.read_text())
    return trace.Traced([trace.Event(*e) for e in raw["events"]], *raw["window"])


def read(name, traced=None, work=WORK):
    return core.metric_reader(name)({"traced": traced or spans_trace(), "work": work})


def test_idle_time_split_by_span_and_layer():
    t = spans_trace()
    assert spans.idle_by_span(t) == pytest.approx(IDLE_BY_SPAN)
    assert spans.idle_by_layer(t) == pytest.approx(IDLE_BY_LAYER)


def test_layers_and_outside_add_up_to_the_idle_time():
    t = spans_trace()
    idle = (t.hi_us - t.lo_us) - trace.device_busy_us(t)
    assert idle == pytest.approx(405.0)
    assert sum(spans.idle_by_layer(t).values()) == pytest.approx(idle)


def test_launches_by_innermost_span():
    assert spans.launches_by_span(spans_trace()) == {
        "policy.obs_in": 1, "solver.sample": 1, "models.step": 6, "kernels.K2": 1,
        "solver.update": 1, "policy.wait": 1, "outside": 1}


@pytest.mark.parametrize("name, want", [
    ("policy.device_idle_ms_per_act", 0.125),
    ("solver.device_idle_ms_per_act", 0.050),
    ("evaluator.device_idle_ms_per_act", 0.020),
    ("policy.device_idle_ms_per_act.pets", 0.125),
    ("solver.device_idle_ms_per_act.pets", 0.050),
    ("evaluator.device_idle_ms_per_act.pets", 0.020),
    ("models.device_idle_ms_per_act.pets", 0.070),
    ("models.launches_per_act.pets", 6.0),
])
def test_reader(name, want):
    assert read(name) == pytest.approx(want)
    assert read(name, work={"acts": 2}) == pytest.approx(want / 2)


NEW_READERS = ["policy.device_idle_ms_per_act", "solver.device_idle_ms_per_act",
               "evaluator.device_idle_ms_per_act", "models.device_idle_ms_per_act.pets",
               "models.launches_per_act.pets"]


@pytest.mark.parametrize("name", NEW_READERS)
def test_no_program_span_nothing_to_read(name):
    """A program that opens no span (an older one) leaves the metric out."""
    t = spans_trace()
    t.events = [e for e in t.events if not e.name.startswith(spans._PREFIXES)]
    assert spans.idle_by_span(t) is None and spans.launches_by_span(t) is None
    assert read(name, t) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_need_acts(name):
    assert read(name, work={}) is None


def test_no_device_operation_no_idle_split():
    t = spans_trace()
    t.events = [e for e in t.events if not e.on_device]
    assert spans.idle_by_layer(t) is None
    assert read("policy.device_idle_ms_per_act", t) is None


def test_an_older_trace_reads_nothing():
    """The readers on the trace of a program with no spans (``small_trace.json``)."""
    from port_bench.tests.test_port_bench_metrics import small_trace

    for name in NEW_READERS:
        assert core.metric_reader(name)({"traced": small_trace(), "work": {"acts": 2}}) \
            is None


def test_the_existing_readers_ignore_the_spans():
    """Spans add no device operation and no wait: the device-side copy of an annotation is
    not an operation."""
    t = spans_trace()
    assert len(t.device_ops()) == 6
    assert read("solver.device_ops_per_act", t) == 6.0
    assert read("policy.host_waits_per_act", t) == 2.0
