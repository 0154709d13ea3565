"""``evaluator.graph_replay_share.pets`` on a synthetic trace (``data/graph_replay_trace.json``,
us: three ``act()``s whose evaluations run eager, then capture and replay, then replay, with a
window over each): 0, a fraction and 100; nothing to read with no program span or no
evaluation. A replayed evaluation opens no ``models.step``, so ``models.launches_per_act.pets``
reads 0 there, not nothing."""
import json
from pathlib import Path

import pytest

from port_bench import core, spans, trace

DATA = Path(__file__).resolve().parent / "data" / "graph_replay_trace.json"
NAME = "evaluator.graph_replay_share.pets"


def traced(window: str) -> trace.Traced:
    raw = json.loads(DATA.read_text())
    return trace.Traced([trace.Event(*e) for e in raw["events"]], *raw["windows"][window])


def read(name, t, acts=1):
    return core.metric_reader(name)({"traced": t, "work": {"acts": acts}})


@pytest.mark.parametrize("window, share", [
    ("eager", 0.0), ("first", 75.0), ("replayed", 100.0), ("all", 70.0)])
def test_replay_share(window, share):
    assert read(NAME, traced(window)) == pytest.approx(share)


@pytest.mark.parametrize("window, launches", [("eager", 4.0), ("first", 2.0),
                                              ("replayed", 0.0)])
def test_model_launches_stop_where_the_evaluations_replay(window, launches):
    assert read("models.launches_per_act.pets", traced(window)) == launches


def test_no_program_span_or_no_evaluation_nothing_to_read():
    t = traced("all")
    t.events = [e for e in t.events if not e.name.startswith(spans._PREFIXES)]
    assert read(NAME, t) is None
    t = traced("all")
    t.events = [e for e in t.events if e.name != "evaluator.evaluate"]
    assert read(NAME, t) is None


def test_an_older_trace_reads_nothing():
    """The trace of a program with no spans (``small_trace.json``)."""
    from port_bench.tests.test_port_bench_metrics import small_trace

    assert read(NAME, small_trace(), acts=2) is None
