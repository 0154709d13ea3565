"""The traced window: ``torch.profiler`` around a few of the cell's calls, and its reduction
to the device's busy time, the host's waits and the device operations by name.

Rewritten from ``chip_smoke.py::profiled_events`` and ``trace_once`` at commit
ac03e766bab09bd63f85a82fabe5130dff9fd456, with the profiler used as
``blackbox_mpc_torch/utils/profiling.py::trace`` uses it: one warm-up step that the profiler
discards, so that the device tracer runs before the window opens and loses none of its first
operations. The events are read from the profiler's raw Kineto results, without building
``FunctionEvent``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

__all__ = ["Event", "Traced", "profile_window", "device_busy_us", "breakdown", "WINDOW"]

WINDOW = "port_bench.window"  # the host span around the traced calls
# The profiler's own host events, which name no work of the program.
PROFILER_OWN = ("ProfilerStep#", "Activity Buffer Request")


class Event(NamedTuple):
    name: str
    on_device: bool
    start_us: float  # from the trace's start
    end_us: float
    is_user_annotation: bool


@dataclass
class Traced:
    """The events of a traced window and the window's host span (us from the trace's
    start)."""

    events: list
    lo_us: float
    hi_us: float

    @property
    def window_s(self) -> float:
        return (self.hi_us - self.lo_us) / 1e6

    def device_ops(self) -> list:
        """Device operations (kernels, copies, sets) that start inside the window."""
        return [e for e in self.events if e.on_device and not e.is_user_annotation
                and self.lo_us <= e.start_us <= self.hi_us]

    def host_calls(self, name: str) -> int:
        """Host events named ``name`` that start inside the window."""
        return sum(1 for e in self.events if not e.on_device and e.name == name
                   and self.lo_us <= e.start_us <= self.hi_us)


def _events(prof) -> list:
    """Frozen from ``chip_smoke.py::profiled_events``: the events ``prof.events()`` gives (no
    memory records, no hidden events), from the Kineto results."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    return [Event(e.name(), e.device_type() == DeviceType.CUDA, (e.start_ns() - t0) / 1000,
                  (e.end_ns() - t0) / 1000, e.is_user_annotation())
            for e in results.events()
            if e.name() not in ("[memory]", "[OutOfMemory]") and not e.is_hidden_event()]


def profile_window(warmup: Callable[[], Any], window: Callable[[], Any], cuda: bool) -> Traced:
    """Runs ``warmup()`` in the profiler's discarded warm-up step, then ``window()`` inside a
    host span named WINDOW in its active step, and returns the events. ``cuda``: trace the
    device too."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if cuda:
            torch.cuda.synchronize()
        warmup()
        prof.step()
        with record_function(WINDOW):
            window()
        prof.step()
    events = _events(prof)
    span = next(e for e in events if e.name == WINDOW and not e.on_device)
    return Traced(events, span.start_us, span.end_us)


def _union(spans, lo: float, hi: float):
    """(busy us, idle gaps [(us, start, the operation after the gap)]) of ``spans`` = sorted
    ``(start, end, name)`` clipped to ``[lo, hi]``."""
    busy, reached, gaps = 0.0, lo, []
    for start, end, name in spans:
        a, b = min(max(start, reached), hi), min(end, hi)
        if a > reached:
            gaps.append((a - reached, reached, name))
        if b > a:
            busy += b - a
        reached = max(reached, b)
    if hi > reached:
        gaps.append((hi - reached, reached, None))
    return busy, gaps


def device_busy_us(traced: Traced) -> float:
    """The time in the window in which some device operation ran."""
    spans = sorted((e.start_us, e.end_us, e.name) for e in traced.device_ops())
    return _union(spans, traced.lo_us, traced.hi_us)[0]


def _host_activity(traced: Traced, at_us: float) -> str:
    """What the host was doing at ``at_us``: the innermost host event around it (the latest
    started one that has not ended), the window's span left out."""
    best = None
    for e in traced.events:
        if (e.on_device or e.name == WINDOW or e.name.startswith(PROFILER_OWN)
                or not e.start_us <= at_us < e.end_us):
            continue
        if best is None or e.start_us >= best.start_us:
            best = e
    return best.name if best is not None else "(host idle)"


def breakdown(traced: Traced, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by name) and the longest
    idle gaps, each named by what the host was doing when it began."""
    ops = traced.device_ops()
    by_name: dict = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    spans = sorted((e.start_us, e.end_us, e.name) for e in ops)
    _, gaps = _union(spans, traced.lo_us, traced.hi_us)
    longest = sorted(gaps, key=lambda g: -g[0])[:top]
    return {
        "device_ops": [[name[:120], s] for name, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_activity(traced, start + min(1.0, us / 2))[:120], us / 1e6]
                      for us, start, _ in longest],
    }

