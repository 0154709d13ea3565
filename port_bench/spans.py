"""The program's spans in a traced window, and the device's idle time put down to them.

The program names its regions ``<layer>.<region>`` (``blackbox_mpc_torch/utils/profiling.py::
span``: ``policy.act``, ``solver.iteration``, ``evaluator.evaluate``, ``models.step``,
``kernels.K2``, ``learning.step``, ...). While the profiler records, each is a host user
annotation of the same trace as the device's operations, on the same clock. A program without
such spans (an older one) gives no program span, and each reading here is then None.

The device's idle time is the window less the union of its operations (as
``trace.device_busy_us`` takes it). Each idle interval is split over the innermost program
span open on the host at each instant: the latest begun that has not ended. The program opens
its spans on the one thread that calls it, so they nest. A piece goes to its span's layer, the
name up to the first dot; a piece with no program span open goes to ``OUTSIDE`` (the harness's
own loop between calls, and the window's edges). The layers and ``OUTSIDE`` add up to the
window's idle time.
"""
from __future__ import annotations

import bisect
import heapq

from port_bench.trace import Traced, _union

__all__ = ["LAUNCHES", "OUTSIDE", "PROGRAM_LAYERS", "idle_by_layer", "idle_by_span",
           "idle_ms_per_act", "launches_by_span", "program_spans"]

PROGRAM_LAYERS = ("policy", "solver", "evaluator", "models", "kernels", "learning")
OUTSIDE = "outside"
# The host's calls that put work on the device: kernel launches, copies and sets.
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")
_PREFIXES = tuple(f"{layer}." for layer in PROGRAM_LAYERS)


def program_spans(traced: Traced) -> list:
    """The host's program spans that overlap the window."""
    return [e for e in traced.events
            if not e.on_device and e.is_user_annotation and e.name.startswith(_PREFIXES)
            and e.start_us < traced.hi_us and e.end_us > traced.lo_us]


def _segments(traced: Traced) -> list:
    """``[(start, end, innermost program span's name or None)]`` in order, covering the
    window."""
    lo, hi = traced.lo_us, traced.hi_us
    spans = sorted(program_spans(traced), key=lambda e: e.start_us)
    edges = sorted({lo, hi, *(t for e in spans for t in (e.start_us, e.end_us) if lo < t < hi)})
    open_spans, i, out = [], 0, []  # a heap: the latest begun (the shortest of a tie) on top
    for a, b in zip(edges, edges[1:]):
        while i < len(spans) and spans[i].start_us <= a:
            e = spans[i]
            heapq.heappush(open_spans, (-e.start_us, e.end_us, i, e.name))
            i += 1
        while open_spans and open_spans[0][1] <= a:
            heapq.heappop(open_spans)
        out.append((a, b, open_spans[0][3] if open_spans else None))
    return out


def idle_by_span(traced: Traced) -> dict | None:
    """``{innermost program span's name or OUTSIDE: device idle us}`` over the window; None
    where the window holds no program span or no device operation."""
    ops = traced.device_ops()
    if not ops or not program_spans(traced):
        return None
    _, gaps = _union(sorted((e.start_us, e.end_us, e.name) for e in ops), traced.lo_us,
                     traced.hi_us)
    segments = _segments(traced)
    starts = [s[0] for s in segments]
    out: dict = {}
    for us, start, _ in gaps:
        end = start + us
        k = max(bisect.bisect_right(starts, start) - 1, 0)
        while k < len(segments) and segments[k][0] < end:
            a, b, name = segments[k]
            piece = min(b, end) - max(a, start)
            if piece > 0:
                key = OUTSIDE if name is None else name
                out[key] = out.get(key, 0.0) + piece
            k += 1
    return out


def idle_by_layer(traced: Traced) -> dict | None:
    """``{layer or OUTSIDE: device idle us}``, every layer of PROGRAM_LAYERS present; None as
    ``idle_by_span``."""
    by_span = idle_by_span(traced)
    if by_span is None:
        return None
    out = {layer: 0.0 for layer in (*PROGRAM_LAYERS, OUTSIDE)}
    for name, us in by_span.items():
        out[name.split(".", 1)[0]] += us
    return out


def idle_ms_per_act(ctx: dict, layer: str) -> float | None:
    """The device's idle ms per ``act()`` while the host's innermost program span is of
    ``layer``."""
    acts = ctx["work"].get("acts")
    by_layer = idle_by_layer(ctx["traced"])
    if not acts or by_layer is None:
        return None
    return by_layer[layer] / 1e3 / acts


def launches_by_span(traced: Traced) -> dict | None:
    """``{innermost program span's name or OUTSIDE: the host's LAUNCHES calls}`` that start
    in the window; None where the window holds no program span."""
    if not program_spans(traced):
        return None
    segments = _segments(traced)
    starts = [s[0] for s in segments]
    out: dict = {}
    for e in traced.events:
        if (e.on_device or not e.name.startswith(LAUNCHES)
                or not traced.lo_us <= e.start_us <= traced.hi_us):
            continue
        name = segments[max(bisect.bisect_right(starts, e.start_us) - 1, 0)][2]
        key = OUTSIDE if name is None else name
        out[key] = out.get(key, 0) + 1
    return out
