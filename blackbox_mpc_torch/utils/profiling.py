"""Profiling hooks: ``torch.profiler`` traces around the solve and rollout hot paths.

Counterpart of ``blackbox_mpc_tpu/utils/profiling.py``: a context manager captures a trace of
the host and, where CUDA is, the device over any region and writes it as a Chrome trace
(``chrome://tracing``, Perfetto or TensorBoard read it); ``profile_policy_solve`` wraps a few
``act()`` steps.

:func:`span` names the program's own regions in such a trace. Each name is its layer, a dot
and the region (``policy.act``, ``solver.iteration``, ``evaluator.evaluate``, ``models.step``,
``kernels.K2``, ``learning.step``, ...). A span is a host event of the profiler's own trace, on
the clock of the device's operations, so each gap of the device can be put down to the span
open on the host at the time. Spans nest on the calling thread: every span of one ``act()``
lies inside its ``policy.act``. With no profiler running a span is one shared object that does
nothing.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function, schedule

logger = logging.getLogger(__name__)

__all__ = ["trace", "profile_policy_solve", "span"]


_NO_SPAN = contextlib.nullcontext()  # the span outside a profiler's session


def span(name: str):
    """``with span("solver.iteration"):`` records the region as a host event while a
    ``torch.profiler`` session records (``record_function``), and is one shared object that
    does nothing otherwise: reading the profiler's flag is all it costs, with no allocation
    and no call into the profiler. It does nothing either while ``torch.export`` or
    ``torch.compile`` traces, so their programs hold no profiler node."""
    if not autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return _NO_SPAN
    return record_function(name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """``with trace("/tmp/trace") as prof:`` profiles the enclosed region (CPU, and CUDA where
    it is available) and writes ``<log_dir>/trace_<pid>_<ns>.json`` when it ends. ``prof`` is
    the ``torch.profiler.profile`` object, for ``prof.events()`` or ``key_averages()``.

    The profiler first runs one warm-up step, which it discards: the device tracer has then
    started before the region, which loses none of its first device operations (without it a
    traced H100 ``act()`` once lost its first 9 ms, ``PERF.md``)."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        yield prof
        prof.step()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("wrote profiler trace to %s", path)


def profile_policy_solve(policy, observations, log_dir: str, steps: int = 3):
    """Traces ``steps`` ``act()`` calls (the first may include first-use costs); returns
    ``log_dir``."""
    import numpy as np

    with trace(log_dir):
        for t in range(steps):
            policy.act(np.asarray(observations), t)
    return log_dir
