"""Profiling hooks: ``torch.profiler`` traces around the solve and rollout hot paths.

Counterpart of ``blackbox_mpc_tpu/utils/profiling.py``: a context manager captures a trace of
the host and, where CUDA is, the device over any region and writes it as a Chrome trace
(``chrome://tracing``, Perfetto or TensorBoard read it); ``profile_policy_solve`` wraps a few
``act()`` steps.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, schedule

logger = logging.getLogger(__name__)

__all__ = ["trace", "profile_policy_solve"]


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
