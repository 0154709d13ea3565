"""Structured metrics: TensorBoard-compatible scalars, an in-memory history and latency
percentiles.

A copy of ``blackbox_mpc_tpu/utils/metrics.py`` (numpy only): the port imports nothing of the
JAX package. ``tensorboardX`` is imported only when a ``log_dir`` asks for it, and its absence
leaves the scalars in the JSONL file.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["MetricsWriter", "LatencyTimer"]


class MetricsWriter:
    """Scalar metrics sink: in-memory history, optional TensorBoard + JSONL files."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        tensorboard: bool = True,
        jsonl_path: Optional[str] = None,
    ):
        """``jsonl_path``: append scalars to this exact file instead of
        ``log_dir/metrics.jsonl`` (benchmark scripts keep one artifact per run)."""
        self.history: Dict[str, List[tuple]] = collections.defaultdict(list)
        self._tb = None
        self._jsonl = None
        if jsonl_path is not None:
            self._jsonl = open(jsonl_path, "a")
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            if self._jsonl is None:
                self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:  # noqa: BLE001
                    logger.warning("tensorboardX unavailable; scalars go to JSONL only")

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        self.history[tag].append((step, value))
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")

    def latest(self, tag: str) -> Optional[float]:
        h = self.history.get(tag)
        return h[-1][1] if h else None

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        self.flush()
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class LatencyTimer:
    """Collects wall-clock samples; reports mean/p50/p95/p99."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "p99_s": float(np.percentile(arr, 99)),
            "count": len(arr),
        }
