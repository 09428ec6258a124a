"""Serving counters and latency windows.

The part of ``opencv_facerecognizer_tpu/utils/metrics.py`` the port's
service and IVF quantizer use: thread-safe counters, last-write gauges,
latency observations with percentiles, and a summary. Names are the
reference's (its ``utils/metric_names.py``), so a reader can compare the
two services' counters one to one. A latency window keeps the last ``window`` samples.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Deque, Dict, Optional

import numpy as np

# counters
FRAMES_ADMITTED = "frames_admitted"
FRAMES_MALFORMED = "frames_malformed"
FRAMES_PROCESSED = "frames_processed"
FRAMES_COMPLETED = "frames_completed"
FRAMES_DROPPED_CRASHED = "frames_dropped_crashed"
FACES_FOUND = "faces_found"
BATCHES_DISPATCHED = "batches_dispatched"
BATCHES_BUCKETED = "batches_bucketed"
READBACK_ERRORS = "readback_errors"
BATCHER_FRAMES_OFFERED = "batcher_frames_offered"
BATCHER_FRAMES_BATCHED = "batcher_frames_batched"
BATCHER_DROPPED_MALFORMED = "batcher_dropped_malformed"
BATCHER_DROPPED_CLOSED = "batcher_dropped_closed"
BATCHER_DROPPED_OVERFLOW = "batcher_dropped_overflow"
BATCHER_BATCHES_SIZE = "batcher_batches_size"
BATCHER_BATCHES_DEADLINE = "batcher_batches_deadline"
BATCHER_BUFFER_REUSE = "batcher_buffer_reuse"
# latency windows (seconds)
WARMUP = "warmup"
QUEUE_WAIT = "queue_wait"
DISPATCH = "dispatch"
READY_WAIT = "ready_wait"
PUBLISH = "publish"
BATCH_LATENCY = "batch_latency"
E2E_LATENCY = "e2e_latency"
# IVF coarse quantizer (parallel.quantizer); IVF_SPILL_ROWS is a gauge. The
# sidecar names are the reference's, for the state store that writes and
# loads sidecars (not ported yet).
IVF_BUILDS = "ivf_builds"
IVF_BUILD_FAILURES = "ivf_build_failures"
IVF_RETRAINS_SKIPPED_INFLIGHT = "ivf_retrains_skipped_inflight"
IVF_INVALIDATIONS = "ivf_invalidations"
IVF_INCREMENTAL_ROWS = "ivf_incremental_rows"
IVF_SPILL_ROWS = "ivf_spill_rows"
IVF_SIDECAR_WRITES = "ivf_sidecar_writes"
IVF_SIDECAR_LOADS = "ivf_sidecar_loads"
IVF_SIDECAR_STALE = "ivf_sidecar_stale"
IVF_SIDECAR_ERRORS = "ivf_sidecar_errors"

#: every way an admitted frame leaves other than published: the ledger
#: ``frames_admitted == frames_completed + sum(these)`` holds once idle
LEDGER_DROP_COUNTERS = (FRAMES_MALFORMED, FRAMES_DROPPED_CRASHED,
                        BATCHER_DROPPED_MALFORMED, BATCHER_DROPPED_CLOSED,
                        BATCHER_DROPPED_OVERFLOW, READBACK_ERRORS)


class Metrics:
    """Thread-safe counters, gauges and latency windows."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._latencies: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latencies[name].append(float(seconds))

    def set_gauge(self, name: str, value: float) -> None:
        """Last-write-wins instantaneous value, reported as-is in
        ``summary``."""
        with self._lock:
            self._gauges[name] = float(value)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def summary(self) -> Dict[str, Optional[float]]:
        """Counters, gauges, and p50/p95/p99 (ms) of every latency window."""
        with self._lock:
            out: Dict[str, Optional[float]] = dict(self._counters)
            out.update(self._gauges)
            windows = {k: list(v) for k, v in self._latencies.items()}
        for name, samples in windows.items():
            for q in (50, 95, 99):
                out[f"{name}_p{q}_ms"] = (float(np.percentile(samples, q)) * 1e3
                                          if samples else None)
        return out
