"""Serving counters and latency windows.

The part of ``opencv_facerecognizer_tpu/utils/metrics.py`` the port's
service uses: thread-safe counters, latency observations with
percentiles, and a summary. Names are the reference's (its
``utils/metric_names.py``), so a reader can compare the two services'
counters one to one. A latency window keeps the last ``window`` samples.
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

#: every way an admitted frame leaves other than published: the ledger
#: ``frames_admitted == frames_completed + sum(these)`` holds once idle
LEDGER_DROP_COUNTERS = (FRAMES_MALFORMED, FRAMES_DROPPED_CRASHED,
                        BATCHER_DROPPED_MALFORMED, BATCHER_DROPPED_CLOSED,
                        BATCHER_DROPPED_OVERFLOW, READBACK_ERRORS)


class Metrics:
    """Thread-safe counters + latency windows."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._latencies: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latencies[name].append(float(seconds))

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def summary(self) -> Dict[str, Optional[float]]:
        """Counters plus p50/p95/p99 (ms) of every latency window."""
        with self._lock:
            out: Dict[str, Optional[float]] = dict(self._counters)
            windows = {k: list(v) for k, v in self._latencies.items()}
        for name, samples in windows.items():
            for q in (50, 95, 99):
                out[f"{name}_p{q}_ms"] = (float(np.percentile(samples, q)) * 1e3
                                          if samples else None)
        return out
