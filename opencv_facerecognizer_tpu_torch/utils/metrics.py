"""Serving counters and latency windows.

The part of ``opencv_facerecognizer_tpu/utils/metrics.py`` the port's
service, connectors, tracker and IVF quantizer use: thread-safe counters,
last-write gauges, latency observations with percentiles, a summary, and
an optional JSONL sink (``log``). The names are the reference's (its
``utils/metric_names.py``), so a reader can compare the two services'
counters one to one; the ledger tables at the end are the one definition
of how an admitted frame ends. A latency window keeps the last
``window`` samples.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import IO, Deque, Dict, Optional

import numpy as np

# counters: the admission ledger
FRAMES_ADMITTED = "frames_admitted"
FRAMES_MALFORMED = "frames_malformed"
FRAMES_PROCESSED = "frames_processed"
FRAMES_COMPLETED = "frames_completed"
FRAMES_COMPLETED_CACHED = "frames_completed_cached"
FRAMES_DROPPED = "frames_dropped"
FRAMES_DROPPED_CRASHED = "frames_dropped_crashed"
FRAMES_FAILED = "frames_failed"
FRAMES_DEAD_LETTERED = "frames_dead_lettered"
FACES_FOUND = "faces_found"
SUBJECTS_ENROLLED = "subjects_enrolled"
GALLERY_GROWN = "gallery_grown"
# counters: dispatch and readback
BATCHES_DISPATCHED = "batches_dispatched"
BATCHES_BUCKETED = "batches_bucketed"
BATCHES_FAILED = "batches_failed"
BATCHES_DEAD_LETTERED = "batches_dead_lettered"
LOOP_CRASHES = "loop_crashes"
DISPATCH_FAILURES = "dispatch_failures"
DISPATCH_RETRIES = "dispatch_retries"
READBACK_ERRORS = "readback_errors"
DEGRADED_TRANSITIONS = "degraded_transitions"
DEGRADED_RECOVERIES = "degraded_recoveries"
# counters and gauges: the identity tracker (runtime.tracker)
TRACK_LOOKUPS = "track_lookups"
TRACK_CACHE_HITS = "track_cache_hits"
TRACK_CACHE_HIT_RATE = "track_cache_hit_rate"
TRACKS_LIVE = "tracks_live"
TRACKS_CREATED = "tracks_created"
TRACKS_CONFIRMED = "tracks_confirmed"
TRACK_REVERIFIES = "track_reverifies"
TRACK_FLUSHES_PREFIX = "track_flushes_"
TRACK_BATCH_EXITS = "track_batch_exits"
TRACK_ERRORS = "track_errors"
# counters: the wire transports (runtime.connector)
CONNECTOR_MALFORMED_LINES = "connector_malformed_lines"
CONNECTOR_PEER_DISCONNECTS = "connector_peer_disconnects"
CONNECTOR_RECONNECTS = "connector_reconnects"
CONNECTOR_RECONNECT_FAILURES = "connector_reconnect_failures"
CONNECTOR_STALLED_CLIENTS_DROPPED = "connector_stalled_clients_dropped"
# counters and gauges: the frame batcher
BATCHER_FRAMES_OFFERED = "batcher_frames_offered"
BATCHER_FRAMES_BATCHED = "batcher_frames_batched"
BATCHER_DROPPED_MALFORMED = "batcher_dropped_malformed"
BATCHER_DROPPED_CLOSED = "batcher_dropped_closed"
BATCHER_DROPPED_OVERFLOW = "batcher_dropped_overflow"
BATCHER_BATCHES_SIZE = "batcher_batches_size"
BATCHER_BATCHES_DEADLINE = "batcher_batches_deadline"
BATCHER_BUFFER_REUSE = "batcher_buffer_reuse"
BATCHER_FLUSH_DEADLINE_MS = "batcher_flush_deadline_ms"
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

#: the admission ledger: once the service is idle, ``frames_admitted ==
#: sum(LEDGER_COMPLETION_COUNTERS) + sum(LEDGER_DROP_COUNTERS)``, each
#: admitted frame in exactly one of them. The reference's tables less the
#: subsystems the port lacks yet (the cascade's ``frames_completed_empty``;
#: the JPEG pool's, the stale shed's and brownout's drops)
LEDGER_COMPLETION_COUNTERS = (FRAMES_COMPLETED, FRAMES_COMPLETED_CACHED)
LEDGER_DROP_COUNTERS = (FRAMES_MALFORMED, BATCHER_DROPPED_MALFORMED,
                        BATCHER_DROPPED_OVERFLOW, BATCHER_DROPPED_CLOSED,
                        FRAMES_DEAD_LETTERED, FRAMES_FAILED, FRAMES_DROPPED_CRASHED)


class Metrics:
    """Thread-safe counters, gauges and latency windows; ``sink`` (an open
    text stream) receives ``log`` records as JSON lines."""

    def __init__(self, window: int = 4096, sink: Optional[IO[str]] = None):
        self._lock = threading.Lock()
        self._sink = sink
        self._sink_lock = threading.Lock()  # sink writes only, never counters
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

    def log(self, event: str, **fields) -> None:
        """One ``{"ts", "event", **fields}`` JSON line to the sink, if any."""
        if self._sink is None:
            return
        line = json.dumps({"ts": time.time(), "event": event, **fields})
        with self._sink_lock:
            self._sink.write(line + "\n")
            self._sink.flush()

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
