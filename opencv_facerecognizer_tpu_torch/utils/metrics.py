"""Serving counters and latency windows.

The part of ``opencv_facerecognizer_tpu/utils/metrics.py`` the port's
service, connectors, tracker, IVF quantizer, durable state, overload
control and signals layer use: thread-safe counters,
last-write gauges, latency observations with percentiles, a summary, and
an optional JSONL sink (``log``). The names and the ledger tables (the
one definition of how an admitted frame ends) live in
``utils.metric_names`` and are re-exported here; they are the
reference's, so a reader can compare the two services' counters one to
one. A latency window is a rolling log-bucket
histogram (``utils.histogram``), as in the reference, so both packages
report the same percentiles for the same observations.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from typing import IO, Any, Dict, Optional, Tuple

from opencv_facerecognizer_tpu_torch.utils.histogram import RollingHistogram

# the names and the ledger tables live in ``utils.metric_names``; re-exported
# here so ``from ...utils import metrics as mn`` reads them as ``mn.<NAME>``
from opencv_facerecognizer_tpu_torch.utils.metric_names import *  # noqa: E402,F401,F403


class Metrics:
    """Thread-safe counters, gauges and latency windows; ``sink`` (an open
    text stream) receives ``log`` records as JSON lines.

    Each latency window is a ``RollingHistogram`` of ``window_s`` seconds
    in ``window_slices`` slices (the reference's defaults: 600 s in 20),
    so a percentile is exact to one log bucket and covers a wall-clock
    horizon, whatever the traffic."""

    def __init__(self, sink: Optional[IO[str]] = None,
                 window_s: float = 600.0, window_slices: int = 20):
        self._lock = threading.Lock()
        self._sink = sink
        self._sink_lock = threading.Lock()  # sink writes only, never counters
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._window_s = float(window_s)
        self._window_slices = int(window_slices)
        self._latencies: Dict[str, RollingHistogram] = defaultdict(
            lambda: RollingHistogram(self._window_s, self._window_slices))

    @property
    def window_s(self) -> float:
        """The rolling horizon of every latency window (seconds)."""
        return self._window_s

    @property
    def window_slice_s(self) -> float:
        """Seconds per slice: a shorter horizon still reads one slice."""
        return self._window_s / self._window_slices

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latencies[name].observe(seconds)

    def set_gauge(self, name: str, value: float) -> None:
        """Last-write-wins instantaneous value, reported as-is in
        ``summary``."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = float("nan")) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def counters_with_prefix(self, prefix: str) -> Dict[str, float]:
        """The counters under one namespace, read atomically."""
        with self._lock:
            return {k: v for k, v in self._counters.items() if k.startswith(prefix)}

    def sum_counters(self, positive, negative=()) -> float:
        """``sum(positive) - sum(negative)`` over counter names, under one
        lock acquisition."""
        with self._lock:
            c = self._counters
            return (sum(c.get(n, 0.0) for n in positive)
                    - sum(c.get(n, 0.0) for n in negative))

    def percentile(self, name: str, q: float,
                   horizon_s: Optional[float] = None) -> float:
        """The window's ``q``-percentile in seconds over the trailing
        ``horizon_s`` (default: the whole window); NaN when the window is
        unknown or empty."""
        with self._lock:
            window = self._latencies.get(name)
            if window is None:
                return float("nan")
            return window.quantile(q, horizon_s=horizon_s)

    def fraction_above(self, name: str, threshold_s: float,
                       horizon_s: Optional[float] = None) -> float:
        """Fraction of the window's observations above ``threshold_s``
        over the trailing horizon; 0.0 for an unknown or empty window."""
        with self._lock:
            window = self._latencies.get(name)
            if window is None:
                return 0.0
            return window.fraction_above(threshold_s, horizon_s=horizon_s)

    def window_count(self, name: str, horizon_s: Optional[float] = None) -> int:
        """Observations inside the trailing horizon."""
        with self._lock:
            window = self._latencies.get(name)
            return 0 if window is None else window.count(horizon_s=horizon_s)

    def reset_window(self, name: Optional[str] = None) -> None:
        """Clear one latency window (or all), counters and gauges kept; a
        cleared window reports ``None`` percentiles until it sees new
        observations."""
        with self._lock:
            windows = (self._latencies.values() if name is None
                       else [w for w in (self._latencies.get(name),) if w is not None])
            for window in windows:
                window.clear()

    def log(self, event: str, **fields) -> None:
        """One ``{"ts", "event", **fields}`` JSON line to the sink, if any."""
        if self._sink is None:
            return
        line = json.dumps({"ts": time.time(), "event": event, **fields})
        with self._sink_lock:
            self._sink.write(line + "\n")
            self._sink.flush()

    def summary(self) -> Dict[str, Optional[float]]:
        """Counters, gauges, and p50/p95/p99 (ms, bucket precision) of
        every latency window; ``None`` for a known but empty window."""
        with self._lock:
            out: Dict[str, Optional[float]] = dict(self._counters)
            out.update(self._gauges)
            for name, window in self._latencies.items():
                merged = window.merged()
                for q in (50, 95, 99):
                    out[f"{name}_p{q}_ms"] = (merged.quantile(q) * 1e3
                                              if merged.count else None)
        return out

    def export_state(self) -> Tuple[Dict[str, float], Dict[str, float],
                                    Dict[str, Dict[str, Any]]]:
        """One atomic ``(counters, gauges, histograms)`` snapshot; each
        histogram is the whole window's merge in
        ``LogBucketHistogram.snapshot`` shape."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {name: window.merged().snapshot()
                     for name, window in self._latencies.items()}
        return counters, gauges, hists
