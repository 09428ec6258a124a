"""Streaming latency histograms: port of
``opencv_facerecognizer_tpu/utils/histogram.py`` (pure Python, imports
only ``math`` and ``time``).

- ``LogBucketHistogram``: counts over one fixed log-spaced boundary
  schema shared by the whole process (10 us .. 120 s, growth 2^0.25, four
  buckets per octave), so histograms merge by adding counts. ``observe``
  is O(1); ``quantile`` and ``fraction_above`` walk the ~100 buckets and
  are exact to one bucket width.
- ``RollingHistogram``: a ring of ``slices`` time-sliced histograms over
  ``window_s`` seconds. An observation lands in the current slice; a read
  merges the slices inside the requested horizon. Expiry is lazy: a slice
  whose epoch rotated out is skipped on read and recycled on write.

Memory per window is ``slices x len(BUCKET_BOUNDS)`` integers whatever
the traffic. ``utils.metrics.Metrics`` keeps one ``RollingHistogram`` per
latency window.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Tuple

#: Log-bucket schema shared by every histogram in the process (merging
#: requires identical boundaries).  Spans 10 us .. 120 s with a 2**0.25
#: growth factor (~19% relative bucket width — four buckets per octave),
#: which covers everything from a sub-ms dispatch to a wedged two-minute
#: readback.  Bucket 0 is the underflow bucket (<= BUCKET_LO); the last
#: bucket is the overflow bucket (> BUCKET_HI).
BUCKET_LO = 1e-5
BUCKET_HI = 120.0
BUCKET_GROWTH = 2.0 ** 0.25

_LOG_GROWTH = math.log(BUCKET_GROWTH)
_N_LOG_BUCKETS = int(math.ceil(math.log(BUCKET_HI / BUCKET_LO) / _LOG_GROWTH))

#: upper boundary of every bucket, in seconds, ascending; the overflow
#: bucket's boundary is +inf.  ``len(BUCKET_BOUNDS) == bucket count``.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    [BUCKET_LO]
    + [BUCKET_LO * BUCKET_GROWTH ** (i + 1) for i in range(_N_LOG_BUCKETS)]
    + [math.inf]
)


def bucket_index(value: float) -> int:
    """Index of the bucket whose range contains ``value`` (seconds).
    Total: ``value <= BUCKET_BOUNDS[bucket_index(value)]`` always — NaN
    and negatives land in the underflow bucket rather than raising (a
    clock hiccup must not crash an observe on the serving path)."""
    if not value > BUCKET_LO:  # catches <=, NaN
        return 0
    # Overflow is "past the last FINITE boundary": the log schema's top
    # bucket may overshoot BUCKET_HI (ceil rounding), and the containment
    # invariant is stated against BUCKET_BOUNDS, not the nominal HI.
    if value > BUCKET_BOUNDS[-2]:
        return len(BUCKET_BOUNDS) - 1
    idx = 1 + int(math.log(value / BUCKET_LO) / _LOG_GROWTH)
    # float-edge guard: a value sitting exactly on a boundary can round
    # either side of the log; nudge into the bucket that contains it.
    if idx >= len(BUCKET_BOUNDS) - 1:
        idx = len(BUCKET_BOUNDS) - 2
    while idx > 0 and value <= BUCKET_BOUNDS[idx - 1]:
        idx -= 1
    while value > BUCKET_BOUNDS[idx]:
        idx += 1
    return idx


class LogBucketHistogram:
    """Counts over the shared ``BUCKET_BOUNDS`` schema, plus exact count
    and sum (the two moments Prometheus histograms carry).  Mergeable:
    ``merge`` adds counts bucket-wise, which the rolling ring builds on."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * len(BUCKET_BOUNDS)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.counts[bucket_index(value)] += 1
        self.count += 1
        self.sum += value

    def clear(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.sum = 0.0

    def merge(self, other: "LogBucketHistogram") -> "LogBucketHistogram":
        counts = self.counts
        for i, c in enumerate(other.counts):
            if c:
                counts[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> float:
        """The ``q``-quantile (q in [0, 100]) in seconds, NaN when empty.
        Nearest-rank over the bucket counts; the returned value is the
        geometric midpoint of the bucket holding that rank (the overflow
        bucket reports its lower edge — its upper edge is infinite), so
        it always lies within one bucket width of the exact sample
        quantile."""
        if self.count == 0:
            return float("nan")
        rank = min(self.count - 1, int(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                return self._bucket_value(i)
        return self._bucket_value(len(self.counts) - 1)  # pragma: no cover

    @staticmethod
    def _bucket_value(idx: int) -> float:
        hi = BUCKET_BOUNDS[idx]
        if idx == 0:
            return hi / 2.0
        lo = BUCKET_BOUNDS[idx - 1]
        if math.isinf(hi):
            return lo
        return math.sqrt(lo * hi)

    def fraction_above(self, threshold: float) -> float:
        """Fraction of observations strictly above ``threshold`` seconds,
        to bucket precision (observations inside the threshold's own
        bucket count as NOT above — the conservative reading for an SLO
        breach signal: a breach is claimed only once it is provable from
        the bucket counts).  0.0 when empty."""
        if self.count == 0:
            return 0.0
        idx = bucket_index(threshold)
        above = sum(self.counts[idx + 1:])
        return above / self.count

    def snapshot(self) -> Dict[str, object]:
        """JSON-able export: boundaries (seconds), per-bucket counts,
        total count and sum (a Prometheus histogram family's shape)."""
        return {"bounds": list(BUCKET_BOUNDS[:-1]),  # +Inf implied
                "counts": list(self.counts),
                "count": self.count,
                "sum": self.sum}


class RollingHistogram:
    """``slices`` time-sliced ``LogBucketHistogram``s covering a rolling
    ``window_s``-second horizon (class docstring above).  Not itself
    thread-safe: ``Metrics`` serializes access under its own lock."""

    def __init__(self, window_s: float = 120.0, slices: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if window_s <= 0 or slices <= 0:
            raise ValueError("window_s and slices must be positive")
        self.window_s = float(window_s)
        self.slices = int(slices)
        self.slice_s = self.window_s / self.slices
        self._clock = clock
        self._hists = [LogBucketHistogram() for _ in range(self.slices)]
        #: epoch (slice number since clock 0) held by each ring position;
        #: -1 = never written.  A position whose epoch is older than
        #: ``current - slices + 1`` is expired: skipped on read, recycled
        #: on write.
        self._epochs = [-1] * self.slices

    def _epoch(self, now: Optional[float]) -> int:
        return int((self._clock() if now is None else now) / self.slice_s)

    def observe(self, value: float, now: Optional[float] = None) -> None:
        epoch = self._epoch(now)
        pos = epoch % self.slices
        if self._epochs[pos] != epoch:
            self._hists[pos].clear()
            self._epochs[pos] = epoch
        self._hists[pos].observe(value)

    def merged(self, horizon_s: Optional[float] = None,
               now: Optional[float] = None) -> LogBucketHistogram:
        """One histogram over the slices still inside ``horizon_s``
        (default: the full window).  The current (partial) slice always
        counts; a horizon of k full slices therefore reads up to k+1
        slice epochs — the documented "within one slice" horizon
        granularity."""
        epoch = self._epoch(now)
        horizon = self.window_s if horizon_s is None else float(horizon_s)
        depth = min(self.slices, 1 + int(math.ceil(horizon / self.slice_s)))
        oldest = epoch - depth + 1
        out = LogBucketHistogram()
        for pos in range(self.slices):
            if oldest <= self._epochs[pos] <= epoch:
                out.merge(self._hists[pos])
        return out

    # convenience pass-throughs (each is one merge + one walk)

    def quantile(self, q: float, horizon_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        return self.merged(horizon_s, now).quantile(q)

    def fraction_above(self, threshold: float,
                       horizon_s: Optional[float] = None,
                       now: Optional[float] = None) -> float:
        return self.merged(horizon_s, now).fraction_above(threshold)

    def count(self, horizon_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        return self.merged(horizon_s, now).count

    def clear(self) -> None:
        for hist in self._hists:
            hist.clear()
        for i in range(self.slices):
            self._epochs[i] = -1

    def memory_cells(self) -> int:
        """Total bucket cells held — a constant for a given construction,
        whatever was observed (the flat-memory soak assertion)."""
        return sum(len(h.counts) for h in self._hists)
