"""Admission control at the connector-receive boundary: port of
``opencv_facerecognizer_tpu/runtime/admission.py``.

``RecognizerService._on_frame`` consults an ``AdmissionController``
before it decodes a frame, and rejects explicitly, cheaply and before any
work is spent:

- **a token-bucket rate limit** per topic (``rate_limit_fps``, a burst of
  ``burst_seconds`` of rate): a producer above its rate gets a
  ``rejected`` status with reason ``rate_limit``;
- **a bounded intake** (``max_inflight_frames``): once the frames in the
  system (admitted less finished, read from the service's ledger) reach
  the bound, new frames are rejected with reason ``overload``; bulk frames
  already at ``1 - interactive_reserve`` of it, so a bulk flood cannot
  starve interactive frames out of the front door.

A frame's optional ``priority`` is ``"interactive"`` (the default: a user
waits on it) or ``"bulk"`` (enrolment or backfill traffic that tolerates
shedding); ``parse_priority`` maps the wire forms onto the numeric scale,
smaller = more important. Rejections are counted per reason
(``frames_rejected_<reason>``) before admission, so they stay outside the
admission ledger: a rejected frame never entered the system.

``clock`` (default ``time.monotonic``) is injectable, so that tests drive
the buckets under a fake clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Union

#: the numeric priority scale: smaller = more important; ints pass through
#: (clamped non-negative)
PRIORITY_INTERACTIVE = 0
PRIORITY_BULK = 1

_PRIORITY_NAMES = {
    "interactive": PRIORITY_INTERACTIVE,
    "bulk": PRIORITY_BULK,
    "enroll": PRIORITY_BULK,
}


def parse_priority(value) -> int:
    """The wire ``priority`` field as a number. Unknown or missing values
    are interactive: serving a misspelled frame eagerly beats rejecting
    it."""
    if value is None:
        return PRIORITY_INTERACTIVE
    if isinstance(value, str):
        return _PRIORITY_NAMES.get(value.lower(), PRIORITY_INTERACTIVE)
    try:
        return max(0, int(value))
    except (TypeError, ValueError):
        return PRIORITY_INTERACTIVE


class TokenBucket:
    """``rate`` tokens a second, at most ``burst``. Thread-safe;
    ``try_acquire`` never blocks (it runs for every offered frame)."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        now = self._clock()
        with self._lock:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


class AdmissionController:
    """Per-topic rate limits and a bounded intake, consulted per frame.

    ``admit(topic, priority)`` returns None to admit, or the rejection's
    reason: ``"rate_limit"``, ``"overload"`` or ``"staging"`` (the last
    when ``staging_free_fn`` reads no free staging buffer; the service
    wires the ingest ring's ``free_slots``). The caller counts and announces the
    rejection.

    ``rate_limit_fps`` is a scalar (every topic) or ``{topic: fps}``;
    0 or None turns a topic's limit off. ``max_inflight_frames`` bounds
    the admitted-but-unfinished frames read through ``inflight_fn`` (the
    service wires its ``frames_in_system``); 0 or None turns it off."""

    def __init__(self, max_inflight_frames: Optional[int] = None,
                 rate_limit_fps: Union[None, float, Dict[str, float]] = None,
                 burst_seconds: float = 1.0, interactive_reserve: float = 0.25,
                 inflight_fn: Optional[Callable[[], float]] = None,
                 staging_free_fn: Optional[Callable[[], int]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_inflight_frames = (None if not max_inflight_frames
                                    else int(max_inflight_frames))
        if rate_limit_fps is None or isinstance(rate_limit_fps, dict):
            self._rate_cfg: Optional[Dict[str, float]] = rate_limit_fps
            self._default_rate: Optional[float] = None
        else:
            self._rate_cfg = None
            self._default_rate = float(rate_limit_fps) or None
        self.burst_seconds = float(burst_seconds)
        self.interactive_reserve = min(0.9, max(0.0, float(interactive_reserve)))
        self.inflight_fn = inflight_fn
        self.staging_free_fn = staging_free_fn
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        # fixed after __init__: the bound-only configuration never takes
        # the bucket lock
        self._any_rate = bool(self._rate_cfg) or self._default_rate is not None

    def _bucket_for(self, topic: str) -> Optional[TokenBucket]:
        if not self._any_rate:
            return None
        with self._lock:
            bucket = self._buckets.get(topic)
            if bucket is None:
                rate = (self._rate_cfg.get(topic) if self._rate_cfg is not None
                        else self._default_rate)
                if not rate or rate <= 0:
                    return None
                bucket = TokenBucket(rate, burst=rate * self.burst_seconds, clock=self._clock)
                self._buckets[topic] = bucket
            return bucket

    def admit(self, topic: str, priority: int = PRIORITY_INTERACTIVE) -> Optional[str]:
        """None = admitted; otherwise the rejection's reason."""
        bucket = self._bucket_for(topic)
        if bucket is not None and not bucket.try_acquire():
            return "rate_limit"
        if self.max_inflight_frames and self.inflight_fn is not None:
            bound = self.max_inflight_frames
            if priority > PRIORITY_INTERACTIVE:
                bound = bound * (1.0 - self.interactive_reserve)
            if self.inflight_fn() >= bound:
                return "overload"
        if self.staging_free_fn is not None and self.staging_free_fn() <= 0:
            return "staging"
        return None
