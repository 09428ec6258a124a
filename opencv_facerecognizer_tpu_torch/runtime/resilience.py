"""Failure handling of the serving loop: port of ``is_transient_error``
and ``ResiliencePolicy`` from
``opencv_facerecognizer_tpu/runtime/resilience.py``.

- ``is_transient_error`` classifies an exception as outage-shaped (retry
  it) or permanent (a poisoned batch: retrying burns the budget for
  nothing), by the reference's markers.
- ``ResiliencePolicy`` holds the knobs ``RecognizerService`` runs on: a
  dispatch failure retries with exponential backoff, a readback that
  outlives its deadline is dead-lettered while the loop keeps serving,
  and ``degraded_after`` consecutive failed dispatches publish degraded
  mode on the status topic.

``BrownoutPolicy``, ``DurabilityMonitor``, ``ServiceSupervisor`` and the
CPU fallback wait for the admission, state-store and supervisor slices
(ROADMAP A.8).
"""

from __future__ import annotations

from dataclasses import dataclass

#: lowercase substrings that mark an exception as an outage (the
#: reference's list, unchanged)
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline exceeded",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "resource exhausted",
    "internal: failed to",
)


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a backend or transport outage."""
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(marker in text for marker in _TRANSIENT_MARKERS)


@dataclass
class ResiliencePolicy:
    """Steady-state failure-handling knobs for ``RecognizerService``."""

    #: retries per batch after its first dispatch failure; then the batch
    #: is abandoned (``batches_failed``, its frames ``frames_failed``)
    dispatch_retries: int = 3
    #: backoff before retry n (0-based): base * multiplier^n, capped
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_multiplier: float = 2.0
    #: a batch whose readback is not ready this long after dispatch is
    #: dead-lettered (``batches_dead_lettered``) and the loop moves on
    readback_deadline_s: float = 30.0
    #: consecutive failed dispatch attempts (across batches) that publish
    #: degraded mode
    degraded_after: int = 3

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (0-based)."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_multiplier ** attempt)
