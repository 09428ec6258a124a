"""The benchmark's in-process connector and the run's record of each frame.

``BenchConnector`` is a ``MiddlewareConnector`` that delivers a frame on
the sender's thread, as an in-process transport does, and keeps no
message: each result's arrival goes into a preallocated array by the
frame's sequence number, and only the results of frames drawn into the
check's sample are kept. (The program's ``FakeConnector`` keeps every
message it sees, each frame's pixels included: gigabytes over a window.)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np

from opencv_facerecognizer_tpu_torch.runtime.connector import MiddlewareConnector
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC)


class FrameLog:
    """Per-frame times by sequence number (``time.monotonic()``, NaN until
    set), the pool index each frame showed, and the results kept for the
    check (those whose ``keep`` flag is set), each with its pool index. A
    frame's ``meta`` is its sequence number alone."""

    def __init__(self, capacity: int, keep: np.ndarray):
        self.capacity = int(capacity)
        self.due = np.full(capacity, np.nan)
        self.sent = np.full(capacity, np.nan)
        self.arrived = np.full(capacity, np.nan)
        self.pool = np.zeros(capacity, dtype=np.int32)
        self.keep = keep
        self.kept: List[dict] = []
        self.count = 0  # frames sent
        self.answered = 0
        self.statuses: Dict[str, int] = {}


class BenchConnector(MiddlewareConnector):
    """Frames go to the subscribed service on the caller's thread; results
    are stamped into the ``FrameLog`` on the service's publishing thread."""

    def __init__(self, log: FrameLog):
        self.log = log
        self._handlers: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def subscribe(self, topic: str, handler: Callable) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        if topic == RESULT_TOPIC:
            now = time.monotonic()
            seq = message["meta"]
            log = self.log
            log.arrived[seq] = now
            log.answered += 1
            if log.keep[seq]:
                log.kept.append((int(log.pool[seq]), message))
            return
        if topic == STATUS_TOPIC:
            key = str(message.get("status"))
            self.log.statuses[key] = self.log.statuses.get(key, 0) + 1
            return
        for handler in self._handlers.get(topic, ()):
            handler(topic, message)

    def send_frame(self, seq: int, pool_index: int, frame: np.ndarray) -> None:
        """Stamp and deliver frame ``seq`` (showing pool frame
        ``pool_index``) to the service."""
        log = self.log
        log.pool[seq] = pool_index
        log.sent[seq] = time.monotonic()
        log.count = max(log.count, seq + 1)
        self.publish(FRAME_TOPIC, {"frame": frame, "meta": seq})
