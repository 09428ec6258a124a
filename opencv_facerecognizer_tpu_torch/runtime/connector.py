"""Middleware connectors: the pluggable transport boundary.

Port of the in-process part of ``opencv_facerecognizer_tpu/runtime/
connector.py``: the ``MiddlewareConnector`` interface, ``FakeConnector``
(in-process pub-sub, the test and smoke transport) and the frame wire
encoding. Messages are dicts; topics are strings. Handlers run on the
publisher's thread, so they must be cheap (the recognizer's handler only
enqueues into the batcher).
"""

from __future__ import annotations

import base64
import threading
from typing import Any, Callable, Dict, List

import numpy as np

Handler = Callable[[str, Dict[str, Any]], None]

def encode_frame(frame: np.ndarray) -> Dict[str, Any]:
    frame = np.ascontiguousarray(frame)
    return {
        "__frame__": base64.b64encode(frame.tobytes()).decode("ascii"),
        "shape": list(frame.shape),
        "dtype": str(frame.dtype),
    }


def decode_frame(obj: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(obj["__frame__"])
    return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()


class MiddlewareConnector:
    """publish/subscribe over topics; start/stop lifecycle."""

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        raise NotImplementedError

    def subscribe(self, topic: str, handler: Handler) -> None:
        raise NotImplementedError

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class FakeConnector(MiddlewareConnector):
    """In-process pub-sub; synchronous dispatch on the publisher's thread.

    ``sent`` records every published message for assertions; ``inject`` is
    an alias of ``publish`` that reads better in tests.
    """

    def __init__(self):
        self._handlers: Dict[str, List[Handler]] = {}
        self._lock = threading.Lock()
        self.sent: List[tuple] = []

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        with self._lock:
            self.sent.append((topic, message))
            handlers = list(self._handlers.get(topic, ()))
        for handler in handlers:
            handler(topic, message)

    inject = publish

    def subscribe(self, topic: str, handler: Handler) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def messages(self, topic: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [m for t, m in self.sent if t == topic]
