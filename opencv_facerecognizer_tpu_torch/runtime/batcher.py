"""Frame batcher: turns an asynchronous frame stream into fixed-size
batches. Port of the core of ``opencv_facerecognizer_tpu/runtime/
batcher.py``.

- ``put`` validates shape and dtype and drops malformed frames, so one
  camera glitch cannot poison a batch.
- ``get_batch`` blocks until ``batch_size`` frames are queued or the
  oldest queued frame is as old as the flush deadline, then returns a
  zero-padded ``[B, H, W]`` batch with its metadata and real count. The
  deadline is ``flush_timeout``; with ``target_latency_s`` it adapts to
  the target less an EWMA of the downstream service time
  (``report_service_time``), clamped to [``MIN_DEADLINE_S``,
  ``flush_timeout``].
- The queue is bounded: beyond ``max_pending`` the oldest frame is
  dropped (a live recognizer wants fresh frames, not a latency debt).
- ``recycle`` hands a batch's staging array back for reuse once the
  consumer is done with it, so steady-state batching allocates nothing.

Every drop is counted on the shared ``Metrics`` (``batcher_dropped_*``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np

from opencv_facerecognizer_tpu_torch.utils import metrics as mn


class Batch(NamedTuple):
    frames: np.ndarray  # [B, H, W] in the batcher's dtype, zero-padded
    metas: List[Any]
    count: int
    enqueue_ts: List[float]  # time.monotonic() at put, per real frame


class FrameBatcher:
    #: floor of the adaptive deadline: back-to-back frames still coalesce
    MIN_DEADLINE_S = 0.002
    #: EWMA weight of the newest reported service time
    SERVICE_TIME_ALPHA = 0.2

    def __init__(self, batch_size: int, frame_shape: Tuple[int, int],
                 flush_timeout: float = 0.05, max_pending: int = 256,
                 dtype=np.float32, metrics: Optional[mn.Metrics] = None,
                 buffer_pool_size: int = 8, target_latency_s: Optional[float] = None):
        self.batch_size = int(batch_size)
        self.target_latency_s = (None if target_latency_s is None
                                 else float(target_latency_s))
        self._service_time_ewma: Optional[float] = None
        self.frame_shape = tuple(frame_shape)
        self.flush_timeout = float(flush_timeout)
        self.max_pending = int(max_pending)
        self.dtype = np.dtype(dtype)
        self.metrics = metrics
        self._pool_cap = int(buffer_pool_size)
        self._buffer_pool: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._frames: deque = deque()
        self._delivered = 0
        self._closed = False

    def _count(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.incr(name, value)

    # ---- producer side ----

    def put(self, frame, meta: Any = None) -> bool:
        """Enqueue one frame; False when it was dropped (malformed or
        closed). An overflow drops the OLDEST queued frame instead."""
        self._count(mn.BATCHER_FRAMES_OFFERED)
        frame = np.asarray(frame)
        if frame.shape != self.frame_shape or not np.issubdtype(frame.dtype, np.number):
            self._count(mn.BATCHER_DROPPED_MALFORMED)
            return False
        if np.issubdtype(self.dtype, np.integer) and not np.issubdtype(
                frame.dtype, np.integer):
            # clip, never wrap, out-of-range floats into the integer range
            info = np.iinfo(self.dtype)
            frame = np.clip(frame, info.min, info.max)
        frame = frame.astype(self.dtype)
        with self._not_empty:
            if self._closed:
                self._count(mn.BATCHER_DROPPED_CLOSED)
                return False
            if len(self._frames) >= self.max_pending:
                self._frames.popleft()
                self._count(mn.BATCHER_DROPPED_OVERFLOW)
            self._frames.append((frame, meta, time.monotonic()))
            self._not_empty.notify()
        return True

    def close(self) -> None:
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()

    # ---- adaptive deadline ----

    def report_service_time(self, seconds: float) -> None:
        """One batch's downstream time (pop -> published) into the EWMA the
        adaptive deadline subtracts (a float store: atomic in CPython)."""
        if seconds < 0:
            return
        prev = self._service_time_ewma
        self._service_time_ewma = (seconds if prev is None
                                   else prev + self.SERVICE_TIME_ALPHA * (seconds - prev))

    def current_flush_deadline(self) -> float:
        """Seconds the oldest frame may wait before a partial batch flushes."""
        if self.target_latency_s is None:
            return self.flush_timeout
        est = self._service_time_ewma or 0.0
        deadline = min(self.flush_timeout,
                       max(self.MIN_DEADLINE_S, self.target_latency_s - est))
        if self.metrics is not None:
            self.metrics.set_gauge(mn.BATCHER_FLUSH_DEADLINE_MS, deadline * 1e3)
        return deadline

    def recycle(self, buf: np.ndarray) -> None:
        """Return a batch's staging array once the consumer is done with it
        (readback finished, no views kept). A wrong shape or a full pool
        just drops it."""
        if (not isinstance(buf, np.ndarray)
                or buf.shape != (self.batch_size, *self.frame_shape)
                or buf.dtype != self.dtype):
            return
        with self._lock:
            if len(self._buffer_pool) < self._pool_cap:
                self._buffer_pool.append(buf)

    # ---- consumer side ----

    def get_batch(self, block: bool = True) -> Optional[Batch]:
        """Next ``Batch``; None when closed and drained, on an idle tick,
        or when non-blocking and nothing is flushable."""
        with self._not_empty:
            while True:
                n = len(self._frames)
                if n >= self.batch_size:
                    break
                if n > 0:
                    deadline = self.current_flush_deadline()
                    age = time.monotonic() - self._frames[0][2]
                    if age >= deadline:
                        break
                    if not block:
                        return None
                    self._not_empty.wait(timeout=deadline - age)
                    continue
                if self._closed or not block:
                    return None
                self._not_empty.wait(timeout=self.flush_timeout)
                if not self._frames:
                    return None  # idle tick: give the caller a turn
            count = min(len(self._frames), self.batch_size)
            items = [self._frames.popleft() for _ in range(count)]
            self._delivered += 1
            buf = self._buffer_pool.pop() if self._buffer_pool else None
        full = count >= self.batch_size
        self._count(mn.BATCHER_BATCHES_SIZE if full else mn.BATCHER_BATCHES_DEADLINE)
        self._count(mn.BATCHER_FRAMES_BATCHED, count)
        if buf is None:
            frames = np.zeros((self.batch_size, *self.frame_shape), self.dtype)
        else:
            self._count(mn.BATCHER_BUFFER_REUSE)
            frames = buf
            frames[count:] = 0  # re-zero a reused buffer's padding lanes
        metas: List[Any] = [None] * self.batch_size
        enqueue_ts: List[float] = []
        for i, (frame, meta, ts) in enumerate(items):
            frames[i] = frame
            metas[i] = meta
            enqueue_ts.append(ts)
        return Batch(frames, metas, count, enqueue_ts)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._frames)

    @property
    def stats(self) -> dict:
        """Queue depth and the batcher's drop and flush counts."""
        c = self.metrics.counters() if self.metrics is not None else {}
        return {"pending": self.pending,
                "dropped_malformed": c.get(mn.BATCHER_DROPPED_MALFORMED, 0.0),
                "dropped_overflow": c.get(mn.BATCHER_DROPPED_OVERFLOW, 0.0),
                "batches_size": c.get(mn.BATCHER_BATCHES_SIZE, 0.0),
                "batches_deadline": c.get(mn.BATCHER_BATCHES_DEADLINE, 0.0)}

    @property
    def delivered_batches(self) -> int:
        """Batches handed out by ``get_batch`` (counted with the pop)."""
        with self._lock:
            return self._delivered
