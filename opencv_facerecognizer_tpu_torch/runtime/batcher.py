"""Frame batcher: turns an asynchronous frame stream into fixed-size
batches. Port of ``opencv_facerecognizer_tpu/runtime/batcher.py``.

- ``put`` validates shape and dtype and drops malformed frames, so one
  camera glitch cannot poison a batch. A ``fault_injector``
  (``runtime.faults``) is crossed first (``on_put``), before the check
  and before any copy into a staging buffer.
- ``get_batch`` blocks until ``batch_size`` frames are queued or the
  oldest queued frame is as old as the flush deadline, then returns a
  zero-padded ``[B, H, W]`` batch with its metadata and real count. The
  deadline is ``flush_timeout``; with ``target_latency_s`` it adapts to
  the target less an EWMA of the downstream service time
  (``report_service_time``), clamped to [``MIN_DEADLINE_S``,
  ``flush_timeout``].
- **The queue is bounded, with priority-aware shedding**: beyond
  ``max_pending`` a victim is evicted in order of preference: a stale
  frame (queued longer than ``stale_after_s``) first, then the oldest
  frame of the least important class (bulk before interactive). An
  incoming frame less important than everything queued is itself the
  victim. Without priorities or a stale bound this is drop-oldest.
- **Deadline-aware dispatch**: with ``stale_after_s``, ``get_batch`` sheds
  the frames already past it before it forms a batch, so a frame that has
  blown its budget never takes a dispatch slot (``batcher_dropped_stale``).
- ``recycle`` hands a batch's staging array back for reuse once the
  consumer is done with it, so steady-state batching allocates nothing.
  With a ``staging_ring`` (``runtime.ingest.StagingRing``) the ring's
  pre-allocated per-rung buffers replace the pool: ``recycle`` and
  ``forfeit`` go to the ring, and an exhausted ring keeps the frames
  queued (the consumer waits for a released buffer) and never allocates.

Every drop is counted on the shared ``Metrics`` (``batcher_dropped_*``),
handed to ``drop_log`` (the service's dead-letter journal) and, with a
``tracer``, settled by the frame's terminal span; both outside the queue
lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

#: a staging-ring acquire already missed in this pop: later re-checks of
#: the same exhaustion episode are quiet (``StagingRing.acquire``)
_EXHAUSTED = object()


class Batch(NamedTuple):
    """One batch and its provenance: ``enqueue_ts`` are the
    ``time.monotonic()`` stamps of ``put`` for the ``count`` real frames,
    ``trace_ids`` their frame traces (0 = untraced) and ``priorities``
    their admission classes."""

    frames: np.ndarray  # [rung or B, H, W] in the batcher's dtype, zero-padded
    metas: List[Any]
    count: int
    enqueue_ts: List[float]
    trace_ids: List[int]
    priorities: List[int]


class FrameBatcher:
    #: floor of the adaptive deadline: back-to-back frames still coalesce
    MIN_DEADLINE_S = 0.002
    #: EWMA weight of the newest reported service time
    SERVICE_TIME_ALPHA = 0.2

    def __init__(self, batch_size: int, frame_shape: Tuple[int, int],
                 flush_timeout: float = 0.05, max_pending: int = 256,
                 dtype=np.float32, metrics: Optional[mn.Metrics] = None,
                 buffer_pool_size: int = 8, target_latency_s: Optional[float] = None,
                 stale_after_s: Optional[float] = None, drop_log=None, tracer=None,
                 trace_topic: Optional[str] = None, staging_ring=None,
                 fault_injector=None):
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
        self._ring = staging_ring
        if staging_ring is not None:
            if (tuple(staging_ring.frame_shape) != self.frame_shape
                    or np.dtype(staging_ring.dtype) != self.dtype):
                raise ValueError(f"staging_ring shape/dtype ({staging_ring.frame_shape}, "
                                 f"{staging_ring.dtype}) does not match the batcher's "
                                 f"({self.frame_shape}, {self.dtype})")
            if max(staging_ring.rungs) < self.batch_size:
                raise ValueError(f"staging_ring's largest rung {max(staging_ring.rungs)} "
                                 f"cannot hold a full batch of {self.batch_size}")
        #: freshness bound (s): older queued frames are shed, reason ``stale``
        self.stale_after_s = None if stale_after_s is None else float(stale_after_s)
        #: ``drop_log(reason, entries)`` for overflow and stale sheds
        self._drop_log = drop_log
        self._tracer = tracer
        self._trace_topic = trace_topic
        #: ``runtime.faults.FaultInjector`` at the put boundary (never in
        #: production)
        self._faults = fault_injector
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        # (frame, meta, enqueue_ts, priority, trace_id), oldest first
        self._frames: deque = deque()
        self._delivered = 0
        self._closed = False
        if staging_ring is not None:
            # a consumer parked on an exhausted ring wakes when a buffer
            # returns (the ring calls this outside its own lock)
            staging_ring.add_notify(self._wake_consumer)

    def _count(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
            self.metrics.incr(name, value)

    # ---- producer side ----

    def put(self, frame, meta: Any = None, priority: int = 0, trace_id: int = 0) -> bool:
        """Enqueue one frame (smaller ``priority`` = more important);
        False when it was dropped (malformed, closed, or the overflow's
        victim itself)."""
        self._count(mn.BATCHER_FRAMES_OFFERED)
        if self._faults is not None:
            frame = self._faults.on_put(frame)
        frame = np.asarray(frame)
        if frame.shape != self.frame_shape or not np.issubdtype(frame.dtype, np.number):
            self._count(mn.BATCHER_DROPPED_MALFORMED)
            self._emit_settle(trace_id, mn.BATCHER_DROPPED_MALFORMED, "batcher.malformed")
            return False
        if np.issubdtype(self.dtype, np.integer) and not np.issubdtype(
                frame.dtype, np.integer):
            # clip, never wrap, out-of-range floats into the integer range
            info = np.iinfo(self.dtype)
            frame = np.clip(frame, info.min, info.max)
        frame = frame.astype(self.dtype)
        evicted = None
        with self._not_empty:
            if self._closed:
                # counted with the decision, under the lock; the span below
                self._count(mn.BATCHER_DROPPED_CLOSED)
                closed = True
            else:
                closed = False
                if len(self._frames) >= self.max_pending:
                    evicted = self._evict_for(int(priority))
                    if evicted is None:
                        # everything queued outranks it: the frame itself drops
                        self._count(mn.BATCHER_DROPPED_OVERFLOW)
                if evicted is not None or len(self._frames) < self.max_pending:
                    self._frames.append((frame, meta, time.monotonic(), int(priority),
                                         int(trace_id)))
                    self._not_empty.notify()
                    accepted = True
                else:
                    accepted = False
        if closed:
            self._emit_settle(trace_id, mn.BATCHER_DROPPED_CLOSED, "batcher.closed")
            return False
        if not accepted:
            self._emit_settle(trace_id, mn.BATCHER_DROPPED_OVERFLOW, "batcher.overflow")
            self._log_drop("overflow", [(meta, None, int(priority), int(trace_id))])
            return False
        if evicted is not None:
            reason, entry = evicted
            self._count(mn.BATCHER_DROPPED_PREFIX + reason)
            self._emit_settle(entry[3], mn.BATCHER_DROPPED_PREFIX + reason, f"batcher.{reason}")
            self._log_drop(reason, [entry])
        return True

    def _evict_for(self, incoming_priority: int):
        """Caller holds the lock and the queue is full: remove the victim,
        the oldest stale frame if any (only the head can be stale), else
        the oldest frame of the least important class when that class is
        no more important than the incoming frame. Returns ``(reason,
        (meta, enqueue_ts, priority, trace_id))``, or None when the
        incoming frame is the victim."""
        if self.stale_after_s is not None and self._frames:
            _f, meta, ts, pri, tid = self._frames[0]
            if time.monotonic() - ts > self.stale_after_s:
                self._frames.popleft()
                return "stale", (meta, ts, pri, tid)
        victim_idx, victim_pri = None, -1
        for idx, (_f, _meta, _ts, pri, _tid) in enumerate(self._frames):
            if pri > victim_pri:  # strictly greater keeps the oldest of a class
                victim_idx, victim_pri = idx, pri
        if victim_pri < incoming_priority:
            return None
        _f, meta, ts, pri, tid = self._frames[victim_idx]
        del self._frames[victim_idx]
        return "overflow", (meta, ts, pri, tid)

    def _emit_settle(self, trace_id: int, outcome: str, where: str) -> None:
        """The terminal span of a frame the batcher dropped (outside the
        queue lock; a no-op untraced)."""
        if self._tracer is not None and trace_id:
            self._tracer.emit(trace_id, "settle", topic=self._trace_topic, outcome=outcome,
                              where=where)

    def _log_drop(self, reason: str, items) -> None:
        """Dropped frames to the drop observer (the journal), outside the
        queue lock; a raising observer costs ``journal_errors``."""
        if self._drop_log is None:
            return
        entries = [{"meta": meta, "enqueue_ts": ts, "priority": pri,
                    "trace_id": tid or None, "stage": f"batcher.{reason}"}
                   for meta, ts, pri, tid in items]
        try:
            self._drop_log(reason, entries)
        except Exception:  # noqa: BLE001 - the observer's bug, counted
            self._count(mn.JOURNAL_ERRORS)

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
        just drops it; with a staging ring it goes back to its rung."""
        if self._ring is not None:
            self._ring.release(buf)
            return
        if (not isinstance(buf, np.ndarray)
                or buf.shape != (self.batch_size, *self.frame_shape)
                or buf.dtype != self.dtype):
            return
        with self._lock:
            if len(self._buffer_pool) < self._pool_cap:
                self._buffer_pool.append(buf)

    def forfeit(self, buf) -> None:
        """An in-flight staging buffer that never comes back (dead letter,
        crash: a copy of it may still be pending); the ring heals with one
        allocation. A no-op without a ring."""
        if self._ring is not None:
            self._ring.forfeit(buf)

    def _wake_consumer(self) -> None:
        with self._not_empty:
            self._not_empty.notify_all()

    # ---- consumer side ----

    def get_batch(self, block: bool = True) -> Optional[Batch]:
        """Next ``Batch``; None when closed and drained, on an idle tick,
        or when non-blocking and nothing is flushable. Frames past
        ``stale_after_s`` are shed here, never dispatched."""
        stale: List[tuple] = []
        try:
            with self._not_empty:
                popped = self._pop_batch_locked(block, stale)
        finally:
            if stale:
                self._count(mn.BATCHER_DROPPED_STALE, len(stale))
                for _meta, _ts, _pri, tid in stale:
                    self._emit_settle(tid, mn.BATCHER_DROPPED_STALE, "batcher.stale")
                self._log_drop("stale", stale)
        if popped is None:
            return None
        items, count, buf = popped
        self._count(mn.BATCHER_BATCHES_SIZE if count >= self.batch_size
                    else mn.BATCHER_BATCHES_DEADLINE)
        self._count(mn.BATCHER_FRAMES_BATCHED, count)
        if buf is None:
            frames = np.zeros((self.batch_size, *self.frame_shape), self.dtype)
        else:
            self._count(mn.BATCHER_BUFFER_REUSE)
            # a ring buffer may be rung-sized (the smallest rung >= count)
            frames = buf
            frames[count:] = 0  # re-zero a reused buffer's padding lanes
        metas: List[Any] = [None] * self.batch_size
        enqueue_ts: List[float] = []
        trace_ids: List[int] = []
        priorities: List[int] = []
        for i, (frame, meta, ts, pri, tid) in enumerate(items):
            frames[i] = frame
            metas[i] = meta
            enqueue_ts.append(ts)
            trace_ids.append(tid)
            priorities.append(pri)
        return Batch(frames, metas, count, enqueue_ts, trace_ids, priorities)

    def _shed_stale(self, collector: List[tuple]) -> None:
        """Caller holds the lock. The queue is FIFO by enqueue time, so the
        stale frames are a prefix."""
        if self.stale_after_s is None:
            return
        now = time.monotonic()
        while self._frames and now - self._frames[0][2] > self.stale_after_s:
            _frame, meta, ts, pri, tid = self._frames.popleft()
            collector.append((meta, ts, pri, tid))

    def _pop_batch_locked(self, block: bool, stale: List[tuple]):
        """Caller holds the lock: wait for a flushable batch and pop it
        with a pooled buffer, or None. With a staging ring the buffer is
        acquired before the pop: an exhausted ring keeps the frames queued
        and waits for a released buffer."""
        buf = None
        while True:
            self._shed_stale(stale)
            n = len(self._frames)
            if n > 0 and n < self.batch_size:
                deadline = self.current_flush_deadline()
                age = time.monotonic() - self._frames[0][2]
                if age < deadline:
                    if not block:
                        return None
                    self._not_empty.wait(timeout=deadline - age)
                    continue
            elif n == 0:
                if self._closed or not block:
                    return None
                self._not_empty.wait(timeout=self.flush_timeout)
                if not self._frames:
                    return None  # idle tick: give the caller a turn
                continue
            if self._ring is None:
                break
            # the one FrameBatcher._lock -> StagingRing._lock nesting
            buf = self._ring.acquire(min(n, self.batch_size), quiet=buf is _EXHAUSTED)
            if buf is not None:
                break
            buf = _EXHAUSTED
            if self._closed or not block:
                return None
            self._not_empty.wait(timeout=min(self.flush_timeout, 0.01))
        count = min(len(self._frames), self.batch_size)
        items = [self._frames.popleft() for _ in range(count)]
        # counted with the pop: drain() compares it with its completions
        self._delivered += 1
        if self._ring is None:
            buf = self._buffer_pool.pop() if self._buffer_pool else None
        return items, count, buf

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
                "dropped_stale": c.get(mn.BATCHER_DROPPED_STALE, 0.0),
                "batches_size": c.get(mn.BATCHER_BATCHES_SIZE, 0.0),
                "batches_deadline": c.get(mn.BATCHER_BATCHES_DEADLINE, 0.0)}

    @property
    def delivered_batches(self) -> int:
        """Batches handed out by ``get_batch`` (counted with the pop)."""
        with self._lock:
            return self._delivered
