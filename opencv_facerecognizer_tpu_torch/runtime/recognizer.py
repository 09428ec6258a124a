"""Recognizer service: port of ``opencv_facerecognizer_tpu/runtime/
recognizer.py`` without the subsystems that wait for later slices.

Flow: connector frames -> ``FrameBatcher`` -> identity-cache lookup ->
one serving step per batch (``RecognitionPipeline.recognize_batch_packed``,
the batch sliced to the smallest rung of a bucket ladder that holds it)
-> in-flight queue -> readback worker -> one result message per frame on
``RESULT_TOPIC``.

- **The dispatch loop never waits on device results.** It enqueues the
  step, starts the packed result's copy to pinned host memory with a CUDA
  event behind it, parks the batch in the in-flight queue and goes on
  batching; ``inflight_depth`` bounds the queue. A readback worker waits
  on each batch in dispatch order (through a sacrificial blocker thread,
  so the wait is bounded by the batch's readback deadline) and publishes.
  ``readback_worker=False`` keeps the inline fallback: the loop itself
  polls readiness between batches (``readback_poll_s``, ``drain_poll_s``).
- **Failure handling** (``runtime.resilience``): a transient dispatch
  failure retries with exponential backoff, a permanent one abandons the
  batch at once (``frames_failed``); ``degraded_after`` consecutive failed
  attempts publish ``degraded`` on ``STATUS_TOPIC`` and the next success
  ``recovered``. A readback not ready by its deadline is dead-lettered
  (``frames_dead_lettered``, a ``dead_letter`` status with the frames'
  metas) and the loop moves on.
- **Identity cache** (``runtime.tracker``, optional): frames whose
  stream's tracks are all fresh settle as ``completed_cached`` with the
  cached identities before dispatch; every full result re-verifies its
  stream's tracks after publish.
- **Control topic**: ``{"cmd": "enroll", "subject", "count"}`` captures
  the best face crop of the next ``count`` frames that have one, embeds
  them in fixed chunks on the pipeline's device off the serving threads,
  adds them to the gallery and publishes ``enrolled`` (the subject's
  label is kept only if that succeeds); ``{"cmd": "stats"}`` publishes
  the metrics, the ledger, the gallery size and the durable state's
  status.
- **Durable state** (``state_store=``, a ``runtime.state_store.
  StateLifecycle``): an enrolment is appended to the WAL before it
  touches the gallery, so ``enrolled`` promises it survives a crash; the
  serving loop ticks the checkpoint thresholds and the durability
  monitor, whose background thread runs between ``start`` and ``stop``.
  While durability is degraded an ``enroll`` is refused
  (``rejected``, reason ``durability_degraded``); a failed WAL append
  publishes ``enroll_failed``. ``commit_hooks`` run after every committed
  gallery change (an enrolment, ``reload_gallery``).
- **Supervision**: an exception that kills the dispatch loop or the
  readback worker sets ``loop_crashed``; ``runtime.resilience.
  ServiceSupervisor`` restores the gallery and calls ``restart_loop``.

Every admitted frame ends in exactly one counter of
``utils.metrics.LEDGER_COMPLETION_COUNTERS`` or ``LEDGER_DROP_COUNTERS``
(``ledger()``).

Not ported yet (ROADMAP A.8): admission control and brownout, the dead-
letter journal, the ingest staging ring and JPEG pool, tracing and SLOs,
the cascade, the model registry's swaps and replication. The CPU
fallback is not ported at all (ROADMAP C): with ``probe_backend_on_degraded``
a dead card is reported (``backend_usable: false``, ``cpu_fallback:
false``) and the service stays degraded.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models.embedder import normalize_faces
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.parallel.pipeline import unpack_result
from opencv_facerecognizer_tpu_torch.runtime.batcher import FrameBatcher
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    MiddlewareConnector, decode_frame)
from opencv_facerecognizer_tpu_torch.runtime.resilience import (
    DurabilityDegradedError, ResiliencePolicy, is_transient_error)
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

FRAME_TOPIC = "ocvfacerec/frames"
RESULT_TOPIC = "ocvfacerec/results"
CONTROL_TOPIC = "ocvfacerec/control"
STATUS_TOPIC = "ocvfacerec/status"
DEFAULT_BUCKET_SIZES = (8, 32, 128)
#: fallback path's readiness poll while it waits out a head batch (s)
FALLBACK_READBACK_POLL_S = 0.005
#: completion-wait tick of drain() and the threads' condition waits (s)
FALLBACK_DRAIN_POLL_S = 0.05
#: enrolment embeds run in fixed chunks of this many crops (warmed once)
ENROL_CHUNK = 8

log = logging.getLogger(__name__)


@dataclass
class _Enrolment:
    subject_name: str
    needed: int
    crops: List[np.ndarray] = field(default_factory=list)


class _Readback:
    """One batch's packed result on its way to the host: a pinned host
    copy and, for a CUDA result, the event recorded behind the copy."""

    def __init__(self, packed: torch.Tensor):
        self.host = packed.to("cpu", non_blocking=True)  # pinned for a CUDA source
        self.event = None
        if packed.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    @property
    def pending(self) -> bool:
        """False when the result was on the host from the start."""
        return self.event is not None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def result(self) -> np.ndarray:
        """The packed result as numpy (waits; a device fault raises here)."""
        self.wait()
        return self.host.numpy()


class _ReadbackBlocker:
    """A daemon thread that performs the possibly unbounded ``wait`` of a
    readback, so the worker's wait can be bounded by the batch's deadline.
    ``block`` returns "ready", "raised" (the wait raised) or "timeout".
    After a timeout the thread may be stuck in a CUDA call: the caller
    abandons this instance and builds a new one."""

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: Any = None
        self._done = threading.Event()
        self._ok = False
        threading.Thread(target=self._run, daemon=True, name="ocvf-readback-blocker").start()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None:
                    self._cv.wait()
                readback = self._pending
            try:
                readback.wait()
                self._ok = True
            except Exception:  # noqa: BLE001 - recorded: block() reports "raised"
                self._ok = False
            with self._cv:
                self._pending = None
            self._done.set()

    def block(self, readback: Any, timeout: float) -> str:
        self._done.clear()
        with self._cv:
            self._pending = readback
            self._cv.notify()
        if not self._done.wait(timeout=max(0.0, timeout)):
            return "timeout"
        return "ready" if self._ok else "raised"


class _Inflight(NamedTuple):
    readback: Any
    frames: np.ndarray
    metas: List[Any]
    count: int
    enqueue_ts: List[float]
    t0: float
    t_disp: float
    deadline: float  # time.monotonic() after which the batch dead-letters
    stamp: Optional[int]  # the gallery's embedder_version at dispatch


class RecognizerService:
    def __init__(self, pipeline, connector: MiddlewareConnector, batch_size: int = 8,
                 frame_shape: Optional[tuple] = None, flush_timeout: float = 0.05,
                 inflight_depth: int = 4, similarity_threshold: float = 0.3,
                 subject_names: Optional[List[str]] = None,
                 metrics: Optional[mn.Metrics] = None, transfer_dtype=np.float32,
                 resilience: Optional[ResiliencePolicy] = None,
                 readback_worker: bool = True,
                 readback_poll_s: float = FALLBACK_READBACK_POLL_S,
                 drain_poll_s: float = FALLBACK_DRAIN_POLL_S,
                 bucket_sizes: Optional[Sequence[int]] = DEFAULT_BUCKET_SIZES,
                 target_latency_s: Optional[float] = None, tracker=None,
                 max_pending: int = 256, state_store=None, fault_injector=None,
                 backend_probe_fn: Optional[Callable[[], tuple]] = None):
        if frame_shape is None:
            raise ValueError("frame_shape (H, W) is required (fixed batch shapes)")
        self.pipeline = pipeline
        self.connector = connector
        self.similarity_threshold = float(similarity_threshold)
        self.subject_names = list(subject_names) if subject_names else []
        self.metrics = metrics or mn.Metrics()
        self.resilience = resilience or ResiliencePolicy()
        self.tracker = tracker
        self.inflight_depth = int(inflight_depth)
        self._use_worker = bool(readback_worker)
        self._readback_poll_s = float(readback_poll_s)
        self._drain_poll_s = float(drain_poll_s)
        self.batcher = FrameBatcher(batch_size, frame_shape, flush_timeout=flush_timeout,
                                    max_pending=max_pending, dtype=transfer_dtype,
                                    metrics=self.metrics, target_latency_s=target_latency_s)
        self._bucket_ladder = sorted(
            {int(b) for b in (bucket_sizes or ()) if 0 < int(b) < batch_size}
            | {int(batch_size)})
        self._inflight: deque = deque()
        # guards the in-flight queue and the completion count; drain() waits on it
        self._inflight_cv = threading.Condition()
        self._completed_batches = 0
        self._blocker: Optional[_ReadbackBlocker] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._worker: Optional[threading.Thread] = None
        self._consecutive_dispatch_failures = 0
        self._degraded = False
        self._enrolment: Optional[_Enrolment] = None
        self._enrol_lock = threading.Lock()
        self._crashed = False
        #: ``runtime.faults.FaultInjector`` at the dispatch boundary (never
        #: in production)
        self._faults = fault_injector
        #: the degraded-mode probe, injectable for tests; default
        #: ``utils.backend_probe.probe_for_recovery``
        self._backend_probe_fn = backend_probe_fn
        #: called (no arguments, best effort) after every committed gallery
        #: change; the state store and the supervisor register here
        self.commit_hooks: List[Callable[[], None]] = []
        self.state = state_store
        if self.state is not None:
            self.state.attach(self)
        dur = self._durability
        if dur is not None and dur.publish is None:
            dur.publish = self._publish_status
        connector.subscribe(FRAME_TOPIC, self._on_frame)
        connector.subscribe(CONTROL_TOPIC, self._on_control)

    @property
    def _durability(self):
        """The state store's ``DurabilityMonitor`` (None without one)."""
        return None if self.state is None else self.state.durability

    # ---- admission ledger ----

    def ledger(self) -> Dict[str, Any]:
        """``admitted``, ``completed``, ``completed_cached`` (answered from
        the identity cache), per-reason ``drops_by_reason`` and the
        ``in_system`` remainder, which is 0 once ``drain()`` returned."""
        c = self.metrics.counters()
        drops = {n: c[n] for n in mn.LEDGER_DROP_COUNTERS if c.get(n)}
        admitted = c.get(mn.FRAMES_ADMITTED, 0.0)
        completed = c.get(mn.FRAMES_COMPLETED, 0.0)
        cached = c.get(mn.FRAMES_COMPLETED_CACHED, 0.0)
        return {"admitted": admitted, "completed": completed, "completed_cached": cached,
                "drops_by_reason": drops,
                "in_system": admitted - completed - cached - sum(drops.values())}

    # ---- connector handlers (the connector's thread; keep cheap) ----

    def _on_frame(self, topic: str, message: Dict[str, Any]) -> None:
        self.metrics.incr(mn.FRAMES_ADMITTED)
        try:
            frame = (decode_frame(message) if "__frame__" in message
                     else np.asarray(message["frame"]))
        except Exception:  # noqa: BLE001 - any undecodable payload is malformed
            self.metrics.incr(mn.FRAMES_MALFORMED)
            return
        if not self.batcher.put(frame, message.get("meta")):
            self.metrics.incr(mn.FRAMES_DROPPED)  # the batcher counted its reason

    def _on_control(self, topic: str, message: Dict[str, Any]) -> None:
        cmd = message.get("cmd")
        if cmd == "enroll":
            dur = self._durability
            if dur is not None and dur.degraded:
                # refused at the door: the crops would only fail their
                # WAL append
                self.metrics.incr(mn.ENROLLMENTS_REFUSED_DEGRADED)
                self._publish_status({
                    "status": "rejected", "reason": "durability_degraded",
                    "detail": "enrollment refused: WAL durability is degraded on this "
                              "writer (serving continues; re-arms automatically when the "
                              "probe sees the disk recover)"})
                return
            name = str(message.get("subject", f"subject_{len(self.subject_names)}"))
            count = int(message.get("count", 5))
            with self._enrol_lock:
                self._enrolment = _Enrolment(name, count)
            self.connector.publish(STATUS_TOPIC, {"status": "enrolling", "subject": name,
                                                  "count": count})
        elif cmd == "stats":
            status = {"status": "stats", **self.metrics.summary(), **self.batcher.stats,
                      "degraded": self._degraded, "ledger": self.ledger(),
                      "gallery_size": self.pipeline.gallery.size}
            if self.tracker is not None:
                status["tracks"] = self.tracker.stats()
            if self.state is not None:
                # the WAL position and the durability monitor's status
                dur = self._durability
                status["durability"] = {"wal_seq": self.state.wal_seq,
                                        "rows_since_checkpoint": self.state.rows_since_checkpoint,
                                        **(dur.status() if dur is not None else {})}
            self.connector.publish(STATUS_TOPIC, status)

    # ---- lifecycle ----

    def start(self, warmup: bool = True) -> None:
        if self._thread is not None:
            return
        if warmup:
            self.warmup()
        self._running = True
        self._crashed = False
        self.connector.start()
        dur = self._durability
        if dur is not None:
            dur.start()
        if self._use_worker:
            self._blocker = _ReadbackBlocker()
            self._worker = threading.Thread(target=self._readback_thread, daemon=True,
                                            name="ocvf-readback")
            self._worker.start()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ocvf-dispatch")
        self._thread.start()

    def warmup(self) -> None:
        """Run every rung of the bucket ladder and one enrolment chunk
        before frames arrive (kernel builds, convolution algorithm search)."""
        t0 = time.perf_counter()
        self.pipeline.prewarm_batch_shapes(self._bucket_ladder, self.batcher.frame_shape,
                                           self.batcher.dtype)
        if getattr(self.pipeline, "embed_net", None) is not None:
            self._run_embed_chunk(np.zeros((ENROL_CHUNK, *self.pipeline.face_size),
                                           np.float32))
        self.metrics.observe(mn.WARMUP, time.perf_counter() - t0)

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until every accepted frame has been batched, computed and
        published (or timeout). Call before ``stop()`` at end of stream."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while time.monotonic() < deadline:
                if (self.batcher.pending == 0
                        and self.batcher.delivered_batches == self._completed_batches):
                    return True
                self._inflight_cv.wait(timeout=self._drain_poll_s)
        return False

    def stop(self) -> None:
        """Stop intake and the loop; the readback worker finishes the
        batches already in flight (each bounded by its deadline)."""
        self._running = False
        dur = self._durability
        if dur is not None:
            dur.stop()
        self.batcher.close()
        with self._inflight_cv:
            self._inflight_cv.notify_all()
        thread = self._thread
        for t in (thread, self._worker):
            if t is not None:
                t.join(timeout=30.0)
        self._thread = self._worker = None
        if not self._use_worker and (thread is None or not thread.is_alive()):
            self._drain(force=True)
        self.connector.stop()

    # ---- dispatch loop ----

    def _pick_bucket(self, count: int) -> int:
        for b in self._bucket_ladder:
            if count <= b:
                return b
        return self.batcher.batch_size

    @property
    def loop_crashed(self) -> bool:
        """True when an exception killed the dispatch loop or the readback
        worker (``ServiceSupervisor`` watches it)."""
        return self._crashed

    def restart_pending(self) -> bool:
        """The crash flag is up and a serving thread has exited, so
        ``restart_loop`` would act."""
        if not self._crashed or not self._running:
            return False
        if self._thread is not None and not self._thread.is_alive():
            return True
        return self._use_worker and self._worker is not None and not self._worker.is_alive()

    def restart_loop(self) -> None:
        """Respawn whichever of the dispatch loop and the readback worker
        died (the supervisor's path); every crash path settled its own
        batch first."""
        if not self._running or self._thread is None:
            return
        serve_dead = not self._thread.is_alive()
        worker_dead = (self._use_worker and self._worker is not None
                       and not self._worker.is_alive())
        if not serve_dead and not worker_dead:
            return
        self._crashed = False
        if worker_dead:
            self._blocker = _ReadbackBlocker()
            self._worker = threading.Thread(target=self._readback_thread, daemon=True,
                                            name="ocvf-readback")
            self._worker.start()
        if serve_dead:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ocvf-dispatch")
            self._thread.start()

    def _loop(self) -> None:
        try:
            self._serve_loop()
        except Exception:  # noqa: BLE001 - flag the crash for the supervisor
            log.exception("serving loop crashed")
            self.metrics.incr(mn.LOOP_CRASHES)
            self._crashed = True
            self._publish_status({"status": "crashed"})

    def _serve_loop(self) -> None:
        while self._running:
            batch = self.batcher.get_batch(block=True)
            if self.state is not None:
                # cheap threshold checks; a due checkpoint runs on its own
                # thread, and the monitor's probe only on its own
                try:
                    self.state.tick()
                    dur = self._durability
                    if dur is not None:
                        dur.tick()
                except BaseException:
                    if batch is not None:
                        # the batch never reached _serve_one: settle it here
                        self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, batch.count)
                        self._mark_completed()
                    raise
            if batch is None:
                if not self._use_worker:
                    self._drain()
                continue
            self._serve_one(batch)
        if not self._use_worker:
            self._drain(force=True)

    def _mark_completed(self) -> None:
        with self._inflight_cv:
            self._completed_batches += 1
            self._inflight_cv.notify_all()

    def _serve_one(self, batch) -> None:
        frames, metas, count = batch.frames, batch.metas, batch.count
        t0 = time.perf_counter()
        now = time.monotonic()
        for ts in batch.enqueue_ts:
            self.metrics.observe(mn.QUEUE_WAIT, now - ts)
        stamp = getattr(getattr(self.pipeline, "gallery", None), "embedder_version", None)
        stamp = None if stamp is None else int(stamp)
        accounted = False
        try:
            if count and self.tracker is not None:
                batch, cached = self._split_cached(batch, stamp)
                # the cached frames leave this batch before they settle, so a
                # crash while they publish settles each frame once
                metas, count = batch.metas, batch.count
                if cached:
                    self._complete_cached(cached)
                if not count:
                    # every frame answered from the cache: no device work
                    self.metrics.incr(mn.TRACK_BATCH_EXITS)
                    accounted = True
                    self._mark_completed()
                    self.batcher.recycle(frames)
                    self.batcher.report_service_time(time.perf_counter() - t0)
                    return
            bucket = self._pick_bucket(count)
            readback = self._dispatch_with_retry(frames[:bucket])
            if readback is None:
                # retries spent or a permanent error: the batch is abandoned
                self.metrics.incr(mn.FRAMES_FAILED, count)
                accounted = True
                self._mark_completed()
                self.batcher.recycle(frames)
                return
            t_disp = time.perf_counter()
            self.metrics.observe(mn.DISPATCH, t_disp - t0)
            deadline = time.monotonic() + self.resilience.readback_deadline_s
            with self._inflight_cv:
                self._inflight.append(_Inflight(readback, frames, metas, count,
                                                batch.enqueue_ts, t0, t_disp, deadline,
                                                stamp))
                accounted = True
                self._inflight_cv.notify_all()
        except BaseException:
            if not accounted:
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, count)
                self._mark_completed()
            raise
        self.metrics.incr(mn.BATCHES_DISPATCHED)
        self.metrics.incr(mn.FRAMES_PROCESSED, count)
        if bucket < self.batcher.batch_size:
            self.metrics.incr(mn.BATCHES_BUCKETED)
        if self._use_worker:
            with self._inflight_cv:
                while self._running and len(self._inflight) > self.inflight_depth:
                    self._inflight_cv.wait(timeout=self._drain_poll_s)
        else:
            self._drain()

    def _dispatch_with_retry(self, frames) -> Optional[_Readback]:
        """One batch through the device under the resilience policy; the
        readback of its packed output, or None when abandoned."""
        policy = self.resilience
        attempt = 0
        while True:
            try:
                if self._faults is not None:
                    self._faults.on_dispatch()
                readback = self._start_readback(self.pipeline.recognize_batch_packed(frames))
            except Exception as exc:  # noqa: BLE001 - classified below
                self.metrics.incr(mn.DISPATCH_FAILURES)
                self._consecutive_dispatch_failures += 1
                if (self._consecutive_dispatch_failures >= policy.degraded_after
                        and not self._degraded):
                    self._enter_degraded(exc)
                transient = is_transient_error(exc)
                if not transient or attempt >= policy.dispatch_retries:
                    log.exception("recognition batch abandoned (%s, attempt %d)",
                                  "transient" if transient else "permanent", attempt)
                    self.metrics.incr(mn.BATCHES_FAILED)
                    return None
                self.metrics.incr(mn.DISPATCH_RETRIES)
                self._backoff_wait(policy.backoff(attempt))
                attempt += 1
                if not self._running:
                    self.metrics.incr(mn.BATCHES_FAILED)
                    return None
                continue
            self._consecutive_dispatch_failures = 0
            if self._degraded:
                self._exit_degraded()
            return readback

    def _start_readback(self, packed: torch.Tensor) -> _Readback:
        return _Readback(packed)

    def _backoff_wait(self, seconds: float) -> None:
        """Sleep in slices, bailing out on stop(); the fallback path keeps
        draining finished batches meanwhile."""
        deadline = time.monotonic() + seconds
        while self._running and time.monotonic() < deadline:
            if not self._use_worker:
                self._drain()
            time.sleep(min(0.01, max(0.0, deadline - time.monotonic())))

    # ---- degraded mode ----

    def _enter_degraded(self, exc: BaseException) -> None:
        self._degraded = True
        self.metrics.incr(mn.DEGRADED_TRANSITIONS)
        status = {"status": "degraded",
                  "consecutive_failures": self._consecutive_dispatch_failures,
                  "error": repr(exc)}
        if self.resilience.probe_backend_on_degraded:
            usable, reason = self._probe_backend()
            status["backend_usable"] = usable
            status["backend_reason"] = reason
            if not usable:
                # the reference's state for a CPU fallback that did not
                # happen: the port has none (ROADMAP C), it stays degraded
                status["cpu_fallback"] = False
        self._publish_status(status)

    def _probe_backend(self) -> tuple:
        """Bounded verdict on the card: the injected fn, else the
        subprocess probe."""
        if self._backend_probe_fn is not None:
            return self._backend_probe_fn()
        from opencv_facerecognizer_tpu_torch.utils.backend_probe import probe_for_recovery

        return probe_for_recovery()

    def _exit_degraded(self) -> None:
        self._degraded = False
        self.metrics.incr(mn.DEGRADED_RECOVERIES)
        self._publish_status({"status": "recovered"})

    def _publish_status(self, status: Dict[str, Any]) -> None:
        """A raising status consumer costs a log line, never the loop."""
        try:
            self.connector.publish(STATUS_TOPIC, status)
        except Exception:  # noqa: BLE001 - the transport or a subscriber failed
            log.exception("status publish failed")

    def _dead_letter(self, entry: _Inflight) -> None:
        """Abandon a batch whose readback missed its deadline (or failed):
        counted, completed, announced with the frames' metas and enqueue
        times so producers can resend. Its staging buffer is not recycled:
        the copy of it to the card may still be pending."""
        self.metrics.incr(mn.BATCHES_DEAD_LETTERED)
        self.metrics.incr(mn.FRAMES_DEAD_LETTERED, entry.count)
        self._mark_completed()
        self._publish_status({"status": "dead_letter", "frames": entry.count,
                              "frame_ids": list(entry.metas[:entry.count]),
                              "enqueued_at": list(entry.enqueue_ts[:entry.count])})

    # ---- identity cache ----

    @staticmethod
    def _track_stream_key(meta):
        """A frame's tracking scope: ``meta["stream"]``, else ``meta["topic"]``;
        None (untracked) otherwise."""
        if isinstance(meta, dict):
            key = meta.get("stream")
            return meta.get("topic") if key is None else key
        return None

    def _split_cached(self, batch, stamp):
        """The frames the tracker can answer, and the batch of the others,
        compacted to the front of the staging buffer: (batch, cached)."""
        frames, metas = batch.frames, batch.metas
        cached, keep = [], []
        for i in range(batch.count):
            hit = None
            key = self._track_stream_key(metas[i])
            if key is not None:
                try:
                    hit = self.tracker.lookup(key, frames[i], embedder_version=stamp)
                except Exception:  # noqa: BLE001 - fail open to the full path
                    log.exception("tracker lookup failed")
                    self.metrics.incr(mn.TRACK_ERRORS)
            if hit is None:
                keep.append(i)
            else:
                cached.append((metas[i], batch.enqueue_ts[i], hit))
        if not cached:
            return batch, cached
        kept = len(keep)
        if kept:
            frames[:kept] = frames[np.asarray(keep, dtype=np.intp)]
        batch = batch._replace(metas=[metas[i] for i in keep] + [None] * (len(metas) - kept),
                               count=kept, enqueue_ts=[batch.enqueue_ts[i] for i in keep])
        return batch, cached

    def _complete_cached(self, cached) -> None:
        """Publish each cache hit's identities (``exit: track_cache``)."""
        published = 0
        try:
            for meta, _ts, hit in cached:
                payload = {"meta": meta, "faces": hit["faces"], "exit": "track_cache",
                           "track_id": hit["track_id"]}
                if hit.get("embedder_version") is not None:
                    payload["embedder_version"] = hit["embedder_version"]
                self.connector.publish(RESULT_TOPIC, payload)
                published += 1
                self.metrics.incr(mn.FACES_FOUND, len(hit["faces"]))
        finally:
            self.metrics.incr(mn.FRAMES_COMPLETED_CACHED, published)
            if published < len(cached):
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, len(cached) - published)
            now = time.monotonic()
            for _meta, ts, _hit in cached[:published]:
                self.metrics.observe(mn.E2E_LATENCY, now - ts)

    # ---- readback ----

    @staticmethod
    def _is_ready(readback) -> bool:
        """Non-blocking readiness; a raising query reports ready, so that
        ``result()`` surfaces the error where it is dead-lettered."""
        try:
            return bool(readback.ready())
        except Exception:  # noqa: BLE001 - deferred to result()
            return True

    def _readback_thread(self) -> None:
        try:
            self._readback_loop()
        except Exception:  # noqa: BLE001 - flag the crash for the supervisor
            log.exception("readback worker crashed")
            self.metrics.incr(mn.LOOP_CRASHES)
            self._crashed = True
            self._publish_status({"status": "crashed"})

    def _readback_loop(self) -> None:
        """Wait for each in-flight batch in dispatch order (bounded by its
        deadline), then publish. Runs until stopped and the queue is empty."""
        while True:
            with self._inflight_cv:
                while self._running and not self._inflight:
                    self._inflight_cv.wait(timeout=self._drain_poll_s)
                if not self._inflight:
                    return
                entry = self._inflight[0]
            try:
                ready = self._await_ready(entry.readback, entry.deadline)
            except Exception:  # noqa: BLE001 - an outage at the readback costs this batch
                log.exception("readback wait failed")
                self.metrics.incr(mn.READBACK_ERRORS)
                ready = False
            with self._inflight_cv:
                self._inflight.popleft()
                self._inflight_cv.notify_all()
            if not ready:
                self._dead_letter(entry)
                continue
            self._complete_head(entry)

    def _await_ready(self, readback, deadline: float) -> bool:
        """Wait for one batch's copy until ``deadline``; False if it missed."""
        if not readback.pending:
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return self._is_ready(readback)
        blocker = self._blocker or _ReadbackBlocker()
        self._blocker = blocker
        outcome = blocker.block(readback, remaining)
        if outcome == "ready":
            return True
        if outcome == "timeout":
            self._blocker = _ReadbackBlocker()  # the old one may be stuck
            return False
        # "raised": poll until the deadline; a failed computation reports
        # ready and raises again in result()
        while self._running and time.monotonic() < deadline:
            if self._is_ready(readback):
                return True
            time.sleep(self._readback_poll_s)
        return self._is_ready(readback)

    def _drain(self, force: bool = False) -> None:
        """Inline fallback (``readback_worker=False``): publish finished head
        batches; dead-letter a head past its deadline; over depth (or
        forced) poll the head until ready or its deadline."""
        while self._inflight:
            entry = self._inflight[0]
            ready = self._is_ready(entry.readback)
            if not ready:
                if time.monotonic() < entry.deadline and not (
                        force or len(self._inflight) > self.inflight_depth):
                    break
                while not ready and time.monotonic() < entry.deadline:
                    time.sleep(self._readback_poll_s)
                    ready = self._is_ready(entry.readback)
            with self._inflight_cv:
                self._inflight.popleft()
                self._inflight_cv.notify_all()
            if not ready:
                self._dead_letter(entry)
                continue
            self._complete_head(entry)

    def _complete_head(self, entry: _Inflight) -> None:
        """Materialize and publish one popped batch and settle it."""
        try:
            packed = entry.readback.result()
        except Exception:  # noqa: BLE001 - a device error carried by the result
            log.exception("readback materialize failed")
            self.metrics.incr(mn.READBACK_ERRORS)
            self._dead_letter(entry)
            return
        self.metrics.observe(mn.READY_WAIT, time.perf_counter() - entry.t_disp)
        t_pub = time.perf_counter()
        try:
            self._publish(packed, entry.frames, entry.metas, entry.count, entry.stamp)
        except BaseException:
            self._mark_completed()
            self.batcher.recycle(entry.frames)
            raise
        self._mark_completed()
        now = time.perf_counter()
        self.metrics.observe(mn.PUBLISH, now - t_pub)
        self.metrics.observe(mn.BATCH_LATENCY, now - entry.t0)
        mono = time.monotonic()
        for ts in entry.enqueue_ts[:entry.count]:
            self.metrics.observe(mn.E2E_LATENCY, mono - ts)
        self.batcher.report_service_time(now - entry.t0)
        self.batcher.recycle(entry.frames)

    def _publish(self, packed: np.ndarray, frames, metas, count: int,
                 stamp: Optional[int] = None) -> None:
        """One result message per real frame: ``{"meta", "faces": [{"box"
        (x0, y0, x1, y1), "detection_score", "label", "name",
        "similarity"}], "embedder_version"}``, the reference's schema."""
        result = unpack_result(packed, self.pipeline.top_k)
        published = 0
        try:
            for i in range(count):
                faces = []
                for j in range(result.boxes.shape[1]):
                    if not result.valid[i, j]:
                        continue
                    sim = float(result.similarities[i, j, 0])
                    label = int(result.labels[i, j, 0])
                    known = sim >= self.similarity_threshold and label >= 0
                    name = (self.subject_names[label]
                            if known and label < len(self.subject_names)
                            else ("unknown" if not known else str(label)))
                    y0, x0, y1, x1 = (float(v) for v in result.boxes[i, j])
                    faces.append({
                        "box": [x0, y0, x1, y1],  # x-first, like the reference API
                        "detection_score": float(result.det_scores[i, j]),
                        "label": label if known else -1,
                        "name": name,
                        "similarity": sim,
                    })
                self._maybe_collect_enrolment(frames[i], faces)
                payload = {"meta": metas[i], "faces": faces}
                if stamp is not None:
                    payload["embedder_version"] = stamp
                self.connector.publish(RESULT_TOPIC, payload)
                published += 1
                self.metrics.incr(mn.FACES_FOUND, len(faces))
                key = self._track_stream_key(metas[i])
                if self.tracker is not None and key is not None:
                    try:
                        self.tracker.update(key, faces, frames[i], embedder_version=stamp)
                    except Exception:  # noqa: BLE001 - the cache only: fail open
                        log.exception("tracker update failed")
                        self.metrics.incr(mn.TRACK_ERRORS)
        finally:
            self.metrics.incr(mn.FRAMES_COMPLETED, published)
            if published < count:
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, count - published)

    # ---- enrolment ----

    def _run_embed_chunk(self, crops: np.ndarray) -> np.ndarray:
        """One fixed-size chunk of face crops [ENROL_CHUNK, h, w] -> unit
        embeddings, on the pipeline's device (the unfused embedder, as
        the reference's enrolment graph)."""
        pipeline = self.pipeline
        with torch.no_grad():
            x = torch.as_tensor(crops, dtype=torch.float32, device=pipeline.device)
            emb = pipeline.embed_net(normalize_faces(x, pipeline.face_size))
        return emb.float().cpu().numpy()

    def _maybe_collect_enrolment(self, frame: np.ndarray, faces: List[dict]) -> None:
        with self._enrol_lock:
            enrolment = self._enrolment
        if enrolment is None or not faces:
            return
        best = max(faces, key=lambda f: f["detection_score"])
        x0, y0, x1, y1 = (int(round(v)) for v in best["box"])
        h, w = frame.shape
        y0, y1 = max(0, y0), min(h, y1)
        x0, x1 = max(0, x0), min(w, x1)
        if y1 - y0 < 4 or x1 - x0 < 4:
            return
        # a copy: the frame's staging buffer is reused once the batch completes
        enrolment.crops.append(frame[y0:y1, x0:x1].copy())
        if len(enrolment.crops) >= enrolment.needed:
            with self._enrol_lock:
                self._enrolment = None
            threading.Thread(target=self._finish_enrolment, args=(enrolment,),
                             daemon=True, name="ocvf-enrol").start()

    def _finish_enrolment(self, enrolment: _Enrolment) -> None:
        """Embed the crops, add them to the gallery, publish ``enrolled``;
        off the serving threads."""
        face_size = self.pipeline.face_size
        # the embedder version these crops are embedded by: the state store
        # refuses them if a cutover changed the gallery's meanwhile
        enrol_version = getattr(self.pipeline.gallery, "embedder_version", None)
        crops = np.stack([image_ops.resize(torch.as_tensor(c, dtype=torch.float32),
                                           face_size).numpy() for c in enrolment.crops])
        embeddings = []
        for start in range(0, len(crops), ENROL_CHUNK):
            part = crops[start:start + ENROL_CHUNK]
            padded = np.zeros((ENROL_CHUNK, *face_size), np.float32)
            padded[:len(part)] = part
            embeddings.append(self._run_embed_chunk(padded)[:len(part)])
        emb = np.concatenate(embeddings)
        with self._enrol_lock:
            if enrolment.subject_name in self.subject_names:
                label = self.subject_names.index(enrolment.subject_name)
            else:
                label = len(self.subject_names)
                self.subject_names.append(enrolment.subject_name)
        gallery = self.pipeline.gallery
        before_grow = gallery.grow_count
        labels = np.full(len(emb), label, np.int32)
        try:
            if self.state is not None:
                # write-ahead: the WAL record (fsynced per policy) lands
                # before the rows, so ``enrolled`` below promises they
                # survive a crash; a failed append raises
                self.state.append_enrollment(emb, labels, subject=enrolment.subject_name,
                                             label=label,
                                             apply_fn=lambda: gallery.add(emb, labels),
                                             embedder_version=enrol_version)
            else:
                gallery.add(emb, labels)
        except Exception as exc:
            # the gallery holds no rows for a name reserved above: drop it
            with self._enrol_lock:
                if (label == len(self.subject_names) - 1
                        and self.subject_names[label] == enrolment.subject_name):
                    self.subject_names.pop()
            if isinstance(exc, (DurabilityDegradedError, OSError)):
                # refused closed, never acknowledged
                log.warning("enrollment %r refused closed: %r", enrolment.subject_name, exc)
                self._publish_status({
                    "status": "enroll_failed", "subject": enrolment.subject_name,
                    "reason": ("durability_degraded"
                               if isinstance(exc, DurabilityDegradedError) else "wal_error"),
                    "error": repr(exc)})
                return
            raise
        if gallery.grow_count > before_grow:
            self.metrics.incr(mn.GALLERY_GROWN, gallery.grow_count - before_grow)
        self.metrics.incr(mn.SUBJECTS_ENROLLED)
        self.connector.publish(STATUS_TOPIC, {"status": "enrolled",
                                              "subject": enrolment.subject_name,
                                              "label": label,
                                              "gallery_size": gallery.size})
        self._run_commit_hooks()

    # ---- reload without drop ----

    def reload_gallery(self, new_gallery) -> None:
        """Swap in a rebuilt gallery between batches (``swap_from``); the
        identity cache starts cold, and with a state store a forced
        checkpoint makes the swap durable (until it lands, a crash
        recovers the previous gallery plus every acknowledged
        enrolment)."""
        self.pipeline.gallery.swap_from(new_gallery)
        if self.tracker is not None:
            self.tracker.flush_all()
        self.connector.publish(STATUS_TOPIC, {"status": "reloaded",
                                              "gallery_size": self.pipeline.gallery.size})
        self._run_commit_hooks()
        if self.state is not None:
            self.state.maybe_checkpoint(force=True)

    def _run_commit_hooks(self) -> None:
        """A raising hook costs a log line, never the enrolment or reload."""
        for hook in list(self.commit_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 - watcher bugs stay theirs
                log.exception("commit hook failed")
