"""Recognizer service: port of the core of
``opencv_facerecognizer_tpu/runtime/recognizer.py``.

Flow: connector frames -> ``FrameBatcher`` -> one serving step per batch
(``RecognitionPipeline.recognize_batch_packed``, the batch sliced to the
smallest rung of a bucket ladder that holds it) -> in-flight queue ->
readback worker -> one result message per frame on ``RESULT_TOPIC``.

The dispatch loop never waits on device results: it enqueues the step,
starts the packed result's copy to pinned host memory with a CUDA event
behind it, parks the batch in the in-flight queue and goes on batching.
A dedicated readback worker waits on each batch's event in dispatch
order and publishes. ``inflight_depth`` bounds the queue.

Every admitted frame ends in exactly one counter: ``frames_completed``
or one of ``utils.metrics.LEDGER_DROP_COUNTERS`` (``ledger()``).

Not ported yet (ROADMAP): resilience (retry, dead letters, degraded
mode, supervisor), admission control, brownout, the ingest staging ring,
tracing, the tracker, the cascade, the model registry, the state store
and enrolment.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionPipeline, unpack_result)
from opencv_facerecognizer_tpu_torch.runtime.batcher import FrameBatcher
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    MiddlewareConnector, decode_frame)
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

FRAME_TOPIC = "ocvfacerec/frames"
RESULT_TOPIC = "ocvfacerec/results"
DEFAULT_BUCKET_SIZES = (8, 32, 128)
#: idle tick of the dispatch loop's and drain's waits (seconds)
DRAIN_POLL_S = 0.05

log = logging.getLogger(__name__)


class RecognizerService:
    def __init__(self, pipeline: RecognitionPipeline,
                 connector: MiddlewareConnector, batch_size: int = 8,
                 frame_shape: Optional[tuple] = None,
                 flush_timeout: float = 0.05, inflight_depth: int = 4,
                 similarity_threshold: float = 0.3,
                 subject_names: Optional[List[str]] = None,
                 metrics: Optional[mn.Metrics] = None,
                 transfer_dtype=np.float32,
                 bucket_sizes: Optional[Sequence[int]] = DEFAULT_BUCKET_SIZES,
                 max_pending: int = 256):
        if frame_shape is None:
            raise ValueError("frame_shape (H, W) is required (fixed batch shapes)")
        self.pipeline = pipeline
        self.connector = connector
        self.similarity_threshold = float(similarity_threshold)
        self.subject_names = list(subject_names) if subject_names else []
        self.metrics = metrics or mn.Metrics()
        self.inflight_depth = int(inflight_depth)
        self.batcher = FrameBatcher(batch_size, frame_shape,
                                    flush_timeout=flush_timeout,
                                    max_pending=max_pending,
                                    dtype=transfer_dtype, metrics=self.metrics)
        self._bucket_ladder = sorted(
            {int(b) for b in (bucket_sizes or ()) if 0 < int(b) < batch_size}
            | {int(batch_size)})
        self._inflight: deque = deque()
        self._inflight_cv = threading.Condition()
        self._completed_batches = 0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._worker: Optional[threading.Thread] = None
        connector.subscribe(FRAME_TOPIC, self._on_frame)

    # ---- intake (connector thread) ----

    def _on_frame(self, topic: str, message: Dict[str, Any]) -> None:
        self.metrics.incr(mn.FRAMES_ADMITTED)
        try:
            frame = (decode_frame(message) if "__frame__" in message
                     else np.asarray(message["frame"]))
        except (KeyError, ValueError, TypeError):
            self.metrics.incr(mn.FRAMES_MALFORMED)
            return
        self.batcher.put(frame, message.get("meta"))

    # ---- lifecycle ----

    def start(self, warmup: bool = True) -> None:
        if self._thread is not None:
            return
        if warmup:
            self.warmup()
        self._running = True
        self.connector.start()
        self._worker = threading.Thread(target=self._readback_loop,
                                        daemon=True, name="ocvf-readback")
        self._worker.start()
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="ocvf-dispatch")
        self._thread.start()

    def warmup(self) -> None:
        """Run every rung of the bucket ladder once before frames arrive
        (kernel builds, convolution algorithm search)."""
        t0 = time.perf_counter()
        self.pipeline.prewarm_batch_shapes(self._bucket_ladder,
                                           self.batcher.frame_shape,
                                           self.batcher.dtype)
        self.metrics.observe(mn.WARMUP, time.perf_counter() - t0)

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until every accepted frame has been batched, computed and
        published (or timeout). Call before ``stop()`` at end of stream."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while time.monotonic() < deadline:
                if (self.batcher.pending == 0 and self.batcher.delivered_batches
                        == self._completed_batches):
                    return True
                self._inflight_cv.wait(timeout=DRAIN_POLL_S)
        return False

    def stop(self) -> None:
        """Stop intake and the loop; the readback worker finishes the
        batches already in flight before it exits."""
        self._running = False
        self.batcher.close()
        with self._inflight_cv:
            self._inflight_cv.notify_all()
        for thread in (self._thread, self._worker):
            if thread is not None:
                thread.join(timeout=30.0)
        self._thread = self._worker = None
        self.connector.stop()

    def ledger(self) -> Dict[str, float]:
        """Admission ledger: admitted, completed, dropped, in_system."""
        c = self.metrics.counters()
        dropped = sum(c.get(n, 0.0) for n in mn.LEDGER_DROP_COUNTERS)
        admitted = c.get(mn.FRAMES_ADMITTED, 0.0)
        completed = c.get(mn.FRAMES_COMPLETED, 0.0)
        return {"admitted": admitted, "completed": completed,
                "dropped": dropped, "in_system": admitted - completed - dropped}

    # ---- dispatch loop ----

    def _pick_bucket(self, count: int) -> int:
        for b in self._bucket_ladder:
            if count <= b:
                return b
        return self.batcher.batch_size

    def _serve_loop(self) -> None:
        while self._running:
            batch = self.batcher.get_batch(block=True)
            if batch is None:
                continue
            self._serve_one(batch)

    def _mark_completed(self) -> None:
        with self._inflight_cv:
            self._completed_batches += 1
            self._inflight_cv.notify_all()

    def _serve_one(self, batch) -> None:
        frames, count = batch.frames, batch.count
        t0 = time.perf_counter()
        now = time.monotonic()
        for ts in batch.enqueue_ts:
            self.metrics.observe(mn.QUEUE_WAIT, now - ts)
        bucket = self._pick_bucket(count)
        try:
            packed = self.pipeline.recognize_batch_packed(frames[:bucket])
            host = packed.to("cpu", non_blocking=True)
            event = None
            if packed.is_cuda:
                event = torch.cuda.Event()
                event.record()
        except Exception:  # noqa: BLE001 - one bad batch must not stop serving
            log.exception("serving step failed")
            self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, count)
            self._mark_completed()
            return
        t_disp = time.perf_counter()
        self.metrics.observe(mn.DISPATCH, t_disp - t0)
        self.metrics.incr(mn.BATCHES_DISPATCHED)
        self.metrics.incr(mn.FRAMES_PROCESSED, count)
        if bucket < self.batcher.batch_size:
            self.metrics.incr(mn.BATCHES_BUCKETED)
        with self._inflight_cv:
            self._inflight.append((host, event, batch, t0, t_disp))
            self._inflight_cv.notify_all()
            while self._running and len(self._inflight) > self.inflight_depth:
                self._inflight_cv.wait(timeout=DRAIN_POLL_S)

    # ---- readback worker ----

    def _readback_loop(self) -> None:
        """Wait for each in-flight batch in dispatch order, then publish.
        Runs until stopped AND the queue is empty."""
        while True:
            with self._inflight_cv:
                while self._running and not self._inflight:
                    self._inflight_cv.wait(timeout=DRAIN_POLL_S)
                if not self._inflight:
                    return
                host, event, batch, t0, t_disp = self._inflight[0]
            try:
                if event is not None:
                    event.synchronize()
            except RuntimeError:  # a device fault surfaces at the wait
                log.exception("readback failed")
                self.metrics.incr(mn.READBACK_ERRORS, batch.count)
            else:
                self._complete(host.numpy(), batch, t0, t_disp)
            finally:
                self.batcher.recycle(batch.frames)
                with self._inflight_cv:
                    self._inflight.popleft()
                self._mark_completed()

    def _complete(self, packed: np.ndarray, batch, t0: float,
                  t_disp: float) -> None:
        self.metrics.observe(mn.READY_WAIT, time.perf_counter() - t_disp)
        t_pub = time.perf_counter()
        try:
            self._publish(packed, batch)
        except Exception:  # noqa: BLE001 - _publish settled the counts; keep serving
            log.exception("publish failed")
            return
        now = time.perf_counter()
        self.metrics.observe(mn.PUBLISH, now - t_pub)
        self.metrics.observe(mn.BATCH_LATENCY, now - t0)
        mono = time.monotonic()
        for ts in batch.enqueue_ts:
            self.metrics.observe(mn.E2E_LATENCY, mono - ts)

    def _publish(self, packed: np.ndarray, batch) -> None:
        """One result message per real frame: ``{"meta", "faces": [{"box"
        (x0, y0, x1, y1), "detection_score", "label", "name",
        "similarity"}]}``, the reference's schema."""
        result = unpack_result(packed, self.pipeline.top_k)
        published = 0
        try:
            for i in range(batch.count):
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
                self.connector.publish(RESULT_TOPIC, {"meta": batch.metas[i],
                                                      "faces": faces})
                published += 1
                self.metrics.incr(mn.FACES_FOUND, len(faces))
        finally:
            self.metrics.incr(mn.FRAMES_COMPLETED, published)
            if published < batch.count:
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, batch.count - published)
