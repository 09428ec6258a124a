"""Ingest: the frames' way from the connector to the card. Port of
``opencv_facerecognizer_tpu/runtime/ingest.py``.

- **Staging ring** (``StagingRing``): pre-allocated host staging buffers,
  a small pool per dispatch-bucket rung, recycled. On a CUDA service the
  buffers are pinned host memory (``torch.empty(..., pin_memory=True)``,
  handed to the batcher as numpy views), so the upload is a true
  asynchronous copy. Steady serving allocates nothing
  (``ingest_staging_allocs`` stays at the preallocation); an exhausted
  ring keeps the batch queued and admission rejects new intake (reason
  ``staging``). A buffer whose upload may still be reading it carries a
  fence (the upload's CUDA event): ``release`` returns it to the pool only
  once the fence has passed, else parks it until a later ``acquire`` or
  ``release`` finds it passed. A forfeited buffer (dead letter, crash)
  never comes back; it opens one replacement allocation.
- **Upload** (``IngestPipeline.upload``): one explicit copy per dispatch
  attempt, host staging view -> a device buffer, ``copy_(non_blocking=
  True)`` on a dedicated upload stream, an event recorded behind it, and
  the serving stream waits on that event before the step. The device
  buffer is recorded on the serving stream, so the allocator hands it out
  again only after the step read it. A failed copy raises; nothing falls
  back to a pageable copy. On the CPU (the tests) the view goes through
  as a tensor over the same bytes.
- **JPEG decode pool** (``DecodeWorkerPool``): compressed payloads
  (``{"__jpeg__": base64}``) are decoded off the connector thread by a
  few workers and handed to the service's intake; a corrupt payload costs
  one frame (``frames_dropped_decode``, journal reason ``decode_error``),
  never a worker. The codec is PIL, else cv2, resolved once; without
  either the pool raises at construction.

Lock order: the batcher acquires ring buffers under its own lock
(``FrameBatcher._lock -> StagingRing._lock``); the ring never calls back
into the batcher or ``Metrics`` under its lock.
"""

from __future__ import annotations

import base64
import logging
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

log = logging.getLogger(__name__)

#: the modes of ``--ingest-mode``
INGEST_MODES = ("f32", "uint8", "jpeg")

#: wire key of a compressed frame (base64 JPEG bytes), the compressed
#: sibling of ``connector.encode_frame``'s ``__frame__``
JPEG_KEY = "__jpeg__"


def resolve_ingest_mode(ingest_mode: Optional[str], transfer_uint8: bool = False,
                        warn: bool = True) -> str:
    """The CLI's mode: ``--ingest-mode``, else ``uint8`` for the deprecated
    ``--transfer-uint8`` alias (warned), else ``f32``."""
    if transfer_uint8:
        if warn:
            warnings.warn("--transfer-uint8 is deprecated and will be removed next release; "
                          "it now aliases --ingest-mode uint8 (the pinned staging-ring "
                          "upload path)", DeprecationWarning, stacklevel=2)
        if ingest_mode is None:
            return "uint8"
    mode = ingest_mode or "f32"
    if mode not in INGEST_MODES:
        raise ValueError(f"unknown ingest mode {mode!r} (valid: {INGEST_MODES})")
    return mode


def encode_jpeg_message(jpeg_bytes: bytes) -> Dict[str, Any]:
    """JPEG bytes -> the frame topic's payload (merge ``meta`` and
    ``priority`` in beside it)."""
    return {JPEG_KEY: base64.b64encode(bytes(jpeg_bytes)).decode("ascii")}


def decode_jpeg_payload(message: Dict[str, Any]) -> bytes:
    return base64.b64decode(message[JPEG_KEY])


#: (encode, decode) of the codec found, resolved once per process
_CODEC_CACHE: Optional[Tuple[Any, Any]] = None


def _jpeg_codec():
    """(encode_fn, decode_fn) over PIL, else cv2, else (None, None)."""
    global _CODEC_CACHE
    if _CODEC_CACHE is None:
        _CODEC_CACHE = _resolve_jpeg_codec()
    return _CODEC_CACHE


def _resolve_jpeg_codec():
    try:
        import io

        from PIL import Image

        def encode(frame: np.ndarray, quality: int = 85) -> bytes:
            buf = io.BytesIO()
            Image.fromarray(np.asarray(frame, np.uint8), mode="L").save(
                buf, format="JPEG", quality=int(quality))
            return buf.getvalue()

        def decode(data: bytes) -> np.ndarray:
            with Image.open(io.BytesIO(data)) as img:
                return np.asarray(img.convert("L"))

        return encode, decode
    except ImportError:
        pass
    try:
        import cv2

        def encode(frame: np.ndarray, quality: int = 85) -> bytes:
            ok, buf = cv2.imencode(".jpg", np.asarray(frame, np.uint8),
                                   [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
            if not ok:
                raise ValueError("cv2.imencode failed")
            return buf.tobytes()

        def decode(data: bytes) -> np.ndarray:
            arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
            if arr is None:
                raise ValueError("cv2.imdecode failed")
            return arr

        return encode, decode
    except ImportError:
        return None, None


def jpeg_supported() -> bool:
    return _jpeg_codec()[0] is not None


def encode_jpeg(frame: np.ndarray, quality: int = 85) -> bytes:
    """Grayscale [H, W] frame -> baseline JPEG bytes."""
    encode, _ = _jpeg_codec()
    if encode is None:
        raise RuntimeError("no JPEG codec available (PIL or cv2 required)")
    return encode(np.clip(np.asarray(frame), 0, 255).astype(np.uint8), quality)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> grayscale [H, W] uint8 frame; raises on a corrupt or
    truncated payload."""
    _, decode = _jpeg_codec()
    if decode is None:
        raise RuntimeError("no JPEG codec available (PIL or cv2 required)")
    arr = np.asarray(decode(bytes(data)))
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError(f"decoded JPEG has shape {arr.shape}, expected a 2-D grayscale frame")
    return arr


@dataclass
class IngestConfig:
    """The ``ocvf-recognize --ingest-*`` knobs."""

    #: ``f32`` (float staging), ``uint8`` (4x fewer bytes, cast on the
    #: card) or ``jpeg`` (uint8, compressed intake decoded off the thread)
    mode: str = "f32"
    #: staging buffers per rung; None sizes it ``inflight_depth + 2``
    ring_depth: Optional[int] = None
    #: decode worker threads (jpeg mode)
    decode_workers: int = 2
    #: bounded decode queue: beyond it a frame drops (``decode_backlog``)
    decode_queue: int = 128

    def __post_init__(self):
        if self.mode not in INGEST_MODES:
            raise ValueError(f"unknown ingest mode {self.mode!r} (valid: {INGEST_MODES})")
        if self.ring_depth is not None:
            self.ring_depth = max(1, int(self.ring_depth))
        self.decode_workers = max(1, int(self.decode_workers))
        self.decode_queue = max(1, int(self.decode_queue))

    def resolve_ring_depth(self, inflight_depth: int) -> int:
        """The explicit depth, or ``inflight_depth + 2``: every batch in
        flight holds a buffer, plus the one being assembled and one
        completing."""
        if self.ring_depth is not None:
            return self.ring_depth
        return max(1, int(inflight_depth)) + 2

    @property
    def transfer_dtype(self):
        return np.float32 if self.mode == "f32" else np.uint8


def _address(buf: np.ndarray) -> int:
    return int(buf.__array_interface__["data"][0])


class StagingRing:
    """Recycled pre-allocated host staging buffers, one pool per rung
    (module docstring). ``acquire(count)`` hands a free buffer of the
    smallest rung that fits (falling upward), or None when every fitting
    rung is in flight: the caller waits, never allocates. Thread-safe."""

    def __init__(self, rung_sizes: Sequence[int], frame_shape: Tuple[int, int], dtype,
                 depth: int = 2, metrics=None, pinned: bool = False):
        rungs = sorted({int(r) for r in rung_sizes if int(r) > 0})
        if not rungs:
            raise ValueError("StagingRing needs at least one rung size")
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.depth = max(1, int(depth))
        self.rungs = rungs
        self.metrics = metrics
        #: buffers in page-locked host memory (a CUDA service's ring)
        self.pinned = bool(pinned)
        self._lock = threading.Lock()
        self._free: Dict[int, deque] = {r: deque(self._alloc(r) for _ in range(self.depth))
                                        for r in rungs}
        self._forfeited: Dict[int, int] = {r: 0 for r in rungs}
        #: buffer address -> the fence (``query()``) of its pending upload
        self._fences: Dict[int, Any] = {}
        #: released buffers whose fence had not passed yet
        self._fenced: List[Tuple[np.ndarray, Any]] = []
        self._notify: List[Callable[[], None]] = []
        # lock-free mirror of the top rung's free + heal count, written
        # under the lock, read bare by the admission check
        self._top_free = self.depth
        #: buffers ever allocated (preallocation + outage heals)
        self.alloc_count = len(rungs) * self.depth
        self.preallocated = self.alloc_count
        if metrics is not None:
            metrics.incr(mn.INGEST_STAGING_ALLOCS, self.preallocated)
            metrics.set_gauge(mn.INGEST_STAGING_FREE, self.preallocated)

    def _alloc(self, rung: int) -> np.ndarray:
        shape = (rung, *self.frame_shape)
        if not self.pinned:
            return np.zeros(shape, self.dtype)
        host = torch.zeros(shape, dtype=torch.from_numpy(np.empty(0, self.dtype)).dtype,
                           pin_memory=True)
        return host.numpy()  # the view keeps the pinned tensor alive

    def add_notify(self, fn: Callable[[], None]) -> None:
        """A release notification (the batcher's consumer wake), called
        outside the ring lock."""
        self._notify.append(fn)

    def _fitting(self, count: int) -> List[int]:
        fits = [r for r in self.rungs if r >= count]
        return fits or [self.rungs[-1]]

    def _refresh_top_free_locked(self) -> None:
        top = self.rungs[-1]
        self._top_free = len(self._free[top]) + self._forfeited[top]

    def _sweep_fenced_locked(self) -> bool:
        """Return parked buffers whose fence has passed to their pools
        (an event query each; never a wait). True when any returned."""
        if not self._fenced:
            return False
        still = []
        returned = False
        for buf, fence in self._fenced:
            if fence.query():
                self._free[buf.shape[0]].append(buf)
                returned = True
            else:
                still.append((buf, fence))
        self._fenced = still
        return returned

    def fence(self, buf: np.ndarray, fence: Any) -> None:
        """Mark ``buf``'s bytes as still being read until ``fence.query()``
        is True (the upload's event)."""
        with self._lock:
            self._fences[_address(buf)] = fence

    def acquire(self, count: int, quiet: bool = False) -> Optional[np.ndarray]:
        """A free buffer of the smallest fitting rung, or None (exhausted:
        wait and retry). ``quiet`` marks a parked consumer's re-check, so
        ``ingest_staging_exhausted`` counts episodes, not polls."""
        buf = None
        healed = False
        with self._lock:
            self._sweep_fenced_locked()
            fits = self._fitting(count)
            for rung in fits:
                if self._free[rung]:
                    buf = self._free[rung].popleft()
                    break
            if buf is None:
                # a forfeited buffer never comes back: replace it once
                for rung in fits:
                    if self._forfeited[rung] > 0:
                        self._forfeited[rung] -= 1
                        buf = self._alloc(rung)
                        self.alloc_count += 1
                        healed = True
                        break
            self._refresh_top_free_locked()
            free_now = sum(len(q) for q in self._free.values())
        if self.metrics is not None:
            if buf is None:
                if not quiet:
                    self.metrics.incr(mn.INGEST_STAGING_EXHAUSTED)
            elif healed:
                self.metrics.incr(mn.INGEST_STAGING_ALLOCS)
            else:
                self.metrics.incr(mn.INGEST_STAGING_REUSE)
            self.metrics.set_gauge(mn.INGEST_STAGING_FREE, free_now)
        return buf

    def release(self, buf) -> None:
        """Return a buffer once its batch is done with it (readback
        complete, no views kept). A buffer whose upload fence has not
        passed is parked until it has. Foreign shapes and dtypes are
        dropped silently."""
        if (not isinstance(buf, np.ndarray) or buf.dtype != self.dtype
                or buf.ndim != 1 + len(self.frame_shape)
                or buf.shape[1:] != self.frame_shape or buf.shape[0] not in self._free):
            return
        rung = buf.shape[0]
        returned = False
        with self._lock:
            returned = self._sweep_fenced_locked()
            fence = self._fences.pop(_address(buf), None)
            held = len(self._free[rung]) + sum(1 for b, _f in self._fenced
                                               if b.shape[0] == rung)
            if held < self.depth + self._forfeited[rung]:
                if fence is not None and not fence.query():
                    self._fenced.append((buf, fence))
                else:
                    self._free[rung].append(buf)
                    returned = True
            self._refresh_top_free_locked()
            free_now = sum(len(q) for q in self._free.values())
        if returned:
            for fn in self._notify:
                fn()
        if self.metrics is not None:
            self.metrics.set_gauge(mn.INGEST_STAGING_FREE, free_now)

    def forfeit(self, buf) -> None:
        """One in-flight buffer will never come back (dead letter, crash:
        a copy of it may still be pending): it stays out of circulation
        and opens one replacement allocation for its rung."""
        if (not isinstance(buf, np.ndarray) or buf.ndim != 1 + len(self.frame_shape)
                or buf.shape[0] not in self._free):
            return
        with self._lock:
            self._fences.pop(_address(buf), None)
            self._forfeited[buf.shape[0]] += 1
            self._refresh_top_free_locked()
        if self.metrics is not None:
            self.metrics.incr(mn.INGEST_STAGING_FORFEITS)

    def free_slots(self) -> int:
        """Free buffers of the largest rung plus its heal credits: the
        admission's ``staging`` signal. Lock-free (it runs for every
        offered frame): a stale read only shifts which frame a flood
        sheds."""
        return self._top_free

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"rungs": list(self.rungs), "depth": self.depth,
                    "free": {r: len(q) for r, q in self._free.items()},
                    "forfeited": dict(self._forfeited),
                    "alloc_count": self.alloc_count, "preallocated": self.preallocated}


class DecodeWorkerPool:
    """A few threads decoding compressed payloads off the connector
    thread (module docstring). ``submit`` enqueues one admitted payload
    (False when the bounded queue is full: the caller settles the drop);
    a worker decodes it and calls ``sink(frame, message, priority,
    trace_id)``, or ``on_error(message, priority, trace_id, reason)`` when
    it fails, or when the sink raises. A worker counts busy until that
    call returns, so ``idle()`` covers frames in transit. The ``decode``
    fault boundary (``runtime.faults``) runs before the decode."""

    def __init__(self, workers: int = 2, max_queue: int = 128,
                 decode_fn: Optional[Callable[[bytes], np.ndarray]] = None, metrics=None,
                 tracer=None, trace_topic: Optional[str] = None, fault_injector=None):
        if decode_fn is None and not jpeg_supported():
            raise RuntimeError("compressed-frame intake needs a JPEG codec (PIL or cv2); "
                               "neither is importable here: pass decode_fn or use "
                               "--ingest-mode uint8")
        self.workers = max(1, int(workers))
        self.max_queue = max(1, int(max_queue))
        self._decode = decode_fn or decode_jpeg
        self.metrics = metrics
        self._tracer = tracer
        self._trace_topic = trace_topic
        self._faults = fault_injector
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._busy = 0
        self._running = False
        self._threads: List[threading.Thread] = []
        self._sink: Optional[Callable] = None
        self._on_error: Optional[Callable] = None

    def start(self, sink: Callable, on_error: Callable) -> None:
        if self._running:
            return
        self._sink = sink
        self._on_error = on_error
        self._running = True
        for i in range(self.workers):
            thread = threading.Thread(target=self._run, daemon=True, name=f"ocvf-decode-{i}")
            thread.start()
            self._threads.append(thread)

    def stop(self) -> None:
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for thread in self._threads:
            thread.join(timeout=2.0)
        self._threads.clear()

    def submit(self, message: Dict[str, Any], priority: int, trace_id: int) -> bool:
        with self._cv:
            if not self._running or len(self._q) >= self.max_queue:
                accepted = False
            else:
                self._q.append((message, int(priority), int(trace_id)))
                accepted = True
                depth = len(self._q)
                self._cv.notify()
        if accepted and self.metrics is not None:
            self.metrics.set_gauge(mn.DECODE_QUEUE_DEPTH, depth)
        return accepted

    def idle(self) -> bool:
        """Queue empty and no worker mid-decode (or mid-sink)."""
        with self._cv:
            return not self._q and self._busy == 0

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._q:
                    self._cv.wait()
                if not self._q:
                    if not self._running:
                        return
                    continue
                message, priority, tid = self._q.popleft()
                self._busy += 1
                depth = len(self._q)
            try:
                if self.metrics is not None:
                    self.metrics.set_gauge(mn.DECODE_QUEUE_DEPTH, depth)
                self._decode_one(message, priority, tid)
            except Exception:  # noqa: BLE001 - costs one frame's accounting, never the worker
                log.exception("decode worker iteration failed")
                if self.metrics is not None:
                    self.metrics.incr(mn.DECODE_ERRORS)
            finally:
                with self._cv:
                    self._busy -= 1

    def _decode_one(self, message, priority: int, tid: int) -> None:
        t0 = time.perf_counter()
        try:
            payload = decode_jpeg_payload(message)
            if self._faults is not None:
                payload = self._faults.on_decode(payload)
            frame = self._decode(payload)
        except Exception:  # noqa: BLE001 - corrupt payloads are what the pool contains
            if self.metrics is not None:
                self.metrics.incr(mn.DECODE_ERRORS)
                self.metrics.observe(mn.DECODE_LATENCY, time.perf_counter() - t0)
            if self._tracer is not None and tid:
                self._tracer.emit(tid, "decode", topic=self._trace_topic,
                                  dur=time.perf_counter() - t0, ok=False)
            self._settle_error(message, priority, tid)
            return
        dur = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.incr(mn.DECODE_FRAMES)
            self.metrics.observe(mn.DECODE_LATENCY, dur)
        if self._tracer is not None and tid:
            self._tracer.emit(tid, "decode", topic=self._trace_topic, dur=dur, ok=True)
        try:
            self._sink(frame, message, priority, tid)
        except Exception:  # noqa: BLE001 - a raising intake costs this frame, never a worker
            log.exception("decode sink failed; settling the frame as a decode drop")
            if self.metrics is not None:
                self.metrics.incr(mn.DECODE_ERRORS)
            self._settle_error(message, priority, tid)

    def _settle_error(self, message, priority: int, tid: int) -> None:
        """One failed frame to ``on_error``; its own failure is logged and
        counted, never raised (the worker outlives it)."""
        try:
            self._on_error(message, priority, tid, "decode_error")
        except Exception:  # noqa: BLE001 - the worker must outlive a broken callback
            log.exception("decode on_error callback failed; the frame may be unsettled")
            if self.metrics is not None:
                self.metrics.incr(mn.DECODE_ERRORS)


class IngestPipeline:
    """The ingest of one ``RecognizerService``: the staging ring, the
    decode pool (jpeg mode) and the upload to ``device`` (module
    docstring). ``start``/``stop`` run the decode workers; ``upload`` runs
    on the dispatch path, once per dispatch attempt."""

    def __init__(self, config: IngestConfig, rung_sizes: Sequence[int],
                 frame_shape: Tuple[int, int], metrics=None, tracer=None,
                 trace_topic: Optional[str] = None, fault_injector=None, decode_fn=None,
                 inflight_depth: int = 4, device=None):
        self.config = config
        self.metrics = metrics
        self.transfer_dtype = np.dtype(config.transfer_dtype)
        self.device = None if device is None else torch.device(device)
        cuda = self.device is not None and self.device.type == "cuda"
        self.staging = StagingRing(rung_sizes, frame_shape, self.transfer_dtype,
                                   depth=config.resolve_ring_depth(inflight_depth),
                                   metrics=metrics, pinned=cuda)
        self.decoder = None
        if config.mode == "jpeg":
            self.decoder = DecodeWorkerPool(workers=config.decode_workers,
                                            max_queue=config.decode_queue,
                                            decode_fn=decode_fn, metrics=metrics,
                                            tracer=tracer, trace_topic=trace_topic,
                                            fault_injector=fault_injector)
        #: the upload stream, made at the first upload on the card
        self._stream = None

    def start(self, sink: Callable, on_error: Callable) -> None:
        if self.decoder is not None:
            self.decoder.start(sink, on_error)

    def stop(self) -> None:
        if self.decoder is not None:
            self.decoder.stop()

    def idle(self) -> bool:
        return self.decoder is None or self.decoder.idle()

    def submit_decode(self, message: Dict[str, Any], priority: int, trace_id: int) -> bool:
        if self.decoder is None:
            return False
        return self.decoder.submit(message, priority, trace_id)

    def upload(self, frames: np.ndarray) -> Tuple[Any, int, float]:
        """One staged batch view to the device: ``(device_frames, nbytes,
        enqueue_seconds)``. On the card the copy is asynchronous on the
        upload stream; the seconds are the host's enqueue cost (the
        transfer itself lands in ``ready_wait``). The staging buffer is
        fenced by the copy's event. Off the card the view goes on as a
        tensor over the same host bytes."""
        nbytes = int(frames.nbytes)
        t0 = time.perf_counter()
        src = torch.from_numpy(frames)
        if self.device is None or self.device.type != "cuda":
            out = src  # the CPU step reads the staged bytes where they are
        else:
            if not src.is_pinned():
                raise RuntimeError("ingest upload from pageable memory: the staging "
                                   "buffer is not pinned")
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            serving = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self._stream):
                out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                out.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            serving.wait_event(event)
            # the step reads ``out`` on the serving stream: the allocator
            # hands its block out again only after that read
            out.record_stream(serving)
            self.staging.fence(frames, event)
        dur = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.incr(mn.INGEST_UPLOAD_BYTES, nbytes)
            self.metrics.observe(mn.INGEST_UPLOAD, dur)
        return out, nbytes, dur

    def stats(self) -> Dict[str, Any]:
        out = {"mode": self.config.mode, "transfer_dtype": str(self.transfer_dtype),
               "pinned": self.staging.pinned, "staging": self.staging.stats()}
        if self.decoder is not None:
            out["decode_queue_depth"] = self.decoder.queue_depth()
        return out
