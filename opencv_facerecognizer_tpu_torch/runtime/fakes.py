"""Scripted serving backends and clocks for deterministic tests: the part
of ``opencv_facerecognizer_tpu/runtime/fakes.py`` the overload, tracing
and signals tests need.

``InstantPipeline`` stands in for ``RecognitionPipeline`` in front of
``RecognizerService``: a dispatch returns at once with a packed result
whose readiness is scripted (``compute_s`` after the dispatch), after
sleeping ``dispatch_s`` on the serving thread (a capacity wall of
``batch_size / dispatch_s`` frames a second). Every frame comes back with
no face, or with ``faces_per_frame`` scripted ones (a fixed box, label 0,
similarity 1). It runs no model and touches no card, so the serving
loop's host side (admission, batching, brownout, publish, spans) is
measurable alone. With ``cascade_stub=True`` it also carries a stage-1
gate: ``cascade_scores`` scores a frame 1.0 when its brightest pixel
reaches 150 (a stamped face) and 0.0 otherwise.

``synthetic_jpeg_frames`` makes seeded camera payloads as real JPEG
bytes, and ``synthetic_frame_stream`` a seeded mix of frames with and
without faces: the reference's generators.

``FakeClock`` is a manual clock with the ``time`` module's interface
(``monotonic``, ``perf_counter``, ``time``, ``sleep``): a test installs it
as a module's ``time`` in both packages and drives their timing alike.
"""

from __future__ import annotations

import threading
import time
from typing import Tuple

import numpy as np
import torch


class FakeClock:
    """A manual clock: ``sleep`` and ``advance`` move it, nothing else."""

    def __init__(self, start: float = 1000.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        return self.monotonic()

    def monotonic(self) -> float:
        with self._lock:
            return self._t

    perf_counter = monotonic

    def time(self) -> float:
        return self.monotonic()

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._t += float(seconds)

    def reset(self, start: float = 1000.0) -> None:
        """Back to ``start``: one script replayed for each package."""
        with self._lock:
            self._t = float(start)

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, float(seconds)))


class FakeReadback:
    """A packed result with scripted readiness, in ``_Readback``'s
    interface: ready ``ready_at`` (``time.monotonic()``) onwards."""

    pending = True

    def __init__(self, packed: np.ndarray, ready_at: float):
        self._packed = packed
        self._ready_at = float(ready_at)

    def ready(self) -> bool:
        return time.monotonic() >= self._ready_at

    def wait(self) -> None:
        delay = self._ready_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)

    def result(self) -> np.ndarray:
        self.wait()
        return self._packed


class _GalleryStub:
    size = 0
    grow_count = 0
    embedder_version = None

    def snapshot(self):
        return ()

    def load_snapshot(self, *parts, embedder_version=None) -> None:
        pass


class InstantPipeline:
    """A pipeline with scripted timing (module docstring). A signature
    (batch, dtype) not prewarmed reads as a cache miss in
    ``last_dispatch_info``, like a step captured after warmup."""

    def __init__(self, frame_shape: Tuple[int, int], top_k: int = 1, max_faces: int = 2,
                 compute_s: float = 0.0, dispatch_s: float = 0.0, faces_per_frame: int = 0,
                 cascade_stub: bool = False):
        self.frame_shape = tuple(frame_shape)
        self.top_k = int(top_k)
        self.max_faces = int(max_faces)
        self.compute_s = float(compute_s)
        self.dispatch_s = float(dispatch_s)
        #: face slots of every frame that come back valid
        self.faces_per_frame = min(int(faces_per_frame), int(max_faces))
        self.face_size = (8, 8)
        self.gallery = _GalleryStub()
        self.dispatches = 0
        #: the batch dimension of every dispatch, in order
        self.batch_sizes_seen: list = []
        #: (batch, dtype) signatures already built; clear it to script a
        #: capture after warmup
        self.compiled_batch_sizes: set = set()
        self.last_dispatch_info: dict = {}
        #: the stage-1 stand-in (module docstring)
        self.cascade = "brightness-stub" if cascade_stub else None
        self.cascade_calls = 0
        #: (batch, dtype) stage-1 signatures already built
        self.compiled_cascade_sigs: set = set()
        self.last_cascade_info: dict = {}

    @staticmethod
    def _sig(batch, dtype) -> tuple:
        return (int(batch), str(np.dtype(dtype)))

    def prewarm_batch_shapes(self, ladder, frame_shape, dtype=np.float32) -> None:
        """Both stages of every rung, as the real pipeline warms them."""
        for bucket in ladder:
            self.compiled_batch_sizes.add(self._sig(bucket, dtype))
            if self.cascade is not None:
                self.compiled_cascade_sigs.add(self._sig(bucket, dtype))

    def cascade_scores(self, frames) -> np.ndarray:
        """[B, H, W] -> [B] scores: 1.0 where the frame's peak reaches 150."""
        host = np.asarray(frames)
        self.cascade_calls += 1
        sig = self._sig(host.shape[0], host.dtype)
        self.last_cascade_info = {"cache_hit": sig in self.compiled_cascade_sigs}
        self.compiled_cascade_sigs.add(sig)
        return (host.reshape(host.shape[0], -1).max(axis=1) >= 150).astype(np.float32)

    def recognize_batch_packed(self, frames) -> FakeReadback:
        host = np.asarray(frames.numpy() if isinstance(frames, torch.Tensor) else frames)
        if self.dispatch_s > 0.0:
            time.sleep(self.dispatch_s)
        self.dispatches += 1
        b = int(host.shape[0])
        self.batch_sizes_seen.append(b)
        sig = self._sig(b, host.dtype)
        self.last_dispatch_info = {"cache_hit": sig in self.compiled_batch_sizes,
                                   "mode": "fake"}
        self.compiled_batch_sizes.add(sig)
        # pack_result's layout: boxes(4) | det_score | valid | labels(k) | sims(k);
        # valid 0 everywhere: no face
        packed = np.zeros((b, self.max_faces, 6 + 2 * self.top_k), np.float32)
        h, w = self.frame_shape
        for j in range(self.faces_per_frame):
            packed[:, j, 0:4] = (2.0, 2.0, max(6.0, h - 2.0), max(6.0, w - 2.0))  # yxyx
            packed[:, j, 4] = 1.0  # det_score
            packed[:, j, 5] = 1.0  # valid
            packed[:, j, 6] = 0.0  # top-1 label
            packed[:, j, 6 + self.top_k] = 1.0  # top-1 similarity
        return FakeReadback(packed, time.monotonic() + self.compute_s)


def _stamp_faces(rng, frame: np.ndarray, n_faces: int) -> None:
    """Stamp ``n_faces`` bright face-ish squares (200, with darker eye
    dots) onto ``frame`` in place at seeded positions."""
    h, w = frame.shape
    for _face in range(int(n_faces)):
        side = int(rng.integers(max(6, h // 8), max(8, h // 3)))
        y0 = int(rng.integers(0, max(1, h - side)))
        x0 = int(rng.integers(0, max(1, w - side)))
        frame[y0:y0 + side, x0:x0 + side] = 200
        ey = y0 + side // 3
        for ex in (x0 + side // 4, x0 + 3 * side // 4):
            frame[max(0, ey - 1):ey + 1, max(0, ex - 1):ex + 1] = 60


def synthetic_jpeg_frames(n: int, frame_hw: Tuple[int, int] = (64, 64), seed: int = 0,
                          quality: int = 85, faces_per_frame: int = 0):
    """``n`` seeded ``(jpeg_bytes, source_frame)`` pairs of uint8 grayscale
    frames (20-90 noise, ``faces_per_frame`` stamped squares); one seed
    gives the same bytes on one codec."""
    from opencv_facerecognizer_tpu_torch.runtime.ingest import encode_jpeg

    rng = np.random.default_rng(seed)
    h, w = int(frame_hw[0]), int(frame_hw[1])
    out = []
    for _ in range(int(n)):
        frame = rng.integers(20, 90, size=(h, w)).astype(np.uint8)
        _stamp_faces(rng, frame, faces_per_frame)
        out.append((encode_jpeg(frame, quality=quality), frame))
    return out


def synthetic_frame_stream(n: int, frame_hw: Tuple[int, int] = (64, 64),
                           face_density: float = 0.3, seed: int = 0,
                           faces_per_frame: int = 1, jpeg: bool = False, quality: int = 85):
    """``n`` seeded uint8 frames of which exactly ``round(n * face_density)``,
    at seeded positions, carry ``faces_per_frame`` stamped faces:
    ``[(frame, n_faces)]``, or ``[(jpeg_bytes, frame, n_faces)]`` with
    ``jpeg=True``. The reference's generator: one seed gives the same
    frames in both packages."""
    n = int(n)
    rng = np.random.default_rng(seed)
    h, w = int(frame_hw[0]), int(frame_hw[1])
    n_faced = int(round(n * float(face_density)))
    faced = np.zeros(n, dtype=bool)
    faced[rng.permutation(n)[:n_faced]] = True
    out = []
    for i in range(n):
        frame = rng.integers(20, 90, size=(h, w)).astype(np.uint8)
        k = int(faces_per_frame) if faced[i] else 0
        _stamp_faces(rng, frame, k)
        if jpeg:
            from opencv_facerecognizer_tpu_torch.runtime.ingest import encode_jpeg

            out.append((encode_jpeg(frame, quality=quality), frame, k))
        else:
            out.append((frame, k))
    return out


def build_overload_stack(frame_shape=(32, 32), batch_size: int = 8, dispatch_s: float = 0.04,
                         max_inflight_frames: int = 24, brownout_queue_wait_s: float = 0.05,
                         brownout_dwell_s: float = 0.3, stale_after_s: float = 0.25,
                         fault_injector=None, journal=None, tracer=None, slo_monitor=None,
                         metrics=None):
    """The reference's overload harness: an ``InstantPipeline`` with a
    ``batch_size / dispatch_s`` frames/s wall behind a ``RecognizerService``
    with the whole protection armed (admission bound, brownout, stale
    shed, a halved ladder). Returns ``(pipeline, service, connector)``."""
    from opencv_facerecognizer_tpu_torch.runtime.admission import AdmissionController
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.resilience import (
        BrownoutPolicy, ResiliencePolicy)

    pipeline = InstantPipeline(frame_shape, dispatch_s=dispatch_s)
    connector = FakeConnector()
    service = RecognizerService(
        pipeline, connector, batch_size=batch_size, frame_shape=frame_shape,
        flush_timeout=0.03, inflight_depth=2, similarity_threshold=0.0, metrics=metrics,
        resilience=ResiliencePolicy(readback_deadline_s=2.0), fault_injector=fault_injector,
        admission=AdmissionController(max_inflight_frames=max_inflight_frames),
        brownout=BrownoutPolicy(queue_wait_s=brownout_queue_wait_s, dwell_s=brownout_dwell_s),
        dead_letter_journal=journal, shed_stale_after_s=stale_after_s,
        bucket_sizes=(max(1, batch_size // 2), batch_size), tracer=tracer,
        slo_monitor=slo_monitor)
    return pipeline, service, connector
