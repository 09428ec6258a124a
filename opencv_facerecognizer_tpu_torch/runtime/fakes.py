"""Scripted serving backends, traffic and clocks for deterministic tests
and the chaos soak (``apps.chaos_soak``): port of
``opencv_facerecognizer_tpu/runtime/fakes.py``.

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
reaches 150 (a stamped face) and 0.0 otherwise. With ``video_oracle=True``
it reads each frame's faces off its pixels instead: a square filled with
``160 + 24 * i`` (``synthetic_video_stream``) is face ``i`` at that box.

``build_overload_stack`` is the overload harness (the fake behind a
fully protected service), ``build_replica_fleet`` N of them behind one
``TopicRouter``, and ``TrafficRecorder`` stamps offered frames and their
results for completion counts and latency percentiles.

``synthetic_jpeg_frames`` makes seeded camera payloads as real JPEG
bytes, ``synthetic_frame_stream`` a seeded mix of frames with and
without faces, and ``synthetic_video_stream`` seeded multi-camera video
of moving identity squares: the reference's generators.

``FakeClock`` is a manual clock with the ``time`` module's interface
(``monotonic``, ``perf_counter``, ``time``, ``sleep``): a test installs it
as a module's ``time`` in both packages and drives their timing alike.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch


#: the similarity of every face ``video_oracle`` reads off the pixels
ORACLE_SIM = 0.9


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


class FakePacked:
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


#: the name earlier slices' tests use
FakeReadback = FakePacked


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
                 cascade_stub: bool = False, video_oracle: bool = False):
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
        #: read the faces off the pixels (module docstring)
        self.video_oracle = bool(video_oracle)

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

    def recognize_batch_packed(self, frames) -> FakePacked:
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
        if self.video_oracle:
            # one face per identity fill present in the frame, at its mask's box
            for fi in range(b):
                slot = 0
                for v in np.unique(host[fi]):
                    fv = float(v)
                    if fv < 160.0 or fv > 232.0 or (fv - 160.0) % 24.0:
                        continue
                    if slot >= self.max_faces:
                        break
                    ys, xs = np.nonzero(host[fi] == v)
                    packed[fi, slot, 0:4] = (float(ys.min()), float(xs.min()),
                                             float(ys.max()) + 1.0, float(xs.max()) + 1.0)
                    packed[fi, slot, 4] = 1.0  # det_score
                    packed[fi, slot, 5] = 1.0  # valid
                    packed[fi, slot, 6] = (fv - 160.0) / 24.0  # label
                    packed[fi, slot, 6 + self.top_k] = ORACLE_SIM
                    slot += 1
            return FakePacked(packed, time.monotonic() + self.compute_s)
        h, w = self.frame_shape
        for j in range(self.faces_per_frame):
            packed[:, j, 0:4] = (2.0, 2.0, max(6.0, h - 2.0), max(6.0, w - 2.0))  # yxyx
            packed[:, j, 4] = 1.0  # det_score
            packed[:, j, 5] = 1.0  # valid
            packed[:, j, 6] = 0.0  # top-1 label
            packed[:, j, 6 + self.top_k] = 1.0  # top-1 similarity
        return FakePacked(packed, time.monotonic() + self.compute_s)


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


def synthetic_video_stream(n: int, frame_hw: Tuple[int, int] = (64, 64), streams: int = 1,
                           tracks_per_stream: int = 1, coherence: float = 0.9,
                           face_density: float = 1.0, seed: int = 0, step_px: int = 1,
                           identity_swap_at: Optional[int] = None, track_churn: float = 0.0,
                           jpeg: bool = False, quality: int = 85):
    """``n`` seeded frames round-robined over ``streams`` cameras
    (``"cam<s>"``), each carrying ``tracks_per_stream`` identity squares
    filled with ``160 + 24 * (identity % 4)`` (what ``InstantPipeline(
    video_oracle=True)`` reads back as box and label). Per frame a square
    takes a ``±step_px`` step with probability ``coherence``, else jumps;
    with probability ``track_churn`` it is replaced by the next identity
    at a new place; at a stream's frame ``identity_swap_at`` track 0
    changes identity in place; a frame carries its squares with
    probability ``face_density``. Returns ``[(frame, stream_key,
    n_faces)]`` (uint8), or ``[(jpeg_bytes, frame, stream_key, n_faces)]``
    with ``jpeg=True``. The reference's generator: one seed gives the
    same frames in both packages."""
    n = int(n)
    streams = max(1, int(streams))
    rng = np.random.default_rng(seed)
    h, w = int(frame_hw[0]), int(frame_hw[1])
    side = max(8, h // 4)
    step = max(1, int(step_px))

    def _spawn(ident):
        return {"ident": int(ident) % 4, "y": int(rng.integers(0, max(1, h - side))),
                "x": int(rng.integers(0, max(1, w - side)))}

    state = []
    for _s in range(streams):
        tracks = [_spawn(i) for i in range(int(tracks_per_stream))]
        state.append({"tracks": tracks, "frame_idx": 0, "next_ident": int(tracks_per_stream)})
    out = []
    for i in range(n):
        st = state[i % streams]
        for ti, t in enumerate(st["tracks"]):
            if track_churn and rng.random() < float(track_churn):
                st["tracks"][ti] = _spawn(st["next_ident"])
                st["next_ident"] += 1
                continue
            if rng.random() < float(coherence):
                t["y"] = int(np.clip(t["y"] + rng.integers(-step, step + 1), 0, max(0, h - side)))
                t["x"] = int(np.clip(t["x"] + rng.integers(-step, step + 1), 0, max(0, w - side)))
            else:
                t["y"] = int(rng.integers(0, max(1, h - side)))
                t["x"] = int(rng.integers(0, max(1, w - side)))
        if (identity_swap_at is not None and st["frame_idx"] == int(identity_swap_at)
                and st["tracks"]):
            t0 = st["tracks"][0]
            t0["ident"] = (t0["ident"] + 1) % 4
        frame = rng.integers(20, 90, size=(h, w)).astype(np.uint8)
        k = 0
        if rng.random() < float(face_density):
            for t in st["tracks"]:
                frame[t["y"]:t["y"] + side, t["x"]:t["x"] + side] = 160 + 24 * (t["ident"] % 4)
                k += 1
        st["frame_idx"] += 1
        key = "cam%d" % (i % streams)
        if jpeg:
            from opencv_facerecognizer_tpu_torch.runtime.ingest import encode_jpeg

            out.append((encode_jpeg(frame, quality=quality), frame, key, k))
        else:
            out.append((frame, key, k))
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


def build_replica_fleet(n_replicas: int, frame_shape=(32, 32), batch_size: int = 8,
                        dispatch_s: float = 0.04, health_interval_s: float = 0.1,
                        budget_fps=None, router_metrics=None, tracer=None,
                        replica_fault_injectors=None, router_fault_injector=None,
                        link_deadline_s=None, hedge_deadline_s=None,
                        dedup_window: int = 4096):
    """``n_replicas`` overload stacks (``build_overload_stack``), each with
    its own ``Metrics`` and, from ``replica_fault_injectors`` (a list or a
    dict by index), its own injector, behind one ``TopicRouter`` that
    probes each service's health in process. ``router_fault_injector``
    arms the router's transport crossings; the deadlines and the dedup
    window pass to the router. Returns ``(router, stacks)``, each stack
    ``(pipeline, service, connector, metrics)``."""
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReplicaHandle, TopicRouter, service_health_probe)
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    stacks = []
    handles = []
    for i in range(n_replicas):
        metrics = Metrics()
        if isinstance(replica_fault_injectors, dict):
            faults = replica_fault_injectors.get(i)
        elif replica_fault_injectors is not None:
            faults = replica_fault_injectors[i]
        else:
            faults = None
        pipeline, service, connector = build_overload_stack(
            frame_shape=frame_shape, batch_size=batch_size, dispatch_s=dispatch_s,
            metrics=metrics, fault_injector=faults)
        stacks.append((pipeline, service, connector, metrics))
        handles.append(ReplicaHandle(f"replica-{i}", connector,
                                     health_fn=service_health_probe(service),
                                     budget_fps=budget_fps))
    router = TopicRouter(handles, metrics=router_metrics, tracer=tracer,
                         health_interval_s=health_interval_s,
                         fault_injector=router_fault_injector,
                         link_deadline_s=link_deadline_s, hedge_deadline_s=hedge_deadline_s,
                         dedup_window=dedup_window)
    return router, stacks


class TrafficRecorder:
    """Stamps each offered frame (by its ``meta["seq"]``) and the first
    result published for it; reduces to completion counts and latency
    percentiles."""

    def __init__(self, connector):
        from opencv_facerecognizer_tpu_torch.runtime.recognizer import RESULT_TOPIC

        self.send_t: dict = {}
        self.done_t: dict = {}
        self._lock = threading.Lock()
        connector.subscribe(RESULT_TOPIC, self._on_result)

    def _on_result(self, topic, message) -> None:
        seq = (message.get("meta") or {}).get("seq")
        if seq is not None:
            with self._lock:
                self.done_t.setdefault(seq, time.monotonic())

    def offer(self, connector, payload: dict, seq, priority: str,
              meta_extra: Optional[dict] = None) -> None:
        """Stamp and inject one frame message (``payload`` is its
        encoding); the priority rides the admission field and the meta,
        ``meta_extra`` merges more meta keys."""
        from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC

        self.send_t[seq] = time.monotonic()
        meta = {"seq": seq, "pri": priority}
        if meta_extra:
            meta.update(meta_extra)
        connector.inject(FRAME_TOPIC, {**payload, "priority": priority, "meta": meta})

    def completed(self, seqs) -> int:
        with self._lock:
            return sum(1 for s in seqs if s in self.done_t)

    def latencies(self, seqs):
        with self._lock:
            return [self.done_t[s] - self.send_t[s] for s in seqs if s in self.done_t]

    def percentile_ms(self, seqs, q: float) -> float:
        """The ``q`` percentile of the completed ``seqs``' latencies in ms;
        NaN when none completed."""
        lat = self.latencies(seqs)
        if not lat:
            return float("nan")
        return float(np.percentile(lat, q)) * 1e3
