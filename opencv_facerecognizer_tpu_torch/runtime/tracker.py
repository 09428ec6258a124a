"""Temporal identity cache: port of
``opencv_facerecognizer_tpu/runtime/tracker.py``, NumPy on the host as
there.

Per-stream box tracking feeds a track -> identity cache, so a coherent
video stream skips detect + embed + match. The cache gates whole frames:
a frame whose stream's tracks are all confirmed, inside their re-verify
window, appearance-stable at their boxes and stamped with the gallery's
``embedder_version`` settles as ``completed_cached`` with the cached
identities and is never dispatched; every other frame takes the full
path, whose published result answers it and re-verifies the stream
(``update``). Association is greedy IoU with a centroid fallback. The
guarantees:

- no identity is served past the re-verify window (``reverify_frames``),
  and appearance drift at a track's box forces the verify at once;
- a verify that sees another label (or an unknown face) flushes the
  track; the fresh result is what publishes;
- two live tracks overlapping above ``iou_ambiguity`` are both flushed;
- a lookup under another ``embedder_version`` flushes (a cutover starts
  the cache cold);
- the state lives in this object, one per service.

Thread model: ``lookup`` runs on the dispatch thread, ``update`` and
``note_miss`` on the readback worker; one lock guards the registry.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

#: Flush-reason suffixes (``track_flushes_<reason>`` counter family):
#: ``identity`` — re-verify saw a different label / collapsed similarity;
#: ``ambiguity`` — two live tracks overlapped above the IoU ceiling;
#: ``version``  — embedder-version fence (rollout cutover);
#: ``lost``     — track missed too many consecutive full observations;
#: ``reset``    — explicit cold start (gallery reload, flush_all).
FLUSH_IDENTITY = "identity"
FLUSH_AMBIGUITY = "ambiguity"
FLUSH_VERSION = "version"
FLUSH_LOST = "lost"
FLUSH_RESET = "reset"


@dataclass
class TrackerConfig:
    """Operating knobs for the temporal identity cache.

    ``reverify_frames`` is the staleness bound: a confirmed track serves
    at most that many consecutive frames (one of which is the full
    verify) before the next full pass — the window every freshness
    guarantee is stated against. ``brownout_stretch`` multiplies it at
    effective brownout level >= 1 (mirroring the cascade threshold
    notch: shed device work BEFORE shedding intake)."""

    #: full re-verify every N frames per track (``--track-reverify-frames``).
    reverify_frames: int = 8
    #: association floor: a result box claims a track only at IoU >= this
    #: (``--track-iou-min``); below it the centroid fallback may still
    #: associate (small fast faces), else the face is a new track.
    iou_min: float = 0.3
    #: ambiguity ceiling: two LIVE tracks overlapping at IoU >= this are
    #: both flushed — identity can never bleed across crossing tracks.
    iou_ambiguity: float = 0.6
    #: centroid-fallback radius as a fraction of the frame's long side.
    centroid_frac: float = 0.15
    #: consecutive verified associations (with a known identity) before a
    #: track is confirmed and cache-eligible.
    confirm_hits: int = 2
    #: consecutive full observations without an association before a
    #: track is flushed ``lost``.
    miss_ttl: int = 2
    #: median abs pooled-signature cell delta (uint8 levels) that forces
    #: an immediate re-verify: box-local motion only disturbs edge cells
    #: (median ~0), an in-place identity swap or a vacated box moves the
    #: majority of cells by the full content delta.
    drift_threshold: float = 8.0
    #: pooled appearance-signature side (sig_pool x sig_pool block means).
    sig_pool: int = 8
    #: per-stream track registry bound (oldest flushed ``lost`` beyond it).
    max_tracks_per_stream: int = 16
    #: re-verify interval multiplier at effective brownout level >= 1.
    brownout_stretch: float = 2.0


@dataclass(eq=False)
class _Track:
    track_id: int
    box: np.ndarray                # (y0, x0, y1, x1) float32
    label: int
    name: str
    similarity: float
    detection_score: float
    signature: np.ndarray          # (sig_pool, sig_pool) float32
    embedder_version: Optional[int]
    hits: int = 1
    misses: int = 0
    confirmed: bool = False
    frames_since_verify: int = 0
    #: set when a scheduled/drift re-verify is owed — counted once, and
    #: every lookup until the next full association declines the cache.
    pending_verify: bool = False


@dataclass
class _Stream:
    tracks: List[_Track] = field(default_factory=list)
    lookups: int = 0
    hits: int = 0


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (y0, x0, y1, x1) boxes (host floats)."""
    y0 = max(a[0], b[0])
    x0 = max(a[1], b[1])
    y1 = min(a[2], b[2])
    x1 = min(a[3], b[3])
    inter = max(0.0, float(y1 - y0)) * max(0.0, float(x1 - x0))
    if inter <= 0.0:
        return 0.0
    area_a = max(0.0, float(a[2] - a[0])) * max(0.0, float(a[3] - a[1]))
    area_b = max(0.0, float(b[2] - b[0])) * max(0.0, float(b[3] - b[1]))
    denom = area_a + area_b - inter
    return inter / denom if denom > 0.0 else 0.0


def _centroid(box: np.ndarray) -> tuple:
    return (float(box[0] + box[2]) * 0.5, float(box[1] + box[3]) * 0.5)


class IdentityTracker:
    """The track -> identity cache (module docstring). One instance per
    service; the service consults ``lookup`` before dispatch and feeds
    every full published result back through ``update``.
    """

    def __init__(self, config: Optional[TrackerConfig] = None,
                 metrics=None):
        self.config = config or TrackerConfig()
        self.metrics = metrics
        self._lock = threading.Lock()
        self._streams: Dict[Any, _Stream] = {}
        self._next_id = 1
        self._lookups = 0
        self._hits = 0

    # ---- host-side appearance signature ----

    def _signature(self, frame: np.ndarray, box: np.ndarray) -> np.ndarray:
        """Mean-pooled patch at ``box`` (clipped to the frame): a
        sig_pool x sig_pool float32 appearance fingerprint. Pooling
        softens box-edge motion (a 1-2 px drift moves a couple of edge
        cells by a few levels) while an in-place content change (identity
        swap, vacated box) moves most cells by the full fill delta."""
        pool = self.config.sig_pool
        h, w = frame.shape[:2]
        y0 = min(max(int(box[0]), 0), max(0, h - 1))
        x0 = min(max(int(box[1]), 0), max(0, w - 1))
        y1 = min(max(int(np.ceil(box[2])), y0 + 1), h)
        x1 = min(max(int(np.ceil(box[3])), x0 + 1), w)
        patch = np.asarray(frame[y0:y1, x0:x1], dtype=np.float32)
        ys = np.linspace(0, patch.shape[0], pool + 1).astype(int)
        xs = np.linspace(0, patch.shape[1], pool + 1).astype(int)
        # Degenerate-bin guard for patches smaller than the pool grid:
        # every cell spans at least one pixel (clamped to the edge).
        r1s = np.minimum(np.maximum(ys[1:], ys[:-1] + 1), patch.shape[0])
        r0s = np.minimum(ys[:-1], r1s - 1)
        c1s = np.minimum(np.maximum(xs[1:], xs[:-1] + 1), patch.shape[1])
        c0s = np.minimum(xs[:-1], c1s - 1)
        # Integral image gives every cell's block SUM in one vectorized
        # gather — this runs per track per lookup on the dispatch
        # thread, so a Python cell loop here would tax the very latency
        # the cache exists to protect.
        ii = np.zeros((patch.shape[0] + 1, patch.shape[1] + 1), np.float64)
        np.cumsum(patch, axis=0, out=ii[1:, 1:])
        np.cumsum(ii[1:, 1:], axis=1, out=ii[1:, 1:])
        sums = (ii[np.ix_(r1s, c1s)] - ii[np.ix_(r0s, c1s)]
                - ii[np.ix_(r1s, c0s)] + ii[np.ix_(r0s, c0s)])
        areas = np.outer(r1s - r0s, c1s - c0s)
        return (sums / areas).astype(np.float32)

    # ---- metrics plumbing (all under self._lock) ----

    def _incr(self, name: str, value: float = 1.0) -> None:
        if self.metrics is not None:
          
            self.metrics.incr(name, value)

    def _flush(self, stream: _Stream, track: _Track, reason: str) -> None:
        if track in stream.tracks:
            stream.tracks.remove(track)
        self._incr(mn.TRACK_FLUSHES_PREFIX + reason)

    def _set_gauges(self) -> None:
        if self.metrics is None:
            return
        live = sum(len(s.tracks) for s in self._streams.values())
        self.metrics.set_gauge(mn.TRACKS_LIVE, live)
        self.metrics.set_gauge(
            mn.TRACK_CACHE_HIT_RATE, self._hits / max(1, self._lookups))

    # ---- the serving-path API ----

    def lookup(self, stream_key: Any, frame: np.ndarray,
               embedder_version: Optional[int] = None,
               reverify_stretch: float = 1.0) -> Optional[Dict[str, Any]]:
        """Cache verdict for one frame of ``stream_key``: the cached
        result payload (``faces`` shaped exactly like the publish path's,
        each carrying its ``track_id``) when EVERY live track of the
        stream is confirmed, version-matched, inside its re-verify window
        and appearance-stable at its box — else None (the frame takes the
        full pipeline, whose published result re-verifies via
        ``update``). Conservative by design: one doubtful track sends the
        whole frame to the full path."""
        with self._lock:
            self._lookups += 1
            self._incr(mn.TRACK_LOOKUPS)
            st = self._streams.get(stream_key)
            if st is None or not st.tracks:
                self._set_gauges()
                return None
            st.lookups += 1
            # Embedder-version fence: entries verified under another
            # version are dead on arrival — a rollout cutover cold-starts
            # the cache with no coordination.
            if embedder_version is not None:
                stale = [t for t in st.tracks
                         if t.embedder_version is not None
                         and t.embedder_version != embedder_version]
                for t in stale:
                    self._flush(st, t, FLUSH_VERSION)
                if stale:
                    self._set_gauges()
                    return None
            # A tentative track pending confirmation needs full frames to
            # mature (and may be a brand-new entrant the cached faces
            # would omit): no caching until the stream is all-confirmed.
            if any(not t.confirmed for t in st.tracks):
                return None
            interval = max(1, int(round(self.config.reverify_frames
                                        * max(1.0, reverify_stretch))))
            due = False
            sigs = []
            for t in st.tracks:
                if t.pending_verify or t.frames_since_verify + 1 >= interval:
                    if not t.pending_verify:
                        t.pending_verify = True
                        self._incr(mn.TRACK_REVERIFIES)
                    due = True
            if due:
                return None
            for t in st.tracks:
                sig = self._signature(frame, t.box)
                # Median cell delta, not mean: sub-cell box motion moves
                # only the EDGE cells (strongly — a half-cell shift is
                # half the fill/background contrast), so the median over
                # all cells stays ~0, while an in-place content change
                # (identity swap, vacated box) moves EVERY cell by the
                # full delta and the median reports it undiluted.
                if float(np.median(np.abs(sig - t.signature))) \
                        > self.config.drift_threshold:
                    # Appearance moved under a live track: force the full
                    # verify NOW — an in-place identity swap never
                    # survives to the window edge.
                    t.pending_verify = True
                    self._incr(mn.TRACK_REVERIFIES)
                    due = True
                sigs.append(sig)
            if due:
                return None
            faces = []
            for t, sig in zip(st.tracks, sigs):
                t.frames_since_verify += 1
                # Rolling signature: smooth motion/appearance change is
                # followed (each hop is below the drift threshold); an
                # abrupt change still trips on its first frame.
                t.signature = sig
                y0, x0, y1, x1 = (float(v) for v in t.box)
                faces.append({
                    "box": [x0, y0, x1, y1],  # x-first, like _publish
                    "detection_score": t.detection_score,
                    "label": t.label,
                    "name": t.name,
                    "similarity": t.similarity,
                    "track_id": t.track_id,
                })
            self._hits += 1
            st.hits += 1
            self._incr(mn.TRACK_CACHE_HITS)
            self._set_gauges()
            return {"faces": faces,
                    "track_id": st.tracks[0].track_id,
                    "embedder_version": embedder_version}

    def update(self, stream_key: Any, faces: List[Dict[str, Any]],
               frame: np.ndarray,
               embedder_version: Optional[int] = None) -> None:
        """Fold one FULL published result into the stream's tracks:
        greedy-IoU (+ centroid fallback) association, identity
        cross-check (mismatch flushes, the fresh result already
        published), confirmation bookkeeping, miss aging, and the
        pairwise ambiguity sweep. ``faces`` are publish-path dicts
        (x-first ``box``, ``label`` -1 when unknown)."""
        cfg = self.config
        with self._lock:
            st = self._streams.setdefault(stream_key, _Stream())
            boxes = []
            for f in faces:
                x0, y0, x1, y1 = (float(v) for v in f["box"])
                boxes.append(np.asarray([y0, x0, y1, x1], np.float32))
            # Greedy best-IoU association, then a centroid pass for
            # leftovers (fast small faces whose boxes slipped past the
            # IoU floor between verifies).
            pairs = []
            for fi, b in enumerate(boxes):
                for ti, t in enumerate(st.tracks):
                    iou = _iou(b, t.box)
                    if iou >= cfg.iou_min:
                        pairs.append((iou, fi, ti))
            pairs.sort(key=lambda p: -p[0])
            face_used: set = set()
            track_used: set = set()
            matches = []
            for iou, fi, ti in pairs:
                if fi in face_used or ti in track_used:
                    continue
                face_used.add(fi)
                track_used.add(ti)
                matches.append((fi, ti))
            radius = cfg.centroid_frac * float(max(frame.shape[:2]))
            for ti, t in enumerate(st.tracks):
                if ti in track_used:
                    continue
                tc = _centroid(t.box)
                best = None
                for fi, b in enumerate(boxes):
                    if fi in face_used:
                        continue
                    fc = _centroid(b)
                    dist = ((tc[0] - fc[0]) ** 2
                            + (tc[1] - fc[1]) ** 2) ** 0.5
                    if dist <= radius and (best is None or dist < best[0]):
                        best = (dist, fi)
                if best is not None:
                    face_used.add(best[1])
                    track_used.add(ti)
                    matches.append((best[1], ti))
            # Association verdicts are collected first and applied after:
            # a mid-loop flush would shift the indices the match list
            # speaks in. ``matched`` is by object identity.
            flush: List[tuple] = []
            matched: set = set()
            for fi, ti in matches:
                t = st.tracks[ti]
                f = faces[fi]
                label = int(f.get("label", -1))
                known = label >= 0
                matched.add(t)
                if (known and label != t.label) or (t.confirmed and not known):
                    # Verify mismatch: the identity under this box is not
                    # the cached one (swap) or no longer known (occlusion
                    # / collapsed similarity). The track dies; the fresh
                    # result — already published by the caller — is the
                    # only thing ever served. A known new identity seeds
                    # a fresh tentative track below.
                    flush.append((t, FLUSH_IDENTITY))
                    if known:
                        face_used.discard(fi)
                    continue
                t.box = boxes[fi]
                t.signature = self._signature(frame, t.box)
                t.misses = 0
                t.frames_since_verify = 0
                t.pending_verify = False
                t.detection_score = float(f.get("detection_score", 0.0))
                t.embedder_version = embedder_version
                if known:
                    t.similarity = float(f.get("similarity", 0.0))
                    t.name = str(f.get("name", t.name))
                    t.hits += 1
                    if not t.confirmed and t.hits >= cfg.confirm_hits:
                        t.confirmed = True
                        self._incr(mn.TRACKS_CONFIRMED)
            # Identity re-acquisition (teleport/scene-cut recovery): a
            # KNOWN face that box-associated with nothing, when exactly
            # one live unmatched track carries its label, IS that track
            # seen again somewhere else — the full pipeline verified the
            # identity at the new box on THIS frame, so re-seeding keeps
            # the track's confirmed state without ever serving anything
            # unverified (the next cached serve still needs a fresh
            # association against the new box). Any ambiguity — two
            # candidate tracks, or two unmatched faces with the label —
            # falls through to fresh-track seeding instead.
            flushing = {t for t, _r in flush}
            by_label: Dict[int, List[int]] = {}
            for fi, f in enumerate(faces):
                label = int(f.get("label", -1))
                if fi not in face_used and label >= 0:
                    by_label.setdefault(label, []).append(fi)
            live_unmatched = [t for t in st.tracks
                              if t not in matched and t not in flushing]
            for label, fis in by_label.items():
                cands = [t for t in live_unmatched if t.label == label]
                if len(fis) != 1 or len(cands) != 1:
                    continue
                fi, t = fis[0], cands[0]
                f = faces[fi]
                face_used.add(fi)
                matched.add(t)
                t.box = boxes[fi]
                t.signature = self._signature(frame, t.box)
                t.misses = 0
                t.frames_since_verify = 0
                t.pending_verify = False
                t.detection_score = float(f.get("detection_score", 0.0))
                t.embedder_version = embedder_version
                t.similarity = float(f.get("similarity", 0.0))
                t.name = str(f.get("name", t.name))
                t.hits += 1
                if not t.confirmed and t.hits >= cfg.confirm_hits:
                    t.confirmed = True
                    self._incr(mn.TRACKS_CONFIRMED)
            # Unmatched tracks age: a track the full detector stopped
            # seeing must never serve again past its miss budget.
            for t in st.tracks:
                if t in matched:
                    continue
                t.misses += 1
                t.pending_verify = False
                t.frames_since_verify = 0
                if t.misses > cfg.miss_ttl:
                    flush.append((t, FLUSH_LOST))
            for t, reason in flush:
                self._flush(st, t, reason)
            # Unmatched KNOWN faces seed tentative tracks; unknown faces
            # never enter the cache (they would serve "unknown" blindly).
            for fi, f in enumerate(faces):
                if fi in face_used:
                    continue
                label = int(f.get("label", -1))
                if label < 0:
                    continue
                self._next_id += 1
                st.tracks.append(_Track(
                    track_id=self._next_id,
                    box=boxes[fi],
                    label=label,
                    name=str(f.get("name", str(label))),
                    similarity=float(f.get("similarity", 0.0)),
                    detection_score=float(f.get("detection_score", 0.0)),
                    signature=self._signature(frame, boxes[fi]),
                    embedder_version=embedder_version))
                self._incr(mn.TRACKS_CREATED)
            # Ambiguity ceiling: two live tracks overlapping this hard
            # could swap each other's association next frame — flush
            # BOTH immediately, so poisoning can never cross tracks.
            amb: set = set()
            for i in range(len(st.tracks)):
                for j in range(i + 1, len(st.tracks)):
                    if _iou(st.tracks[i].box,
                            st.tracks[j].box) >= cfg.iou_ambiguity:
                        amb.add(st.tracks[i])
                        amb.add(st.tracks[j])
            for t in amb:
                self._flush(st, t, FLUSH_AMBIGUITY)
            # Registry bound: oldest (front of list) flushes first.
            while len(st.tracks) > cfg.max_tracks_per_stream:
                self._flush(st, st.tracks[0], FLUSH_LOST)
            self._set_gauges()

    def note_miss(self, stream_key: Any) -> None:
        """A full pass saw this stream with NO faces (cascade early exit
        or an empty detection): every live track takes a miss; past the
        TTL it flushes ``lost`` — a vanished subject stops being served
        within ``miss_ttl`` full frames."""
        cfg = self.config
        with self._lock:
            st = self._streams.get(stream_key)
            if st is None:
                return
            for t in list(st.tracks):
                t.misses += 1
                # A missed track must re-associate on a full frame before
                # it may serve again — the flag parks it out of the cache
                # without burning a flush it may not deserve (occlusion).
                t.pending_verify = True
                if t.misses > cfg.miss_ttl:
                    self._flush(st, t, FLUSH_LOST)
            self._set_gauges()

    def flush_all(self, reason: str = FLUSH_RESET) -> int:
        """Cold start (gallery reload / explicit reset): every live track
        flushes under ``reason``. Returns the count flushed."""
        with self._lock:
            n = 0
            for st in self._streams.values():
                n += len(st.tracks)
                for _ in range(len(st.tracks)):
                    self._incr(mn.TRACK_FLUSHES_PREFIX + reason)
                st.tracks.clear()
            self._streams.clear()
            self._set_gauges()
            return n

    # ---- observability ----

    def registry(self) -> List[Dict[str, Any]]:
        """Read-only live-track snapshot for ``GET /tracks``."""
        with self._lock:
            out = []
            for key, st in self._streams.items():
                for t in st.tracks:
                    y0, x0, y1, x1 = (float(v) for v in t.box)
                    out.append({
                        "stream": key,
                        "track_id": t.track_id,
                        "box": [x0, y0, x1, y1],
                        "label": t.label,
                        "name": t.name,
                        "similarity": t.similarity,
                        "confirmed": t.confirmed,
                        "hits": t.hits,
                        "misses": t.misses,
                        "frames_since_verify": t.frames_since_verify,
                        "embedder_version": t.embedder_version,
                    })
            return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "streams": len(self._streams),
                "tracks_live": sum(len(s.tracks)
                                   for s in self._streams.values()),
                "lookups": self._lookups,
                "hits": self._hits,
                "hit_rate": self._hits / max(1, self._lookups),
                "reverify_frames": self.config.reverify_frames,
            }
