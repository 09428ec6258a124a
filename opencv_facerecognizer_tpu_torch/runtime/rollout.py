"""Embedder rollout: the staged re-embed, the dual-score parity window and
the fenced cutover. Port of ``opencv_facerecognizer_tpu/runtime/rollout.py``;
a stage file written by either package is read by the other.

- **Version fence**: ``ShardedGallery.embedder_version`` names the one
  space every served row lives in. The state store stamps it into
  checkpoints and WAL rows and refuses an enrolment embedded by another
  version (``EmbedderVersionMismatchError``, no seq burned); replay never
  applies a row across the fence.
- **Staged re-embed** (``ReEmbedStage``): the gallery's rows, mapped into
  the new space off the serving threads, are appended in fixed chunks to
  ``rollout/stage-v<N>.jsonl`` (base64 rows, a crc32 each, fsync every
  chunk, a torn tail sealed at open). A kill at any point resumes from the
  contiguous watermark; the re-embed is deterministic over append-only
  source rows, so a re-staged chunk is bit for bit the same. The live
  gallery is untouched until the cutover.
- **Dual-score parity** (``DualScoreParity``): faces sampled off the
  publish path (``offer_live``) go through both embedders on the rollout
  thread; top-1 label agreement (host math over the galleries' f32 rows)
  over a sliding window must clear a threshold at a sample floor before a
  cutover is allowed (``rollout_parity_*`` gauges,
  ``runtime.slo.rollout_parity_objective``).
- **Cutover** (``RolloutCoordinator.cutover`` ->
  ``StateLifecycle.perform_cutover``): under the enroll lock the last
  rows are staged, the ``cutover`` fence record is fsynced, and the
  gallery installs the new rows and version in one publish (a batch in
  flight keeps the snapshot it matched; the quantizer retrains). A forced
  checkpoint follows and the stage file is discarded once it lands;
  until then recovery completes the cutover from the stage. **Rollback**
  is the same mechanism towards the prior space, at the next version.

Every published result's ``embedder_version`` moves from old to new once
and is never mixed within a batch.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
from opencv_facerecognizer_tpu_torch.runtime.state_store import (
    EmbedderVersionMismatchError, StateLifecycle)
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC

__all__ = ["DualScoreParity", "EmbedderVersionMismatchError", "ReEmbedStage",
           "RolloutCoordinator", "RolloutGateError", "RolloutStateError", "load_stage",
           "stage_path"]

logger = logging.getLogger(__name__)

#: state-dir subdirectory holding staged re-embed progress journals.
ROLLOUT_DIR = "rollout"

#: phase gauge codes (``rollout_phase`` on /prom).
PHASE_CODES = {"idle": 0, "staging": 1, "parity": 2, "ready": 3,
               "cutover": 4, "done": 5}


class RolloutStateError(RuntimeError):
    """Durable rollout state (the staged shard set) is missing or damaged
    where correctness requires it — e.g. recovery found a fsynced cutover
    fence but the stage file no longer covers the promised rows. Fails
    CLOSED: serving a mixed- or partially-migrated gallery is the one
    outcome this subsystem exists to prevent."""


class RolloutGateError(RuntimeError):
    """Cutover refused: the staged re-embed is not caught up or the
    dual-score parity window has not cleared its gate. ``force=True``
    overrides (the operator's explicit judgment call)."""


def stage_path(state_dir: str, to_version: int) -> str:
    return os.path.join(str(state_dir), ROLLOUT_DIR,
                        f"stage-v{int(to_version)}.jsonl")


def _l2norm(rows: np.ndarray) -> np.ndarray:
    rows = np.asarray(rows, np.float32)
    return rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True),
                             1e-12)


def _decode_stage_chunk(record: Dict[str, Any]
                        ) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
    """Validate + decode one parsed stage chunk -> (start, emb, labels),
    or None when the record fails its crc/shape checks (a torn-then-
    sealed remnant, or media damage — the caller decides whether a gap
    is fatal)."""
    try:
        raw = base64.b64decode(record["emb"], validate=True)
        if (binascii.crc32(raw) & 0xFFFFFFFF) != record["crc32"]:
            return None
        n, dim = int(record["n"]), int(record["dim"])
        emb = np.frombuffer(raw, np.float32)
        if emb.size != n * dim:
            return None
        labels = np.asarray(record["labels"], np.int32)
        if labels.shape[0] != n:
            return None
        return int(record["start"]), emb.reshape(n, dim), labels
    except (KeyError, TypeError, ValueError, binascii.Error):
        return None


def _read_stage_file(path: str) -> Tuple[Optional[Dict[str, Any]],
                                         Dict[int, Tuple[np.ndarray,
                                                         np.ndarray]], int]:
    """Parse one stage journal -> (begin record or None, {start: (emb,
    labels)} with later duplicates winning, torn/invalid line count).
    Pure read — shared by the owning ``ReEmbedStage`` (resume) and the
    recovery-side ``load_stage`` (which must never write)."""
    begin: Optional[Dict[str, Any]] = None
    chunks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    bad = 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            lines = fh.read().split("\n")
    except OSError:
        return None, {}, 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
            if not isinstance(record, dict):
                raise ValueError("not an object")
        except (json.JSONDecodeError, ValueError):
            bad += 1
            continue
        kind = record.get("kind")
        if kind == "stage_begin" and begin is None:
            begin = record
        elif kind == "stage":
            decoded = _decode_stage_chunk(record)
            if decoded is None:
                bad += 1
                continue
            start, emb, labels = decoded
            chunks[start] = (emb, labels)
    return begin, chunks, bad


def _coverage(chunks: Dict[int, Tuple[np.ndarray, np.ndarray]]) -> int:
    """Contiguous watermark: the largest W with rows [0, W) fully staged.
    Chunks may overlap after a crash-resume (the re-staged chunk is
    bit-identical — re-embedding is deterministic over append-only
    source rows), so walk starts in order and extend greedily."""
    watermark = 0
    for start in sorted(chunks):
        n = chunks[start][0].shape[0]
        if start <= watermark < start + n or start == watermark:
            watermark = max(watermark, start + n)
        elif start > watermark:
            break  # gap: nothing past it is contiguous
    return watermark


def load_stage(state_dir: str, to_version: int,
               expect_rows: Optional[int] = None,
               expect_dim: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Recovery-side loader: the staged shard set as ``(embeddings
    [rows, dim], labels [rows])`` — strictly read-only (the recovering
    process may be completing another process's cutover). Raises
    ``RolloutStateError`` when the file is absent, mis-headed, or does
    not contiguously cover ``expect_rows`` — the fence record promised
    those rows were durable, so anything less is media damage and the
    caller must fail closed, never serve a partial migration."""
    path = stage_path(state_dir, to_version)
    begin, chunks, _bad = _read_stage_file(path)
    if begin is None:
        raise RolloutStateError(
            f"stage file {path} is missing or headerless, but a durable "
            f"cutover record references it — cannot complete the cutover "
            f"(restore the rollout/ directory or roll back)")
    if int(begin.get("to_version", -1)) != int(to_version) or (
            expect_dim is not None
            and int(begin.get("dim", -1)) != int(expect_dim)):
        raise RolloutStateError(
            f"stage file {path} header disagrees with the cutover record "
            f"(header: {begin}, wanted to_version={to_version} "
            f"dim={expect_dim})")
    watermark = _coverage(chunks)
    rows = int(expect_rows) if expect_rows is not None else watermark
    if watermark < rows:
        raise RolloutStateError(
            f"stage file {path} covers only {watermark} contiguous rows "
            f"of the {rows} the cutover record promised — damaged stage; "
            f"refusing a partial migration")
    dim = int(begin["dim"])
    emb = np.zeros((rows, dim), np.float32)
    labels = np.zeros((rows,), np.int32)
    for start in sorted(chunks):
        c_emb, c_lab = chunks[start]
        if start >= rows:
            continue
        end = min(rows, start + c_emb.shape[0])
        emb[start:end] = c_emb[:end - start]
        labels[start:end] = c_lab[:end - start]
    return emb, labels


class ReEmbedStage:
    """Crash-safe staged re-embed progress for one target version
    (module docstring). Append-only JSONL, fsync on every chunk: the
    watermark visible after ANY kill is exactly the set of chunks whose
    append returned. Single-writer by contract — the rollout thread (or
    the cutover's locked finalize) owns it."""

    def __init__(self, state_dir: str, to_version: int, dim: int,
                 from_version: int = 1, metrics=None, fault_injector=None):
        self.state_dir = str(state_dir)
        self.to_version = int(to_version)
        self.from_version = int(from_version)
        self.dim = int(dim)
        self.metrics = metrics
        self._faults = fault_injector
        self.path = stage_path(state_dir, to_version)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._chunks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.watermark = 0
        self.resumed = False
        self._load_or_begin()

    # ---- durable file plumbing ----

    def _append_line(self, text: str, newline: bool = True) -> None:
        if self._faults is not None:
            # Storage boundary (disk stays broken — distinct from the
            # ``stage`` kill-point faults): an injected ENOSPC/EIO raises
            # out of stage_chunk before the watermark advances, exactly
            # like a real full disk; the rollout loop's existing
            # stage-error handling owns it.
            self._faults.on_storage("stage_append")
        # append-only, as the WAL: a fsynced record never changes, a torn
        # tail is sealed at open and skipped by the crc-checked reader
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(text + ("\n" if newline else ""))
            fh.flush()
            os.fsync(fh.fileno())

    def _seal_torn_tail(self) -> None:
        try:
            if not os.path.getsize(self.path):
                return
            with open(self.path, "rb+") as fh:
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")
                    fh.flush()
                    os.fsync(fh.fileno())
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.ROLLOUT_STAGE_ERRORS)

    def _load_or_begin(self) -> None:
        if os.path.exists(self.path):
            self._seal_torn_tail()
            begin, chunks, _bad = _read_stage_file(self.path)
            if (begin is not None
                    and int(begin.get("to_version", -1)) == self.to_version
                    and int(begin.get("dim", -1)) == self.dim):
                self._chunks = chunks
                self.watermark = _coverage(chunks)
                self.resumed = bool(chunks)
                if self.resumed and self.metrics is not None:
                    self.metrics.incr(mn.ROLLOUT_STAGE_RESUMES)
                if self.resumed:
                    logger.info(
                        "rollout stage v%d resumed at watermark %d "
                        "(%s)", self.to_version, self.watermark, self.path)
                return
            # Config drift (different target dim/version reusing the
            # file name): the old progress is unusable — start clean.
            logger.warning("rollout stage %s header mismatch; restaging "
                           "from zero", self.path)
            try:
                os.remove(self.path)
            except OSError:
                pass
        self._append_line(json.dumps({
            "kind": "stage_begin", "to_version": self.to_version,
            "from_version": self.from_version, "dim": self.dim,
            "ts": time.time()}))

    # ---- staging ----

    def stage_chunk(self, start: int, emb: np.ndarray,
                    labels: np.ndarray) -> None:
        """Durably append one contiguous chunk of re-embedded rows
        (raises on write failure or injected kill — the watermark only
        advances once the fsync returned)."""
        emb = np.ascontiguousarray(np.asarray(emb, np.float32))
        labels = np.asarray(labels, np.int32)
        if emb.ndim != 2 or emb.shape[1] != self.dim \
                or emb.shape[0] != labels.shape[0]:
            raise ValueError(f"stage chunk shape mismatch: emb {emb.shape} "
                             f"labels {labels.shape} dim {self.dim}")
        raw = emb.tobytes()
        line = json.dumps({
            "kind": "stage", "start": int(start), "n": int(emb.shape[0]),
            "dim": self.dim, "labels": [int(v) for v in labels],
            "emb": base64.b64encode(raw).decode("ascii"),
            "crc32": binascii.crc32(raw) & 0xFFFFFFFF, "ts": time.time(),
        })
        fault = self._faults.on_stage() if self._faults is not None else None
        if fault == "crash":
            raise InjectedCrashError("crash before stage chunk append")
        if fault == "torn":
            self._append_line(line[:max(1, len(line) // 2)], newline=False)
            raise InjectedCrashError("torn stage chunk append")
        self._append_line(line)
        self._chunks[int(start)] = (emb, labels)
        self.watermark = _coverage(self._chunks)
        if self.metrics is not None:
            self.metrics.incr(mn.ROLLOUT_STAGE_CHUNKS)
            self.metrics.set_gauge(mn.ROLLOUT_STAGED_ROWS, self.watermark)

    def parts(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The staged set up to the watermark as (emb, labels) views of
        its chunks, in row order and tiling ``[0, watermark)`` once: no
        copy. Where chunks overlap (a crash-resume re-staged one) the
        rows are bit-identical, so the first chunk's are taken."""
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        pos = 0
        for start in sorted(self._chunks):
            if pos >= self.watermark:
                break
            c_emb, c_lab = self._chunks[start]
            end = min(self.watermark, start + c_emb.shape[0])
            if end > pos:
                out.append((c_emb[pos - start:end - start],
                            c_lab[pos - start:end - start]))
                pos = end
        return out

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """The staged set up to the watermark as (emb, labels)."""
        emb = np.zeros((self.watermark, self.dim), np.float32)
        labels = np.zeros((self.watermark,), np.int32)
        for start in sorted(self._chunks):
            c_emb, c_lab = self._chunks[start]
            if start >= self.watermark:
                continue
            end = min(self.watermark, start + c_emb.shape[0])
            emb[start:end] = c_emb[:end - start]
            labels[start:end] = c_lab[:end - start]
        return emb, labels

    def discard(self) -> None:
        """Delete the progress journal — ONLY after the post-cutover
        checkpoint landed (until then, recovery needs this file to
        complete a fenced-but-uncheckpointed cutover)."""
        try:
            os.remove(self.path)
        except OSError:
            pass


class DualScoreParity:
    """Old-vs-new embedder agreement over a sliding window of live
    queries (module docstring). Pure host math on the galleries' f32
    truth — it runs on the rollout thread, never the hot path."""

    def __init__(self, old_embed_fn: Callable[[np.ndarray], np.ndarray],
                 new_embed_fn: Callable[[np.ndarray], np.ndarray],
                 threshold: float = 0.98, min_samples: int = 32,
                 window: int = 512, metrics=None):
        self.old_embed_fn = old_embed_fn
        self.new_embed_fn = new_embed_fn
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.metrics = metrics
        self._agreements: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    @staticmethod
    def _top1(queries: np.ndarray,
              parts: List[Tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
        """Top-1 gallery LABEL per query over ``parts``, the (rows,
        labels) pieces of one gallery in row order (lowest-index
        tie-break, like the serving kernels); -1 when the gallery side is
        empty."""
        best = best_lab = None
        for rows, labels in parts:
            if rows.shape[0] == 0 or queries.shape[0] == 0:
                continue
            sims = queries @ rows.T
            idx = np.argmax(sims, axis=1)
            val = sims[np.arange(idx.shape[0]), idx]
            if best is None:
                best, best_lab = val, labels[idx]
            else:
                better = val > best  # a tie keeps the earlier row
                best = np.where(better, val, best)
                best_lab = np.where(better, labels[idx], best_lab)
        if best_lab is None:
            return np.full((queries.shape[0],), -1, np.int64)
        return best_lab

    def score(self, crops: np.ndarray, old_rows: np.ndarray,
              old_labels: np.ndarray, new_rows: np.ndarray,
              new_labels: np.ndarray) -> int:
        """Score one batch of query crops through BOTH embedders against
        their respective galleries; returns samples recorded."""
        return self.score_parts(crops, [(old_rows, old_labels)],
                                [(new_rows, new_labels)])

    def score_parts(self, crops: np.ndarray,
                    old_parts: List[Tuple[np.ndarray, np.ndarray]],
                    new_parts: List[Tuple[np.ndarray, np.ndarray]]) -> int:
        """``score`` with each gallery given as (rows, labels) pieces in
        row order (``_top1``), so no caller assembles a copy."""
        crops = np.asarray(crops, np.float32)
        if crops.ndim == 2:
            crops = crops[None]
        old_q = _l2norm(np.asarray(self.old_embed_fn(crops), np.float32))
        new_q = _l2norm(np.asarray(self.new_embed_fn(crops), np.float32))
        old_top = self._top1(old_q, old_parts)
        new_top = self._top1(new_q, new_parts)
        with self._lock:
            for a, b in zip(old_top, new_top):
                self._agreements.append(1.0 if (a == b and a >= 0) else 0.0)
            samples = len(self._agreements)
            agreement = (sum(self._agreements) / samples) if samples else 0.0
        if self.metrics is not None:
            self.metrics.set_gauge(mn.ROLLOUT_PARITY_SAMPLES, samples)
            self.metrics.set_gauge(mn.ROLLOUT_PARITY_AGREEMENT,
                                   round(agreement, 4))
        return int(old_top.shape[0])

    @property
    def samples(self) -> int:
        with self._lock:
            return len(self._agreements)

    @property
    def agreement(self) -> float:
        with self._lock:
            if not self._agreements:
                return 0.0
            return sum(self._agreements) / len(self._agreements)

    @property
    def disagreement(self) -> float:
        """1 - agreement once the window has data; 0.0 below the sample
        floor (no data is not a breach — the SLO gauge contract)."""
        with self._lock:
            n = len(self._agreements)
            if n < self.min_samples:
                return 0.0
            return 1.0 - sum(self._agreements) / n

    def ok(self) -> bool:
        with self._lock:
            n = len(self._agreements)
            return (n >= self.min_samples
                    and sum(self._agreements) / n >= self.threshold)


class RolloutCoordinator:
    """Drives one embedder rollout end to end (module docstring):
    background staged re-embed with durable resume, the dual-score
    parity window over live traffic, and the gated atomic cutover.

    ``reembed_fn(rows) -> rows'`` maps the OLD gallery's (normalized,
    host-truth) rows into the new embedder's space — in production the
    fine-tuned model re-extracting from the enrollment source store, in
    a test a fixed linear map. It must be deterministic over
    its input: a crash-resumed chunk re-stages from the same source rows
    and must reproduce the same bytes. ``old_embed_fn``/``new_embed_fn``
    embed live QUERY crops for the parity window (both optional — without
    them the parity gate never opens and cutover needs ``force=True``).
    """

    def __init__(self, state: StateLifecycle, gallery,
                 reembed_fn: Callable[[np.ndarray], np.ndarray],
                 to_version: int, *,
                 old_embed_fn: Optional[Callable] = None,
                 new_embed_fn: Optional[Callable] = None,
                 parity_threshold: float = 0.98,
                 parity_min_samples: int = 32,
                 parity_window: int = 512,
                 chunk_rows: int = 256,
                 live_sample_interval_s: float = 0.05,
                 face_size: Optional[Tuple[int, int]] = None,
                 metrics=None, tracer=None, fault_injector=None):
        self.state = state
        self.gallery = gallery
        self.reembed_fn = reembed_fn
        self.to_version = int(to_version)
        self.from_version = int(getattr(gallery, "embedder_version", 1))
        if self.to_version <= self.from_version:
            raise ValueError(
                f"to_version {to_version} must exceed the serving version "
                f"{self.from_version} (versions are monotonic; a rollback "
                f"is a NEW version whose space equals the prior one)")
        self.chunk_rows = max(1, int(chunk_rows))
        self.metrics = metrics
        self.tracer = tracer
        self.face_size = face_size
        # Kept verbatim so rollback() can clone the FULL configuration
        # (the parity deque only remembers its maxlen indirectly).
        self._parity_window = int(parity_window)
        self._fault_injector = fault_injector
        self.stage = ReEmbedStage(state.state_dir, self.to_version,
                                  dim=int(gallery.dim),
                                  from_version=self.from_version,
                                  metrics=metrics,
                                  fault_injector=fault_injector)
        self.parity = (DualScoreParity(old_embed_fn, new_embed_fn,
                                       threshold=parity_threshold,
                                       min_samples=parity_min_samples,
                                       window=parity_window, metrics=metrics)
                       if old_embed_fn is not None
                       and new_embed_fn is not None else None)
        self._phase = "idle"
        self._live_q: deque = deque(maxlen=64)
        self._live_lock = threading.Lock()
        self._live_interval_s = float(live_sample_interval_s)
        self._last_live_t = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # reembed_fn comes in two shapes: ``fn(rows)`` (a space-to-space
        # map, e.g. a fixed linear transform) and
        # ``fn(rows, start)`` (a source-store re-extract that needs the
        # row indices, e.g. a re-extract from stored images). Sniffed once.
        try:
            import inspect

            self._reembed_wants_start = len(
                inspect.signature(reembed_fn).parameters) >= 2
        except (TypeError, ValueError):
            self._reembed_wants_start = False
        self._set_phase("idle")

    def _reembed(self, rows: np.ndarray, start: int) -> np.ndarray:
        if self._reembed_wants_start:
            return self.reembed_fn(rows, start)
        return self.reembed_fn(rows)

    # ---- phase bookkeeping ----

    def _set_phase(self, phase: str) -> None:
        self._phase = phase
        if self.metrics is not None:
            self.metrics.set_gauge(mn.ROLLOUT_PHASE, PHASE_CODES[phase])
            self.metrics.set_gauge(mn.ROLLOUT_TOTAL_ROWS,
                                   int(self.gallery.size))
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "rollout_phase",
                             topic=LIFECYCLE_TOPIC, phase=phase,
                             to_version=self.to_version,
                             staged=self.stage.watermark,
                             total=int(self.gallery.size))

    @property
    def phase(self) -> str:
        return self._phase

    @property
    def caught_up(self) -> bool:
        return self.stage.watermark >= int(self.gallery.size)

    # ---- staged re-embed ----

    def run_stage_step(self) -> bool:
        """Stage one chunk of not-yet-re-embedded rows; returns True when
        a chunk was staged (False = caught up). Reads only the chunk's
        rows of the gallery's host truth (``snapshot_rows``) — source rows
        are append-only, so a chunk staged from them stays valid forever."""
        start = self.stage.watermark
        emb, lab, size = self.gallery.snapshot_rows(start, start + self.chunk_rows)
        if start >= size:
            return False
        if self._phase in ("idle", "done"):
            self._set_phase("staging")
        end = start + emb.shape[0]
        # a copy: ``reembed_fn`` never holds a view of the live mirror
        new_rows = _l2norm(self._reembed(np.array(emb), start))
        if new_rows.shape != (end - start, self.stage.dim):
            raise RolloutStateError(
                f"reembed_fn returned {new_rows.shape}, expected "
                f"{(end - start, self.stage.dim)}")
        self.stage.stage_chunk(start, new_rows, lab)
        return True

    def run_stage(self, max_chunks: Optional[int] = None) -> int:
        """Stage until caught up (or ``max_chunks``); returns chunks
        staged. The synchronous form."""
        staged = 0
        while (max_chunks is None or staged < max_chunks):
            if not self.run_stage_step():
                break
            staged += 1
        if self.caught_up and self._phase in ("idle", "staging"):
            self._set_phase("parity" if self.parity is not None else "ready")
        return staged

    # ---- the rollout thread ----

    def start(self) -> None:
        """Run staging + parity scoring on a background daemon thread —
        the serving loop never pays for a re-embed."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ocvf-rollout")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                progressed = self.run_stage_step()
                if self.caught_up and self._phase == "staging":
                    self._set_phase("parity" if self.parity is not None
                                    else "ready")
                self._drain_live()
                if (self._phase == "parity" and self.parity is not None
                        and self.parity.ok()):
                    self._set_phase("ready")
            except InjectedCrashError:
                raise  # simulated kill: the thread dies like the process
            except Exception:  # noqa: BLE001 - staging must not die silently
                logger.exception("rollout background step failed")
                if self.metrics is not None:
                    self.metrics.incr(mn.ROLLOUT_STAGE_ERRORS)
                progressed = False
            if not progressed:
                self._stop.wait(timeout=0.02)

    # ---- dual-score parity over live traffic ----

    def offer_live(self, frame: np.ndarray, faces: List[Dict[str, Any]]) -> None:
        """Publish-path hook (``RecognizerService._publish``): sample the
        best detected face crop, rate-limited, COPIED (the frame lives in
        a recycled staging buffer), onto the rollout thread's queue.
        Cheap and non-blocking by contract — the hot path pays one clock
        read in the common (not-due) case."""
        if self.parity is None or not faces:
            return
        now = time.monotonic()
        if now - self._last_live_t < self._live_interval_s:
            return
        self._last_live_t = now
        best = max(faces, key=lambda f: f.get("detection_score", 0.0))
        x0, y0, x1, y1 = (int(round(v)) for v in best["box"])
        h, w = frame.shape[:2]
        y0, y1 = max(0, y0), min(h, y1)
        x0, x1 = max(0, x0), min(w, x1)
        if y1 - y0 < 4 or x1 - x0 < 4:
            return
        with self._live_lock:
            self._live_q.append(frame[y0:y1, x0:x1].copy())

    def _drain_live(self) -> None:
        with self._live_lock:
            crops = list(self._live_q)
            self._live_q.clear()
        if crops:
            self.score_parity(crops)

    def score_parity(self, crops) -> int:
        """Score query crops through both embedders (the rollout thread's
        path for live samples; tests call it
        directly with synthetic traffic). No-op (0) until the stage has
        rows to match against."""
        if self.parity is None or self.stage.watermark == 0:
            return 0
        if self.face_size is not None:
            from opencv_facerecognizer_tpu_torch.ops import image as image_ops

            crops = [image_ops.resize(torch.as_tensor(np.asarray(c, np.float32)),
                                      self.face_size).numpy()
                     for c in crops]
        batch = np.stack([np.asarray(c, np.float32) for c in crops])
        old_emb, old_lab, _size = self.gallery.snapshot_rows(0, None)
        return self.parity.score_parts(batch, [(old_emb, old_lab)],
                                       self.stage.parts())

    def parity_ok(self) -> bool:
        return self.parity is not None and self.parity.ok()

    # ---- the gated atomic cutover ----

    def cutover(self, force: bool = False) -> int:
        """Atomic fleet cutover (module docstring): gate -> locked
        finalize (stage the enrollment delta durably) -> WAL fence ->
        epoch-fenced install -> forced checkpoint. Returns the fence
        record's WAL sequence. Raises ``RolloutGateError`` when the stage
        is far behind or the parity window has not cleared its threshold
        (``force`` overrides both — and is required when no parity
        embedders were wired)."""
        if not force:
            reasons = []
            if not self.caught_up:
                reasons.append(f"stage watermark {self.stage.watermark} < "
                               f"gallery size {int(self.gallery.size)}")
            if self.parity is None:
                reasons.append("no parity window wired (old/new embed fns)")
            elif not self.parity.ok():
                reasons.append(
                    f"parity gate not met: agreement "
                    f"{self.parity.agreement:.4f} over "
                    f"{self.parity.samples} samples (need >= "
                    f"{self.parity.threshold:g} over >= "
                    f"{self.parity.min_samples})")
            if reasons:
                if self.metrics is not None:
                    self.metrics.incr(mn.ROLLOUT_CUTOVER_BLOCKED)
                raise RolloutGateError("cutover refused: "
                                       + "; ".join(reasons))
        # Stop the background staging/parity thread BEFORE the locked
        # finalize: ReEmbedStage is single-writer by contract, and the
        # thread's run_stage_step would otherwise race build()'s own
        # stage_chunk/arrays on the chunk map (and could even re-create a
        # headerless stage file after discard()).
        self.stop()

        def build() -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
            # Runs under the lifecycle's enroll lock: no enrollment can
            # land between the delta re-embed and the install, so the
            # staged set covers EXACTLY the gallery being swapped.
            while True:
                start = self.stage.watermark
                emb, lab, size = self.gallery.snapshot_rows(
                    start, start + self.chunk_rows)
                if start >= size:
                    break
                rows = _l2norm(self._reembed(np.array(emb), start))
                self.stage.stage_chunk(start, rows, lab)
            capacity = max(int(self.gallery.capacity), size)
            emb_full = np.zeros((capacity, self.stage.dim), np.float32)
            lab_full = np.full((capacity,),
                               int(getattr(self.gallery, "labels_pad", -1)),
                               np.int32)
            pos = 0
            for c_emb, c_lab in self.stage.parts():
                end = min(size, pos + c_emb.shape[0])
                emb_full[pos:end] = c_emb[:end - pos]
                lab_full[pos:end] = c_lab[:end - pos]
                pos = end
            val_full = np.zeros((capacity,), bool)
            val_full[:size] = True
            return emb_full, lab_full, val_full, size

        self._set_phase("cutover")
        seq = self.state.perform_cutover(self.to_version, build)
        # Forced checkpoint: the cutover is fence-durable already (a crash
        # here recovers INTO the new version from the stage); the
        # checkpoint makes it cheap (no stage replay) and lets replicas
        # re-anchor. The stage file is discarded only once it lands.
        if self.state.checkpoint_now(wait=True):
            self.stage.discard()
        else:
            self.state.maybe_checkpoint(force=True)
            logger.warning(
                "post-cutover checkpoint did not land; the stage file is "
                "retained and the forced-checkpoint latch will retry")
        self._set_phase("done")
        return seq

    def rollback(self, reembed_fn: Callable[[np.ndarray], np.ndarray],
                 **overrides) -> "RolloutCoordinator":
        """Rollback is the SAME mechanism pointed at the prior space: a
        fresh coordinator whose ``reembed_fn`` maps the rolled-out rows
        back into the previous embedder's space, at the next monotonic
        version (versions never reuse numbers — the fence stays
        unambiguous in the WAL). Stage -> parity -> cutover apply
        unchanged; the returned coordinator is NOT started."""
        if self.metrics is not None:
            self.metrics.incr(mn.ROLLOUT_ROLLBACKS)
        kwargs: Dict[str, Any] = dict(
            parity_threshold=(self.parity.threshold
                              if self.parity is not None else 0.98),
            parity_min_samples=(self.parity.min_samples
                                if self.parity is not None else 32),
            parity_window=self._parity_window,
            chunk_rows=self.chunk_rows, metrics=self.metrics,
            tracer=self.tracer, face_size=self.face_size,
            live_sample_interval_s=self._live_interval_s,
            fault_injector=self._fault_injector)
        if self.parity is not None:
            # The parity pair swaps roles: the NEW serving embedder is the
            # one being rolled back FROM.
            kwargs["old_embed_fn"] = self.parity.new_embed_fn
            kwargs["new_embed_fn"] = self.parity.old_embed_fn
        kwargs.update(overrides)
        return RolloutCoordinator(self.state, self.gallery, reembed_fn,
                                  self.to_version + 1, **kwargs)

    # ---- observability ----

    def status(self) -> Dict[str, Any]:
        """JSON-able snapshot for ``GET /rollout``."""
        out = {
            "phase": self._phase,
            "from_version": self.from_version,
            "to_version": self.to_version,
            "staged_rows": self.stage.watermark,
            "total_rows": int(self.gallery.size),
            "caught_up": self.caught_up,
            "stage_resumed": self.stage.resumed,
            "parity": None,
        }
        if self.parity is not None:
            out["parity"] = {
                "samples": self.parity.samples,
                "agreement": round(self.parity.agreement, 4),
                "threshold": self.parity.threshold,
                "min_samples": self.parity.min_samples,
                "ok": self.parity.ok(),
            }
        return out
