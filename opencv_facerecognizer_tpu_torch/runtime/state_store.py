"""Crash-safe state: durable checkpoints, the enrolment WAL, startup
recovery and the graceful drain. Port of
``opencv_facerecognizer_tpu/runtime/state_store.py``; a state directory
written by either package recovers in the other.

- **CheckpointStore**: atomic, checksummed, versioned checkpoints in a
  retention-bounded directory. A file is ``MAGIC + u32 header_len +
  header JSON + sha256(header JSON) + payload``; the header carries the
  payload's sha256 and byte count, and the header's own digest catches a
  flipped bit in e.g. its ``wal_seq``. ``load_latest`` scans newest first
  and falls back past a corrupt file (renamed ``*.corrupt``); a file of a
  newer format is skipped and left in place; a read error raises.
- **EnrollmentWAL**: one JSON line per enrolment (rows base64, a crc32
  each), strict appends, fsync ``always`` by default, the torn tail
  sealed at open, ``abort`` tombstones, ``truncate_below`` after a
  checkpoint, and size rotation that only warns (acknowledged records
  are never rotated away). It scans the ``cutover``, ``registry_cutover``
  and ``registry_abort`` records the JAX package writes.
- **StateLifecycle**: write-ahead ``append_enrollment`` (the WAL record,
  then the gallery mutation, under one lock), background checkpoints
  from WAL row and age thresholds (single flight, a forced request
  latched, failures backed off), the IVF sidecar written after each
  checkpoint and loaded on recovery when its ``wal_seq`` matches, and
  ``recover``: the newest checkpoint that verifies and decodes, then the
  WAL records past its ``wal_seq``.
- **graceful_shutdown**: the SIGTERM path (drain, stop, final checkpoint,
  WAL truncated, the ledger).

The payload is the reference's ``flax.serialization.msgpack_serialize(
{"emb", "lab", "val"})``, byte for byte, from ``utils._msgpack``. The
checkpoint is written from the payload's pieces, so the gallery's rows
are hashed and written from the snapshot itself; recovery decodes from
a view of the file's bytes. ``last_checkpoint_s`` and
``last_recovery_s`` keep each stage's seconds.

Rows an asynchronous grow staged (``gallery.pending_rows``): a checkpoint
waits up to 30 s for them to land, and defers (``checkpoints_deferred_pending``,
a retry 5 s later) while any are still staged; recovery waits up to 300 s
for its replayed rows to land.

With a ``tracer`` (``utils.tracing.Tracer``) each recovery, WAL append
and checkpoint is a lifecycle span (``recover``, ``wal_append`` with
``ok``, ``checkpoint`` with its outcome: ok, deferred, save_failed or
crashed), emitted after the locks are released. ``graceful_shutdown``
dumps the flight recorder.

**The embedder cutover** (``perform_cutover``, driven by
``runtime.rollout.RolloutCoordinator``): under the enroll lock the final
delta is staged, the ``cutover`` fence record is appended with a strict
fsync, and the gallery installs the new-space rows and version in one
``load_snapshot`` publish; the caller forces a checkpoint. A fence record
past the newest checkpoint is completed by ``recover`` from the durable
stage file (``runtime.rollout.load_stage``), which fails closed when the
stage does not cover the promised rows.

**A registry swap** (``perform_registry_cutover``, driven by
``runtime.registry.RegistrySwapCoordinator`` or the CLI's
``--registry-swap``): under the enroll lock the ``registry_cutover`` fence
record (the post-swap stamp of every role, the candidate's params path and
sha256) is appended with a strict fsync, the manifest installs the new
version, and ``install_fn`` publishes the weights in memory. A fence past
the newest checkpoint whose manifest install never ran is completed by
``recover`` when the staged params verify, and abandoned (a
``registry_abort`` tombstone, the version retired) when they do not.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
from opencv_facerecognizer_tpu_torch.runtime.journal import RotatingJournal
from opencv_facerecognizer_tpu_torch.utils import _msgpack
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC
from opencv_facerecognizer_tpu_torch.utils.serialization import (
    CheckpointCorruptError, atomic_write_bytes, fsync_directory)

CHECKPOINT_MAGIC = b"OCVFSTATE\n"
CHECKPOINT_FORMAT_VERSION = 1
CHECKPOINT_SUFFIX = ".ckpt"
QUARANTINE_SUFFIX = ".corrupt"

#: the IVF quantizer's sidecar: derived state, keyed by the checkpoint's
#: ``wal_seq``; a mismatched or corrupt sidecar means a retrain
SIDECAR_NAME = "quantizer.ivf"

log = logging.getLogger(__name__)


class CheckpointVersionError(ValueError):
    """An intact checkpoint of a newer format than this binary reads.
    Not ``CheckpointCorruptError``: quarantining it would let retention
    prune valid newer state; scans skip it."""


class EmbedderVersionMismatchError(ValueError):
    """An enrolment embedded by one embedder version met a gallery serving
    another; refused before any WAL sequence is burned."""


def _encode_checkpoint(header: Dict[str, Any], payload: bytes) -> bytes:
    """``MAGIC + u32 header_len + header_json + sha256(header_json) +
    payload``."""
    return _checkpoint_prefix(header) + bytes(payload)


def _checkpoint_prefix(header: Dict[str, Any]) -> bytes:
    header_blob = json.dumps(header, sort_keys=True).encode("utf-8")
    return (CHECKPOINT_MAGIC + len(header_blob).to_bytes(4, "big") + header_blob
            + hashlib.sha256(header_blob).digest())


def _decode_checkpoint(blob, path: str) -> Tuple[Dict[str, Any], memoryview]:
    """Parse and check one checkpoint file's bytes -> (header, payload as a
    view of ``blob``). Raises ``CheckpointCorruptError`` on any format or
    checksum miss, ``CheckpointVersionError`` on a newer format."""
    view = memoryview(blob)
    if bytes(view[:len(CHECKPOINT_MAGIC)]) != CHECKPOINT_MAGIC:
        raise CheckpointCorruptError(f"{path}: bad magic")
    off = len(CHECKPOINT_MAGIC)
    if len(view) < off + 4:
        raise CheckpointCorruptError(f"{path}: truncated before header")
    hlen = int.from_bytes(view[off:off + 4], "big")
    off += 4
    if hlen <= 0 or len(view) < off + hlen + 32:
        raise CheckpointCorruptError(f"{path}: truncated header")
    header_blob = bytes(view[off:off + hlen])
    if hashlib.sha256(header_blob).digest() != bytes(view[off + hlen:off + hlen + 32]):
        raise CheckpointCorruptError(f"{path}: header sha256 mismatch")
    header, version = _parse_header(header_blob, path)
    try:
        want_bytes = int(header.get("payload_bytes", -1))
    except (TypeError, ValueError) as exc:
        raise CheckpointCorruptError(f"{path}: header decode failed: {exc!r}") from exc
    if version > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointVersionError(
            f"{path}: format v{version} is newer than supported "
            f"v{CHECKPOINT_FORMAT_VERSION} (binary downgrade?)")
    payload = view[off + hlen + 32:]
    if want_bytes != len(payload):
        raise CheckpointCorruptError(
            f"{path}: payload truncated ({len(payload)} bytes, header says {want_bytes})")
    if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
        raise CheckpointCorruptError(f"{path}: sha256 mismatch")
    return header, payload


def _parse_header(header_blob: bytes, path: str) -> Tuple[Dict[str, Any], int]:
    try:
        header = json.loads(header_blob.decode("utf-8"))
        if not isinstance(header, dict):
            raise ValueError(f"header is {type(header).__name__}, not object")
        return header, int(header.get("format_version", -1))
    except (UnicodeDecodeError, json.JSONDecodeError, TypeError, ValueError,
            AttributeError) as exc:
        raise CheckpointCorruptError(f"{path}: header decode failed: {exc!r}") from exc


def read_checkpoint_header(path: str) -> Dict[str, Any]:
    """One checkpoint's header, checked (magic, length, header sha256,
    format) without reading its payload."""
    with open(path, "rb") as fh:
        prefix = fh.read(len(CHECKPOINT_MAGIC) + 4)
        if not prefix.startswith(CHECKPOINT_MAGIC) or len(prefix) < len(CHECKPOINT_MAGIC) + 4:
            raise CheckpointCorruptError(f"{path}: bad magic")
        hlen = int.from_bytes(prefix[len(CHECKPOINT_MAGIC):], "big")
        if hlen <= 0 or hlen > 64 << 20:
            raise CheckpointCorruptError(f"{path}: bad header length")
        header_blob = fh.read(hlen)
        header_digest = fh.read(32)
    if len(header_blob) < hlen or len(header_digest) < 32:
        raise CheckpointCorruptError(f"{path}: truncated header")
    if hashlib.sha256(header_blob).digest() != header_digest:
        raise CheckpointCorruptError(f"{path}: header sha256 mismatch")
    header, version = _parse_header(header_blob, path)
    if version > CHECKPOINT_FORMAT_VERSION:
        raise CheckpointVersionError(f"{path}: format v{version} is newer than supported "
                                     f"v{CHECKPOINT_FORMAT_VERSION}")
    return header


def scan_checkpoint_files(directory: str) -> List[Tuple[int, str]]:
    """(seq, path) of every installed checkpoint in ``directory``, newest
    first; reads nothing but the directory."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        seq = CheckpointStore._seq_of(name)
        if seq is not None:
            out.append((seq, os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


class CheckpointStore:
    """Atomic, checksummed, versioned checkpoints ``ckpt-<seq:08d>.ckpt``
    in one directory; ``seq`` grows across restarts, retention keeps the
    newest ``keep``, and corrupt files found by a load are quarantined."""

    def __init__(self, directory: str, keep: int = 3, metrics=None, fault_injector=None):
        self.directory = str(directory)
        self.keep = max(1, int(keep))
        self.metrics = metrics
        #: ``runtime.faults`` hook: the storage boundary before the
        #: install and before each read
        self._faults = fault_injector
        self._lock = threading.Lock()
        #: seconds of the last save's stages ("sha256", "write")
        self.last_save_s: Dict[str, float] = {}
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def _seq_of(filename: str) -> Optional[int]:
        base = os.path.basename(filename)
        if not (base.startswith("ckpt-") and base.endswith(CHECKPOINT_SUFFIX)):
            return None
        try:
            return int(base[len("ckpt-"):-len(CHECKPOINT_SUFFIX)])
        except ValueError:
            return None

    def checkpoint_files(self) -> List[Tuple[int, str]]:
        """(seq, path) of every installed checkpoint, newest first."""
        return scan_checkpoint_files(self.directory)

    def next_seq(self) -> int:
        files = self.checkpoint_files()
        return (files[0][0] + 1) if files else 1

    # ---- writing ----

    def save(self, payload, meta: Dict[str, Any], fault: Optional[str] = None) -> str:
        """Install one checkpoint atomically; returns its path. ``payload``
        is bytes-like or a list of bytes-like pieces (written in order,
        never joined). ``fault`` is ``FaultInjector.on_checkpoint``'s
        verdict: ``torn`` leaves a partial tmp and raises, ``crash`` a
        complete tmp that is never renamed."""
        pieces = payload if isinstance(payload, (list, tuple)) else [payload]
        with self._lock:
            seq = self.next_seq()
            t0 = time.perf_counter()
            digest = hashlib.sha256()
            size = 0
            for piece in pieces:
                digest.update(piece)
                size += memoryview(piece).nbytes
            header = {
                "format_version": CHECKPOINT_FORMAT_VERSION,
                "seq": seq,
                "created_ts": time.time(),
                "payload_bytes": size,
                "sha256": digest.hexdigest(),
                "meta": dict(meta),
            }
            blob = [_checkpoint_prefix(header), *pieces]
            t1 = time.perf_counter()
            path = os.path.join(self.directory, f"ckpt-{seq:08d}{CHECKPOINT_SUFFIX}")
            if fault in ("torn", "crash"):
                whole = b"".join(blob)
                with open(path + ".tmp", "wb") as fh:
                    fh.write(whole[:max(1, len(whole) // 2)] if fault == "torn" else whole)
                    fh.flush()
                    os.fsync(fh.fileno())
                raise InjectedCrashError("torn checkpoint write (tmp left)" if fault == "torn"
                                         else "crash before checkpoint rename")
            if self._faults is not None:
                self._faults.on_storage("checkpoint_write")
            atomic_write_bytes(path, blob)
            self.last_save_s = {"sha256": t1 - t0, "write": time.perf_counter() - t1}
            if self.metrics is not None:
                self.metrics.incr(mn.CHECKPOINTS_WRITTEN)
            self._prune_locked()
            return path

    def _prune_locked(self) -> None:
        """Retention: installed checkpoints beyond ``keep`` (oldest first),
        stale tmp files, quarantined files beyond ``keep``; a failed
        removal is counted (``checkpoint_gc_errors``)."""
        for _seq, path in self.checkpoint_files()[self.keep:]:
            try:
                os.remove(path)
            except OSError:
                log.warning("checkpoint retention sweep could not remove %s", path)
                if self.metrics is not None:
                    self.metrics.incr(mn.CHECKPOINT_GC_ERRORS)
        try:
            names = os.listdir(self.directory)
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.CHECKPOINT_GC_ERRORS)
            return
        stale_tmp = [n for n in names if n.endswith(".tmp") or ".tmp." in n]
        quarantined = sorted(n for n in names if n.endswith(QUARANTINE_SUFFIX))
        for name in stale_tmp + quarantined[:-self.keep or None]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                log.warning("checkpoint retention sweep could not remove %s", name)
                if self.metrics is not None:
                    self.metrics.incr(mn.CHECKPOINT_GC_ERRORS)

    # ---- reading ----

    def load_latest(self) -> Optional[Tuple[Dict[str, Any], memoryview, str]]:
        """Newest valid checkpoint as ``(header, payload view, path)``, or
        None. Falls back past corrupt files (counted, quarantined) and
        newer-format ones (counted, left in place); a read error raises:
        it proves nothing about the bytes."""
        with self._lock:
            for _seq, path in self.checkpoint_files():
                try:
                    if self._faults is not None:
                        self._faults.on_storage_read("checkpoint_read")
                    with open(path, "rb") as fh:
                        blob = fh.read()
                except OSError:
                    log.exception("checkpoint read failed (NOT corruption): %s", path)
                    if self.metrics is not None:
                        self.metrics.incr(mn.CHECKPOINT_READ_ERRORS)
                    raise
                try:
                    header, payload = _decode_checkpoint(blob, path)
                    return header, payload, path
                except CheckpointVersionError as exc:
                    log.warning("newer-format checkpoint skipped (NOT quarantined): %s", exc)
                    if self.metrics is not None:
                        self.metrics.incr(mn.CHECKPOINTS_VERSION_SKIPPED)
                except CheckpointCorruptError as exc:
                    log.warning("corrupt checkpoint skipped: %s", exc)
                    if self.metrics is not None:
                        self.metrics.incr(mn.CHECKPOINTS_CORRUPT)
                    self.quarantine(path)
            return None

    def quarantine(self, path: str) -> None:
        """Rename a corrupt checkpoint to ``*.corrupt``."""
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
            fsync_directory(self.directory)
        except OSError:
            pass

    def verify(self) -> Dict[str, Any]:
        """Check every installed checkpoint without quarantining:
        ``{"ok", "corrupt", "newer_version", "unreadable"}``."""
        ok, corrupt, newer, unreadable = [], [], [], []
        for _seq, path in self.checkpoint_files():
            try:
                with open(path, "rb") as fh:
                    blob = fh.read()
            except OSError as exc:
                unreadable.append((path, str(exc)))
                continue
            try:
                _decode_checkpoint(blob, path)
                ok.append(path)
            except CheckpointVersionError as exc:
                newer.append((path, str(exc)))
            except CheckpointCorruptError as exc:
                corrupt.append((path, str(exc)))
        return {"ok": ok, "corrupt": corrupt, "newer_version": newer,
                "unreadable": unreadable}


def decode_enroll_record(record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Check and decode one parsed ``enroll`` record (base64 rows, crc32,
    shape): the record with ``embeddings`` and ``labels_np`` attached, or
    None."""
    try:
        raw = base64.b64decode(record["emb"], validate=True)
        if (binascii.crc32(raw) & 0xFFFFFFFF) != record["crc32"]:
            return None
        n, dim = int(record["n"]), int(record["dim"])
        emb = np.frombuffer(raw, np.float32)
        if emb.size != n * dim:
            return None
        out = dict(record)
        out["embeddings"] = emb.reshape(n, dim)
        out["labels_np"] = np.asarray(record["labels"], np.int32)
        return out
    except (KeyError, TypeError, ValueError, binascii.Error):
        return None


class EnrollmentWAL(RotatingJournal):
    """Write-ahead log of enrolments between checkpoints: one JSON line
    per ``add``, ``{"kind": "enroll", "seq", "ts", "n", "dim", "labels",
    "label", "subject", "embedder_version", "emb": base64(<f4 bytes),
    "crc32"}``. Never rotates records away (past ``max_bytes`` it warns
    once, ``wal_over_bytes``); only ``truncate_below`` compacts it."""

    def __init__(self, path: str, max_bytes: int = 64 << 20, metrics=None,
                 fsync: str = "always", fsync_interval_s: float = 1.0,
                 fault_injector=None):
        super().__init__(path, max_bytes=max_bytes, backups=0, metrics=metrics,
                         fsync=fsync, fsync_interval_s=fsync_interval_s,
                         fault_injector=fault_injector)
        self._warned_over_bytes = False
        self._seal_torn_tail()

    def _rotate_if_needed(self, incoming: int) -> None:
        """Warn once when the WAL first passes ``max_bytes``; never rotate."""
        if self._warned_over_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming <= self.max_bytes:
            return
        self._warned_over_bytes = True
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_OVER_BYTES)
        log.warning("enrollment WAL exceeds %d bytes without a checkpoint truncating it; "
                    "records are retained (never rotated away)", self.max_bytes)

    def _seal_torn_tail(self) -> None:
        """End a torn final line (a crash mid-append) with a newline at
        open, so it stays one skipped line and new appends start clean."""
        with self._lock:
            try:
                if not os.path.exists(self.path) or not os.path.getsize(self.path):
                    return
                with open(self.path, "rb+") as fh:
                    fh.seek(-1, os.SEEK_END)
                    if fh.read(1) != b"\n":
                        fh.write(b"\n")
                        fh.flush()
                        os.fsync(fh.fileno())
                        if self.metrics is not None:
                            self.metrics.incr(mn.WAL_TORN_TAILS_SEALED)
            except OSError:
                if self.metrics is not None:
                    self.metrics.incr(mn.JOURNAL_ERRORS)

    def append_enroll(self, seq: int, embeddings: np.ndarray, labels: np.ndarray,
                      subject: Optional[str] = None, label: Optional[int] = None,
                      embedder_version: int = 1,
                      registry: Optional[Dict[str, int]] = None) -> None:
        """Append one enrolment record; raises on a failed write (strict)
        or an injected crash. The caller acknowledges only after this
        returns."""
        emb = np.ascontiguousarray(np.asarray(embeddings, np.float32))
        labels = np.asarray(labels, np.int32)
        if emb.ndim != 2 or emb.shape[0] != labels.shape[0]:
            raise ValueError(f"embeddings {emb.shape} / labels {labels.shape} mismatch")
        raw = emb.tobytes()
        record = {
            "kind": "enroll",
            "seq": int(seq),
            "ts": time.time(),
            "n": int(emb.shape[0]),
            "dim": int(emb.shape[1]),
            "labels": [int(v) for v in labels],
            "label": None if label is None else int(label),
            "subject": subject,
            "embedder_version": int(embedder_version),
            "emb": base64.b64encode(raw).decode("ascii"),
            "crc32": binascii.crc32(raw) & 0xFFFFFFFF,
        }
        if registry is not None:
            record["registry"] = {str(k): int(v) for k, v in registry.items()}
        line = json.dumps(record)
        fault = self._faults.on_wal_append() if self._faults is not None else None
        if fault == "crash":
            raise InjectedCrashError("crash before WAL append")
        if fault == "torn":
            with self._lock:
                self._append_locked(line[:max(1, len(line) // 2)], newline=False)
            raise InjectedCrashError("torn WAL append")
        try:
            self.append_line(line, strict=True)
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.WAL_APPEND_ERRORS)
            raise
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_APPENDS)
            self.metrics.incr(mn.WAL_ROWS_APPENDED, emb.shape[0])

    def append_cutover(self, seq: int, from_version: int, to_version: int, rows: int,
                       dim: int) -> None:
        """Append the embedder cutover's fence record (strict: the gallery
        swaps only after it is durable). ``rows`` and ``dim`` are what
        recovery checks the stage against."""
        self.append_line(json.dumps({
            "kind": "cutover", "seq": int(seq), "from_version": int(from_version),
            "to_version": int(to_version), "rows": int(rows), "dim": int(dim),
            "ts": time.time(),
        }), strict=True)
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_CUTOVER_RECORDS)

    def append_registry_cutover(self, seq: int, role: str, from_version: int,
                                to_version: int, registry: Dict[str, int], config: Any = None,
                                params_path: Optional[str] = None,
                                params_sha256: Optional[str] = None) -> None:
        """Append a registry swap's fence record (strict: the manifest and
        the weights change only after it is durable), in the reference's
        layout: the post-swap stamp of every role and the candidate's
        params path and sha256, which recovery verifies."""
        self.append_line(json.dumps({
            "kind": "registry_cutover", "seq": int(seq), "role": str(role),
            "from_version": int(from_version), "to_version": int(to_version),
            "registry": {str(k): int(v) for k, v in registry.items()},
            "config": config, "params_path": params_path, "params_sha256": params_sha256,
            "ts": time.time(),
        }), strict=True)
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_REGISTRY_RECORDS)

    def append_registry_abort(self, fence_seq: int, role: str, to_version: int) -> None:
        """Tombstone a ``registry_cutover`` fence that recovery abandoned
        (strict)."""
        self.append_line(json.dumps({
            "kind": "registry_abort", "seq": int(fence_seq), "role": str(role),
            "to_version": int(to_version), "ts": time.time(),
        }), strict=True)
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_REGISTRY_ABORTS)

    def scan(self) -> Tuple[List[Dict[str, Any]], int]:
        """One parse of the whole WAL -> (decoded enrolments and the fence
        records, oldest first; the highest ``seq`` of ANY record, aborts
        and crc-failed ones included, which seeds the next sequence)."""
        records = list(self.records())
        highest = 0
        aborted = set()
        for record in records:
            seq = record.get("seq")
            if isinstance(seq, (int, float)):
                highest = max(highest, int(seq))
                if record.get("kind") == "abort":
                    aborted.add(int(seq))
        out = []
        for record in records:
            kind = record.get("kind")
            seq = record.get("seq")
            if (kind in ("cutover", "registry_cutover", "registry_abort")
                    and isinstance(seq, (int, float))):
                out.append(dict(record))
                continue
            if kind != "enroll":
                continue
            if isinstance(seq, (int, float)) and int(seq) in aborted:
                continue
            decoded = decode_enroll_record(record)
            if decoded is None:
                if self.metrics is not None:
                    self.metrics.incr(mn.WAL_CORRUPT_RECORDS)
                continue
            out.append(decoded)
        return out, highest

    def max_seq(self) -> int:
        return self.scan()[1]

    def append_abort(self, seq: int) -> None:
        """Tombstone an enrol record whose gallery apply failed after the
        append (best effort, not strict): replay skips it."""
        self.append_line(json.dumps({"kind": "abort", "seq": int(seq), "ts": time.time()}),
                         strict=False)
        if self.metrics is not None:
            self.metrics.incr(mn.WAL_ABORTS)

    def enrollments(self) -> Iterator[Dict[str, Any]]:
        """Decoded enrolments oldest first, aborted ones left out."""
        return iter(r for r in self.scan()[0] if r.get("kind") == "enroll")

    def truncate_below(self, seq: int) -> None:
        """Drop the records with ``seq`` <= ``seq`` (an installed
        checkpoint covers them): the survivors are rewritten atomically."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
            survivors: List[str] = []
            try:
                with open(self.path, "r", encoding="utf-8", errors="replace") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                            covered = isinstance(rec, dict) and int(rec.get("seq", 0)) <= seq
                        except (json.JSONDecodeError, TypeError, ValueError):
                            continue  # a torn remnant: drop it
                        if not covered:
                            survivors.append(line)
            except OSError:
                return
            blob = ("\n".join(survivors) + "\n") if survivors else ""
            try:
                atomic_write_bytes(self.path, blob.encode("utf-8"))
                self._warned_over_bytes = False
            except OSError:
                if self.metrics is not None:
                    self.metrics.incr(mn.JOURNAL_ERRORS)


class StateLifecycle:
    """WAL-backed enrolments, threshold-driven background checkpoints and
    startup recovery over one ``state_dir``::

        state_dir/
          checkpoints/ckpt-00000001.ckpt   # CheckpointStore
          enroll.wal                        # EnrollmentWAL
          quantizer.ivf                     # IVF sidecar
          registry.json                     # runtime.registry manifest

    ``attach`` it to a ``RecognizerService`` or ``bind`` a bare gallery
    and subject-name list."""

    def __init__(self, state_dir: str, metrics=None, keep_checkpoints: int = 3,
                 checkpoint_wal_rows: int = 256, checkpoint_every_s: float = 300.0,
                 fault_injector=None, tracer=None):
        self.state_dir = str(state_dir)
        os.makedirs(self.state_dir, exist_ok=True)
        self.metrics = metrics
        #: lifecycle spans, emitted outside the enroll and checkpoint locks
        self.tracer = tracer
        self.checkpoint_wal_rows = int(checkpoint_wal_rows)
        self.checkpoint_every_s = float(checkpoint_every_s)
        self._faults = fault_injector
        #: the ``runtime.resilience.DurabilityMonitor``, set by its
        #: constructor: while it reports degraded, enrolments are refused
        self.durability = None
        self.store = CheckpointStore(os.path.join(self.state_dir, "checkpoints"),
                                     keep=keep_checkpoints, metrics=metrics,
                                     fault_injector=fault_injector)
        self.sidecar_path = os.path.join(self.state_dir, SIDECAR_NAME)
        # the WAL's defaults: fsync "always", warn past 64 MiB
        self.wal = EnrollmentWAL(os.path.join(self.state_dir, "enroll.wal"),
                                 metrics=metrics, fault_injector=fault_injector)
        self._wal_seq = 0
        self._rows_since_ckpt = 0
        self._last_ckpt_t = time.monotonic()
        # Orders WAL appends and gallery mutations against the checkpoint
        # snapshot: a record with seq <= the snapshot's wal_seq is in the
        # snapshot. Taken before the WAL's file lock, never after.
        self._enroll_lock = threading.Lock()
        # Single flight: one checkpoint at a time; a forced request that
        # meets one in flight is latched in _force_pending.
        self._ckpt_lock = threading.Lock()
        self._force_pending = False
        self._ckpt_retry_backoff_s = 1.0
        self._ckpt_retry_at = 0.0
        self._gallery = None
        self._subject_names: Optional[list] = None
        self._service = None
        self._closed = False
        #: the ``runtime.registry.ModelRegistry`` manifest, when attached
        self.registry = None
        #: seconds of the last successful checkpoint's stages and its bytes
        self.last_checkpoint_s: Dict[str, float] = {}
        #: seconds of the last recovery's stages
        self.last_recovery_s: Dict[str, float] = {}

    # ---- wiring ----

    def attach_registry(self, registry) -> None:
        self.registry = registry

    def bind(self, gallery, subject_names: list) -> None:
        """A bare gallery and the live subject-name list (read at
        checkpoint time, not copied now)."""
        self._gallery = gallery
        self._subject_names = subject_names

    def attach(self, service) -> None:
        """Checkpoints read the service's live gallery and names; its
        commit hooks nudge the thresholds."""
        self._service = service
        service.commit_hooks.append(self.maybe_checkpoint)

    def _targets(self):
        if self._service is not None:
            return self._service.pipeline.gallery, self._service.subject_names
        if self._gallery is None:
            raise RuntimeError("StateLifecycle has no gallery: call attach(service) "
                               "or bind(gallery, names)")
        return self._gallery, self._subject_names

    @property
    def wal_seq(self) -> int:
        return self._wal_seq

    @property
    def rows_since_checkpoint(self) -> int:
        return self._rows_since_ckpt

    @staticmethod
    def _gallery_version(gallery) -> int:
        return int(getattr(gallery, "embedder_version", 1))

    @property
    def embedder_version(self) -> int:
        """The serving embedder version, read from the live gallery."""
        gallery, _names = self._targets()
        return self._gallery_version(gallery)

    def _role_stamp(self) -> Optional[Dict[str, int]]:
        """``{"detector": v, "cascade": v}`` for WAL rows, or None."""
        if self.registry is None:
            return None
        stamp = self.registry.stamp()
        stamp.pop("embedder", None)
        return stamp

    def registry_stamp(self) -> Optional[Dict[str, int]]:
        """Every role's version, the embedder's from the live gallery; None
        without a registry."""
        if self.registry is None:
            return None
        gallery, _names = self._targets()
        stamp = self.registry.stamp()
        stamp["embedder"] = self._gallery_version(gallery)
        return stamp

    # ---- recovery ----

    def recover(self, gallery=None, subject_names: Optional[list] = None) -> Dict[str, Any]:
        """Install the newest checkpoint that verifies and decodes
        (``load_snapshot``: capacity, size and labels are the
        checkpoint's), complete a pending embedder cutover from its stage
        (or restore the IVF sidecar when there is none), settle fenced
        registry swaps, then replay the WAL records past the checkpoint's
        ``wal_seq`` (past the cutover's fence, when one was completed).
        Under the enroll lock. Returns the report; raises ``ValueError`` on
        a dim mismatch and ``runtime.rollout.RolloutStateError`` when a
        pending cutover's stage is missing or short."""
        if gallery is not None:
            self.bind(gallery, subject_names if subject_names is not None else [])
        gallery, names = self._targets()
        report: Dict[str, Any] = {"recovered_checkpoint": None, "checkpoint_size": 0,
                                  "replayed_records": 0, "replayed_rows": 0,
                                  "skipped_records": 0, "version_skipped_records": 0}
        stages: Dict[str, float] = {}
        with self._enroll_lock:
            surviving, highest = self.wal.scan()
            base_seq, current_version = self._recover_checkpoint_locked(
                gallery, names, report, surviving, stages)
            # a fence past the checkpoint: the crash fell between the
            # cutover record and its checkpoint; the stage is durable
            cutover = self._pending_cutover(surviving, base_seq)
            effective_base = base_seq
            t = time.perf_counter()
            if cutover is not None:
                self._complete_cutover_locked(gallery, cutover, report)
                current_version = int(cutover["to_version"])
                effective_base = int(cutover["seq"])
                stages["cutover"] = time.perf_counter() - t
            else:
                # the sidecar's centroids live in the old space after a cutover
                self._restore_quantizer_locked(gallery, base_seq, report)
                stages["sidecar"] = time.perf_counter() - t
            self._settle_registry_locked(surviving, report)
            t = time.perf_counter()
            for record in surviving:
                if record.get("kind") != "enroll":
                    continue
                seq = int(record["seq"])
                if seq <= base_seq:
                    report["skipped_records"] += 1
                    if self.metrics is not None:
                        self.metrics.incr(mn.WAL_SKIPPED_RECORDS)
                    continue
                if seq <= effective_base:
                    # its rows ride the completed cutover's stage; its name
                    # still re-grows from the record
                    self._grow_names(names, record)
                    report["skipped_records"] += 1
                    continue
                if int(record.get("embedder_version", 1)) != current_version:
                    report["version_skipped_records"] += 1
                    if self.metrics is not None:
                        self.metrics.incr(mn.ROLLOUT_VERSION_SKIPPED_ROWS, int(record["n"]))
                    log.error("WAL record seq %d carries embedder version %s but recovery "
                              "landed on version %d: row NOT applied", seq,
                              record.get("embedder_version"), current_version)
                    continue
                gallery.add(record["embeddings"], record["labels_np"])
                self._grow_names(names, record)
                report["replayed_records"] += 1
                report["replayed_rows"] += int(record["n"])
                if self.metrics is not None:
                    self.metrics.incr(mn.WAL_REPLAYED_RECORDS)
                    self.metrics.incr(mn.WAL_REPLAYED_ROWS, int(record["n"]))
            self._wal_seq = max(base_seq, highest)
            self._rows_since_ckpt = report["replayed_rows"]
            # replayed rows an asynchronous grow staged land before serving
            wait_ready = getattr(gallery, "wait_ready", None)
            if wait_ready is not None:
                wait_ready(timeout=300.0)
            stages["replay"] = time.perf_counter() - t
        self._last_ckpt_t = time.monotonic()
        if cutover is not None:
            # the completed cutover lives in memory and the stage until a
            # new-version checkpoint lands: the next tick forces one
            self._force_pending = True
        if self.metrics is not None:
            self.metrics.incr(mn.STATE_RECOVERIES)
            self.metrics.set_gauge(mn.WAL_ROWS, self._rows_since_ckpt)
        report["gallery_size"] = gallery.size
        report["embedder_version"] = current_version
        if self.registry is not None:
            report["registry"] = {**self.registry.stamp(), "embedder": current_version}
        # No or stale sidecar: the quantizer retrains in the background
        # while the exact matcher serves.
        poke = getattr(gallery, "_poke_quantizer", None)
        if poke is not None:
            poke()
        self.last_recovery_s = stages
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "recover", topic=LIFECYCLE_TOPIC,
                             replayed_records=report["replayed_records"],
                             replayed_rows=report["replayed_rows"],
                             checkpoint=report["recovered_checkpoint"],
                             gallery_size=int(gallery.size))
        return report

    def _restore_quantizer_locked(self, gallery, base_seq: int,
                                  report: Dict[str, Any]) -> None:
        """Reinstate the IVF quantizer from its sidecar when the sidecar's
        ``wal_seq`` (and nlist, seed, dim, embedder version) match the
        recovered checkpoint's; anything else means a retrain."""
        quantizer = getattr(gallery, "quantizer", None)
        if quantizer is None:
            return
        from opencv_facerecognizer_tpu_torch.parallel.quantizer import (
            SidecarError, decode_sidecar)

        try:
            with open(self.sidecar_path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return
        try:
            header, centroids, assign = decode_sidecar(blob)
        except SidecarError as exc:
            log.warning("quantizer sidecar unreadable (%s); will retrain", exc)
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_SIDECAR_ERRORS)
            return
        nlist_drift = (not getattr(quantizer, "auto_nlist", False)
                       and int(header.get("nlist", -1)) != quantizer.nlist)
        if (int(header.get("wal_seq", -1)) != int(base_seq)
                or nlist_drift
                or int(header.get("seed", -1)) != quantizer.seed
                or int(header.get("dim", -1)) != gallery.dim
                or int(header.get("embedder_version", 1)) != self._gallery_version(gallery)):
            log.info("quantizer sidecar stale (wal_seq %s vs checkpoint %s); will retrain",
                     header.get("wal_seq"), base_seq)
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_SIDECAR_STALE)
            return
        if quantizer.install_from_arrays(centroids, assign,
                                         trained_size=header.get("trained_size")):
            report["quantizer_sidecar"] = "loaded"
            if self.metrics is not None:
                self.metrics.incr(mn.IVF_SIDECAR_LOADS)
        elif self.metrics is not None:
            self.metrics.incr(mn.IVF_SIDECAR_STALE)

    def _settle_registry_locked(self, surviving: List[Dict[str, Any]],
                                report: Dict[str, Any]) -> None:
        """Complete (the staged params verify) or abandon (tombstone and
        retired version) every fenced registry swap whose manifest install
        never ran. Attaches the dir's manifest when none was wired; a
        corrupt manifest raises ``RegistryStateError``."""
        from opencv_facerecognizer_tpu_torch.runtime.registry import (
            MANIFEST_NAME, ModelRegistry, _file_sha256)

        registry = self.registry
        if registry is None:
            if not os.path.exists(os.path.join(self.state_dir, MANIFEST_NAME)):
                return
            registry = self.registry = ModelRegistry(self.state_dir, metrics=self.metrics)
        voided = {(r.get("role"), int(r.get("to_version", -1)))
                  for r in surviving if r.get("kind") == "registry_abort"}
        for record in surviving:
            if record.get("kind") != "registry_cutover":
                continue
            role = str(record.get("role"))
            to_version = int(record.get("to_version", -1))
            if (role, to_version) in voided or registry.version(role) >= to_version:
                continue
            entry = {"role": role, "seq": int(record.get("seq", 0)),
                     "from_version": int(record.get("from_version", 0)),
                     "to_version": to_version}
            sha = record.get("params_sha256")
            path = record.get("params_path")
            params_ok = True
            if sha is not None:
                try:
                    params_ok = (path is not None and os.path.exists(path)
                                 and _file_sha256(path) == sha)
                except OSError:
                    params_ok = False
            if params_ok:
                registry.install(role, to_version, config=record.get("config"),
                                 params_path=path, params_sha256=sha)
                report.setdefault("completed_registry_swaps", []).append(entry)
                if self.metrics is not None:
                    self.metrics.incr(mn.REGISTRY_SWAPS_COMPLETED_RECOVERY)
                log.warning("completed pending registry swap %s v%d -> v%d from the fence "
                            "and the staged params", role, entry["from_version"], to_version)
            else:
                try:
                    self.wal.append_registry_abort(entry["seq"], role, to_version)
                except OSError:
                    log.exception("registry_abort tombstone append failed; the abandonment "
                                  "stands (the manifest never moved)")
                registry.retire(role, to_version)
                report.setdefault("abandoned_registry_swaps", []).append(entry)
                if self.metrics is not None:
                    self.metrics.incr(mn.REGISTRY_SWAPS_ABANDONED_RECOVERY)
                log.warning("ABANDONED pending registry swap %s v%d -> v%d: the fenced "
                            "params are missing or damaged; version %d is retired", role,
                            entry["from_version"], to_version, to_version)

    @staticmethod
    def _pending_cutover(records: List[Dict[str, Any]],
                         base_seq: int) -> Optional[Dict[str, Any]]:
        """The newest ``cutover`` record past the recovered checkpoint
        (each stage holds the whole row set, so the newest alone is
        exact)."""
        pending = None
        for record in records:
            if record.get("kind") == "cutover" and int(record.get("seq", 0)) > base_seq:
                pending = record
        return pending

    def _complete_cutover_locked(self, gallery, cutover: Dict[str, Any],
                                 report: Dict[str, Any]) -> None:
        """Install a fenced cutover's staged row set as the whole gallery
        at the new version (``load_stage``: a missing or short stage is
        media damage and raises ``RolloutStateError``)."""
        from opencv_facerecognizer_tpu_torch.runtime.rollout import load_stage

        rows = int(cutover["rows"])
        dim = int(cutover["dim"])
        to_version = int(cutover["to_version"])
        if dim != gallery.dim:
            raise ValueError(f"state dir {self.state_dir!r} holds a pending cutover to "
                             f"dim={dim} but the gallery is dim={gallery.dim}: wrong "
                             f"--state-dir (or wrong model) for completing this rollout?")
        emb, labels = load_stage(self.state_dir, to_version, expect_rows=rows, expect_dim=dim)
        capacity = max(int(gallery.capacity), rows)
        emb_full = np.zeros((capacity, dim), np.float32)
        emb_full[:rows] = emb
        lab_full = np.full((capacity,), getattr(gallery, "labels_pad", -1), np.int32)
        lab_full[:rows] = labels
        val_full = np.zeros((capacity,), bool)
        val_full[:rows] = True
        gallery.load_snapshot(emb_full, lab_full, val_full, rows, embedder_version=to_version)
        report["completed_cutover"] = {"seq": int(cutover["seq"]),
                                       "from_version": int(cutover.get("from_version", 0)),
                                       "to_version": to_version, "rows": rows}
        if self.metrics is not None:
            self.metrics.incr(mn.ROLLOUT_CUTOVERS_COMPLETED_RECOVERY)
        log.warning("completed pending embedder cutover v%s -> v%d from the staged shard set "
                    "(%d rows; the crash fell between the cutover record and its checkpoint)",
                    cutover.get("from_version"), to_version, rows)

    def _recover_checkpoint_locked(self, gallery, names, report: Dict[str, Any],
                                   wal_records: List[Dict[str, Any]],
                                   stages: Dict[str, float]) -> Tuple[int, int]:
        """Install the newest checkpoint that verifies AND decodes,
        quarantining past any that fails either; -> (wal_seq, embedder
        version)."""
        while True:
            t = time.perf_counter()
            loaded = self.store.load_latest()
            stages["read_verify"] = time.perf_counter() - t
            if loaded is None:
                return 0, self._gallery_version(gallery)
            header, payload, path = loaded
            del loaded
            meta = header.get("meta", {})
            dim = int(meta.get("dim", -1))
            ckpt_version = int(meta.get("embedder_version", 1))
            wal_seq = int(meta.get("wal_seq", 0))
            if dim != gallery.dim:
                pending = self._pending_cutover(wal_records, wal_seq)
                if pending is not None and int(pending.get("dim", -1)) == gallery.dim:
                    # an old-space checkpoint and a durable cutover to this
                    # dim: the stage supersedes its rows; adopt its names
                    # and its anchor only
                    if names is not None:
                        names[:] = [str(v) for v in meta.get("subject_names", [])]
                    report["recovered_checkpoint"] = path
                    report["checkpoint_superseded_by_cutover"] = True
                    return wal_seq, ckpt_version
                raise ValueError(f"state dir {self.state_dir!r} holds dim={dim} checkpoints "
                                 f"but the gallery is dim={gallery.dim}: wrong --state-dir "
                                 f"for this model?")
            t = time.perf_counter()
            try:
                state = _msgpack.unpackb(payload)
                emb = np.asarray(state["emb"], np.float32)
                lab = np.array(state["lab"], np.int32)
                val = np.array(state["val"], bool)
                del state
            except Exception as exc:  # noqa: BLE001 - any decode failure is corruption
                log.warning("checkpoint %s payload decode failed (%r); falling back to "
                            "the previous checkpoint", path, exc)
                if self.metrics is not None:
                    self.metrics.incr(mn.CHECKPOINTS_CORRUPT)
                report.setdefault("payload_decode_errors", []).append(repr(exc))
                self.store.quarantine(path)
                continue
            del payload  # the file's bytes go once nothing views them
            stages["decode"] = time.perf_counter() - t
            size = int(meta.get("size", int(val.sum())))
            t = time.perf_counter()
            gallery.load_snapshot(emb, lab, val, size, embedder_version=ckpt_version)
            stages["load_snapshot"] = time.perf_counter() - t
            if names is not None:
                names[:] = [str(s) for s in meta.get("subject_names", [])]
            report["recovered_checkpoint"] = path
            report["checkpoint_size"] = size
            return wal_seq, ckpt_version

    @staticmethod
    def _grow_names(names: Optional[list], record: Dict[str, Any]) -> None:
        """Re-grow the name list from a replayed record: its subject at
        index ``label`` (gaps get placeholders)."""
        if names is None or record.get("label") is None:
            return
        label = int(record["label"])
        while len(names) <= label:
            names.append(f"subject_{len(names)}")
        if record.get("subject"):
            names[label] = str(record["subject"])

    # ---- write path ----

    def append_enrollment(self, embeddings: np.ndarray, labels: np.ndarray,
                          subject: Optional[str] = None, label: Optional[int] = None,
                          apply_fn: Optional[Callable[[], None]] = None,
                          embedder_version: Optional[int] = None) -> int:
        """Write-ahead append, then ``apply_fn`` (the gallery mutation),
        both under the enroll lock; returns the record's seq. Raises when
        the append fails (the caller must not acknowledge), when
        ``embedder_version`` differs from the gallery's
        (``EmbedderVersionMismatchError``, no seq burned), and while the
        durability monitor reports degraded (``DurabilityDegradedError``,
        no seq burned). A failed apply tombstones its burned seq."""
        dur = self.durability
        if dur is not None and dur.degraded:
            if self.metrics is not None:
                self.metrics.incr(mn.ENROLLMENTS_REFUSED_DEGRADED)
            from opencv_facerecognizer_tpu_torch.runtime.resilience import (
                DurabilityDegradedError)

            raise DurabilityDegradedError(
                "durability degraded: enrollment refused closed (WAL appends are failing "
                "on this state dir; serving continues, the recovery probe re-arms "
                "automatically)")
        n = int(np.asarray(labels).shape[0])
        t0 = time.monotonic()
        ok = False
        wal_exc: Optional[OSError] = None
        try:
            with self._enroll_lock:
                gallery, _names = self._targets()
                gver = self._gallery_version(gallery)
                if embedder_version is not None and int(embedder_version) != gver:
                    if self.metrics is not None:
                        self.metrics.incr(mn.ROLLOUT_VERSION_MISMATCHES)
                    raise EmbedderVersionMismatchError(
                        f"enrollment embedded by embedder v{embedder_version} refused: the "
                        f"gallery serves v{gver}")
                # Burn the seq before the append: a failed strict append
                # may still have landed its bytes.
                seq = self._wal_seq = self._wal_seq + 1
                try:
                    self.wal.append_enroll(seq, embeddings, labels, subject=subject,
                                           label=label, embedder_version=gver,
                                           registry=self._role_stamp())
                except InjectedCrashError:
                    raise
                except BaseException as exc:
                    self.wal.append_abort(seq)
                    if isinstance(exc, OSError):
                        wal_exc = exc  # fed to the monitor outside the lock
                    raise
                if apply_fn is not None:
                    try:
                        apply_fn()
                    except BaseException:
                        self.wal.append_abort(seq)
                        raise
                self._rows_since_ckpt += n
            ok = True
        finally:
            if self.tracer is not None:
                # outside the enroll lock; ok=False: failed or rolled back
                self.tracer.emit(self.tracer.new_trace(), "wal_append", topic=LIFECYCLE_TOPIC,
                                 t0=t0, dur=time.monotonic() - t0, rows=n, ok=ok)
            if dur is not None:
                if wal_exc is not None:
                    dur.note_wal_failure(wal_exc)
                elif ok:
                    dur.note_wal_success()
        if self.metrics is not None:
            self.metrics.set_gauge(mn.WAL_ROWS, self._rows_since_ckpt)
        self.maybe_checkpoint()
        return seq

    def stamped_snapshot(self):
        """(wal_seq, gallery snapshot, names copy, embedder version), read
        atomically against enrolments (the supervisor's last-known-good)."""
        gallery, names = self._targets()
        with self._enroll_lock:
            return (self._wal_seq, gallery.snapshot(),
                    list(names) if names is not None else None,
                    self._gallery_version(gallery))

    def replay_tail(self, from_seq: int) -> int:
        """Re-apply the acknowledged WAL records with ``seq > from_seq`` to
        the live gallery (after the supervisor rolled it back to a
        snapshot stamped ``from_seq``); returns the rows replayed."""
        gallery, names = self._targets()
        rows = 0
        with self._enroll_lock:
            gver = self._gallery_version(gallery)
            surviving, _highest = self.wal.scan()
            for record in surviving:
                if record.get("kind") != "enroll" or int(record["seq"]) <= from_seq:
                    continue
                if int(record.get("embedder_version", 1)) != gver:
                    if self.metrics is not None:
                        self.metrics.incr(mn.ROLLOUT_VERSION_SKIPPED_ROWS, int(record["n"]))
                    continue
                gallery.add(record["embeddings"], record["labels_np"])
                self._grow_names(names, record)
                rows += int(record["n"])
        if rows and self.metrics is not None:
            self.metrics.incr(mn.WAL_TAIL_REPLAYED_ROWS, rows)
        return rows

    def perform_cutover(self, to_version: int,
                        build_fn: Callable[[], Tuple[np.ndarray, np.ndarray, np.ndarray,
                                                     int]]) -> int:
        """The embedder cutover, under the enroll lock (no enrolment and no
        checkpoint snapshot can fall between the fence and the swap):
        ``build_fn()`` stages the last rows durably and returns the new
        space's ``(emb, lab, val, size)``; the ``cutover`` fence record is
        appended (strict fsync); the gallery installs the arrays and the
        version in one ``load_snapshot`` publish. Returns the fence's seq.
        The caller forces a checkpoint next; until it lands ``recover``
        completes the cutover from the stage."""
        gallery, _names = self._targets()
        t0 = time.monotonic()
        with self._enroll_lock:
            from_version = self._gallery_version(gallery)
            emb, lab, val, size = build_fn()
            fault = self._faults.on_cutover() if self._faults is not None else None
            if fault == "crash_before_record":
                raise InjectedCrashError("crash before the cutover record: the stage is "
                                         "durable, the old version stays")
            seq = self._wal_seq = self._wal_seq + 1
            self.wal.append_cutover(seq, from_version, int(to_version), rows=int(size),
                                    dim=int(emb.shape[1]))
            if fault == "crash_after_record":
                raise InjectedCrashError("crash after the cutover record, before the swap: "
                                         "recovery completes it from the stage")
            gallery.load_snapshot(emb, lab, val, int(size), embedder_version=int(to_version))
        # the quantizer retrains in the background; the exact match serves
        poke = getattr(gallery, "_poke_quantizer", None)
        if poke is not None:
            poke()
        if self.registry is not None:
            self.registry.mirror_embedder(int(to_version))
        if self.metrics is not None:
            self.metrics.incr(mn.ROLLOUT_CUTOVERS)
            self.metrics.set_gauge(mn.ROLLOUT_EMBEDDER_VERSION, int(to_version))
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "cutover", topic=LIFECYCLE_TOPIC, t0=t0,
                             dur=time.monotonic() - t0, from_version=from_version,
                             to_version=int(to_version), rows=int(size), seq=seq)
        return seq

    def perform_registry_cutover(self, role: str, to_version: int, *, config: Any = None,
                                 params_path: Optional[str] = None,
                                 params_sha256: Optional[str] = None,
                                 install_fn: Optional[Callable[[], None]] = None) -> int:
        """A detector or cascade swap, under the enroll lock (no enrolment
        and no checkpoint snapshot falls between the fence and the swap):
        the ``registry_cutover`` fence record (strict fsync), the manifest's
        ``install``, then ``install_fn()``, which publishes the weights.
        Returns the fence's seq; the caller forces a checkpoint next. The
        ``cutover`` fault boundary dies on either side of the record."""
        if self.registry is None:
            raise RuntimeError("perform_registry_cutover needs an attached ModelRegistry "
                               "(attach_registry)")
        t0 = time.monotonic()
        with self._enroll_lock:
            from_version = self.registry.version(role)
            if int(to_version) <= from_version:
                raise ValueError(f"registry versions are monotonic: {role} serves "
                                 f"v{from_version}, refusing cutover to v{to_version}")
            stamp_after = self.registry.stamp()
            stamp_after[role] = int(to_version)
            if self._service is not None or self._gallery is not None:
                gallery, _names = self._targets()
                stamp_after["embedder"] = self._gallery_version(gallery)
            fault = self._faults.on_cutover() if self._faults is not None else None
            if fault == "crash_before_record":
                raise InjectedCrashError("crash before the registry_cutover record: the "
                                         "candidate params are durable, the old version "
                                         "stays")
            seq = self._wal_seq = self._wal_seq + 1
            self.wal.append_registry_cutover(seq, role, from_version, int(to_version),
                                             registry=stamp_after, config=config,
                                             params_path=params_path,
                                             params_sha256=params_sha256)
            if fault == "crash_after_record":
                raise InjectedCrashError("crash after the registry_cutover record, before "
                                         "the manifest: recovery completes or abandons it")
            self.registry.install(role, int(to_version), config=config,
                                  params_path=params_path, params_sha256=params_sha256)
            if install_fn is not None:
                install_fn()
        if self.metrics is not None:
            self.metrics.incr(mn.REGISTRY_SWAPS)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "registry_cutover", topic=LIFECYCLE_TOPIC,
                             t0=t0, dur=time.monotonic() - t0, role=str(role),
                             from_version=from_version, to_version=int(to_version), seq=seq)
        return seq

    def adopt_wal_seq(self) -> int:
        """Seed the sequence from the existing WAL without a recovery."""
        _records, highest = self.wal.scan()
        with self._enroll_lock:
            self._wal_seq = max(self._wal_seq, int(highest))
            return self._wal_seq

    # ---- checkpointing ----

    def checkpoint_due(self) -> bool:
        if time.monotonic() < self._ckpt_retry_at:
            return False  # failure backoff
        if self._force_pending:
            return True
        if self._rows_since_ckpt >= self.checkpoint_wal_rows:
            return True
        return (self._rows_since_ckpt > 0
                and time.monotonic() - self._last_ckpt_t >= self.checkpoint_every_s)

    def tick(self) -> None:
        """The serving loop's cheap threshold check."""
        if self.checkpoint_due():
            self.maybe_checkpoint()

    def maybe_checkpoint(self, force: bool = False) -> bool:
        """Start a background checkpoint when due (or ``force``); True when
        one started. A threshold trigger that meets one in flight is
        counted and dropped; a forced one is latched for the next tick."""
        if self._closed:
            return False
        if force:
            self._force_pending = True
        elif not self.checkpoint_due():
            return False
        if self._ckpt_lock.locked():
            if self.metrics is not None:
                self.metrics.incr(mn.CHECKPOINTS_SKIPPED_INFLIGHT)
            return False
        threading.Thread(target=self.checkpoint_now, daemon=True,
                         name="state-checkpoint").start()
        return True

    def checkpoint_now(self, wait: bool = False) -> bool:
        """One durable checkpoint now: snapshot (with ``wal_seq``, under the
        enroll lock), serialize, install, write the sidecar, truncate the
        WAL below the snapshot's seq. False when another holds the single
        flight (unless ``wait``) or the save failed (counted, backed off);
        an ``InjectedCrashError`` propagates."""
        if not self._ckpt_lock.acquire(blocking=wait):
            if self.metrics is not None:
                self.metrics.incr(mn.CHECKPOINTS_SKIPPED_INFLIGHT)
            return False
        claimed_force = self._force_pending
        self._force_pending = False
        span_t0 = time.monotonic()
        span = {"outcome": "crashed", "wal_seq": None, "rows": None}
        try:
            gallery, names = self._targets()
            # Bounded wait for rows an asynchronous grow staged: a snapshot
            # taken mid-grow would miss rows whose WAL records this
            # checkpoint claims to cover.
            wait_ready = getattr(gallery, "wait_ready", None)
            if wait_ready is not None:
                wait_ready(timeout=30.0)
            t0 = time.perf_counter()
            with self._enroll_lock:
                # Staging happens only inside append_enrollment (under this
                # lock), so pending can only drain here: zero proves the
                # snapshot holds every sequenced row. Nonzero (a grow in
                # flight, wedged, or failed and awaiting a retry): defer,
                # keep the previous checkpoint and the whole WAL, retry soon.
                if getattr(gallery, "pending_rows", 0):
                    if self.metrics is not None:
                        self.metrics.incr(mn.CHECKPOINTS_DEFERRED_PENDING)
                    log.warning("checkpoint deferred: %d staged rows not yet landed",
                                gallery.pending_rows)
                    self._force_pending = self._force_pending or claimed_force
                    self._ckpt_retry_at = time.monotonic() + 5.0
                    span["outcome"] = "deferred"
                    return False
                wal_seq = self._wal_seq
                rows_at = self._rows_since_ckpt
                span.update(wal_seq=wal_seq, rows=rows_at)
                emb, lab, val, size = gallery.snapshot()
                gver = self._gallery_version(gallery)
                reg_stamp = self._role_stamp()
                names_copy = [] if names is None else list(names)
                snap_q = getattr(gallery, "snapshot_quantizer", None)
                qpayload = snap_q() if snap_q is not None else None
            t1 = time.perf_counter()
            payload = _msgpack.pack_pieces({"emb": emb, "lab": lab, "val": val})
            t2 = time.perf_counter()
            meta = {
                "kind": "gallery",
                "size": int(size),
                "capacity": int(emb.shape[0]),
                "dim": int(emb.shape[1]),
                "subject_names": names_copy,
                "wal_seq": wal_seq,
                "embedder_version": gver,
            }
            if reg_stamp is not None:
                meta["registry"] = {**reg_stamp, "embedder": gver}
            fault = self._faults.on_checkpoint() if self._faults is not None else None
            try:
                self.store.save(payload, meta, fault=fault if fault != "late" else None)
            except InjectedCrashError:
                raise
            except Exception:  # noqa: BLE001 - disk full, permissions, ...
                log.exception("checkpoint save failed")
                if self.metrics is not None:
                    self.metrics.incr(mn.CHECKPOINT_FAILURES)
                self._force_pending = self._force_pending or claimed_force
                self._ckpt_retry_at = time.monotonic() + self._ckpt_retry_backoff_s
                self._ckpt_retry_backoff_s = min(60.0, self._ckpt_retry_backoff_s * 2.0)
                span["outcome"] = "save_failed"
                return False
            nbytes = sum(memoryview(p).nbytes for p in payload)
            del payload, emb
            self.last_checkpoint_s = {"snapshot": t1 - t0, "serialize": t2 - t1,
                                      **self.store.last_save_s, "payload_bytes": nbytes}
            if qpayload is not None:
                # After the checkpoint is durable; derived state never
                # fails a checkpoint.
                from opencv_facerecognizer_tpu_torch.parallel.quantizer import (
                    encode_sidecar)

                try:
                    atomic_write_bytes(self.sidecar_path, encode_sidecar(qpayload, wal_seq))
                    if self.metrics is not None:
                        self.metrics.incr(mn.IVF_SIDECAR_WRITES)
                except OSError:
                    log.exception("quantizer sidecar write failed (the checkpoint is "
                                  "durable; recovery will retrain)")
                    if self.metrics is not None:
                        self.metrics.incr(mn.IVF_SIDECAR_ERRORS)
            if fault == "late":
                raise InjectedCrashError("crash after checkpoint, before WAL truncate")
            self.wal.truncate_below(wal_seq)
            with self._enroll_lock:
                self._rows_since_ckpt = max(0, self._rows_since_ckpt - rows_at)
            self._last_ckpt_t = time.monotonic()
            self._ckpt_retry_backoff_s = 1.0
            self._ckpt_retry_at = 0.0
            if self.metrics is not None:
                self.metrics.set_gauge(mn.WAL_ROWS, self._rows_since_ckpt)
            span["outcome"] = "ok"
            return True
        finally:
            self._ckpt_lock.release()
            if self.tracer is not None:
                self.tracer.emit(self.tracer.new_trace(), "checkpoint", topic=LIFECYCLE_TOPIC,
                                 t0=span_t0, dur=time.monotonic() - span_t0, **span)

    def close(self) -> None:
        self._closed = True
        self.wal.close()


def graceful_shutdown(service, state: Optional[StateLifecycle] = None, supervisor=None,
                      drain_timeout: float = 60.0) -> Dict[str, Any]:
    """The SIGTERM path: drain in-flight batches, stop the service (or the
    supervisor), take the final checkpoint (which truncates the WAL),
    close the state, dump the flight recorder (past its rate limit: the
    last dump of a process), and report; the caller exits 0 when
    ``report["clean"]``."""
    drained = service.drain(timeout=drain_timeout)
    if supervisor is not None:
        supervisor.stop()
    else:
        service.stop()
    report: Dict[str, Any] = {"drained": drained}
    if state is not None:
        report["final_checkpoint"] = state.checkpoint_now(wait=True)
        state.close()
    ledger = service.ledger()
    report["ledger"] = ledger
    report["clean"] = bool(drained and abs(ledger["in_system"]) < 1e-6
                           and (state is None or report["final_checkpoint"]))
    tracer = getattr(service, "tracer", None)
    if tracer is not None:
        report["flight_dump"] = tracer.dump("sigterm_drain",
                                            extra={"ledger": ledger, "drained": drained},
                                            force=True)
    return report
