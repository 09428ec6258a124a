"""Replication: port of ``opencv_facerecognizer_tpu/runtime/
replication.py``. One writer and N read replicas serve one logical
gallery over a shared ``--state-dir``; a topic router spreads camera
topics across them.

- **WriterLease**: a non-blocking ``fcntl.flock`` on ``<state-dir>/
  writer.lease`` makes one process the dir's only writer. A second writer
  fails closed at start (``WriterLeaseHeldError``) instead of interleaving
  WAL appends; the kernel drops the lock when its holder dies. The file's
  JSON (pid, host, time) is diagnostics only. It is the same file and the
  same lock in both packages, so a JAX writer and a port writer exclude
  each other too.
- **WALTailer**: a read-only incremental reader of the enrolment WAL. It
  advances only past complete lines, counts the torn remnants it skips,
  and detects a compaction swap (``truncate_below``) by inode change or
  shrink on the *open* fd, answering it by re-reading from offset 0 (the
  consumer dedups by ``seq``).
- **ReadReplica**: the tailer over a live gallery. ``resync`` loads the
  newest checkpoint that verifies (read-only: nothing is quarantined or
  renamed) through ``ShardedGallery.load_snapshot`` and anchors at its
  ``wal_seq``; ``poll`` (interval-gated, on the serving thread between
  batches) applies new rows through ``ShardedGallery.add``. It dedups by
  ``seq``, filters abort tombstones, resyncs on an abort after apply and
  on a compaction past what it applied, and parks on every fence (an
  embedder ``cutover``, a ``registry_cutover``, a row of another embedder
  version or registry stamp) until a checkpoint covering the fence's
  sequence lands. The lag gauges feed ``runtime.slo.
  replication_lag_objective``. Unlike the reference, a registry re-anchor
  also installs the weights the manifest names (``install_model``,
  ROADMAP C.15): the params staged at the version's
  ``registry_params_path`` (a swap's candidate, or the copy a rollback
  stages of the weights it restores), or, where none is staged and the
  manifest records none, version 1's: the models every process starts
  from. So a reader's stamps name the weights that ran; an install that
  fails is retried alone after a backoff, and the reader's health reads
  critical meanwhile.
- **TopicRouter**: a ``MiddlewareConnector`` over N replicas: rendezvous
  order per topic (blake2b, 8 bytes, over ``topic\\0name``: both packages
  route a topic to the same replica), per-replica token-bucket budgets
  that spill to the next replica, health failover and recovery, planned
  cordons, link supervision by ping/pong with a deadline, hedging of
  interactive frames by frame id, and first-result-wins dedup at fan-in.
  It holds no model and touches no card.

A read replica serves a prefix of the acknowledged enrolment history;
once its lag is 0 it holds exactly that history. Its staleness is the
poll interval plus the append's visibility, surfaced by the gauges.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import logging
import os
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from opencv_facerecognizer_tpu_torch.runtime.admission import TokenBucket
from opencv_facerecognizer_tpu_torch.runtime.connector import MiddlewareConnector
from opencv_facerecognizer_tpu_torch.runtime.state_store import (
    CheckpointCorruptError, CheckpointVersionError, StateLifecycle, _decode_checkpoint,
    decode_enroll_record, read_checkpoint_header, scan_checkpoint_files)
from opencv_facerecognizer_tpu_torch.utils import _msgpack
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC

LEASE_NAME = "writer.lease"

#: a failed weights install is retried alone on the poll, after a backoff
#: that doubles from the first to the last
INSTALL_RETRY_S = (1.0, 60.0)

log = logging.getLogger(__name__)


class WriterLeaseHeldError(RuntimeError):
    """Another process holds the writer lease."""


class WriterLease:
    """Exclusive writer ownership of one ``--state-dir``; ``acquire`` never
    blocks."""

    def __init__(self, state_dir: str, metrics=None):
        self.state_dir = str(state_dir)
        self.path = os.path.join(self.state_dir, LEASE_NAME)
        self.metrics = metrics
        self._fd: Optional[int] = None

    @property
    def held(self) -> bool:
        return self._fd is not None

    def acquire(self) -> "WriterLease":
        """Take the lease or raise ``WriterLeaseHeldError`` (idempotent
        while held). The holder's diagnostics are written after the lock
        is won."""
        if self._fd is not None:
            return self
        os.makedirs(self.state_dir, exist_ok=True)
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            holder = ""
            try:
                holder = os.read(fd, 4096).decode("utf-8", "replace").strip()
            except OSError:
                pass
            try:
                os.close(fd)
            except OSError:
                pass
            if self.metrics is not None:
                self.metrics.incr(mn.REPLICATION_LEASE_CONFLICTS)
            raise WriterLeaseHeldError(
                f"writer lease {self.path} is held"
                + (f" (holder: {holder})" if holder else "")
                + " — refusing to start a second writer (split-brain fails closed)")
        info = {"pid": os.getpid(), "host": socket.gethostname(), "acquired_ts": time.time()}
        try:
            os.ftruncate(fd, 0)
            os.write(fd, (json.dumps(info) + "\n").encode("utf-8"))
            os.fsync(fd)
        except OSError:
            log.exception("writer lease holder info write failed")
        self._fd = fd
        if self.metrics is not None:
            self.metrics.incr(mn.REPLICATION_LEASE_ACQUIRED)
        return self

    def release(self) -> None:
        """Drop the lease (the file stays, with stale diagnostics)."""
        fd, self._fd = self._fd, None
        if fd is None:
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        except OSError:
            pass
        try:
            os.close(fd)
        except OSError:
            pass

    close = release

    def __enter__(self) -> "WriterLease":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class WALTailer:
    """Read-only incremental reader of one WAL file (module docstring).
    One consumer (the replica's serving thread, or the verifier), so no
    lock, and none held across file I/O."""

    def __init__(self, path: str, metrics=None, fault_injector=None):
        self.path = str(path)
        self.metrics = metrics
        #: ``runtime.faults`` hook: the storage boundary's read side at the
        #: top of every poll
        self._faults = fault_injector
        self._offset = 0
        self._inode: Optional[int] = None
        self.reopens = 0
        self.malformed_lines = 0

    def reset(self) -> None:
        """The next ``poll`` reads the file from the start."""
        self._offset = 0
        self._inode = None

    def poll(self) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
        """Every complete line appended since the last poll, parsed, in
        file order, and ``info``: ``reopened`` (a compaction swapped a new
        file in), ``partial`` (an append is in progress past the offset),
        ``missing`` or ``error`` (a read error, counted). Unparseable and
        non-object lines are skipped and counted, as replay skips them."""
        info: Dict[str, Any] = {"reopened": False, "partial": False}
        try:
            if self._faults is not None:
                self._faults.on_storage_read("tailer_poll")
            fd = os.open(self.path, os.O_RDONLY)
        except FileNotFoundError:
            info["missing"] = True
            return [], info
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.REPLICATION_POLL_ERRORS)
            info["error"] = True
            return [], info
        try:
            st = os.fstat(fd)
            if self._inode is not None and (st.st_ino != self._inode
                                            or st.st_size < self._offset):
                # a rewritten file (new inode) or a shrink: from zero again
                self._offset = 0
                self.reopens += 1
                info["reopened"] = True
                if self.metrics is not None:
                    self.metrics.incr(mn.REPLICATION_WAL_REOPENS)
            self._inode = st.st_ino
            if st.st_size <= self._offset:
                return [], info
            os.lseek(fd, self._offset, os.SEEK_SET)
            chunks = []
            while True:
                chunk = os.read(fd, 1 << 20)
                if not chunk:
                    break
                chunks.append(chunk)
            blob = b"".join(chunks)
        finally:
            os.close(fd)
        nl = blob.rfind(b"\n")
        if nl < 0:
            # one append without its newline yet: never advance past it
            info["partial"] = True
            return [], info
        self._offset += nl + 1
        if nl + 1 < len(blob):
            info["partial"] = True
        records: List[Dict[str, Any]] = []
        for line in blob[:nl].split(b"\n"):
            text = line.strip()
            if not text:
                continue
            try:
                record = json.loads(text.decode("utf-8", errors="replace"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                record = None
            if not isinstance(record, dict):
                self.malformed_lines += 1  # a sealed torn remnant
                continue
            records.append(record)
        return records, info


def load_latest_checkpoint_readonly(ckpt_dir: str, metrics=None,
                                    stages: Optional[Dict[str, float]] = None):
    """The newest checkpoint that verifies and decodes, as ``(header,
    {"emb", "lab", "val"}, path)``, or None. Never touches the directory:
    a corrupt file is logged, counted and skipped, not quarantined (renames
    are the writer's). ``stages`` receives the seconds of ``read_verify``
    and ``decode``."""
    for _seq, path in scan_checkpoint_files(ckpt_dir):
        t = time.perf_counter()
        try:
            with open(path, "rb") as fh:
                header, payload = _decode_checkpoint(fh.read(), path)
            t1 = time.perf_counter()
            state = _msgpack.unpackb(payload)
            emb = np.asarray(state["emb"], np.float32)
            lab = np.asarray(state["lab"], np.int32)
            val = np.asarray(state["val"], bool)
        except CheckpointVersionError as exc:
            log.warning("replica: newer-format checkpoint skipped: %s", exc)
            continue
        except (OSError, CheckpointCorruptError, KeyError, TypeError, ValueError) as exc:
            log.warning("replica: unreadable checkpoint skipped (read-only, not "
                        "quarantined): %s: %r", path, exc)
            if metrics is not None:
                metrics.incr(mn.CHECKPOINTS_CORRUPT)
            continue
        if stages is not None:
            stages["read_verify"] = t1 - t
            stages["decode"] = time.perf_counter() - t1
        return header, {"emb": emb, "lab": lab, "val": val}, path
    return None


def newest_checkpoint_info(ckpt_dir: str) -> Tuple[int, int]:
    """``(wal_seq, embedder_version)`` of the newest checkpoint whose
    header verifies, ``(0, 0)`` without one; reads headers only."""
    for _seq, path in scan_checkpoint_files(ckpt_dir):
        try:
            header = read_checkpoint_header(path)
        except (OSError, CheckpointCorruptError, CheckpointVersionError):
            continue
        meta = header.get("meta", {})
        return int(meta.get("wal_seq", 0)), int(meta.get("embedder_version", 1))
    return 0, 0


def newest_checkpoint_wal_seq(ckpt_dir: str) -> int:
    """The ``wal_seq`` of ``newest_checkpoint_info``."""
    return newest_checkpoint_info(ckpt_dir)[0]


def pipeline_model_installer(pipeline) -> Callable[[str, int, Optional[str]], None]:
    """The ``ReadReplica.install_model`` of a ``RecognitionPipeline``:
    ``install(role, version, params_path)`` serves the params file, loaded
    onto the pipeline's device, as ``version`` through
    ``install_detector_params`` / ``install_cascade`` (under the lock that
    orders installs against queued steps). ``params_path`` None serves
    version 1's weights again: the ones the pipeline ran before its first
    install, copied then. Raises ``LookupError`` when it started on a
    later version and so never held them."""
    import copy

    first: Dict[str, Any] = {}  # role -> (running version, weights copy)

    def install(role: str, version: int, params_path: Optional[str]) -> None:
        if role not in ("detector", "cascade"):
            raise ValueError(f"no installer for role {role!r}")
        if role not in first:
            running = pipeline.model_versions.get(role, 1)
            first[role] = (running, {k: v.detach().clone()
                                     for k, v in pipeline.detector.params.items()}
                           if role == "detector" else copy.deepcopy(pipeline.cascade))
        if params_path is None:
            running, weights = first[role]
            if running != 1:
                raise LookupError(f"{role} v{version} serves version 1's weights, which this "
                                  f"pipeline never ran (it started on v{running})")
        elif role == "detector":
            from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector

            weights = CNNFaceDetector.load(params_path, device=pipeline.device).params
        else:
            from opencv_facerecognizer_tpu_torch.models.cascade import FaceGate

            weights = FaceGate.load(params_path, device=pipeline.device)
        if role == "detector":
            pipeline.install_detector_params(weights, version=version)
        else:
            pipeline.install_cascade(weights, version=version)

    return install


class ReadReplica:
    """One read replica of a shared ``--state-dir`` (module docstring):
    the checkpoint anchor and the WAL tail applied to a live gallery
    between batches. Single-threaded: ``RecognizerService(replica=...)``
    ticks ``poll`` on its serving loop, so applies interleave with
    dispatch as the writer's enrolments do, and a resync (the checkpoint
    read, decode and upload) stalls that replica's serving while it runs
    (``last_resync_s`` keeps its stages)."""

    def __init__(self, state_dir: str, gallery, subject_names: Optional[list] = None,
                 metrics=None, tracer=None, poll_interval_s: float = 0.05,
                 name: str = "replica", fault_injector=None):
        self.state_dir = str(state_dir)
        self.wal_path = os.path.join(self.state_dir, "enroll.wal")
        self.ckpt_dir = os.path.join(self.state_dir, "checkpoints")
        self.gallery = gallery
        self.subject_names = subject_names if subject_names is not None else []
        self.metrics = metrics
        self.tracer = tracer
        self.poll_interval_s = float(poll_interval_s)
        self.name = str(name)
        self.tailer = WALTailer(self.wal_path, metrics=metrics, fault_injector=fault_injector)
        #: highest WAL seq applied to (or covered by the checkpoint under)
        #: the gallery, and the highest seen in the file (lag numerator)
        self.applied_seq = 0
        self.seen_seq = 0
        self.anchor_checkpoint: Optional[str] = None
        self.lag_rows = 0
        self.lag_s = 0.0
        self._synced = False
        self._resync_needed = False
        self._last_poll_t = 0.0
        # the last anchor and the abort seqs already accounted for: a
        # compaction reopen re-reads surviving tombstones, which must not
        # force a resync again
        self._anchor_seq = 0
        self._aborted_seen: set = set()
        #: the embedder version the gallery serves (the checkpoint's)
        self.embedder_version = int(getattr(gallery, "embedder_version", 1))
        # a fence seen in the tail: {"to_version", "seq"[, "role" |
        # "registry"]}; nothing is applied past it until a checkpoint
        # covering its seq lands
        self._await_cutover: Optional[Dict[str, Any]] = None
        #: ``on_resync("begin" | "end")`` around every resync (a router's
        #: ``cordon_hook`` drains the replica meanwhile)
        self.on_resync: Optional[Callable[[str], None]] = None
        #: a read-only ``runtime.registry.ModelRegistry``: re-read at every
        #: resync, its fences park the tail
        self.registry = None
        #: ``install_model(role, version, params_path)``: serves the
        #: weights of a role whose manifest version moved at a re-anchor
        #: (``pipeline_model_installer``), before ``on_registry_change``;
        #: ``params_path`` is None for a version that stages no params:
        #: version 1's weights (module docstring)
        self.install_model: Optional[Callable[[str, int, Optional[str]], None]] = None
        self._install_due: Dict[str, int] = {}  # role -> version not installed yet
        self._install_retry_at = 0.0
        self._install_backoff_s = 0.0
        #: the last failed install, while one is due
        self.install_error: Optional[str] = None
        self.on_registry_change: Optional[Callable[[Dict[str, int]], None]] = None
        #: seconds of the last resync's stages: read_verify, decode,
        #: load_snapshot, registry, tail
        self.last_resync_s: Dict[str, float] = {}

    # ---- sync ----

    def resync(self) -> Dict[str, Any]:
        """Re-anchor: the newest readable checkpoint through
        ``load_snapshot`` (or an empty gallery without one), ``applied_seq``
        its ``wal_seq``, the registry re-read (and the moved roles'
        weights installed: a failed install is retried alone, see
        ``install_pending``), then one read of the whole WAL applying every
        surviving row past the anchor. Raises when the checkpoint's dim is
        not the gallery's."""
        report = {"checkpoint": None, "applied_records": 0, "applied_rows": 0}
        stages: Dict[str, float] = {}
        if self.on_resync is not None:
            try:
                self.on_resync("begin")
            except Exception:  # noqa: BLE001 - a drain hook's bug must not block the resync
                log.exception("replica %s on_resync(begin) failed", self.name)
        try:
            loaded = load_latest_checkpoint_readonly(self.ckpt_dir, metrics=self.metrics,
                                                     stages=stages)
            prior_version = self.embedder_version
            if loaded is not None:
                header, state, path = loaded
                meta = header.get("meta", {})
                dim = int(meta.get("dim", -1))
                if dim != self.gallery.dim:
                    raise ValueError(
                        f"replica {self.name}: state dir {self.state_dir!r} holds dim={dim} "
                        f"checkpoints but the gallery is dim={self.gallery.dim}: wrong "
                        f"--state-dir for this model?")
                size = int(meta.get("size", int(state["val"].sum())))
                ckpt_version = int(meta.get("embedder_version", 1))
                t = time.perf_counter()
                self.gallery.load_snapshot(state["emb"], state["lab"], state["val"], size,
                                           embedder_version=ckpt_version)
                stages["load_snapshot"] = time.perf_counter() - t
                del state, loaded
                self.subject_names[:] = [str(s) for s in meta.get("subject_names", [])]
                self.applied_seq = int(meta.get("wal_seq", 0))
                self.anchor_checkpoint = path
                self.embedder_version = ckpt_version
                report["checkpoint"] = path
                if ckpt_version != prior_version:
                    if self.metrics is not None:
                        self.metrics.incr(mn.ROLLOUT_REPLICA_REANCHORS)
                    log.info("replica %s re-anchored onto embedder v%d (was v%d)",
                             self.name, ckpt_version, prior_version)
            else:
                # no checkpoint yet: the whole WAL onto an empty gallery
                if self.gallery.size:
                    self.gallery.reset()
                self.subject_names[:] = []
                self.applied_seq = 0
                self.anchor_checkpoint = None
            if self.registry is not None:
                t = time.perf_counter()
                self._reanchor_registry()
                stages["registry"] = time.perf_counter() - t
            self.seen_seq = max(self.seen_seq, self.applied_seq)
            self._anchor_seq = self.applied_seq
            self._aborted_seen.clear()
            self._await_cutover = None
            if self.metrics is not None:
                self.metrics.set_gauge(mn.ROLLOUT_REPLICA_AWAITING, 0)
            t = time.perf_counter()
            self.tailer.reset()
            records, _info = self.tailer.poll()
            applied = self._apply_records(records)
            stages["tail"] = time.perf_counter() - t
            report["applied_records"] = applied["records"]
            report["applied_rows"] = applied["rows"]
            self._synced = True
            self._resync_needed = False
            self._update_lag()
        finally:
            if self.on_resync is not None:
                try:
                    self.on_resync("end")
                except Exception:  # noqa: BLE001 - see begin
                    log.exception("replica %s on_resync(end) failed", self.name)
        self.last_resync_s = stages
        if self.metrics is not None:
            self.metrics.incr(mn.REPLICATION_RESYNCS)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "wal_tail", topic=LIFECYCLE_TOPIC,
                             replica=self.name, resync=True, applied_seq=self.applied_seq,
                             rows=applied["rows"], embedder_version=self.embedder_version,
                             checkpoint=report["checkpoint"])
        return report

    def _reanchor_registry(self) -> None:
        """Re-read the manifest; serve the weights of each detector or
        cascade version that moved (or whose install is still due), then
        announce the new stamp."""
        prior = self.registry.stamp()
        self.registry.reload()
        stamp = self.registry.stamp()
        changed = stamp != prior
        if changed:
            log.info("replica %s re-anchored registry %s -> %s", self.name, prior, stamp)
            if self.metrics is not None:
                self.metrics.incr(mn.ROLLOUT_REPLICA_REANCHORS)
            for role in ("detector", "cascade"):
                if stamp.get(role) != prior.get(role):
                    self._install_due[role] = int(stamp[role])
        if self._install_moved() or changed:
            self._registry_changed()

    def _registry_changed(self) -> None:
        if self.on_registry_change is not None:
            try:
                self.on_registry_change(dict(self.registry.stamp()))
            except Exception:  # noqa: BLE001 - a cache hook only
                log.exception("replica %s on_registry_change failed", self.name)

    def _install_moved(self) -> bool:
        """Install every due role's weights: the params staged at its
        version's ``registry_params_path``, or version 1's weights when
        the manifest records none and none is staged (a rollback to them).
        A failure keeps the role due and retries it alone on the poll
        after a backoff (``INSTALL_RETRY_S``); meanwhile
        ``install_pending`` names it and the replica's health reads
        critical, as its stamps keep naming the weights that run. Returns
        True when one installed."""
        from opencv_facerecognizer_tpu_torch.runtime.registry import registry_params_path

        if self.install_model is None:
            self._install_due.clear()
            return False
        installed = False
        for role, version in sorted(self._install_due.items()):
            try:
                path = registry_params_path(self.state_dir, role, version)
                if not os.path.exists(path):
                    recorded = self.registry.describe(role).get("params_path")
                    if recorded is not None:
                        raise FileNotFoundError(f"the manifest names {recorded} but {path} "
                                                f"is not staged")
                    path = None
                self.install_model(role, version, path)
            except Exception as exc:  # noqa: BLE001 - retried; health reads critical
                self.install_error = f"{role} v{version}: {exc!r}"
                if self.metrics is not None:
                    self.metrics.incr(mn.REPLICATION_INSTALL_ERRORS)
                log.error("replica %s: installing %s v%d failed (%r); the running weights "
                          "and their stamps stay", self.name, role, version, exc)
                continue
            del self._install_due[role]
            installed = True
        if self._install_due:
            low, high = INSTALL_RETRY_S
            self._install_backoff_s = min(high, max(low, 2 * self._install_backoff_s))
            self._install_retry_at = time.monotonic() + self._install_backoff_s
        else:
            self.install_error = None
            self._install_backoff_s = 0.0
        return installed

    @property
    def install_pending(self) -> Dict[str, int]:
        """``{role: version}`` whose install failed and is retried: the
        manifest names weights this replica does not run."""
        return dict(self._install_due) if self.install_error is not None else {}

    # ---- the tail ----

    def poll(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """Apply what the WAL grew since the last poll (interval-gated;
        ``force`` bypasses the gate). Returns the summary, or None when not
        due (one clock read)."""
        now = time.monotonic()
        if not force and now - self._last_poll_t < self.poll_interval_s:
            return None
        self._last_poll_t = now
        if self.metrics is not None:
            self.metrics.incr(mn.REPLICATION_POLLS)
        if not self._synced or self._resync_needed:
            return self.resync()
        if self._install_due and now >= self._install_retry_at and self._install_moved():
            self._registry_changed()
        if self._await_cutover is not None:
            # parked: watch (headers only) for a checkpoint covering the
            # fence's seq; any such checkpoint was taken after the swap, so
            # it carries its version or a later one (stacked cutovers). The
            # tail still advances seen_seq: the lag stays honest
            anchor_seq, _version = newest_checkpoint_info(self.ckpt_dir)
            if anchor_seq >= self._await_cutover["seq"]:
                return self.resync()
            records, _info = self.tailer.poll()
            for record in records:
                seq = record.get("seq")
                if isinstance(seq, (int, float)):
                    self.seen_seq = max(self.seen_seq, int(seq))
            self._update_lag()
            return {"records": 0, "rows": 0,
                    "awaiting_version": self._await_cutover["to_version"]}
        records, info = self.tailer.poll()
        if info["reopened"] and newest_checkpoint_wal_seq(self.ckpt_dir) > self.applied_seq:
            # the compaction truncated rows this replica never applied
            return self.resync()
        applied = self._apply_records(records)
        if self._resync_needed:
            return self.resync()  # an abort after apply: no phantom rows
        self._update_lag()
        if applied["rows"] and self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "wal_tail", topic=LIFECYCLE_TOPIC,
                             replica=self.name, resync=False, rows=applied["rows"],
                             records=applied["records"], applied_seq=self.applied_seq,
                             lag_s=round(self.lag_s, 4))
        return applied

    def _park(self, fence: Dict[str, Any]) -> None:
        self._await_cutover = fence
        if self.metrics is not None:
            self.metrics.set_gauge(mn.ROLLOUT_REPLICA_AWAITING, 1)

    def _gallery_version(self) -> int:
        return int(getattr(self.gallery, "embedder_version", self.embedder_version))

    def _apply_records(self, records: List[Dict[str, Any]]) -> Dict[str, Any]:
        """Apply one poll's records in file order, filtering the aborts
        among them; an abort whose enroll an earlier poll applied flags a
        resync."""
        applied_at_entry = self.applied_seq
        aborted = set()
        for record in records:
            seq = record.get("seq")
            if record.get("kind") == "abort" and isinstance(seq, (int, float)):
                seq = int(seq)
                aborted.add(seq)
                # after apply only when new (not a reopen's replay) and not
                # covered by the anchor (whose checkpoint never held the row)
                if (seq <= applied_at_entry and seq > self._anchor_seq
                        and seq not in self._aborted_seen):
                    log.warning("replica %s: abort for already-applied seq %d; resync",
                                self.name, seq)
                    if self.metrics is not None:
                        self.metrics.incr(mn.REPLICATION_ABORTS_AFTER_APPLY)
                    self._resync_needed = True
                self._aborted_seen.add(seq)
                if len(self._aborted_seen) > 1 << 16:
                    self._resync_needed = True  # bound the set: a resync restarts it
        out = {"records": 0, "rows": 0}
        oldest_ts: Optional[float] = None
        for record in records:
            seq = record.get("seq")
            if isinstance(seq, (int, float)):
                self.seen_seq = max(self.seen_seq, int(seq))
            kind = record.get("kind")
            if kind == "cutover" and isinstance(seq, (int, float)):
                seq = int(seq)
                if seq <= self.applied_seq:
                    continue  # covered by the anchor
                to_version = int(record.get("to_version", 0))
                if to_version == self._gallery_version():
                    self.applied_seq = seq  # already there: burn it
                    continue
                self._park({"to_version": to_version, "seq": seq})
                log.info("replica %s: cutover fence seq %d -> embedder v%d; holding at v%d "
                         "until a covering checkpoint lands", self.name, seq, to_version,
                         self.embedder_version)
                break
            if kind == "registry_cutover" and isinstance(seq, (int, float)):
                seq = int(seq)
                if seq <= self.applied_seq:
                    continue
                role = str(record.get("role", "?"))
                to_version = int(record.get("to_version", 0))
                if self.registry is not None and self.registry.version(role) >= to_version:
                    self.applied_seq = seq  # the manifest here covers it: burn it
                    continue
                self._park({"to_version": to_version, "seq": seq, "role": role})
                log.info("replica %s: registry fence seq %d -> %s v%d; holding until a "
                         "covering checkpoint lands", self.name, seq, role, to_version)
                break
            if kind == "registry_abort" and isinstance(seq, (int, float)):
                continue  # voids a fence that parks the tail anyway
            if kind != "enroll" or not isinstance(seq, (int, float)):
                continue
            seq = int(seq)
            if seq <= self.applied_seq:
                continue  # applied, or covered by the anchor
            if seq in aborted:
                self.applied_seq = seq  # tombstoned: burn it
                continue
            if int(record.get("embedder_version", 1)) != self._gallery_version():
                # a version fence with no visible cutover record (a late
                # start past a compacted fence): park like the explicit one
                self._park({"to_version": int(record.get("embedder_version", 1)),
                            "seq": seq})
                log.warning("replica %s: enroll seq %d carries embedder v%s but the gallery "
                            "serves v%d; holding for a matching checkpoint", self.name, seq,
                            record.get("embedder_version"), self.embedder_version)
                break
            row_stamp = record.get("registry")
            if (isinstance(row_stamp, dict) and self.registry is not None
                    and any(int(v) != self.registry.version(str(r))
                            for r, v in row_stamp.items())):
                self._park({"to_version": 0, "seq": seq, "registry": dict(row_stamp)})
                log.warning("replica %s: enroll seq %d carries registry stamp %s but the "
                            "manifest here serves %s; holding for a covering checkpoint",
                            self.name, seq, row_stamp, self.registry.stamp())
                break
            decoded = decode_enroll_record(record)
            if decoded is None:
                # acknowledged and unreadable: counted loudly, not applied
                if self.metrics is not None:
                    self.metrics.incr(mn.REPLICATION_CORRUPT_RECORDS)
                log.error("replica %s: corrupt acked WAL record seq %d", self.name, seq)
                self.applied_seq = seq
                continue
            self.gallery.add(decoded["embeddings"], decoded["labels_np"])
            StateLifecycle._grow_names(self.subject_names, decoded)
            self.applied_seq = seq
            out["records"] += 1
            out["rows"] += int(decoded["n"])
            ts = record.get("ts")
            if isinstance(ts, (int, float)) and oldest_ts is None:
                oldest_ts = float(ts)
        if out["rows"]:
            if self.metrics is not None:
                self.metrics.incr(mn.REPLICATION_RECORDS_APPLIED, out["records"])
                self.metrics.incr(mn.REPLICATION_ROWS_APPLIED, out["rows"])
            if oldest_ts is not None:
                # the oldest row's age when it became visible here
                self.lag_s = max(0.0, time.time() - oldest_ts)
        else:
            self.lag_s = 0.0
        return out

    def _update_lag(self) -> None:
        self.lag_rows = max(0, self.seen_seq - self.applied_seq)
        if self.metrics is not None:
            self.metrics.set_gauge(mn.REPLICATION_LAG_ROWS, self.lag_rows)
            self.metrics.set_gauge(mn.REPLICATION_LAG_S, round(self.lag_s, 4))

    def stats(self) -> Dict[str, Any]:
        return {"name": self.name, "applied_seq": self.applied_seq,
                "seen_seq": self.seen_seq, "lag_rows": self.lag_rows,
                "lag_s": round(self.lag_s, 4), "wal_reopens": self.tailer.reopens,
                "anchor_checkpoint": self.anchor_checkpoint,
                "embedder_version": self.embedder_version,
                "registry": self.registry.stamp() if self.registry is not None else None,
                "awaiting_cutover": (dict(self._await_cutover)
                                     if self._await_cutover else None),
                "gallery_size": int(self.gallery.size)}


# ---- health probes ----


def service_health_probe(service) -> Callable[[], int]:
    """In-process health: critical when the service stopped, its loop
    crashed or its replica runs weights other than its manifest names
    (``ReadReplica.install_pending``), else its SLO monitor's state code
    (ok without one): the verdict ``/health`` serves, read without
    HTTP."""
    from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL, STATE_OK

    def probe() -> int:
        if service.loop_crashed or not service._running:
            return STATE_CRITICAL
        replica = getattr(service, "replica", None)
        if replica is not None and replica.install_pending:
            return STATE_CRITICAL
        monitor = getattr(service, "slo", None)
        return monitor.state_code if monitor is not None else STATE_OK

    return probe


def http_health_probe(url: str, timeout_s: float = 2.0) -> Callable[[], int]:
    """A replica's ``GET /health``: 503 reads critical, 200 its JSON
    ``state_code`` (ok when absent or unparseable); any other failure
    raises, and the router fails the replica closed."""
    import urllib.error
    import urllib.request

    def probe() -> int:
        from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL

        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                body = resp.read(1 << 16)
        except urllib.error.HTTPError as exc:
            if exc.code == 503:
                return STATE_CRITICAL
            raise
        try:
            return int(json.loads(body.decode("utf-8")).get("state_code", 0))
        except (json.JSONDecodeError, UnicodeDecodeError, TypeError, ValueError,
                AttributeError):
            return 0  # reachable is serving

    return probe


# ---- the topic router ----


class ReplicaHandle:
    """One routable replica: its connector, an optional health probe (a
    ``runtime.slo`` state code; raising reads as down) and an optional
    frames/s budget (a token bucket with ``budget_burst_s`` of burst)."""

    def __init__(self, name: str, connector: MiddlewareConnector,
                 health_fn: Optional[Callable[[], int]] = None,
                 budget_fps: Optional[float] = None, budget_burst_s: float = 1.0,
                 writer: bool = False):
        self.name = str(name)
        self.connector = connector
        self.health_fn = health_fn
        self.budget = (TokenBucket(float(budget_fps), float(budget_fps) * float(budget_burst_s))
                       if budget_fps else None)
        self.budget_fps = budget_fps
        #: the enrolment owner: control traffic routes here only
        self.writer = bool(writer)
        self.healthy = True
        self.health_state = 0
        #: a planned drain (``TopicRouter.set_cordon``): out of rendezvous
        #: like an unhealthy replica, but no failover is counted
        self.cordoned = False
        self.routed = 0
        self.last_probe_error: Optional[str] = None
        #: consecutive probe exceptions (capped), logged on the first only
        self.probe_streak = 0
        #: a pong came back within the router's ``link_deadline_s``
        self.link_up = True
        self.last_pong_t: Optional[float] = None


class TopicRouter(MiddlewareConnector):
    """Rendezvous topic router over N replicas (module docstring).
    ``publish(<camera topic>, frame)`` forwards to the chosen replica's
    ``FRAME_TOPIC`` (with ``_route_topic`` when the topic is not it);
    results and statuses of every replica fan back in to the router's
    subscribers, a status stamped with its ``replica``. The health thread
    (``start``) runs the probes, the link pings and the hedges; routing
    only reads the flags they set. A replica turning critical is a
    failover: counted, a ``failover`` span and a flight dump, and out of
    rendezvous until it recovers; the router queues nothing itself."""

    #: cap of a replica's consecutive probe-error streak
    PROBE_STREAK_CAP = 1000

    def __init__(self, replicas: List[ReplicaHandle], metrics=None, tracer=None,
                 health_interval_s: float = 1.0, fault_injector=None,
                 link_deadline_s: Optional[float] = None,
                 hedge_deadline_s: Optional[float] = None, dedup_window: int = 4096):
        from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
            CONTROL_TOPIC, FRAME_TOPIC, LINK_PING_TOPIC, LINK_PONG_TOPIC, RESULT_TOPIC,
            STATUS_TOPIC)

        self.metrics = metrics
        self.tracer = tracer
        self.health_interval_s = float(health_interval_s)
        #: ``runtime.faults`` transport boundary: every forward and ping
        #: (send) and every fan-in and pong (recv) crosses ``on_transport``
        self._faults = fault_injector
        #: None: no link supervision; else a replica whose last pong is
        #: older than this is out of rendezvous until it pongs again
        self.link_deadline_s = None if link_deadline_s is None else float(link_deadline_s)
        #: None: no hedging; else an interactive frame without a result
        #: after this long is re-sent once to its next replica
        self.hedge_deadline_s = None if hedge_deadline_s is None else float(hedge_deadline_s)
        #: frame ids remembered (stamping, fan-in dedup, hedges); 0 = off
        self.dedup_window = max(0, int(dedup_window))
        self.frame_topic = FRAME_TOPIC
        self.control_topic = CONTROL_TOPIC
        self.status_topic = STATUS_TOPIC
        self.result_topic = RESULT_TOPIC
        self.link_ping_topic = LINK_PING_TOPIC
        self.link_pong_topic = LINK_PONG_TOPIC
        self._result_topics = (RESULT_TOPIC, STATUS_TOPIC)
        self._lock = threading.Lock()
        self._replicas: List[ReplicaHandle] = list(replicas)
        self._handlers: Dict[str, List] = {}
        #: topic -> (replica, last routed time), behind ``/replicas``
        self._topic_map: Dict[str, Tuple[str, float]] = {}
        self._topic_map_max = 4096
        self._order_cache: Dict[str, List[ReplicaHandle]] = {}
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # hedges and dedup, under their own lock (fan-in runs on the
        # replicas' connector threads)
        self._hedge_lock = threading.Lock()
        self._fid_counter = 0
        self._inflight: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._seen_results: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._ping_counter = 0
        for handle in self._replicas:
            self._wire_replica(handle)
        self._set_replica_gauges()

    # ---- the replicas ----

    def _wire_replica(self, handle: ReplicaHandle) -> None:
        for topic in self._result_topics:
            handle.connector.subscribe(topic, self._make_fan_in(topic, handle.name))
        handle.connector.subscribe(self.link_pong_topic, self._make_pong(handle.name))

    def _transport_sink(self, kind: str) -> None:
        if self.metrics is not None:
            self.metrics.incr(mn.TRANSPORT_FAULTS_PREFIX + kind)

    def _cross(self, name: str, direction: str, message: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One crossing of the link to replica ``name``: ``[message]``
        without an injector."""
        if self._faults is None:
            return [message]
        return self._faults.on_transport(name, direction, message, sink=self._transport_sink)

    def _make_fan_in(self, topic: str, name: str):
        # statuses get the replica's name; results pass the first-result-
        # wins window (a duplicate, a failover re-send or a hedge's loser
        # never publishes twice upstream)
        stamp = topic == self.status_topic
        dedup = topic == self.result_topic

        def fan_in(_topic, message, _name=name, _up=topic, _stamp=stamp, _dedup=dedup):
            for msg in self._cross(_name, "recv", message):
                if _stamp and isinstance(msg, dict):
                    msg = {**msg, "replica": _name}
                if _dedup and not self._admit_result(_name, msg):
                    continue
                self._dispatch_up(_up, msg)

        return fan_in

    def _make_pong(self, name: str):
        def on_pong(_topic, message, _name=name):
            if not self._cross(_name, "recv", message):
                return  # lost on the wire
            handle = self._handle(_name)
            if handle is None:
                return
            handle.last_pong_t = time.monotonic()
            if self.metrics is not None:
                self.metrics.incr(mn.LINK_HEARTBEATS_RECEIVED)

        return on_pong

    def _handle(self, name: str) -> Optional[ReplicaHandle]:
        with self._lock:
            return next((r for r in self._replicas if r.name == name), None)

    def replace_connector(self, name: str, connector: MiddlewareConnector) -> None:
        """Point replica ``name`` at a new connector (a restarted process)
        and subscribe the fan-in there; its name, so its topics, stay.
        Raises ``KeyError`` for an unknown name."""
        handle = self._handle(name)
        if handle is None:
            raise KeyError(f"no replica named {name!r}")
        handle.connector = connector
        self._wire_replica(handle)

    def _dispatch_up(self, topic: str, message: Dict[str, Any]) -> None:
        with self._lock:
            handlers = list(self._handlers.get(topic, ()))
        for handler in handlers:
            handler(topic, message)

    def subscribe(self, topic: str, handler) -> None:
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def set_cordon(self, name: str, cordoned: bool) -> None:
        """A planned drain of replica ``name``: while cordoned its topics
        go to their next replicas, and uncordoning hands exactly them back.
        No failover is counted and nothing is dumped. Raises ``KeyError``
        for an unknown name."""
        handle = self._handle(name)
        if handle is None:
            raise KeyError(f"no replica named {name!r}")
        if cordoned and not handle.cordoned:
            if self.metrics is not None:
                self.metrics.incr(mn.ROUTER_CUTOVER_DRAINS)
            if self.tracer is not None:
                self.tracer.emit(self.tracer.new_trace(), "cutover_drain",
                                 topic=LIFECYCLE_TOPIC, replica=name)
        handle.cordoned = bool(cordoned)
        log.info("router: replica %s %s", name,
                 "cordoned" if cordoned else "uncordoned")

    def cordon_hook(self, name: str) -> Callable[[str], None]:
        """A ``ReadReplica.on_resync``: cordon at "begin", uncordon at "end"."""
        def hook(phase: str, _name=name) -> None:
            self.set_cordon(_name, phase == "begin")

        return hook

    def replicas(self) -> List[ReplicaHandle]:
        with self._lock:
            return list(self._replicas)

    def registry(self) -> List[Dict[str, Any]]:
        """``GET /replicas``: each replica's health, routing counts and
        recently routed topics."""
        from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_NAMES

        with self._lock:
            handles = list(self._replicas)
            topic_map = dict(self._topic_map)
        by_name: Dict[str, List[str]] = {}
        for topic, (name, _t) in topic_map.items():
            by_name.setdefault(name, []).append(topic)
        return [{"name": h.name, "writer": h.writer, "healthy": h.healthy,
                 "cordoned": h.cordoned,
                 "health_state": STATE_NAMES[min(h.health_state, len(STATE_NAMES) - 1)],
                 "routed": h.routed, "budget_fps": h.budget_fps,
                 "topics": sorted(by_name.get(h.name, ())), "probe_error": h.last_probe_error,
                 "probe_streak": h.probe_streak, "link_up": h.link_up} for h in handles]

    def _set_replica_gauges(self) -> None:
        if self.metrics is None:
            return
        handles = self.replicas()
        self.metrics.set_gauge(mn.ROUTER_REPLICAS, len(handles))
        self.metrics.set_gauge(mn.ROUTER_HEALTHY_REPLICAS, sum(1 for r in handles if r.healthy))
        if self.link_deadline_s is not None:
            self.metrics.set_gauge(mn.LINKS_DOWN, sum(1 for r in handles if not r.link_up))
            for handle in handles:
                self.metrics.set_gauge(mn.LINK_STATE_PREFIX + handle.name,
                                       1 if handle.link_up else 0)

    # ---- rendezvous ----

    @staticmethod
    def _weight(topic: str, name: str) -> int:
        digest = hashlib.blake2b(f"{topic}\x00{name}".encode("utf-8"), digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def _preference_order(self, topic: str) -> List[ReplicaHandle]:
        """Every replica in the topic's highest-random-weight order (the
        filters apply at route time, so a recovered replica takes back
        exactly its topics); cached per topic, bounded."""
        with self._lock:
            order = self._order_cache.get(topic)
            if order is not None:
                return order
            order = sorted(self._replicas, key=lambda r: self._weight(topic, r.name),
                           reverse=True)
            if len(self._order_cache) < self._topic_map_max:
                self._order_cache[topic] = order
            return order

    @staticmethod
    def _routable(handle: ReplicaHandle) -> bool:
        return handle.healthy and not handle.cordoned and handle.link_up

    def route(self, topic: str) -> Optional[ReplicaHandle]:
        """The replica this topic goes to now: rendezvous order, routable
        replicas only, past spent budgets; None (counted) when none can
        take it."""
        spilled = False
        for handle in self._preference_order(topic):
            if not self._routable(handle):
                continue
            if handle.budget is not None and not handle.budget.try_acquire():
                spilled = True
                if self.metrics is not None:
                    self.metrics.incr(mn.ROUTER_BUDGET_SPILLS)
                continue
            return handle
        if self.metrics is not None:
            self.metrics.incr(mn.ROUTER_REJECTED_PREFIX + ("budget" if spilled else "no_replica"))
        return None

    def publish(self, topic: str, message: Dict[str, Any]) -> None:
        if topic == self.control_topic:
            self._publish_control(message)
            return
        handle = self.route(topic)
        if handle is None:
            return
        message = self._stamp_fid(message)
        handle.routed += 1
        now = time.monotonic()
        with self._lock:
            if topic in self._topic_map or len(self._topic_map) < self._topic_map_max:
                self._topic_map[topic] = (handle.name, now)
        # forwarded outside the lock: the connector may dispatch in line or
        # write a socket
        forwarded = message if topic == self.frame_topic else {**message, "_route_topic": topic}
        self._track_inflight(topic, forwarded, handle, now)
        self._forward(handle, forwarded)
        if self.metrics is not None:
            self.metrics.incr(mn.ROUTER_ROUTED)

    inject = publish

    def _forward(self, handle: ReplicaHandle, forwarded: Dict[str, Any]) -> None:
        for msg in self._cross(handle.name, "send", forwarded):
            handle.connector.publish(self.frame_topic, msg)

    # ---- frame ids: stamping and first-result-wins ----

    def _stamp_fid(self, message: Dict[str, Any]) -> Dict[str, Any]:
        """A router-unique ``meta["_fid"]``: the service echoes ``meta`` in
        its results, so the same id dedups at the replica's intake and at
        fan-in; a re-send keeps its id."""
        if self.dedup_window <= 0 or not isinstance(message, dict):
            return message
        meta = message.get("meta")
        if meta is not None and not isinstance(meta, dict):
            return message
        meta = dict(meta) if meta else {}
        if "_fid" in meta:
            return message
        with self._hedge_lock:
            self._fid_counter += 1
            meta["_fid"] = f"f{self._fid_counter}"
        return {**message, "meta": meta}

    def _track_inflight(self, topic: str, forwarded: Dict[str, Any], handle: ReplicaHandle,
                        now: float) -> None:
        """An interactive frame becomes hedge-eligible (with hedging on)."""
        if self.hedge_deadline_s is None or not isinstance(forwarded, dict):
            return
        if forwarded.get("priority") != "interactive":
            return
        meta = forwarded.get("meta")
        fid = meta.get("_fid") if isinstance(meta, dict) else None
        if fid is None:
            return
        with self._hedge_lock:
            self._inflight[fid] = {"topic": topic, "forwarded": forwarded, "t0": now,
                                   "replicas": [handle.name], "hedged": False}
            while len(self._inflight) > self.dedup_window:
                self._inflight.popitem(last=False)

    def _admit_result(self, name: str, message: Any) -> bool:
        """First result per fid passes upstream; later ones are swallowed
        (counted). A message without a fid always passes."""
        if self.dedup_window <= 0 or not isinstance(message, dict):
            return True
        meta = message.get("meta")
        fid = meta.get("_fid") if isinstance(meta, dict) else None
        if fid is None:
            return True
        wasted = deduped = win = False
        with self._hedge_lock:
            seen = self._seen_results.get(fid)
            if seen is not None:
                deduped = True
                wasted = seen["hedged"]
            else:
                entry = self._inflight.pop(fid, None)
                hedged = bool(entry and entry["hedged"])
                self._seen_results[fid] = {"hedged": hedged, "winner": name}
                while len(self._seen_results) > self.dedup_window:
                    self._seen_results.popitem(last=False)
                win = hedged and bool(entry["replicas"]) and name != entry["replicas"][0]
        if self.metrics is not None:
            if deduped:
                self.metrics.incr(mn.ROUTER_RESULTS_DEDUPED)
                if wasted:
                    self.metrics.incr(mn.ROUTER_HEDGE_WASTED)
            elif win:
                self.metrics.incr(mn.ROUTER_HEDGE_WINS)
        return not deduped

    def check_hedges(self, now: Optional[float] = None) -> int:
        """Re-send each interactive frame past the hedge deadline to its
        next routable replica, once per frame (the health thread; tests
        call it). Returns the hedges sent."""
        if self.hedge_deadline_s is None:
            return 0
        now = time.monotonic() if now is None else now
        to_send: List[Tuple[ReplicaHandle, Dict[str, Any]]] = []
        with self._hedge_lock:
            stale_after = max(30.0 * self.hedge_deadline_s, 30.0)
            for fid in list(self._inflight):
                entry = self._inflight[fid]
                age = now - entry["t0"]
                if age > stale_after:
                    del self._inflight[fid]  # both copies died
                    continue
                if entry["hedged"] or age < self.hedge_deadline_s:
                    continue
                target = self._hedge_target(entry)
                entry["hedged"] = True
                if target is not None:
                    entry["replicas"].append(target.name)
                    to_send.append((target, entry["forwarded"]))
        for target, forwarded in to_send:
            self._forward(target, forwarded)
            if self.metrics is not None:
                self.metrics.incr(mn.ROUTER_HEDGES)
        return len(to_send)

    def _hedge_target(self, entry: Dict[str, Any]) -> Optional[ReplicaHandle]:
        tried = set(entry["replicas"])
        return next((h for h in self._preference_order(entry["topic"])
                     if h.name not in tried and self._routable(h)), None)

    def _publish_control(self, message: Dict[str, Any]) -> None:
        """Control traffic (enrolment) goes to the healthy writer only."""
        writer = next((r for r in self.replicas() if r.writer and r.healthy), None)
        if writer is None:
            if self.metrics is not None:
                self.metrics.incr(mn.ROUTER_REJECTED_PREFIX + "no_writer")
            return
        writer.connector.publish(self.control_topic, message)

    # ---- health ----

    def check_health(self) -> None:
        """Probe every replica once and apply the transitions (the health
        thread; tests call it)."""
        from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL

        for handle in self.replicas():
            if handle.health_fn is None:
                continue
            try:
                state = int(handle.health_fn())
                if handle.probe_streak:
                    log.info("router: health probe for %s recovered after %d error(s)",
                             handle.name, handle.probe_streak)
                handle.probe_streak = 0
                handle.last_probe_error = None
            except Exception as exc:  # noqa: BLE001 - a dead probe fails the replica closed
                if handle.probe_streak == 0:
                    log.warning("router: health probe for %s failed (repeats not logged): %r",
                                handle.name, exc)
                handle.probe_streak = min(handle.probe_streak + 1, self.PROBE_STREAK_CAP)
                if self.metrics is not None:
                    self.metrics.incr(mn.ROUTER_HEALTH_PROBE_FAILURES)
                    self.metrics.incr(mn.ROUTER_PROBE_ERRORS)
                handle.last_probe_error = repr(exc)
                state = STATE_CRITICAL
            handle.health_state = state
            healthy = state < STATE_CRITICAL
            if healthy != handle.healthy:
                self._transition(handle, healthy)
        self._set_replica_gauges()

    def check_links(self, now: Optional[float] = None) -> None:
        """One heartbeat cycle (with ``link_deadline_s``): ping every
        replica through the transport boundary, then fail each link whose
        last pong is older than the deadline; the deadline starts at the
        first ping."""
        if self.link_deadline_s is None:
            return
        now = time.monotonic() if now is None else now
        for handle in self.replicas():
            with self._lock:
                self._ping_counter += 1
                ping = {"ping": self._ping_counter, "replica": handle.name}
            for msg in self._cross(handle.name, "send", ping):
                handle.connector.publish(self.link_ping_topic, msg)
            if self.metrics is not None:
                self.metrics.incr(mn.LINK_HEARTBEATS_SENT)
            if handle.last_pong_t is None:
                handle.last_pong_t = now
                continue
            up = (now - handle.last_pong_t) <= self.link_deadline_s
            if up != handle.link_up:
                self._link_transition(handle, up)
        self._set_replica_gauges()

    def _link_transition(self, handle: ReplicaHandle, up: bool) -> None:
        handle.link_up = up
        if self.metrics is not None:
            self.metrics.incr(mn.LINK_RECOVERIES if up else mn.LINK_FAILURES)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "link", topic=LIFECYCLE_TOPIC,
                             replica=handle.name, link_up=up)
            if not up:
                self.tracer.dump("failover", extra={"replica": handle.name, "link": "down",
                                                    "registry": self.registry()})
        log.warning("router: link to replica %s %s", handle.name,
                    "recovered" if up else "down (pong deadline passed); rerouting its topics")

    def down_link_fraction(self) -> float:
        """The share of links down: ``runtime.slo.link_health_objective``'s
        gauge."""
        handles = self.replicas()
        if not handles:
            return 0.0
        return sum(1 for h in handles if not h.link_up) / len(handles)

    def _transition(self, handle: ReplicaHandle, healthy: bool) -> None:
        handle.healthy = healthy
        if self.metrics is not None:
            self.metrics.incr(mn.ROUTER_RECOVERIES if healthy else mn.ROUTER_FAILOVERS)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "failover", topic=LIFECYCLE_TOPIC,
                             replica=handle.name, healthy=healthy,
                             health_state=handle.health_state)
            if not healthy:
                self.tracer.dump("failover", extra={"replica": handle.name,
                                                    "registry": self.registry()})
        log.warning("router: replica %s %s", handle.name,
                    "recovered" if healthy else "critical; rerouting its topics")

    def _health_loop(self) -> None:
        while not self._stop.wait(timeout=self.health_interval_s):
            try:
                self.check_health()
                self.check_links()
                self.check_hedges()
            except Exception:  # noqa: BLE001 - the health thread must live
                log.exception("router health sweep failed")
                if self.metrics is not None:
                    self.metrics.incr(mn.ROUTER_HEALTH_PROBE_FAILURES)

    # ---- lifecycle ----

    def start(self) -> None:
        if self._health_thread is not None:
            return
        self._stop.clear()
        self.check_health()
        self.check_links()
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True,
                                               name="ocvf-router-health")
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2.0)
            self._health_thread = None
