"""Durable journals: port of ``opencv_facerecognizer_tpu/runtime/journal.py``.

``RotatingJournal`` is an append-only JSONL file with an fsync policy; the
enrolment WAL (``runtime.state_store.EnrollmentWAL``), the dead-letter
journal below and the tracer's span sink (``utils.tracing.
make_span_journal``) are built on it. One JSON object per line; a line is
flushed per append and fsynced per ``fsync``:

- ``"never"``: flushed to the kernel, never fsynced (a power cut can lose
  what the kernel had not written back);
- ``"interval"``: fsynced at most once per ``fsync_interval_s``, on the
  next append, and at ``close``;
- ``"always"``: fsynced before the append returns (the WAL's default: an
  acknowledged enrolment survives a power cut).

A failed append (ENOSPC can land part of a line before it raises) latches
a seal: the next append starts with a newline, so the torn bytes stay one
unparseable line instead of the prefix of an acknowledged record. A file
whose last byte is not a newline when it is first opened (a crash of the
previous process) is sealed the same way. ``records`` skips every line
that is not a JSON object.

Appends are ``strict`` (an ``OSError`` re-raises: the WAL, whose
acknowledgement depends on the write) or lenient (counted on the sink's
``error_counter``, ``journal_errors`` by default, and swallowed).
``shed_fn``, when set and true, drops lenient appends before they touch
the disk (counted on ``shed_counter``; ``DurabilityMonitor.attach_sinks``
wires it while durability is degraded). Past ``max_bytes`` the file
rotates to ``path.1 .. path.<backups>``.

``DeadLetterJournal`` records every dead-lettered, shed or abandoned
frame: the producer's ``meta``, its enqueue stamp, its priority, its
trace id and the lifecycle stage it died at, under the record's reason,
so a producer can re-offer exactly what was lost (``replay``). One record
per line::

    {"ts": <unix s>, "reason": "dead_letter", "frames": [{"meta": ...,
     "enqueue_ts": <monotonic s|null>, "priority": <int|null>,
     "trace_id": <int|null>, "stage": "readback.dead_letter"}], ...}

``python -m opencv_facerecognizer_tpu_torch.runtime.journal PATH
[--reason R] [--trace ID] [--stage S]`` prints a journal's records as
JSON lines, oldest first; the filters compose.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

#: accepted fsync policies, in increasing durability order
FSYNC_POLICIES = ("never", "interval", "always")


class RotatingJournal:
    """Append-only JSONL file with bounded rotation and an fsync policy
    (module docstring). Subclasses own the record semantics."""

    def __init__(self, path: str, max_bytes: int = 4 << 20, backups: int = 2,
                 metrics=None, fsync: str = "never", fsync_interval_s: float = 1.0,
                 fault_injector=None, error_counter: str = mn.JOURNAL_ERRORS,
                 shed_counter: str = mn.JOURNAL_SHED):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in {FSYNC_POLICIES}")
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.backups = max(0, int(backups))
        self.metrics = metrics
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        #: ``runtime.faults`` hook: the storage boundary fires before each
        #: real write
        self._faults = fault_injector
        #: per-sink counters: the dead-letter journal and the span sink share
        #: this class, not their counters
        self.error_counter = str(error_counter)
        self.shed_counter = str(shed_counter)
        #: when set and true, lenient appends are dropped (degraded durability)
        self.shed_fn = None
        self._last_fsync_t = 0.0
        self._lock = threading.Lock()
        self._fh = None
        self._needs_seal = False
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)

    # ---- writing ----

    def append_line(self, line: str, strict: bool = False) -> bool:
        """Append one encoded JSON line (rotating first if needed), flushed
        and fsynced per policy. True on success; an ``OSError`` is counted
        and re-raised when ``strict``, else swallowed (False)."""
        if not strict and self.shed_fn is not None and self.shed_fn():
            if self.metrics is not None:
                self.metrics.incr(self.shed_counter)
            return False
        with self._lock:
            try:
                self._append_locked(line)
            except OSError:
                self._needs_seal = True  # part of the line may have landed
                if self.metrics is not None:
                    self.metrics.incr(self.error_counter)
                if strict:
                    raise
                return False
        return True

    def _append_locked(self, line: str, newline: bool = True) -> None:
        """Caller holds the lock: write (after a pending seal), flush,
        fsync per policy."""
        if self._faults is not None:
            self._faults.on_storage("journal_append")
        self._rotate_if_needed(len(line) + 2)
        if self._fh is None:
            self._latch_torn_tail_locked()
            self._fh = open(self.path, "a", encoding="utf-8")
        prefix = "\n" if self._needs_seal else ""
        self._fh.write(prefix + line + ("\n" if newline else ""))
        self._needs_seal = False
        self._fh.flush()
        self._fsync_locked()

    def _latch_torn_tail_locked(self) -> None:
        """Before the first open of an existing file: latch the seal when
        its last byte is not a newline (counted ``journal_torn_tails``)."""
        if self._needs_seal:
            return
        try:
            with open(self.path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                torn = fh.read(1) != b"\n"
        except OSError:
            return  # no file yet
        if torn:
            self._needs_seal = True
            if self.metrics is not None:
                self.metrics.incr(mn.JOURNAL_TORN_TAILS)

    def _fsync_locked(self) -> None:
        if self.fsync == "never" or self._fh is None:
            return
        now = time.monotonic()
        if self.fsync == "interval" and now - self._last_fsync_t < self.fsync_interval_s:
            return
        os.fsync(self._fh.fileno())
        self._last_fsync_t = now

    def sync(self) -> None:
        """fsync the active file now, whatever the policy."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._last_fsync_t = time.monotonic()
                except OSError:
                    if self.metrics is not None:
                        self.metrics.incr(self.error_counter)

    def _rotate_if_needed(self, incoming: int) -> None:
        """Caller holds the lock: shift ``path -> path.1 -> ...`` when the
        file would pass ``max_bytes``."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming <= self.max_bytes:
            return
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self.backups == 0:
            os.replace(self.path, self.path + ".old")
            os.remove(self.path + ".old")
            return
        oldest = f"{self.path}.{self.backups}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")

    def close(self) -> None:
        """Flush, fsync (unless ``never``) and close the file."""
        with self._lock:
            if self._fh is not None:
                try:
                    if self.fsync != "never":
                        self._fh.flush()
                        os.fsync(self._fh.fileno())
                except OSError:
                    pass
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # ---- reading ----

    def _files_oldest_first(self) -> List[str]:
        files = [f"{self.path}.{i}" for i in range(self.backups, 0, -1)]
        files.append(self.path)
        return [f for f in files if os.path.exists(f)]

    def records(self) -> Iterator[Dict[str, Any]]:
        """Every record oldest first (rotated files included); invalid
        UTF-8, unparseable JSON and non-object lines are skipped."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            files = self._files_oldest_first()
        for path in files:
            try:
                with open(path, "r", encoding="utf-8", errors="replace") as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            record = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if isinstance(record, dict):
                            yield record
            except OSError:
                continue


class DeadLetterJournal(RotatingJournal):
    """The rotating journal of dead-lettered, shed and abandoned frames
    (module docstring). Lenient: a failed write is counted and swallowed,
    serving never dies to its flight recorder."""

    @staticmethod
    def frame_entry(meta: Any = None, enqueue_ts: Optional[float] = None,
                    priority: Optional[int] = None, trace_id: Optional[int] = None,
                    stage: Optional[str] = None) -> Dict[str, Any]:
        """One journaled frame."""
        return {"meta": meta, "enqueue_ts": enqueue_ts, "priority": priority,
                "trace_id": trace_id, "stage": stage}

    def append(self, reason: str, frames: List[Dict[str, Any]], **extra: Any) -> None:
        """One record for ``frames`` lost for ``reason`` (``extra`` rides
        the record, e.g. a flight dump's path). Never raises."""
        record = {"ts": time.time(), "reason": str(reason), "frames": list(frames)}
        if extra:
            record.update(extra)
        try:
            line = json.dumps(record, default=repr)
        except (TypeError, ValueError):
            line = json.dumps({"ts": record["ts"], "reason": record["reason"],
                               "frames": [], "encode_error": True})
        if not self.append_line(line, strict=False):
            return
        if self.metrics is not None:
            self.metrics.incr(mn.JOURNAL_RECORDS)
            self.metrics.incr(mn.JOURNAL_FRAMES, len(record["frames"]))

    def replay(self, handler: Callable[[Dict[str, Any]], None],
               reasons: Optional[tuple] = None) -> int:
        """``handler(entry)`` for every journaled frame, oldest first, each
        entry with its record's ``reason`` and ``ts``; returns the frames
        replayed. A raising handler stops the replay."""
        n = 0
        for record in self.records():
            if reasons is not None and record.get("reason") not in reasons:
                continue
            for entry in record.get("frames", ()):
                handler({**entry, "reason": record.get("reason"), "ts": record.get("ts")})
                n += 1
        return n


def main(argv=None) -> int:
    """Print a journal's records as JSON lines, oldest first (module
    docstring): ``--trace`` answers where a frame died, ``--stage`` what
    died at a stage (exact match, the settle spans' ``where`` strings)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="dump a dead-letter journal as JSON lines")
    parser.add_argument("path")
    parser.add_argument("--reason", help="only records with this reason")
    parser.add_argument("--trace", type=int, default=None,
                        help="only records holding a frame with this trace id")
    parser.add_argument("--stage", default=None,
                        help="only records holding a frame that died at this lifecycle "
                             "stage (exact match, e.g. batcher.stale, readback.dead_letter)")
    args = parser.parse_args(argv)
    journal = DeadLetterJournal(args.path)
    for record in journal.records():
        frames = record.get("frames", ())
        if args.reason and record.get("reason") != args.reason:
            continue
        if args.trace is not None and not any(f.get("trace_id") == args.trace for f in frames):
            continue
        if args.stage is not None and not any(f.get("stage") == args.stage for f in frames):
            continue
        sys.stdout.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
