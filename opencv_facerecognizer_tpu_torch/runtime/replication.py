"""The writer lease: port of ``WriterLease`` from
``opencv_facerecognizer_tpu/runtime/replication.py``.

A non-blocking ``fcntl.flock`` on ``<state-dir>/writer.lease`` makes one
process the state dir's only writer. A second writer fails closed at
start (``WriterLeaseHeldError``) instead of interleaving WAL appends; the
kernel drops the lock when its holder dies, so a crashed writer needs no
cleanup. The file's JSON (pid, host, time) is diagnostics only. The lease
is the same file and the same lock in both packages, so a JAX writer and
a port writer exclude each other too.

The WAL tailer and the read replica wait for ROADMAP A.8.6.
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import socket
import time
from typing import Optional

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

LEASE_NAME = "writer.lease"

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
