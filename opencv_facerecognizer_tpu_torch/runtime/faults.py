"""Fault injection at the durability and dispatch boundaries: port of that
part of ``opencv_facerecognizer_tpu/runtime/faults.py``.

- **dispatch**: the backend fast-fails at call time (``unavailable``); the
  service's retry path classifies it as transient.
- **wal** and **checkpoint**: simulated process death while the state
  store writes. ``torn`` leaves a partial record or file on disk,
  ``crash`` dies before the write becomes visible, and checkpoint
  ``late`` dies after the checkpoint lands but before the WAL truncation
  that follows it (the window the checkpoint's ``wal_seq`` exists for).
- **stage**: the same two deaths at a rollout's stage append.
- **cutover**: death on either side of a cutover's WAL fence record
  (``crash_before_record``, ``crash_after_record``): the embedder's
  (``StateLifecycle.perform_cutover``) and a registry swap's
  (``perform_registry_cutover``).
- **cascade**: the serving loop's stage-1 gate (``runtime.recognizer``):
  ``reject_all`` turns the batch's keep mask all False, so every frame
  exits as ``completed_empty``.
- **decode**: the JPEG decode pool's worker (``runtime.ingest``): ``slow``
  stalls ``slow_decode_s`` before the decode, ``corrupt`` replaces the
  payload with bytes no decoder accepts.
- **storage**: the disk stays broken. ``enospc`` and ``eio`` raise the
  matching ``OSError`` before the real syscall of every durable write,
  ``slow_fsync`` stalls ``slow_fsync_s`` and then lets it proceed, and
  ``read_error`` raises ``OSError(EIO)`` at a durable read. Write
  crossings draw only the write kinds and reads only ``read_error``, so
  one scripted queue interleaves both.

Faults are scripted (``script("wal", "torn")``: consumed in order, one
per crossing) or drawn at ``rates`` from a ``random.Random(seed)``;
``injected`` counts each one fired as ``"boundary:fault"``. Without
scripted faults and rates every hook is a no-op, and no production path
arms an injector. The connector, batcher, readback and transport
boundaries wait for their subsystems (ROADMAP A.8.6).
"""

from __future__ import annotations

import errno
import random
import time
from collections import Counter, deque
from typing import Dict, Optional

import numpy as np

#: boundary name -> the fault kinds it understands
BOUNDARIES: Dict[str, tuple] = {
    "dispatch": ("unavailable",),
    "wal": ("torn", "crash"),
    "checkpoint": ("torn", "crash", "late"),
    "stage": ("torn", "crash"),
    "cutover": ("crash_before_record", "crash_after_record"),
    "decode": ("slow", "corrupt"),
    "cascade": ("reject_all",),
    "storage": ("enospc", "eio", "slow_fsync", "read_error"),
}

#: storage kinds by crossing direction (the filtered draw of
#: ``on_storage`` / ``on_storage_read``)
STORAGE_WRITE_KINDS = ("enospc", "eio", "slow_fsync")
STORAGE_READ_KINDS = ("read_error",)


class InjectedCrashError(RuntimeError):
    """Simulated process death at a durability boundary. The caller treats
    it as fatal, never catches and carries on: a real SIGKILL offers no
    such choice."""

    def __init__(self, msg: str = "injected crash at a durability boundary"):
        super().__init__(msg)


class InjectedUnavailableError(RuntimeError):
    """The backend's fast-fail outage. The message carries ``UNAVAILABLE``
    so ``resilience.is_transient_error`` classifies it as an outage."""

    def __init__(self, msg: str = "UNAVAILABLE: injected dispatch fault"):
        super().__init__(msg)


class FaultInjector:
    """Deterministic, seedable faults at the boundaries of ``BOUNDARIES``.

    ``script(boundary, *faults)`` queues faults consumed one per crossing;
    ``rates`` draws them from the seeded RNG; ``disarm()`` makes every
    hook a passthrough (``arm()`` undoes it)."""

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, Dict[str, float]]] = None,
                 slow_decode_s: float = 0.05, slow_fsync_s: float = 0.05):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        #: stall of a ``decode: slow`` fault, before the worker decodes
        self.slow_decode_s = float(slow_decode_s)
        #: stall of a ``storage: slow_fsync`` fault
        self.slow_fsync_s = float(slow_fsync_s)
        self.rates = rates or {}
        for boundary, fault_rates in self.rates.items():
            unknown = set(fault_rates) - set(BOUNDARIES.get(boundary, ()))
            if boundary not in BOUNDARIES or unknown:
                raise ValueError(f"unknown fault(s) for {boundary!r}: "
                                 f"{sorted(unknown) or boundary}")
        self._scripted: Dict[str, deque] = {b: deque() for b in BOUNDARIES}
        self.injected: Counter = Counter()
        self.enabled = True

    def script(self, boundary: str, *faults: str) -> None:
        """Queue faults at ``boundary``, consumed in order, once each."""
        kinds = BOUNDARIES.get(boundary)
        if kinds is None:
            raise ValueError(f"unknown boundary {boundary!r}")
        for fault in faults:
            if fault not in kinds:
                raise ValueError(f"boundary {boundary!r} has no fault {fault!r} "
                                 f"(valid: {kinds})")
            self._scripted[boundary].append(fault)

    def disarm(self) -> None:
        """Every hook becomes a passthrough (scripted queues included)."""
        self.enabled = False

    def arm(self) -> None:
        self.enabled = True

    def _draw(self, boundary: str, allowed: Optional[tuple] = None) -> Optional[str]:
        """The fault to fire at this crossing, or None. A scripted fault
        at the head of the queue is consumed only when it is in
        ``allowed`` (all of the boundary's kinds by default); scripted
        faults take priority over rates."""
        if not self.enabled:
            return None
        allowed = BOUNDARIES[boundary] if allowed is None else allowed
        queue = self._scripted[boundary]
        fault = None
        if queue and queue[0] in allowed:
            fault = queue.popleft()
        elif not queue:
            for kind, rate in self.rates.get(boundary, {}).items():
                if kind in allowed and rate > 0 and self._rng.random() < rate:
                    fault = kind
                    break
        if fault is not None:
            self.injected[f"{boundary}:{fault}"] += 1
        return fault

    # ---- boundary hooks ----

    def on_dispatch(self) -> None:
        """Device-dispatch boundary: raises the fast-fail outage."""
        if self._draw("dispatch") is not None:
            raise InjectedUnavailableError()

    def on_wal_append(self) -> Optional[str]:
        """WAL append: ``"torn"`` or ``"crash"`` for the writer to enact
        (it writes its own real encoding, half of it for a torn line), or
        None."""
        return self._draw("wal")

    def on_checkpoint(self) -> Optional[str]:
        """Checkpoint save: ``"torn"``, ``"crash"``, ``"late"`` or None."""
        return self._draw("checkpoint")

    def on_stage(self) -> Optional[str]:
        """Rollout stage append: ``"torn"``, ``"crash"`` or None."""
        return self._draw("stage")

    def on_cutover(self) -> Optional[str]:
        """A cutover (``StateLifecycle.perform_cutover`` and
        ``perform_registry_cutover``): the side of the fence record the
        death lands on, or None."""
        return self._draw("cutover")

    def on_cascade(self, keep: np.ndarray) -> np.ndarray:
        """Stage-1 gate: ``reject_all`` replaces the keep mask with all
        False; otherwise ``keep`` unchanged."""
        if self._draw("cascade") is None:
            return keep
        return np.zeros_like(keep, dtype=bool)

    def on_decode(self, payload: bytes) -> bytes:
        """JPEG decode (a decode worker, never the serving thread):
        ``slow`` sleeps ``slow_decode_s`` and passes the payload on,
        ``corrupt`` returns a truncated pseudo-JPEG (SOI, then zeros) that
        the decoder rejects like real corrupt camera bytes."""
        fault = self._draw("decode")
        if fault is None:
            return payload
        if fault == "slow":
            time.sleep(self.slow_decode_s)
            return payload
        return b"\xff\xd8\xff" + b"\x00" * 5

    def on_storage(self, op: str = "write") -> None:
        """Durable-write boundary, called just before the real syscall
        inside the caller's own ``OSError`` handling: ``enospc``/``eio``
        raise, ``slow_fsync`` sleeps and lets the write proceed. ``op``
        only labels the error."""
        fault = self._draw("storage", STORAGE_WRITE_KINDS)
        if fault is None:
            return
        if fault == "slow_fsync":
            time.sleep(self.slow_fsync_s)
            return
        code = errno.ENOSPC if fault == "enospc" else errno.EIO
        raise OSError(code, f"injected storage fault ({fault}) at {op}")

    def on_storage_read(self, op: str = "read") -> None:
        """Durable-read boundary: ``read_error`` raises ``OSError(EIO)``."""
        if self._draw("storage", STORAGE_READ_KINDS) is not None:
            raise OSError(errno.EIO, f"injected storage fault (read_error) at {op}")

    def summary(self) -> Dict[str, int]:
        return dict(self.injected)
