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

- **transport**: the link to a peer (``runtime.replication.TopicRouter``
  and ``runtime.connector.SocketConnector`` cross it on every send and
  receive). Link conditions are toggled per (peer, direction) and hold
  until healed: ``partition`` and ``half_open`` eat every message (only a
  heartbeat deadline tells a half-open link from a live one), ``slow``
  sleeps a latency plus jitter first. Per-crossing faults are scripted or
  drawn: ``drop``, ``duplicate`` (delivered twice) and ``reorder`` (held
  and delivered after the link's next message).

Faults are scripted (``script("wal", "torn")``: consumed in order, one
per crossing) or drawn at ``rates`` from a ``random.Random(seed)``;
``injected`` counts each one fired as ``"boundary:fault"``. Without
scripted faults and rates every hook is a no-op, and no production path
arms an injector. The ``receive``, ``put`` and ``readback`` boundaries
are not ported yet: they come with the chaos soak (ROADMAP A.14).
"""

from __future__ import annotations

import errno
import random
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional

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
    "transport": ("partition", "half_open", "slow", "drop", "duplicate", "reorder"),
}

#: storage kinds by crossing direction (the filtered draw of
#: ``on_storage`` / ``on_storage_read``)
STORAGE_WRITE_KINDS = ("enospc", "eio", "slow_fsync")
STORAGE_READ_KINDS = ("read_error",)

#: transport kinds a crossing draws; the link conditions are toggled
#: (``set_partition`` ...), never scripted
TRANSPORT_DRAW_KINDS = ("drop", "duplicate", "reorder")

#: a crossing's direction as the injecting side sees it
TRANSPORT_DIRECTIONS = ("send", "recv")


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
            valid = (TRANSPORT_DRAW_KINDS if boundary == "transport"
                     else BOUNDARIES.get(boundary, ()))
            unknown = set(fault_rates) - set(valid)
            if boundary not in BOUNDARIES or unknown:
                raise ValueError(f"unknown fault(s) for {boundary!r}: "
                                 f"{sorted(unknown) or boundary}")
        self._scripted: Dict[str, deque] = {b: deque() for b in BOUNDARIES}
        self.injected: Counter = Counter()
        self.enabled = True
        # transport link conditions, keyed (peer, direction): cut and
        # half-open links, slow links' (latency, jitter), and the messages
        # a reorder holds back
        self._partitioned: set = set()
        self._half_open: set = set()
        self._slow_links: Dict[tuple, tuple] = {}
        self._holdback: Dict[tuple, list] = {}

    def script(self, boundary: str, *faults: str) -> None:
        """Queue faults at ``boundary``, consumed in order, once each."""
        kinds = BOUNDARIES.get(boundary)
        if kinds is None:
            raise ValueError(f"unknown boundary {boundary!r}")
        if boundary == "transport":
            kinds = TRANSPORT_DRAW_KINDS
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

    # ---- the transport boundary ----

    @staticmethod
    def _link_keys(peer: str, direction: str) -> List[tuple]:
        if direction == "both":
            return [(peer, d) for d in TRANSPORT_DIRECTIONS]
        if direction not in TRANSPORT_DIRECTIONS:
            raise ValueError(f"unknown transport direction {direction!r} "
                             f"(valid: {TRANSPORT_DIRECTIONS + ('both',)})")
        return [(peer, direction)]

    def set_partition(self, peer: str, direction: str = "both") -> None:
        """Cut the link: every crossing in ``direction`` vanishes."""
        self._partitioned.update(self._link_keys(peer, direction))

    def heal_partition(self, peer: str, direction: str = "both") -> None:
        self._partitioned.difference_update(self._link_keys(peer, direction))

    def set_half_open(self, peer: str, direction: str = "send") -> None:
        """Blackhole crossings in ``direction`` with no error and no EOF."""
        self._half_open.update(self._link_keys(peer, direction))

    def heal_half_open(self, peer: str, direction: str = "both") -> None:
        self._half_open.difference_update(self._link_keys(peer, direction))

    def set_slow_link(self, peer: str, latency_s: float, jitter_s: float = 0.0,
                      direction: str = "both") -> None:
        """Each crossing sleeps ``latency_s`` plus a draw from ``[0,
        jitter_s]`` first."""
        for key in self._link_keys(peer, direction):
            self._slow_links[key] = (float(latency_s), float(jitter_s))

    def heal_slow_link(self, peer: str, direction: str = "both") -> None:
        for key in self._link_keys(peer, direction):
            self._slow_links.pop(key, None)

    def heal_all_links(self) -> None:
        """Clear every link condition (held messages stay held)."""
        self._partitioned.clear()
        self._half_open.clear()
        self._slow_links.clear()

    def flush_holdback(self, peer: str, direction: str = "both") -> List[Dict[str, Any]]:
        """The messages a reorder holds on the link, now forgotten."""
        flushed: List[Dict[str, Any]] = []
        for key in self._link_keys(peer, direction):
            flushed.extend(self._holdback.pop(key, ()))
        return flushed

    def on_transport(self, peer: str, direction: str, message: Dict[str, Any],
                     sink=None) -> List[Dict[str, Any]]:
        """One crossing of the link to ``peer``: the messages to deliver,
        in order: ``[]`` (cut, half-open, dropped or held), ``[m, m]``
        (duplicated), or the message followed by one a reorder held.
        ``sink(kind)`` is told each fault enacted (the caller's
        ``transport_fault_<kind>`` counter)."""
        if not self.enabled:
            return [message]
        key = (peer, direction)

        def fire(kind: str) -> None:
            self.injected[f"transport:{kind}"] += 1
            if sink is not None:
                sink(kind)

        # a dead link eats the message before any draw, held ones included
        if key in self._partitioned:
            fire("partition")
            return []
        if key in self._half_open:
            fire("half_open")
            return []
        slow = self._slow_links.get(key)
        if slow is not None:
            latency_s, jitter_s = slow
            delay = latency_s + (self._rng.random() * jitter_s if jitter_s > 0 else 0.0)
            if delay > 0:
                time.sleep(delay)
            fire("slow")
        fault = self._draw("transport", TRANSPORT_DRAW_KINDS)
        if fault is not None and sink is not None:
            sink(fault)  # the draw counted it in ``injected``
        if fault == "drop":
            return []
        if fault == "reorder":
            self._holdback.setdefault(key, []).append(message)
            return []
        held = self._holdback.pop(key, None)
        out = [message, message] if fault == "duplicate" else [message]
        if held:
            out.extend(held)  # the held message lands after the newer one
        return out

    def summary(self) -> Dict[str, int]:
        return dict(self.injected)
