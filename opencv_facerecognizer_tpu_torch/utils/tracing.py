"""Frame-lifecycle tracing: causal spans and a flight recorder. Port of
``opencv_facerecognizer_tpu/utils/tracing.py``.

One **span** per stage a frame passes through::

    receive (verdict) -> queue_wait (batch ancestry) -> [batch trace:
    dispatch / ready_wait / publish] -> settle (terminal outcome)

plus **lifecycle spans** for the slow machinery (checkpoints, WAL appends,
IVF retrains, brownout and health transitions, recovery). Spans are plain
dicts in bounded **per-topic rings**:

- **Emission takes no lock.** ``deque.append`` is thread-safe in CPython;
  the tracer's lock guards only ring creation and dump bookkeeping and
  never nests inside a serving-path lock. A span is host timestamps only:
  nothing here waits for the card.
- **Sampling is deterministic.** A frame's keep/drop verdict is a pure
  function of ``(seed, arrival index)`` (a Knuth multiplicative hash over
  the frame-trace ids, which have their own counter), the reference's
  hash exactly, so both packages sample the same frames. ``sample=1.0``
  traces every frame; batch and lifecycle spans are never sampled out.
- **Terminal accounting.** Every admitted frame ends in exactly one
  ``settle`` span whose ``outcome`` is ``completed`` (or
  ``completed_cached``) or the ledger drop counter it was counted under;
  ``account_spans`` reduces spans back to the ledger's shape.
- **Flight recorder.** ``dump`` writes the rings atomically to
  ``dump_dir/flight-<seq>-<reason>.json`` with a per-reason rate limit and
  bounded retention: on a dead-letter, a stall, a critical health
  transition and the SIGTERM drain. Span stamps are ``time.monotonic()``;
  a dump's header pairs a monotonic and a wall clock.
- **JSONL export.** An optional ``span_sink`` (``make_span_journal``)
  streams every span as one JSON line beyond the rings' horizon.

``device_busy_fraction`` folds the batch spans into the share of a window
the card spent on batch round trips.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.serialization import atomic_write_json

#: ring topic of batch spans (dispatch / ready_wait / publish / dead_letter);
#: frame spans ride the topic the frame arrived on
BATCH_TOPIC = "_batch"
#: ring topic of lifecycle spans (checkpoint / wal_append / ivf_retrain /
#: brownout / health / recover ...)
LIFECYCLE_TOPIC = "_lifecycle"
#: the terminal stage every admitted frame reaches exactly once
SETTLE_STAGE = "settle"
#: ``settle`` outcome of a frame that published a result; any other
#: outcome is the ledger counter the frame was counted under
OUTCOME_COMPLETED = "completed"
#: the cascade's face-free early exit (``runtime.recognizer``): a completion
OUTCOME_COMPLETED_EMPTY = "completed_empty"
#: a frame answered from the identity cache: a completion
OUTCOME_COMPLETED_CACHED = "completed_cached"

_HASH_MULT = 2654435761  # Knuth multiplicative hash (mod 2^32)


class Tracer:
    """Per-topic span rings with deterministic sampling and an atomic
    flight-recorder dump (module docstring)."""

    def __init__(self, ring_size: int = 4096, sample: float = 1.0, seed: int = 0,
                 dump_dir: Optional[str] = None, keep_dumps: int = 8,
                 min_dump_interval_s: float = 1.0, span_sink=None, metrics=None,
                 fault_injector=None):
        self.ring_size = max(1, int(ring_size))
        self.sample = min(1.0, max(0.0, float(sample)))
        self.seed = int(seed)
        self.dump_dir = None if dump_dir is None else str(dump_dir)
        self.keep_dumps = max(1, int(keep_dumps))
        self.min_dump_interval_s = float(min_dump_interval_s)
        #: optional ``RotatingJournal`` streaming every span (lenient appends)
        self.span_sink = span_sink
        #: the dumps' counters only: emission never takes the Metrics lock
        self.metrics = metrics
        #: ``runtime.faults`` hook: the storage boundary fires before a dump
        self.fault_injector = fault_injector
        #: while true, dumps are shed (``trace_dumps_shed``); wired by
        #: ``DurabilityMonitor.attach_sinks``
        self.shed_fn = None
        # three id streams (``next`` is atomic in CPython): frame traces
        # (odd, in arrival order only, so sampling depends on (seed, index)),
        # batch and lifecycle traces (even), and span ids (emission order)
        self._frame_ids = itertools.count(0)
        self._aux_ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._rings: Dict[str, deque] = {}
        # ring creation and dump bookkeeping only; never held across
        # emission, file I/O or a call out of this class
        self._lock = threading.Lock()
        self._dump_seq = itertools.count(1)
        self._last_dump_t: Dict[str, float] = {}
        if self.dump_dir is not None:
            os.makedirs(self.dump_dir, exist_ok=True)

    # ---- trace ids and sampling ----

    def start_trace(self, topic: str) -> int:
        """A new frame trace id (odd), or 0 when sampled out (every
        ``emit`` with id 0 is a no-op)."""
        tid = 2 * next(self._frame_ids) + 1
        if self.sample >= 1.0:
            return tid
        if self.sample <= 0.0:
            return 0
        h = ((tid + self.seed) * _HASH_MULT) & 0xFFFFFFFF
        return tid if h < self.sample * 4294967296.0 else 0

    def new_trace(self) -> int:
        """An unsampled trace id (even) for batch and lifecycle traces."""
        return 2 * next(self._aux_ids)

    # ---- emission (the hot path: no lock) ----

    def _ring_for(self, topic: str) -> deque:
        ring = self._rings.get(topic)
        if ring is None:
            with self._lock:  # the first span of a topic only
                ring = self._rings.setdefault(topic, deque(maxlen=self.ring_size))
        return ring

    def emit(self, trace_id: int, stage: str, topic: Optional[str] = None,
             t0: Optional[float] = None, dur: float = 0.0, **attrs: Any) -> None:
        """Record one finished span: ``t0`` is ``time.monotonic()`` at its
        start (default now - dur), ``dur`` seconds. A no-op for id 0."""
        if not trace_id:
            return
        span: Dict[str, Any] = {"trace": trace_id, "span": next(self._span_ids),
                                "stage": stage,
                                "t0": (time.monotonic() - dur) if t0 is None else t0,
                                "dur": dur}
        if attrs:
            span.update(attrs)
        self._ring_for(topic or BATCH_TOPIC).append(span)
        sink = self.span_sink
        if sink is not None:
            sink.append_line(json.dumps({"topic": topic or BATCH_TOPIC, **span}, default=repr))

    @contextlib.contextmanager
    def lifecycle(self, stage: str, **attrs: Any):
        """Span the body as a lifecycle operation: yields a dict the body
        may enrich; the span carries the duration and ``ok`` (False with
        the error's repr when the body raised, which re-raises). For a
        body that holds no lock at its exit: with a sink, ``emit`` writes
        a file."""
        tid = self.new_trace()
        t0 = time.monotonic()
        try:
            yield attrs
        except BaseException as exc:
            attrs.setdefault("ok", False)
            attrs.setdefault("error", repr(exc))
            raise
        finally:
            attrs.setdefault("ok", True)
            self.emit(tid, stage, topic=LIFECYCLE_TOPIC, t0=t0,
                      dur=time.monotonic() - t0, **attrs)

    # ---- reading ----

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def snapshot(self, topic: Optional[str] = None,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """The spans held (oldest first): one topic, or all merged in
        emission order. A ring appended to mid-copy raises in CPython: the
        copy is retried rather than serializing emission against readers."""
        if topic is not None:
            rings = [self._rings.get(topic)]
        else:
            with self._lock:
                rings = list(self._rings.values())
        out: List[Dict[str, Any]] = []
        for ring in rings:
            if ring is None:
                continue
            for _ in range(8):
                try:
                    copied = list(ring)  # whole, or retried: never a partial copy
                except RuntimeError:
                    continue
                out.extend(copied)
                break
        if topic is None:
            out.sort(key=lambda s: s["span"])
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_topic = {t: len(r) for t, r in self._rings.items()}
        return {"ring_size": self.ring_size, "sample": self.sample, "spans_held": per_topic}

    # ---- the flight recorder ----

    def dump(self, reason: str, extra: Optional[Dict[str, Any]] = None,
             force: bool = False) -> Optional[str]:
        """Write the rings atomically as ``flight-<seq>-<reason>.json``;
        the path, or None without a dump dir, within the reason's rate
        limit (``force`` bypasses it) or while shed. Keeps the newest
        ``keep_dumps`` files. Never raises (``trace_dump_errors``)."""
        if self.dump_dir is None:
            return None
        if self.shed_fn is not None and self.shed_fn():
            if self.metrics is not None:
                self.metrics.incr(mn.TRACE_DUMPS_SHED)
            return None
        now = time.monotonic()
        with self._lock:
            if (not force and self.min_dump_interval_s > 0
                    and now - self._last_dump_t.get(reason, float("-inf"))
                    < self.min_dump_interval_s):
                return None
            self._last_dump_t[reason] = now
            seq = next(self._dump_seq)
        record = {"schema": 1, "reason": str(reason), "seq": seq, "ts_unix": time.time(),
                  "ts_monotonic": now, "sample": self.sample,
                  "spans": {t: self.snapshot(t) for t in self.topics()}}
        if extra:
            record["extra"] = extra
        path = os.path.join(self.dump_dir, f"flight-{seq:06d}-{reason}.json")
        try:
            if self.fault_injector is not None:
                self.fault_injector.on_storage("trace_dump")
            atomic_write_json(path, record)
        except (OSError, TypeError, ValueError):
            if self.metrics is not None:
                self.metrics.incr(mn.TRACE_DUMP_ERRORS)
            return None
        if self.metrics is not None:
            self.metrics.incr(mn.TRACE_DUMPS)
        self._prune_dumps()
        return path

    def _prune_dumps(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.dump_dir)
                           if n.startswith("flight-") and n.endswith(".json"))
        except OSError:
            return
        for name in names[:-self.keep_dumps or None]:
            try:
                os.remove(os.path.join(self.dump_dir, name))
            except OSError:
                pass


# ---- helpers ----


def make_span_journal(path: str, max_bytes: int = 16 << 20, backups: int = 2,
                      metrics=None, fault_injector=None):
    """A bounded rotating JSONL sink for ``Tracer(span_sink=...)``: the
    dead-letter journal's base, never fsynced, with its own counters
    (``trace_span_errors``, ``trace_spans_shed``)."""
    from opencv_facerecognizer_tpu_torch.runtime.journal import RotatingJournal

    return RotatingJournal(path, max_bytes=max_bytes, backups=backups, metrics=metrics,
                           fsync="never", fault_injector=fault_injector,
                           error_counter=mn.TRACE_SPAN_ERRORS,
                           shed_counter=mn.TRACE_SPANS_SHED)


def account_spans(spans: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Frame spans in the ledger's shape: the terminal ``settle`` spans'
    completions by kind and drops by outcome, and ``traced``, the distinct
    traces whose ``receive`` span says admitted. At ``sample=1.0`` these
    equal the service's ``ledger()``."""
    completed = completed_empty = completed_cached = 0
    drops: Dict[str, int] = {}
    admitted_traces = set()
    for span in spans:
        stage = span.get("stage")
        if stage == "receive" and span.get("verdict") == "admitted":
            admitted_traces.add(span.get("trace"))
        elif stage == SETTLE_STAGE:
            outcome = span.get("outcome")
            if outcome == OUTCOME_COMPLETED:
                completed += 1
            elif outcome == OUTCOME_COMPLETED_EMPTY:
                completed_empty += 1
            elif outcome == OUTCOME_COMPLETED_CACHED:
                completed_cached += 1
            elif outcome:
                drops[outcome] = drops.get(outcome, 0) + 1
    return {"traced": len(admitted_traces), "completed": completed,
            "completed_empty": completed_empty, "completed_cached": completed_cached,
            "drops": drops}


def device_busy_fraction(batch_spans: Iterable[Dict[str, Any]], window_s: float = 30.0,
                         now: Optional[float] = None) -> float:
    """Share of the trailing ``window_s`` covered by the union of the
    ``ready_wait`` spans' ``[t0, t0 + dur]`` (dispatch to readback: the
    batches' round trips on the card); overlapping batches count once."""
    now = time.monotonic() if now is None else now
    lo = now - window_s
    ivals = sorted((max(s["t0"], lo), min(s["t0"] + s["dur"], now))
                   for s in batch_spans
                   if s.get("stage") == "ready_wait" and s["t0"] + s["dur"] > lo)
    busy = 0.0
    cur_s = cur_e = None
    for s, e in ivals:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / window_s if window_s > 0 else 0.0
