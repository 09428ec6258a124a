"""Failure handling of the serving loop and of its durable state: port of
``opencv_facerecognizer_tpu/runtime/resilience.py``.

- ``is_transient_error`` classifies an exception as outage-shaped (retry
  it) or permanent (a poisoned batch: retrying burns the budget for
  nothing), by the reference's markers.
- ``ResiliencePolicy`` holds the knobs ``RecognizerService`` runs on: a
  dispatch failure retries with exponential backoff, a readback that
  outlives its deadline is dead-lettered while the loop keeps serving,
  and ``degraded_after`` consecutive failed dispatches publish degraded
  mode on the status topic, with the bounded backend probe's verdict
  when ``probe_backend_on_degraded``.
- ``DurabilityMonitor``: the degraded-durability state machine of one
  writer's state dir. ``degraded_after`` (3) consecutive WAL append failures
  (or a critical disk watermark, or an unreachable state dir) flip it to
  degraded: enrolments are refused closed while serving goes on. A
  background probe (write, fsync, unlink in the state dir) re-arms it.
  ``statvfs`` watermarks: below the low one, one forced checkpoint and
  one checkpoint-retention shrink per episode (restored once the disk
  recovers); below ``1 / CRITICAL_DIVISOR`` of it, the degraded flip
  before ENOSPC lands.
- ``ServiceSupervisor`` restarts a crashed serving loop from the
  in-memory last-known-good snapshot (the acknowledged WAL tail replayed
  on top), falling back to the durable recovery; restarts are bounded
  (``supervisor_gave_up``), and a loop that makes no progress with frames
  pending is announced ``stalled``.

- ``BrownoutPolicy`` holds the service's load-shedding knobs (its
  docstring).

The monitor's flips and re-arms are lifecycle spans; ``attach_sinks``
sheds the dead-letter journal, the span sink and the flight dumps while
durability is degraded, and the warn watermark's retention shrink reaches
them too (journal backups and kept dumps to their floor, restored with
the disk). The supervisor announces the SLO monitor's health transitions
on the status topic, and a stall dumps the flight recorder.

Not ported: ``rebuild_pipeline_on_cpu``: the port has no CPU fallback, so
a dead card leaves the service degraded (ROADMAP C.7).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC

log = logging.getLogger(__name__)

#: lowercase substrings that mark an exception as an outage (the
#: reference's list, unchanged)
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline exceeded",
    "connection reset",
    "connection refused",
    "broken pipe",
    "socket closed",
    "resource exhausted",
    "internal: failed to",
)


def is_transient_error(exc: BaseException) -> bool:
    """True when ``exc`` looks like a backend or transport outage."""
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(marker in text for marker in _TRANSIENT_MARKERS)


@dataclass
class ResiliencePolicy:
    """Steady-state failure-handling knobs for ``RecognizerService``."""

    #: retries per batch after its first dispatch failure; then the batch
    #: is abandoned (``batches_failed``, its frames ``frames_failed``)
    dispatch_retries: int = 3
    #: backoff before retry n (0-based): base * multiplier^n, capped
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_multiplier: float = 2.0
    #: a batch whose readback is not ready this long after dispatch is
    #: dead-lettered (``batches_dead_lettered``) and the loop moves on
    readback_deadline_s: float = 30.0
    #: consecutive failed dispatch attempts (across batches) that publish
    #: degraded mode
    degraded_after: int = 3
    #: on entering degraded mode, run the bounded subprocess probe of the
    #: card (``utils.backend_probe``; its deadline from
    #: ``OCVF_RECOVERY_PROBE_TIMEOUT_S``) and publish its verdict
    probe_backend_on_degraded: bool = False

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (0-based)."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_multiplier ** attempt)


@dataclass
class BrownoutPolicy:
    """Load-shedding knobs of ``RecognizerService``'s brownout controller.

    The controller watches an EWMA of the queue wait (enqueue to batch
    pop: the term that balloons first when the offered load exceeds
    capacity). Crossing ``queue_wait_s`` raises the level one step per
    ``dwell_s``; falling below ``exit_ratio * queue_wait_s`` lowers it. The
    asymmetric thresholds and the dwell are the hysteresis.

    - level 1: bulk frames are shed at intake, one kept in every
      ``bulk_skip`` (reason ``brownout``);
    - level 2 (``max_level``): every bulk frame is shed at intake, and a
      batch is cut to the smallest rung of the dispatch ladder (the cut
      frames shed, reason ``brownout``). The rung was captured at warmup,
      so the cut never captures a graph.

    The intake skip never sheds an interactive frame; the level-2 cut is
    blind to class. Keeping interactive loss at zero is the admission
    bound's job (its interactive reserve)."""

    #: queue-wait EWMA (s) above which the level rises
    queue_wait_s: float = 0.25
    #: the level falls below exit_ratio * queue_wait_s
    exit_ratio: float = 0.5
    #: minimum seconds between level changes (both directions)
    dwell_s: float = 0.5
    #: highest level (2: every bulk frame shed and the ladder capped)
    max_level: int = 2
    #: level 1 keeps one bulk frame in every bulk_skip
    bulk_skip: int = 2
    #: EWMA weight of the newest queue wait
    ewma_alpha: float = 0.3


class DurabilityDegradedError(RuntimeError):
    """An enrolment refused closed because durability is degraded."""


#: disk-pressure severities (the ``disk_pressure_state`` gauge)
DISK_OK, DISK_WARN, DISK_CRITICAL = 0, 1, 2
#: the critical watermark is the low one over this (the reference's default)
CRITICAL_DIVISOR = 6.0
#: consecutive WAL append (or state-dir reach) failures that flip the
#: durability monitor (the reference's default)
DEGRADED_AFTER = 3


class DurabilityMonitor:
    """Degraded-durability state machine and disk-pressure watermarks for
    one writer's state dir (module docstring). The constructor sets
    ``state.durability`` to this monitor; ``StateLifecycle`` feeds it the
    outcome of every WAL append from outside its locks.

    ``tick`` (the serving loop, ``probe=False``) refreshes the disk gauges
    and acts on the watermarks, interval-gated; the background thread
    (``start``) also checks that the state dir is reachable and, while
    degraded, runs the recovery probe."""

    PROBE_NAME = ".durability_probe"


    def __init__(self, state, metrics=None, tracer=None,
                 degraded_after: int = DEGRADED_AFTER, probe_interval_s: float = 5.0,
                 low_watermark_bytes: int = 0, critical_divisor: float = CRITICAL_DIVISOR,
                 publish: Optional[Callable[[dict], None]] = None,
                 fault_injector=None, statvfs_fn=None):
        self.state = state
        self.metrics = metrics
        #: ``utils.tracing.Tracer``: a lifecycle span per flip and re-arm
        self.tracer = tracer
        #: consecutive failures that flip it (the reference's argument)
        self.degraded_after = max(1, int(degraded_after))
        self.probe_interval_s = float(probe_interval_s)
        self.low_watermark_bytes = max(0, int(low_watermark_bytes))
        #: the critical watermark is the low one over this
        self.critical_divisor = max(1.0, float(critical_divisor))
        #: status announcements ({"status": ...}); the service wires its
        #: status publisher here
        self.publish = publish
        self._faults = fault_injector
        self._statvfs = statvfs_fn if statvfs_fn is not None else os.statvfs
        self._degraded = False
        self._degraded_reason: Optional[str] = None
        self._consecutive_wal_failures = 0
        self._consecutive_lease_failures = 0
        self._disk_state = DISK_OK
        self._retention_shrunk = False
        self._saved_retention: dict = {}
        #: the sinks attach_sinks registered, for the retention shrink
        self._journal = None
        self._tracer_sink = None
        self._lock = threading.Lock()
        # one tick cycle at a time (non-blocking claim): the watermark
        # transitions are check-then-act
        self._tick_lock = threading.Lock()
        self._last_tick_t = 0.0
        self._free_bytes: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if state is not None:
            state.durability = self
        if self.metrics is not None:
            self.metrics.set_gauge(mn.DURABILITY_STATE, 0)

    # ---- readers ----

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def degraded_reason(self) -> Optional[str]:
        return self._degraded_reason

    @property
    def disk_state(self) -> int:
        return self._disk_state

    def status(self) -> dict:
        return {
            "degraded": self._degraded,
            "reason": self._degraded_reason,
            "consecutive_wal_failures": self._consecutive_wal_failures,
            "consecutive_lease_failures": self._consecutive_lease_failures,
            "disk_state": self._disk_state,
            "free_bytes": self._free_bytes,
            "low_watermark_bytes": self.low_watermark_bytes,
            "retention_shrunk": self._retention_shrunk,
        }

    def free_bytes(self) -> float:
        """The last sample of the state volume's free bytes (sampled once
        when never sampled): the ``disk_free_objective`` probe."""
        if self._free_bytes is None:
            self._sample_disk()
        return float(self._free_bytes if self._free_bytes is not None else float("inf"))

    # ---- sinks ----

    def attach_sinks(self, journal=None, span_sink=None, tracer=None) -> None:
        """Point the lenient sinks' shed hooks at this monitor: while
        degraded they drop their writes, counted per sink. The WAL never
        sheds: its failures are the signal."""
        shed = lambda: self._degraded  # noqa: E731 - the one-line contract
        if journal is not None:
            journal.shed_fn = shed
            self._journal = journal
        if span_sink is not None:
            span_sink.shed_fn = shed
        if tracer is not None:
            tracer.shed_fn = shed
            self._tracer_sink = tracer

    # ---- the WAL outcome feed ----

    def note_wal_failure(self, exc: BaseException) -> None:
        """One strict WAL append failed with a storage error; the
        ``degraded_after``-th in a row flips the writer."""
        with self._lock:
            self._consecutive_wal_failures += 1
            should_flip = (not self._degraded
                           and self._consecutive_wal_failures >= self.degraded_after)
        if should_flip:
            self._flip_degraded("wal_append_failures", error=repr(exc),
                                consecutive=self._consecutive_wal_failures)

    def note_wal_success(self) -> None:
        with self._lock:
            self._consecutive_wal_failures = 0

    # ---- transitions ----

    def _flip_degraded(self, reason: str, **detail) -> None:
        with self._lock:
            if self._degraded:
                return
            self._degraded = True
            self._degraded_reason = reason
        if self.metrics is not None:
            self.metrics.incr(mn.DURABILITY_DEGRADED_TRANSITIONS)
            self.metrics.set_gauge(mn.DURABILITY_STATE, 1)
        log.error("durability DEGRADED (%s): enrollments refused closed, serving "
                  "continues, recovery probe armed (%s)", reason, detail)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "durability", topic=LIFECYCLE_TOPIC,
                             from_state="armed", to_state="degraded", reason=reason, **detail)
        self._announce({"status": "durability_degraded", "reason": reason, **detail})

    def _rearm(self) -> None:
        with self._lock:
            if not self._degraded:
                return
            self._degraded = False
            reason = self._degraded_reason
            self._degraded_reason = None
            self._consecutive_wal_failures = 0
        if self.metrics is not None:
            self.metrics.incr(mn.DURABILITY_REARMS)
            self.metrics.set_gauge(mn.DURABILITY_STATE, 0)
        log.warning("durability RE-ARMED (probe write+fsync succeeded; was degraded: %s)",
                    reason)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "durability", topic=LIFECYCLE_TOPIC,
                             from_state="degraded", to_state="armed", was=reason)
        self._announce({"status": "durability_restored", "was": reason})

    def _announce(self, status: dict) -> None:
        publish = self.publish
        if publish is None:
            return
        try:
            publish(status)
        except Exception:  # noqa: BLE001 - a dead transport never blocks a flip
            log.exception("durability status publish failed")

    # ---- the recovery probe and the lease check ----

    def probe_now(self) -> bool:
        """One durable write + fsync + unlink of a file in the state dir
        (through the storage fault boundary); a success while the disk is
        above the critical watermark re-arms."""
        if self.metrics is not None:
            self.metrics.incr(mn.DURABILITY_PROBES)
        path = os.path.join(getattr(self.state, "state_dir", "."), self.PROBE_NAME)
        try:
            if self._faults is not None:
                self._faults.on_storage("durability_probe")
            with open(path, "wb") as fh:
                fh.write(b"probe\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.unlink(path)
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.DURABILITY_PROBE_FAILURES)
            return False
        if self._degraded and self._disk_state < DISK_CRITICAL:
            self._rearm()
        return True

    def _check_lease(self) -> None:
        """A writer whose state dir (home of its lease) is unreachable
        ``degraded_after`` times in a row flips degraded: it can no
        longer prove it owns enrolment."""
        state_dir = getattr(self.state, "state_dir", None)
        if state_dir is None:
            return
        try:
            if self._faults is not None:
                self._faults.on_storage_read("lease_check")
            os.stat(state_dir)
        except OSError:
            if self.metrics is not None:
                self.metrics.incr(mn.DURABILITY_LEASE_CHECK_FAILURES)
            with self._lock:
                self._consecutive_lease_failures += 1
                should_flip = (not self._degraded
                               and self._consecutive_lease_failures >= self.degraded_after)
            if should_flip:
                self._flip_degraded("lease_unreachable",
                                    consecutive=self._consecutive_lease_failures)
            return
        with self._lock:
            self._consecutive_lease_failures = 0

    # ---- disk-pressure watermarks ----

    def _sample_disk(self) -> None:
        state_dir = getattr(self.state, "state_dir", None)
        if state_dir is None:
            return
        try:
            st = self._statvfs(state_dir)
            self._free_bytes = float(st.f_bavail) * float(st.f_frsize)
        except OSError:
            return
        if self.metrics is not None:
            self.metrics.set_gauge(mn.DISK_FREE_BYTES, self._free_bytes)

    def _check_watermarks(self) -> None:
        if not self.low_watermark_bytes or self._free_bytes is None:
            return
        free = self._free_bytes
        critical_at = self.low_watermark_bytes / self.critical_divisor
        new_state = (DISK_CRITICAL if free < critical_at
                     else DISK_WARN if free < self.low_watermark_bytes else DISK_OK)
        prev = self._disk_state
        self._disk_state = new_state
        if self.metrics is not None:
            self.metrics.set_gauge(mn.DISK_PRESSURE_STATE, new_state)
        if new_state >= DISK_WARN and prev < DISK_WARN:
            self._on_disk_warn(free)
        if new_state >= DISK_CRITICAL and not self._degraded:
            self._flip_degraded("disk_critical", free_bytes=int(free),
                                low_watermark_bytes=self.low_watermark_bytes)
        if new_state == DISK_OK and prev > DISK_OK:
            self._restore_retention()

    def _on_disk_warn(self, free: float) -> None:
        """Entering warn: one forced checkpoint (it truncates the WAL) and
        one retention shrink."""
        log.warning("disk pressure: %d bytes free < %d watermark: forcing a checkpoint and "
                    "shrinking retention", int(free), self.low_watermark_bytes)
        if self.state is not None:
            try:
                self.state.maybe_checkpoint(force=True)
                if self.metrics is not None:
                    self.metrics.incr(mn.DISK_PRESSURE_COMPACTIONS)
            except Exception:  # noqa: BLE001 - pressure relief is best effort
                log.exception("disk-pressure checkpoint trigger failed")
        self._shrink_retention()
        self._announce({"status": "disk_pressure", "state": "warn", "free_bytes": int(free),
                        "low_watermark_bytes": self.low_watermark_bytes})

    def _dump_tracer(self):
        return self._tracer_sink if self._tracer_sink is not None else self.tracer

    def _shrink_retention(self) -> None:
        """Checkpoints kept, flight dumps kept and journal backups to their
        floor, once per pressure episode."""
        if self._retention_shrunk:
            return
        self._retention_shrunk = True
        store = getattr(self.state, "store", None)
        if store is not None:
            self._saved_retention["store_keep"] = store.keep
            store.keep = 1
        tracer = self._dump_tracer()
        if tracer is not None and hasattr(tracer, "keep_dumps"):
            self._saved_retention["keep_dumps"] = tracer.keep_dumps
            tracer.keep_dumps = 1
        if self._journal is not None:
            self._saved_retention["journal_backups"] = self._journal.backups
            self._journal.backups = 0
        if self.metrics is not None:
            self.metrics.incr(mn.DISK_PRESSURE_RETENTION_SHRINKS)

    def _restore_retention(self) -> None:
        if not self._retention_shrunk:
            return
        self._retention_shrunk = False
        saved = self._saved_retention
        store = getattr(self.state, "store", None)
        if store is not None and "store_keep" in saved:
            store.keep = saved["store_keep"]
        tracer = self._dump_tracer()
        if tracer is not None and "keep_dumps" in saved:
            tracer.keep_dumps = saved["keep_dumps"]
        if self._journal is not None and "journal_backups" in saved:
            self._journal.backups = saved["journal_backups"]
        saved.clear()

    # ---- ticking ----

    def tick(self, force: bool = False, probe: bool = False) -> None:
        """Interval-gated cycle: the disk gauges and watermark actions;
        with ``probe`` (the background thread only) also the lease check
        and, while degraded, the recovery probe, both outside the tick
        claim. A concurrent ticker skips."""
        now = time.monotonic()
        if not force and now - self._last_tick_t < self.probe_interval_s:
            return
        if not self._tick_lock.acquire(blocking=False):
            return
        try:
            self._last_tick_t = now
            self._sample_disk()
            self._check_watermarks()
            should_probe = probe and self._degraded
        finally:
            self._tick_lock.release()
        if probe:
            self._check_lease()
        if should_probe:
            self.probe_now()

    def start(self) -> None:
        """The background ticker (a daemon thread); idempotent."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="durability-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(timeout=max(0.05, self.probe_interval_s)):
            try:
                self.tick(force=True, probe=True)
            except Exception:  # noqa: BLE001 - the monitor thread must live
                log.exception("durability monitor tick failed")


class ServiceSupervisor:
    """Restart a crashed serving loop with the last-known-good gallery
    (module docstring).

    ``checkpoint`` records the gallery and names (stamped with the WAL
    sequence they cover when ``state`` is wired) at start and after every
    committed change (the service's commit hooks). On a crash the watchdog
    restores that snapshot (``load_snapshot``), replays the acknowledged
    WAL tail past its stamp, and restarts the dead threads; without a
    snapshot, or when its install fails, it runs the durable
    ``state.recover``. After ``max_restarts`` it publishes
    ``supervisor_gave_up`` once and stops intervening. Frames pending with
    no progress for ``stall_warn_s`` publish one ``stalled``."""

    def __init__(self, service, max_restarts: int = 5, poll_interval_s: float = 0.2,
                 restart_backoff_s: float = 0.1, commit_wait_s: float = 30.0,
                 state=None):
        self.service = service
        self.max_restarts = int(max_restarts)
        self.poll_interval_s = float(poll_interval_s)
        self.restart_backoff_s = float(restart_backoff_s)
        #: bounded wait for rows an asynchronous grow staged before a
        #: post-commit checkpoint; on timeout the previous one is kept
        self.commit_wait_s = float(commit_wait_s)
        self.state = state
        self.stall_warn_s = 60.0
        self.restarts = 0
        self.gave_up = False
        self._last_processed = -1.0
        self._last_progress_t = time.monotonic()
        self._stall_warned = False
        self._last_health = -1
        self._snapshot: Optional[Tuple] = None
        self._snapshot_wal_seq: Optional[int] = None
        self._snapshot_version: Optional[int] = None
        self._subject_names: Optional[list] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self, warmup: bool = True) -> None:
        """Start the service (if not running) and the watchdog."""
        if self._thread is not None:
            return
        self.service.start(warmup=warmup)
        self.checkpoint()
        self.service.commit_hooks.append(self._on_commit)
        self._running = True
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="service-supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._on_commit in self.service.commit_hooks:
            self.service.commit_hooks.remove(self._on_commit)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.service.stop()

    def checkpoint(self) -> None:
        """Record the gallery and names as last-known-good (host-mirror
        copies; stamped with the WAL sequence when ``state`` is wired)."""
        if self.state is not None:
            (self._snapshot_wal_seq, self._snapshot, self._subject_names,
             self._snapshot_version) = self.state.stamped_snapshot()
        else:
            gallery = self.service.pipeline.gallery
            self._snapshot_wal_seq = None
            self._snapshot = gallery.snapshot()
            self._subject_names = list(self.service.subject_names)
            self._snapshot_version = getattr(gallery, "embedder_version", None)
        self.service.metrics.incr(mn.SUPERVISOR_CHECKPOINTS)

    def _on_commit(self) -> None:
        """Advance last-known-good after a committed gallery change. The
        committing add may only have staged its rows (``async_grow``): wait
        (bounded) for them to land, and on timeout keep the previous
        checkpoint rather than one that misses the rows this commit
        announced."""
        if not self._running:
            return
        wait_ready = getattr(self.service.pipeline.gallery, "wait_ready", None)
        if wait_ready is not None and not wait_ready(timeout=self.commit_wait_s):
            log.warning("post-commit checkpoint skipped: staged rows not landed within "
                        "%.0f s; keeping the previous snapshot", self.commit_wait_s)
            return
        self.checkpoint()

    def _monitor(self) -> None:
        from opencv_facerecognizer_tpu_torch.runtime.recognizer import STATUS_TOPIC

        service = self.service
        while self._running:
            time.sleep(self.poll_interval_s)
            self._check_stall(service, STATUS_TOPIC)
            self._check_health(service, STATUS_TOPIC)
            if not service.loop_crashed or not service._running:
                continue
            if not service.restart_pending():
                continue  # flagged, but the thread is still unwinding
            if self.restarts >= self.max_restarts:
                if not self.gave_up:
                    self.gave_up = True
                    service.metrics.incr(mn.SUPERVISOR_GAVE_UP)
                    self._publish(STATUS_TOPIC, {"status": "supervisor_gave_up",
                                                 "restarts": self.restarts})
                continue
            self.restarts += 1
            tracer = getattr(service, "tracer", None)
            if tracer is not None:
                # before the restore mutates anything: what was in flight
                tracer.dump("supervisor_restart",
                            extra={"restarts": self.restarts, "ledger": service.ledger()})
            try:
                self._restore_gallery()
            except Exception:  # noqa: BLE001 - fall back to the durable state
                log.exception("gallery restore failed; trying durable state")
                if not self._restore_durable():
                    log.error("durable restore unavailable; restarting with current state")
            service.restart_loop()
            # counted once the restore and the restart are done
            service.metrics.incr(mn.SUPERVISOR_RESTARTS)
            self._publish(STATUS_TOPIC, {"status": "supervisor_restart",
                                         "restarts": self.restarts})
            time.sleep(self.restart_backoff_s)

    def _check_stall(self, service, status_topic: str) -> None:
        """One ``stalled`` announcement when frames are pending and no batch
        has settled (processed, failed or dead-lettered) for
        ``stall_warn_s``."""
        m = service.metrics
        processed = (m.counter(mn.FRAMES_PROCESSED) + m.counter(mn.BATCHES_FAILED)
                     + m.counter(mn.BATCHES_DEAD_LETTERED))
        now = time.monotonic()
        if processed != self._last_processed:
            self._last_processed = processed
            self._last_progress_t = now
            self._stall_warned = False
            return
        if (not self._stall_warned and service.batcher.pending > 0
                and now - self._last_progress_t > self.stall_warn_s):
            self._stall_warned = True
            service.metrics.incr(mn.SUPERVISOR_STALLS)
            tracer = getattr(service, "tracer", None)
            if tracer is not None:
                # what was in flight when the loop stopped moving
                tracer.dump("wedge_stall", extra={
                    "pending_frames": service.batcher.pending,
                    "seconds_without_progress": round(now - self._last_progress_t, 1),
                    "ledger": service.ledger()})
            self._publish(status_topic, {
                "status": "stalled", "pending_frames": service.batcher.pending,
                "seconds_without_progress": round(now - self._last_progress_t, 1)})

    def _check_health(self, service, status_topic: str) -> None:
        """Publish the SLO monitor's health transitions, one ``health``
        status per change with the objectives' burns (the initial ``ok``
        is not announced). Ticks the monitor first: a wedged serving loop
        stops ticking it."""
        monitor = getattr(service, "slo", None)
        if monitor is None:
            return
        try:
            monitor.tick()
        except Exception:  # noqa: BLE001 - the watchdog thread must live
            log.exception("supervisor slo backstop tick failed")
            service.metrics.incr(mn.SLO_TICK_ERRORS)
        state = monitor.state_code
        if state == self._last_health:
            return
        first = self._last_health < 0
        self._last_health = state
        if first and state == 0:
            return
        verdict = monitor.verdict()
        self._publish(status_topic, {
            "status": "health", "state": monitor.state,
            "objectives": {name: obj.get("burn")
                           for name, obj in verdict.get("objectives", {}).items()},
            "events": verdict.get("events", {})})

    def _restore_gallery(self) -> None:
        if self._snapshot is None:
            self._restore_durable()
            return
        service = self.service
        gallery = service.pipeline.gallery
        gallery.load_snapshot(*self._snapshot, embedder_version=self._snapshot_version)
        if self._subject_names is not None:
            service.subject_names[:] = self._subject_names
        if self.state is not None and self._snapshot_wal_seq is not None:
            # enrolments acknowledged after the snapshot's stamp
            self.state.replay_tail(self._snapshot_wal_seq)
        poke = getattr(gallery, "_poke_quantizer", None)
        if poke is not None:
            poke()  # load_snapshot invalidated the quantizer: retrain

    def _restore_durable(self) -> bool:
        """The process-restart path (checkpoint + WAL replay); True when it
        ran."""
        if self.state is None:
            return False
        try:
            self.state.recover(self.service.pipeline.gallery, self.service.subject_names)
            self.service.metrics.incr(mn.SUPERVISOR_DURABLE_RESTORES)
            return True
        except Exception:  # noqa: BLE001 - restore is best effort here
            log.exception("durable restore failed")
            return False

    def _publish(self, topic: str, message: dict) -> None:
        try:
            self.service.connector.publish(topic, message)
        except Exception:  # noqa: BLE001 - a dead transport must not kill the watchdog
            log.exception("supervisor publish failed")
