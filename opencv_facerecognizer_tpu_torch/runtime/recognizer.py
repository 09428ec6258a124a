"""Recognizer service: port of ``opencv_facerecognizer_tpu/runtime/
recognizer.py`` without the subsystems that wait for later slices.

Flow: connector frames -> ``FrameBatcher`` -> identity-cache lookup ->
one serving step per batch (``RecognitionPipeline.recognize_batch_packed``,
the batch sliced to the smallest rung of a bucket ladder that holds it)
-> in-flight queue -> readback worker -> one result message per frame on
``RESULT_TOPIC``.

- **The dispatch loop never waits on device results.** It enqueues the
  step, starts the packed result's copy to pinned host memory with a CUDA
  event behind it, parks the batch in the in-flight queue and goes on
  batching; ``inflight_depth`` bounds the queue. A readback worker waits
  on each batch in dispatch order (through a sacrificial blocker thread,
  so the wait is bounded by the batch's readback deadline) and publishes.
  ``readback_worker=False`` keeps the inline fallback: the loop itself
  polls readiness between batches (``readback_poll_s``, ``drain_poll_s``).
- **Failure handling** (``runtime.resilience``): a transient dispatch
  failure retries with exponential backoff, a permanent one abandons the
  batch at once (``frames_failed``); ``degraded_after`` consecutive failed
  attempts publish ``degraded`` on ``STATUS_TOPIC`` and the next success
  ``recovered``. A readback not ready by its deadline is dead-lettered
  (``frames_dead_lettered``, a ``dead_letter`` status with the frames'
  metas) and the loop moves on. A ``fault_injector`` (``runtime.faults``,
  chaos tests only) is crossed at each delivery (``receive``), handed to
  the batcher (``put``), and crossed at each dispatch attempt and on each
  dispatched batch's readback; the warmup crosses none of them.
- **Identity cache** (``runtime.tracker``, optional): frames whose
  stream's tracks are all fresh settle as ``completed_cached`` with the
  cached identities before dispatch; every full result re-verifies its
  stream's tracks after publish.
- **Control topic**: ``{"cmd": "enroll", "subject", "count"}`` captures
  the best face crop of the next ``count`` frames that have one, embeds
  them in fixed chunks on the pipeline's device off the serving threads,
  adds them to the gallery and publishes ``enrolled`` (the subject's
  label is kept only if that succeeds); ``{"cmd": "stats"}`` publishes
  the metrics, the ledger, the gallery size and the durable state's
  status.
- **Durable state** (``state_store=``, a ``runtime.state_store.
  StateLifecycle``): an enrolment is appended to the WAL before it
  touches the gallery, so ``enrolled`` promises it survives a crash; the
  serving loop ticks the checkpoint thresholds and the durability
  monitor, whose background thread runs between ``start`` and ``stop``.
  While durability is degraded an ``enroll`` is refused
  (``rejected``, reason ``durability_degraded``); a failed WAL append
  publishes ``enroll_failed``. ``commit_hooks`` run after every committed
  gallery change (an enrolment, ``reload_gallery``).
- **Supervision**: an exception that kills the dispatch loop or the
  readback worker sets ``loop_crashed``; ``runtime.resilience.
  ServiceSupervisor`` restores the gallery and calls ``restart_loop``.

**Overload control**, in front of and inside the loop:

- **Frame-id dedup**: a delivery whose ``meta["_fid"]`` was already
  admitted (within the last ``dedup_window`` ids) is refused before
  admission (``frames_deduped``), so a duplicated transport or a re-send
  never counts twice.
- **Admission** (``runtime.admission``): ``_on_frame`` consults the
  controller before it decodes; a rejected frame is counted
  (``frames_rejected_<reason>``) and announced in aggregate (one
  ``rejected`` status per reason per half second). Frames carry a
  ``priority`` (``interactive``, the default, or ``bulk``): the batcher
  sheds stale and bulk frames first, and sheds frames older than
  ``shed_stale_after_s`` before they take a dispatch slot.
- **Brownout** (``BrownoutPolicy``): a queue-wait EWMA past its threshold
  sheds bulk intake (level 1 one in two, level 2 all) and at the top
  level cuts a batch to the smallest ladder rung, a graph captured at
  warmup; announced as ``brownout`` / ``brownout_recovered`` statuses
  with the ``brownout_level`` gauge. A critical SLO verdict adds one
  level of intake pressure.
- Shed, dead-lettered and abandoned frames go to the optional
  ``DeadLetterJournal`` with their metas, stamps, trace ids and the
  stage they died at.

**Observability**: with a ``tracer`` every sampled frame records its
spans (receive with the admission verdict, queue_wait with its batch,
the batch's dispatch / ready_wait / publish, a settle span mirroring its
ledger bucket), brownout transitions and captures after warmup are
lifecycle spans, and a dead-letter dumps the flight recorder (its path
rides the journal record). The spans are host timestamps around the
existing dispatch and readback: nothing waits for the card for them.
``slo_monitor`` is ticked by the loop; a step captured after warmup is
also its watchdog event.

Every admitted frame ends in exactly one counter of
``utils.metrics.LEDGER_COMPLETION_COUNTERS`` or ``LEDGER_DROP_COUNTERS``
(``ledger()``); rejected and deduped frames never enter it.

**Ingest** (``ingest=``, a ``runtime.ingest.IngestConfig``): the batcher
stages into a pre-allocated ring of host buffers (pinned on the card),
each dispatch attempt uploads its batch explicitly on a side stream
(``upload`` span), a buffer goes back to the ring only after its batch's
readback (and its upload has passed), and a dead-lettered or crashed
batch forfeits its buffer. Ring exhaustion backpressures through the
admission (reason ``staging``). In ``jpeg`` mode a compressed payload is
decoded by the decode pool off the connector thread (``decode`` span); a
corrupt one is a ``frames_dropped_decode`` drop journaled as
``decode_error``, a full decode queue one journaled as ``decode_backlog``.
A compressed payload with no decode pool counts as malformed.

**Rollout** (``rollout``, a ``runtime.rollout.RolloutCoordinator``
set by the code that runs the rollout): the publish path offers a face of each frame
with faces to its live parity window (rate-limited and copied by the
coordinator). Each batch's results carry the ``embedder_version`` of the
gallery snapshot its step matched against (ROADMAP C.12), and the
in-flight entry holds that snapshot until the readback.

**The cascade** (a pipeline with a stage-1 gate, ``cascade=True``): each
batch is scored at its rung first (``RecognitionPipeline.cascade_scores``;
the ``[B]`` readback is the decision point), frames below the threshold
(``cascade_threshold``, else the gate's own, tightened by
``cascade_brownout_notch`` at brownout level 1 and up) settle as
``completed_empty`` with an empty result (``exit: "cascade"``), the
survivors are compacted to the front of the staging buffer and dispatch at
the smallest rung that holds them; a batch with no survivor exits
(``cascade_batch_exits``). A failed stage-1 pass fails open: the whole batch
takes the full step (``cascade_errors``). The host writes the staging
buffer only after the scores' readback, which follows the stage-1 copy of
the buffer on the same stream.

**The registry** (``registry``, a ``runtime.registry.ModelRegistry``, and
``registry_swap``, a live ``RegistrySwapCoordinator``, set by the code
that runs them): results carry ``registry``, the version of each role the
batch really ran (the pipeline records it with each queued step: ROADMAP
C.14), and the identity cache keys on that stamp; the publish path offers
frames to a live swap's parity window; ``flush_model_caches`` is a swap's
cache flush.

**A read replica** (``replica=``, a ``runtime.replication.ReadReplica``):
the serving loop polls it between batches (interval-gated; a failed poll
counts ``replication_poll_errors`` and serving goes on), and an
``enroll`` is refused (``rejected``, reason ``read_replica``,
``replication_enroll_rejected``): the writer owns the WAL.

**Link supervision**: a ping on ``LINK_PING_TOPIC`` is echoed on
``LINK_PONG_TOPIC`` from the connector's thread, the path frames take; a
router marks the link down when the echo stops.

The CPU fallback is not ported (ROADMAP C.7): with
``probe_backend_on_degraded`` a dead card is reported (``backend_usable:
false``, ``cpu_fallback: false``) and the service stays degraded.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models.cascade import DEFAULT_THRESHOLD
from opencv_facerecognizer_tpu_torch.models.embedder import normalize_faces
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.parallel.mesh import DP_AXIS
from opencv_facerecognizer_tpu_torch.parallel.pipeline import unpack_result
from opencv_facerecognizer_tpu_torch.runtime.admission import (
    PRIORITY_INTERACTIVE, AdmissionController, parse_priority)
from opencv_facerecognizer_tpu_torch.runtime.batcher import FrameBatcher
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    MiddlewareConnector, decode_frame)
from opencv_facerecognizer_tpu_torch.runtime.ingest import (
    JPEG_KEY, IngestConfig, IngestPipeline)
from opencv_facerecognizer_tpu_torch.runtime.resilience import (
    BrownoutPolicy, DurabilityDegradedError, ResiliencePolicy, is_transient_error)
from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing

FRAME_TOPIC = "ocvfacerec/frames"
RESULT_TOPIC = "ocvfacerec/results"
CONTROL_TOPIC = "ocvfacerec/control"
STATUS_TOPIC = "ocvfacerec/status"
#: link supervision: a router's pings and this service's echoes
LINK_PING_TOPIC = "ocvfacerec/link/ping"
LINK_PONG_TOPIC = "ocvfacerec/link/pong"
DEFAULT_BUCKET_SIZES = (8, 32, 128)
#: fallback path's readiness poll while it waits out a head batch (s)
FALLBACK_READBACK_POLL_S = 0.005
#: completion-wait tick of drain() and the threads' condition waits (s)
FALLBACK_DRAIN_POLL_S = 0.05
#: enrolment embeds run in fixed chunks of this many crops (warmed once)
ENROL_CHUNK = 8
#: one aggregated ``rejected`` status per reason per this many seconds
REJECT_NOTE_INTERVAL_S = 0.5
#: the stage-1 threshold's rise at brownout level 1 and up (capped at 0.99)
CASCADE_BROWNOUT_NOTCH = 0.15

log = logging.getLogger(__name__)


@dataclass
class _Enrolment:
    subject_name: str
    needed: int
    crops: List[np.ndarray] = field(default_factory=list)


class _Readback:
    """One batch's packed result on its way to the host: a pinned host
    copy and, for a CUDA result, the event recorded behind the copy. The
    copy is queued on the dispatching stream right after the step, so a
    CUDA graph's static output is read before the next replay rewrites
    it. A pipeline may return an object with this class's interface
    (``pending``, ``ready``, ``wait``, ``result``) instead of a tensor:
    ``runtime.fakes`` scripts its readiness that way."""

    def __init__(self, packed: torch.Tensor):
        self.host = packed.to("cpu", non_blocking=True)  # pinned for a CUDA source
        self.event = None
        if packed.is_cuda:
            # the copy is queued on the current stream of the result's
            # device, which need not be the current device
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(packed.device))

    @property
    def pending(self) -> bool:
        """False when the result was on the host from the start."""
        return self.event is not None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def result(self) -> np.ndarray:
        """The packed result as numpy (waits; a device fault raises here)."""
        self.wait()
        return self.host.numpy()


class _ReadbackBlocker:
    """A daemon thread that performs the possibly unbounded ``wait`` of a
    readback, so the worker's wait can be bounded by the batch's deadline.
    ``block`` returns "ready", "raised" (the wait raised) or "timeout".
    After a timeout the thread may be stuck in a CUDA call: the caller
    closes this instance and builds a new one. ``close`` ends the thread
    once its current wait (if any) returns; ``join`` waits for that."""

    def __init__(self):
        self._cv = threading.Condition()
        self._pending: Any = None
        self._closed = False
        self._done = threading.Event()
        self._ok = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ocvf-readback-blocker")
        self._thread.start()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()

    def join(self, timeout: float) -> bool:
        """Wait up to ``timeout`` s for the thread to end (after ``close``);
        False if it is still inside a wait."""
        self._thread.join(timeout=max(0.0, timeout))
        return not self._thread.is_alive()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None:
                    return
                readback = self._pending
            try:
                readback.wait()
                self._ok = True
            except Exception:  # noqa: BLE001 - recorded: block() reports "raised"
                self._ok = False
            with self._cv:
                self._pending = None
            self._done.set()

    def block(self, readback: Any, timeout: float) -> str:
        self._done.clear()
        with self._cv:
            self._pending = readback
            self._cv.notify()
        if not self._done.wait(timeout=max(0.0, timeout)):
            return "timeout"
        return "ready" if self._ok else "raised"


class _Inflight(NamedTuple):
    readback: Any
    frames: np.ndarray
    metas: List[Any]
    count: int
    enqueue_ts: List[float]
    t0: float
    t_disp: float
    deadline: float  # time.monotonic() after which the batch dead-letters
    # the embedder_version of the snapshot the step matched, or with a
    # registry the sorted (role, version) pairs the batch ran
    stamp: Any
    trace_ids: List[int]  # the frames' traces (0 = untraced)
    batch_tid: int  # the batch's trace (0 = no member traced)
    priorities: List[int]
    snapshot: Any = None  # that gallery snapshot, alive until the readback


def bucket_ladder(bucket_sizes, batch_size: int, pipeline) -> List[int]:
    """The dispatch ladder (the reference's ``_build_bucket_ladder``):
    ascending sizes ending at ``batch_size``, keeping only the rungs that
    the largest dp axis of the pipeline's meshes (``gallery.mesh``,
    ``mesh_a``) divides, since a dp-split step refuses the others. A
    pipeline with no mesh (a stub) divides by 1."""
    divisor = 1
    for mesh in (getattr(getattr(pipeline, "gallery", None), "mesh", None),
                 getattr(pipeline, "mesh_a", None)):
        if mesh is not None:
            divisor = max(divisor, int(mesh.shape[DP_AXIS]))
    return sorted({int(b) for b in (bucket_sizes or ())
                   if 0 < int(b) < batch_size and int(b) % divisor == 0}
                  | {int(batch_size)})


class RecognizerService:
    def __init__(self, pipeline, connector: MiddlewareConnector, batch_size: int = 8,
                 frame_shape: Optional[tuple] = None, flush_timeout: float = 0.05,
                 inflight_depth: int = 4, similarity_threshold: float = 0.3,
                 subject_names: Optional[List[str]] = None,
                 metrics: Optional[mn.Metrics] = None, transfer_dtype=np.float32,
                 resilience: Optional[ResiliencePolicy] = None,
                 readback_worker: bool = True,
                 readback_poll_s: float = FALLBACK_READBACK_POLL_S,
                 drain_poll_s: float = FALLBACK_DRAIN_POLL_S,
                 bucket_sizes: Optional[Sequence[int]] = DEFAULT_BUCKET_SIZES,
                 target_latency_s: Optional[float] = None, tracker=None,
                 max_pending: int = 256, state_store=None, fault_injector=None,
                 backend_probe_fn: Optional[Callable[[], tuple]] = None,
                 admission: Optional[AdmissionController] = None,
                 brownout: Optional[BrownoutPolicy] = None, dead_letter_journal=None,
                 shed_stale_after_s: Optional[float] = None, tracer=None,
                 slo_monitor=None, dedup_window: int = 4096,
                 ingest: Optional[IngestConfig] = None, cascade: bool = True,
                 cascade_threshold: Optional[float] = None,
                 cascade_brownout_notch: float = CASCADE_BROWNOUT_NOTCH, replica=None):
        if frame_shape is None:
            raise ValueError("frame_shape (H, W) is required (fixed batch shapes)")
        self.pipeline = pipeline
        self.connector = connector
        self.similarity_threshold = float(similarity_threshold)
        self.subject_names = list(subject_names) if subject_names else []
        self.metrics = metrics or mn.Metrics()
        self.resilience = resilience or ResiliencePolicy()
        self.tracker = tracker
        self.inflight_depth = int(inflight_depth)
        self._use_worker = bool(readback_worker)
        self._readback_poll_s = float(readback_poll_s)
        self._drain_poll_s = float(drain_poll_s)
        self.admission = admission
        if admission is not None and admission.inflight_fn is None:
            # the bound reads the admission ledger: one bookkeeping, no drift
            admission.inflight_fn = self.frames_in_system
        self.brownout_policy = brownout
        self.journal = dead_letter_journal
        self.tracer = tracer
        self.slo = slo_monitor
        #: a ``runtime.replication.ReadReplica``: polled by the loop, and
        #: enrolment is refused
        self.replica = replica
        #: the model registry, a live registry swap and the rollout
        #: coordinator, set by the code that runs them; the exposition reads them
        self._registry = None
        self.registry_swap = None
        self.rollout = None
        # the stage-1 gate runs when enabled and the pipeline carries one;
        # the threshold: the argument, else the gate's, else the default
        gate = getattr(pipeline, "cascade", None)
        self._cascade_active = (bool(cascade) and gate is not None
                                and hasattr(pipeline, "cascade_scores"))
        if cascade_threshold is None:
            cascade_threshold = getattr(gate, "threshold", None)
        self.cascade_threshold = float(DEFAULT_THRESHOLD if cascade_threshold is None
                                       else cascade_threshold)
        self.cascade_brownout_notch = float(cascade_brownout_notch)
        # frames scored and rejected, the rate gauges' totals (serving thread)
        self._cascade_scored = 0
        self._cascade_rejected = 0
        self._brownout_level = 0
        self._queue_wait_ewma: Optional[float] = None
        self._brownout_changed_at = 0.0
        self._bulk_seq = 0
        self._reject_note_interval_s = REJECT_NOTE_INTERVAL_S
        self._reject_pending: Dict[str, int] = {}
        self._reject_last_pub: Dict[str, float] = {}
        self._reject_lock = threading.Lock()
        # fids of admitted frames: a set to test, a deque to evict in order
        self._dedup_window = max(0, int(dedup_window))
        self._dedup_seen: set = set()
        self._dedup_order: deque = deque()
        self._dedup_lock = threading.Lock()
        #: time.monotonic() of the loop's last iteration (loop_staleness_s)
        self._loop_progress_t: Optional[float] = None
        self._bucket_ladder = bucket_ladder(bucket_sizes, batch_size, pipeline)
        #: the staging ring, the upload and the decode pool (runtime.ingest),
        #: built before the batcher, which stages into the ring
        self.ingest = None
        if ingest is not None:
            self.ingest = IngestPipeline(ingest, self._bucket_ladder, tuple(frame_shape),
                                         metrics=self.metrics, tracer=tracer,
                                         trace_topic=FRAME_TOPIC,
                                         fault_injector=fault_injector,
                                         inflight_depth=int(inflight_depth),
                                         device=getattr(pipeline, "device", None))
            transfer_dtype = self.ingest.transfer_dtype
            if admission is not None and admission.staging_free_fn is None:
                # an exhausted ring rejects at the front door (``staging``)
                admission.staging_free_fn = self.ingest.staging.free_slots
        self.batcher = FrameBatcher(batch_size, frame_shape, flush_timeout=flush_timeout,
                                    max_pending=max_pending, dtype=transfer_dtype,
                                    metrics=self.metrics, target_latency_s=target_latency_s,
                                    stale_after_s=shed_stale_after_s,
                                    drop_log=self._journal_drop, tracer=tracer,
                                    trace_topic=FRAME_TOPIC,
                                    staging_ring=(None if self.ingest is None
                                                  else self.ingest.staging),
                                    fault_injector=fault_injector)
        self._inflight: deque = deque()
        # guards the in-flight queue and the completion count; drain() waits on it
        self._inflight_cv = threading.Condition()
        self._completed_batches = 0
        self._blocker: Optional[_ReadbackBlocker] = None
        #: blockers closed while a wait may still hold them (a timed-out
        #: readback, a restarted worker); ``stop`` joins them
        self._retired_blockers: List[_ReadbackBlocker] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._worker: Optional[threading.Thread] = None
        self._consecutive_dispatch_failures = 0
        self._degraded = False
        self._enrolment: Optional[_Enrolment] = None
        self._enrol_lock = threading.Lock()
        self._crashed = False
        #: set by ``warmup``: a step built after it is a capture on the
        #: serving thread, counted as ``recompiles_post_warmup``
        self._warmed = False
        #: ``runtime.faults.FaultInjector`` at the receive, dispatch and
        #: readback boundaries, handed to the batcher for put (never in
        #: production); warmup crosses none of them
        self._faults = fault_injector
        #: the degraded-mode probe, injectable for tests; default
        #: ``utils.backend_probe.probe_for_recovery``
        self._backend_probe_fn = backend_probe_fn
        #: called (no arguments, best effort) after every committed gallery
        #: change; the state store and the supervisor register here
        self.commit_hooks: List[Callable[[], None]] = []
        self.state = state_store
        if self.state is not None:
            self.state.attach(self)
        dur = self._durability
        if dur is not None and dur.publish is None:
            dur.publish = self._publish_status
        connector.subscribe(FRAME_TOPIC, self._on_frame)
        connector.subscribe(CONTROL_TOPIC, self._on_control)
        connector.subscribe(LINK_PING_TOPIC, self._on_link_ping)

    @property
    def _durability(self):
        """The state store's ``DurabilityMonitor`` (None without one)."""
        return None if self.state is None else self.state.durability

    @property
    def registry(self):
        return self._registry

    @registry.setter
    def registry(self, registry) -> None:
        """Attach the manifest; a pipeline that records its installs starts
        from the versions the manifest serves."""
        self._registry = registry
        versions = getattr(self.pipeline, "model_versions", None)
        if registry is not None and versions is not None:
            for role, version in registry.stamp().items():
                if role != "embedder":
                    versions.setdefault(role, version)

    # ---- admission ledger ----

    def ledger(self) -> Dict[str, Any]:
        """``admitted``, ``completed``, ``completed_empty`` (the cascade's
        exits), ``completed_cached`` (answered from the identity cache),
        per-reason ``drops_by_reason`` and the ``in_system`` remainder,
        which is 0 once ``drain()`` returned."""
        c = self.metrics.counters()
        drops = {n: c[n] for n in mn.LEDGER_DROP_COUNTERS if c.get(n)}
        admitted = c.get(mn.FRAMES_ADMITTED, 0.0)
        completed = c.get(mn.FRAMES_COMPLETED, 0.0)
        empty = c.get(mn.FRAMES_COMPLETED_EMPTY, 0.0)
        cached = c.get(mn.FRAMES_COMPLETED_CACHED, 0.0)
        return {"admitted": admitted, "completed": completed, "completed_empty": empty,
                "completed_cached": cached, "drops_by_reason": drops,
                "in_system": admitted - completed - empty - cached - sum(drops.values())}

    def frames_in_system(self) -> float:
        """Admitted frames not finished yet, the admission bound's signal:
        one counter read under one lock (it runs for every offered frame);
        exact only when the service is idle."""
        return max(0.0, self.metrics.sum_counters(
            (mn.FRAMES_ADMITTED,), mn.LEDGER_COMPLETION_COUNTERS + mn.LEDGER_DROP_COUNTERS))

    def _journal_drop(self, reason: str, entries: List[Dict[str, Any]], **extra) -> None:
        """Lost frames to the dead-letter journal, if any (also the
        batcher's ``drop_log``)."""
        if self.journal is not None:
            self.journal.append(reason, entries, **extra)

    @staticmethod
    def _drop_entries(metas, enqueue_ts, trace_ids, stage: str,
                      priority=None) -> List[Dict[str, Any]]:
        """Journal entries of a run of lost frames, aligned by index."""
        return [{"meta": metas[i],
                 "enqueue_ts": (enqueue_ts[i] if enqueue_ts is not None
                                and i < len(enqueue_ts) else None),
                 "priority": priority,
                 "trace_id": ((trace_ids[i] or None) if trace_ids is not None
                              and i < len(trace_ids) else None),
                 "stage": stage} for i in range(len(metas))]

    def _trace_settle(self, trace_ids, outcome: str, where: str, batch: int = 0) -> None:
        """The terminal ``settle`` span of each traced frame of a run:
        ``outcome`` is its ledger bucket."""
        tracer = self.tracer
        if tracer is None:
            return
        for tid in trace_ids or ():
            if tid:
                tracer.emit(tid, tracing.SETTLE_STAGE, topic=FRAME_TOPIC, outcome=outcome,
                            where=where, batch=batch)

    def _note_rejection(self, reason: str) -> None:
        """Count one rejection and announce the reason's count since its
        last announcement, at most once per ``REJECT_NOTE_INTERVAL_S``."""
        self.metrics.incr(mn.FRAMES_REJECTED_PREFIX + reason)
        now = time.monotonic()
        with self._reject_lock:
            self._reject_pending[reason] = self._reject_pending.get(reason, 0) + 1
            if now - self._reject_last_pub.get(reason, 0.0) < self._reject_note_interval_s:
                return
            count = self._reject_pending.pop(reason)
            self._reject_last_pub[reason] = now
        self._publish_status({"status": "rejected", "reason": reason, "count": count})

    def _flush_rejections(self, force: bool = False) -> None:
        """Announce the rejections still pending when a flood stopped
        mid-interval (the loop's idle tick; ``stop`` forces it)."""
        now = time.monotonic()
        flush = []
        with self._reject_lock:
            for reason in list(self._reject_pending):
                if force or (now - self._reject_last_pub.get(reason, 0.0)
                             >= self._reject_note_interval_s):
                    flush.append((reason, self._reject_pending.pop(reason)))
                    self._reject_last_pub[reason] = now
        for reason, count in flush:
            self._publish_status({"status": "rejected", "reason": reason, "count": count})

    # ---- brownout controller ----

    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    def _note_queue_wait(self, seconds: float) -> None:
        """One batch's mean queue wait (0.0 on an idle tick, so an emptied
        queue recovers) into the controller's EWMA."""
        if self.brownout_policy is None:
            return
        policy = self.brownout_policy
        prev = self._queue_wait_ewma
        self._queue_wait_ewma = (seconds if prev is None
                                 else prev + policy.ewma_alpha * (seconds - prev))
        self._update_brownout()

    def _update_brownout(self) -> None:
        policy = self.brownout_policy
        if time.monotonic() - self._brownout_changed_at < policy.dwell_s:
            return  # the dwell: no flapping between batches
        ewma = self._queue_wait_ewma or 0.0
        level = self._brownout_level
        if ewma > policy.queue_wait_s and level < policy.max_level:
            self._set_brownout(level + 1, ewma)
        elif ewma < policy.exit_ratio * policy.queue_wait_s and level > 0:
            self._set_brownout(level - 1, ewma)

    def _set_brownout(self, level: int, ewma: float) -> None:
        prev = self._brownout_level
        self._brownout_level = level
        self._brownout_changed_at = time.monotonic()
        self.metrics.set_gauge(mn.BROWNOUT_LEVEL, level)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "brownout",
                             topic=tracing.LIFECYCLE_TOPIC, level=level, from_level=prev,
                             queue_wait_ewma_ms=round(ewma * 1e3, 2))
        if level > 0:
            self.metrics.incr(mn.BROWNOUT_TRANSITIONS)
            self._publish_status({"status": "brownout", "level": level,
                                  "queue_wait_ewma_ms": round(ewma * 1e3, 2)})
        else:
            self.metrics.incr(mn.BROWNOUT_RECOVERIES)
            self._publish_status({"status": "brownout_recovered",
                                  "queue_wait_ewma_ms": round(ewma * 1e3, 2)})

    def _effective_brownout_level(self) -> int:
        """The controller's level, one higher while the SLO monitor reads
        critical (the intake skip alone reads the boost)."""
        level = self._brownout_level
        if (self.slo is not None and self.brownout_policy is not None
                and self.slo.state_code >= STATE_CRITICAL):
            level = min(self.brownout_policy.max_level, level + 1)
        return level

    def _brownout_sheds_intake(self, priority: int, level: int) -> bool:
        """Shed this admitted frame at intake? Never an interactive one;
        bulk one in ``bulk_skip`` kept at level 1, none at the top."""
        if level <= 0 or priority <= PRIORITY_INTERACTIVE:
            return False
        if level >= self.brownout_policy.max_level:
            return True
        self._bulk_seq += 1
        return self._bulk_seq % max(2, self.brownout_policy.bulk_skip) != 0

    def _brownout_bucket_cap(self) -> Optional[int]:
        """At the top level, the smallest ladder rung (warmed at start, so
        the cut never captures on the serving thread); else None."""
        if (self.brownout_policy is not None
                and self._brownout_level >= self.brownout_policy.max_level):
            return self._bucket_ladder[0]
        return None

    def _observe_e2e(self, enqueue_ts: float, priority: int, now_mono: float) -> None:
        """One frame's enqueue-to-publish latency, and again in the
        interactive window for an interactive frame."""
        e2e = now_mono - enqueue_ts
        self.metrics.observe(mn.E2E_LATENCY, e2e)
        if priority <= PRIORITY_INTERACTIVE:
            self.metrics.observe(mn.E2E_LATENCY_INTERACTIVE, e2e)

    def _note_recompile(self, bucket: int, frames_n: int, mode) -> None:
        """A step whose cache entry was missing after warmup (a CUDA graph
        captured on the serving thread): counted, a lifecycle span, and a
        warn-level SLO event."""
        self.metrics.incr(mn.RECOMPILES_POST_WARMUP)
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "recompile",
                             topic=tracing.LIFECYCLE_TOPIC, bucket=bucket, frames=frames_n,
                             mode=mode)
        if self.slo is not None:
            self.slo.note_event("recompile_post_warmup")

    # ---- connector handlers (the connector's thread; keep cheap) ----

    def _on_frame(self, topic: str, message: Dict[str, Any]) -> None:
        # the receive boundary: a fault may drop, duplicate, flood or
        # corrupt the delivery; each message it returns is handled alone
        messages = [message] if self._faults is None else self._faults.on_receive(message)
        for msg in messages:
            self._receive_one(topic, msg)

    def _receive_one(self, topic: str, message: Dict[str, Any]) -> None:
        tracer = self.tracer
        priority = parse_priority(message.get("priority"))
        # tid 0: sampled out, every emit below is a no-op
        tid = tracer.start_trace(topic) if tracer is not None else 0
        if tid:
            t_recv = message.get("_recv_ts") or time.monotonic()
        meta = message.get("meta")
        fid = meta.get("_fid") if self._dedup_window and isinstance(meta, dict) else None
        if fid is not None and self._dedup_hit(fid):
            # outside the ledger, like a rejection
            self.metrics.incr(mn.FRAMES_DEDUPED)
            if tid:
                tracer.emit(tid, "receive", topic=topic, t0=t_recv,
                            dur=time.monotonic() - t_recv, verdict="deduped",
                            priority=priority)
            return
        if self.admission is not None:
            # before the decode: a rejected frame costs next to nothing
            reason = self.admission.admit(topic, priority)
            if reason is not None:
                self._note_rejection(reason)
                if tid:
                    tracer.emit(tid, "receive", topic=topic, t0=t_recv,
                                dur=time.monotonic() - t_recv, verdict="rejected_" + reason,
                                priority=priority)
                return
        # admitted: the frame ends in exactly one ledger bucket from here
        if fid is not None:
            self._dedup_record(fid)
        self.metrics.incr(mn.FRAMES_ADMITTED)
        if tid:
            tracer.emit(tid, "receive", topic=topic, t0=t_recv, dur=time.monotonic() - t_recv,
                        verdict="admitted", priority=priority)
        if (JPEG_KEY in message and "__frame__" not in message
                and self.ingest is not None and self.ingest.decoder is not None):
            # the decode pool decodes it off this thread; a full queue is a
            # counted drop (without a pool the pixel decode below fails:
            # malformed). A message that also carries a pixel payload (a
            # corrupted delivery) is decoded as pixels below, so it counts
            # malformed before it reaches the pool or a staging slot.
            if not self.ingest.submit_decode(message, priority, tid):
                self.metrics.incr(mn.FRAMES_DROPPED_DECODE)
                self._trace_settle([tid], mn.FRAMES_DROPPED_DECODE, "ingest.decode_backlog")
                self._journal_drop("decode_backlog", self._drop_entries(
                    [meta], None, [tid], "ingest.decode_backlog", priority=priority))
            return
        try:
            frame = (decode_frame(message) if "__frame__" in message
                     else np.asarray(message["frame"]))
        except Exception:  # noqa: BLE001 - any undecodable payload is malformed
            self.metrics.incr(mn.FRAMES_MALFORMED)
            self._trace_settle([tid], mn.FRAMES_MALFORMED, "decode")
            return
        self._intake_frame(frame, meta, priority, tid)

    def _dedup_hit(self, fid) -> bool:
        with self._dedup_lock:
            return fid in self._dedup_seen

    def _dedup_record(self, fid) -> None:
        """Remember an admitted fid; the oldest leave past the window."""
        with self._dedup_lock:
            if fid in self._dedup_seen:
                return
            self._dedup_seen.add(fid)
            self._dedup_order.append(fid)
            while len(self._dedup_order) > self._dedup_window:
                self._dedup_seen.discard(self._dedup_order.popleft())

    def _on_link_ping(self, topic: str, message: Dict[str, Any]) -> None:
        """Echo a router's ping on the pong topic, from the connector's
        thread. A failed echo is the signal: the router's deadline turns
        the silence into a link-down verdict."""
        try:
            pong = dict(message) if isinstance(message, dict) else {}
            if self.replica is not None:
                pong["replica"] = self.replica.name
            self.connector.publish(LINK_PONG_TOPIC, pong)
        except Exception:  # noqa: BLE001 - silence is the verdict
            log.debug("link pong failed", exc_info=True)

    def _intake_frame(self, frame, meta, priority: int, tid: int) -> None:
        """After the decode: the brownout's intake shed, then the batcher."""
        level = self._effective_brownout_level()
        if self._brownout_sheds_intake(priority, level):
            self.metrics.incr(mn.FRAMES_DROPPED_BROWNOUT)
            self._trace_settle([tid], mn.FRAMES_DROPPED_BROWNOUT, "intake.brownout")
            # the effective level (with the SLO boost) is what caused it
            self._journal_drop("brownout", self._drop_entries(
                [meta], None, [tid], "intake.brownout", priority=priority), level=level)
            return
        if not self.batcher.put(frame, meta, priority=priority, trace_id=tid):
            self.metrics.incr(mn.FRAMES_DROPPED)  # the batcher counted its reason

    def _intake_decoded(self, frame, message, priority: int, tid: int) -> None:
        """The decode pool's sink: the decoded frame joins the intake (the
        batcher still checks its shape). An intake failure settles the
        frame as a decode drop here, where the ledger lives."""
        try:
            self._intake_frame(frame, message.get("meta"), priority, tid)
        except Exception:  # noqa: BLE001 - costs this frame, never a decode worker
            log.exception("decoded-frame intake failed; settling as a decode drop")
            self._decode_failed(message, priority, tid, "decode_error")

    def _decode_failed(self, message, priority: int, tid: int, reason: str) -> None:
        """The decode pool's failure sink: one counted drop, one journal
        row, one terminal span."""
        self.metrics.incr(mn.FRAMES_DROPPED_DECODE)
        self._trace_settle([tid], mn.FRAMES_DROPPED_DECODE, "ingest.decode")
        self._journal_drop(reason, self._drop_entries(
            [message.get("meta")], None, [tid], "ingest.decode", priority=priority))

    def _on_control(self, topic: str, message: Dict[str, Any]) -> None:
        cmd = message.get("cmd")
        if cmd == "enroll" and self.replica is not None:
            # the writer owns the WAL: a reader enrolling on its own would
            # fork its gallery from the writer's history for good
            self.metrics.incr(mn.REPLICATION_ENROLL_REJECTED)
            self._publish_status({"status": "rejected", "reason": "read_replica",
                                  "detail": "enrollment is writer-only; route enroll to "
                                            "the writer replica"})
            return
        if cmd == "enroll":
            dur = self._durability
            if dur is not None and dur.degraded:
                # refused at the door: the crops would only fail their
                # WAL append
                self.metrics.incr(mn.ENROLLMENTS_REFUSED_DEGRADED)
                self._publish_status({
                    "status": "rejected", "reason": "durability_degraded",
                    "detail": "enrollment refused: WAL durability is degraded on this "
                              "writer (serving continues; re-arms automatically when the "
                              "probe sees the disk recover)"})
                return
            name = str(message.get("subject", f"subject_{len(self.subject_names)}"))
            count = int(message.get("count", 5))
            with self._enrol_lock:
                self._enrolment = _Enrolment(name, count)
            self.connector.publish(STATUS_TOPIC, {"status": "enrolling", "subject": name,
                                                  "count": count})
        elif cmd == "stats":
            status = {"status": "stats", **self.metrics.summary(), **self.batcher.stats,
                      "degraded": self._degraded, "brownout_level": self._brownout_level,
                      "ledger": self.ledger(), "gallery_size": self.pipeline.gallery.size}
            if self.ingest is not None:
                status["ingest"] = self.ingest.stats()
            if self._cascade_active:
                status["cascade"] = {"threshold": self.cascade_threshold,
                                     "effective_threshold": self._effective_cascade_threshold(),
                                     "scored": self._cascade_scored,
                                     "rejected": self._cascade_rejected}
            if self.tracker is not None:
                status["tracks"] = self.tracker.stats()
            if self.state is not None:
                # the WAL position and the durability monitor's status
                dur = self._durability
                status["durability"] = {"wal_seq": self.state.wal_seq,
                                        "rows_since_checkpoint": self.state.rows_since_checkpoint,
                                        **(dur.status() if dur is not None else {})}
            self.connector.publish(STATUS_TOPIC, status)

    # ---- lifecycle ----

    def start(self, warmup: bool = True) -> None:
        if self._thread is not None:
            return
        if warmup:
            self.warmup()
        self._running = True
        self._crashed = False
        self._loop_progress_t = None
        if self.ingest is not None:
            # decode workers feed the intake the connector thread uses
            self.ingest.start(sink=self._intake_decoded, on_error=self._decode_failed)
        self.connector.start()
        dur = self._durability
        if dur is not None:
            dur.start()
        if self._use_worker:
            self._blocker = _ReadbackBlocker()
            self._worker = threading.Thread(target=self._readback_thread, daemon=True,
                                            name="ocvf-readback")
            self._worker.start()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ocvf-dispatch")
        self._thread.start()

    def warmup(self) -> None:
        """Build every rung of the bucket ladder (on the card, capture each
        as a CUDA graph) and run one enrolment chunk before frames arrive
        (kernel builds, convolution algorithm search)."""
        t0 = time.perf_counter()
        prewarm = getattr(self.pipeline, "prewarm_batch_shapes", None)
        if prewarm is not None:
            prewarm(self._bucket_ladder, self.batcher.frame_shape, self.batcher.dtype)
        else:
            # a pipeline without the helper (``TwoStagePipeline``) runs
            # each rung once
            for bucket in self._bucket_ladder:
                zeros = np.zeros((bucket, *self.batcher.frame_shape), self.batcher.dtype)
                self._start_readback(self.pipeline.recognize_batch_packed(zeros)).result()
        if getattr(self.pipeline, "embed_net", None) is not None:
            self._run_embed_chunk(np.zeros((ENROL_CHUNK, *self.pipeline.face_size),
                                           np.float32))
        self.metrics.observe(mn.WARMUP, time.perf_counter() - t0)
        self._warmed = True

    def drain(self, timeout: float = 120.0) -> bool:
        """Block until every accepted frame has been batched, computed and
        published (or timeout). Call before ``stop()`` at end of stream."""
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while time.monotonic() < deadline:
                # the decode pool first: a worker is busy until its batcher
                # put returned, so once idle no frame is in transit
                if ((self.ingest is None or self.ingest.idle())
                        and self.batcher.pending == 0
                        and self.batcher.delivered_batches == self._completed_batches):
                    return True
                self._inflight_cv.wait(timeout=self._drain_poll_s)
        return False

    def stop(self) -> None:
        """Stop intake and the loop; the readback worker finishes the
        batches already in flight (each bounded by its deadline)."""
        self._running = False
        self._flush_rejections(force=True)
        dur = self._durability
        if dur is not None:
            dur.stop()
        if self.ingest is not None:
            self.ingest.stop()
        self.batcher.close()
        with self._inflight_cv:
            self._inflight_cv.notify_all()
        thread = self._thread
        for t in (thread, self._worker):
            if t is not None:
                t.join(timeout=30.0)
        self._thread = self._worker = None
        if self._blocker is not None:
            self._retire_blocker(self._blocker)
            self._blocker = None
        self._join_blockers()
        if not self._use_worker and (thread is None or not thread.is_alive()):
            self._drain(force=True)
        self.connector.stop()

    # ---- dispatch loop ----

    def _pick_bucket(self, count: int) -> int:
        for b in self._bucket_ladder:
            if count <= b:
                return b
        return self.batcher.batch_size

    @property
    def loop_staleness_s(self) -> float:
        """Seconds since the serving loop's last iteration (the
        loop-liveness SLO's gauge); 0.0 while stopped or before the first."""
        if not self._running or self._loop_progress_t is None:
            return 0.0
        return max(0.0, time.monotonic() - self._loop_progress_t)

    @property
    def loop_crashed(self) -> bool:
        """True when an exception killed the dispatch loop or the readback
        worker (``ServiceSupervisor`` watches it)."""
        return self._crashed

    def restart_pending(self) -> bool:
        """The crash flag is up and a serving thread has exited, so
        ``restart_loop`` would act."""
        if not self._crashed or not self._running:
            return False
        if self._thread is not None and not self._thread.is_alive():
            return True
        return self._use_worker and self._worker is not None and not self._worker.is_alive()

    def restart_loop(self) -> None:
        """Respawn whichever of the dispatch loop and the readback worker
        died (the supervisor's path); every crash path settled its own
        batch first."""
        if not self._running or self._thread is None:
            return
        serve_dead = not self._thread.is_alive()
        worker_dead = (self._use_worker and self._worker is not None
                       and not self._worker.is_alive())
        if not serve_dead and not worker_dead:
            return
        self._crashed = False
        if worker_dead:
            if self._blocker is not None:
                self._retire_blocker(self._blocker)
            self._blocker = _ReadbackBlocker()
            self._worker = threading.Thread(target=self._readback_thread, daemon=True,
                                            name="ocvf-readback")
            self._worker.start()
        if serve_dead:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="ocvf-dispatch")
            self._thread.start()

    def _loop(self) -> None:
        try:
            self._serve_loop()
        except Exception:  # noqa: BLE001 - flag the crash for the supervisor
            log.exception("serving loop crashed")
            self.metrics.incr(mn.LOOP_CRASHES)
            self._crashed = True
            self._publish_status({"status": "crashed"})

    def _serve_loop(self) -> None:
        while self._running:
            batch = self.batcher.get_batch(block=True)
            # after the pop: a loop wedged anywhere below stops refreshing it
            self._loop_progress_t = time.monotonic()
            if self.state is not None:
                # cheap threshold checks; a due checkpoint runs on its own
                # thread, and the monitor's probe only on its own
                try:
                    self.state.tick()
                    dur = self._durability
                    if dur is not None:
                        dur.tick()
                except BaseException:
                    if batch is not None:
                        # the batch never reached _serve_one: settle it here
                        self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, batch.count)
                        self._trace_settle(batch.trace_ids, mn.FRAMES_DROPPED_CRASHED,
                                           "dispatch.crashed")
                        # nothing read the buffer yet: back to the ring
                        self.batcher.recycle(batch.frames)
                        self._mark_completed()
                    raise
            if self.slo is not None:
                # on idle ticks too: recovery is part of the signal
                self.slo.tick()
            if self.replica is not None:
                # the WAL tail between batches; a failed poll costs that
                # poll only (the lag gauges show a replica that stalls)
                try:
                    self.replica.poll()
                except Exception:  # noqa: BLE001 - replication must not kill serving
                    log.exception("read-replica WAL poll failed")
                    self.metrics.incr(mn.REPLICATION_POLL_ERRORS)
            if batch is None:
                # an empty queue waits 0: the EWMA recovers when traffic stops
                self._note_queue_wait(0.0)
                self._flush_rejections()
                if not self._use_worker:
                    self._drain()
                continue
            self._serve_one(batch)
        if not self._use_worker:
            self._drain(force=True)

    def _mark_completed(self) -> None:
        with self._inflight_cv:
            self._completed_batches += 1
            self._inflight_cv.notify_all()

    def _serve_one(self, batch) -> None:
        frames, metas, count = batch.frames, batch.metas, batch.count
        trace_ids = batch.trace_ids
        tracer = self.tracer
        # the batch's trace, the ancestor its traced frames point at
        batch_tid = tracer.new_trace() if tracer is not None and any(trace_ids) else 0
        t0 = time.perf_counter()
        now = time.monotonic()
        for ts, tid in zip(batch.enqueue_ts, trace_ids):
            self.metrics.observe(mn.QUEUE_WAIT, now - ts)
            if tid:
                tracer.emit(tid, "queue_wait", topic=FRAME_TOPIC, t0=ts, dur=now - ts,
                            batch=batch_tid)
        if batch.enqueue_ts:
            self._note_queue_wait(sum(now - ts for ts in batch.enqueue_ts)
                                  / len(batch.enqueue_ts))
        cap = self._brownout_bucket_cap()
        if cap is not None and count > cap:
            # the top level: the newest frames beyond the smallest rung shed
            self.metrics.incr(mn.FRAMES_DROPPED_BROWNOUT, count - cap)
            self._trace_settle(trace_ids[cap:count], mn.FRAMES_DROPPED_BROWNOUT,
                               "dispatch.brownout_trim", batch=batch_tid)
            self._journal_drop("brownout", self._drop_entries(
                metas[cap:count], batch.enqueue_ts[cap:count], trace_ids[cap:count],
                "dispatch.brownout_trim"), level=self._brownout_level)
            count = cap
            batch = batch._replace(count=cap)
        stamp = getattr(getattr(self.pipeline, "gallery", None), "embedder_version", None)
        stamp = None if stamp is None else int(stamp)
        accounted = False
        try:
            if count and self.tracker is not None:
                batch, cached = self._split_cached(batch, self._model_stamp(stamp))
                # the cached frames leave this batch before they settle, so a
                # crash while they publish settles each frame once
                metas, count, trace_ids = batch.metas, batch.count, batch.trace_ids
                if cached:
                    if batch_tid:
                        tracer.emit(batch_tid, "track_cache", topic=tracing.BATCH_TOPIC,
                                    frames=count + len(cached), hits=len(cached))
                    self._complete_cached(cached, batch_tid)
                if not count:
                    # every frame answered from the cache: no device work
                    self.metrics.incr(mn.TRACK_BATCH_EXITS)
                    if batch_tid:
                        tracer.emit(batch_tid, "dispatch", topic=tracing.BATCH_TOPIC,
                                    dur=time.perf_counter() - t0, bucket=0, frames=0,
                                    exit="track_cache", brownout=self._brownout_level)
                    accounted = True
                    self._mark_completed()
                    self.batcher.recycle(frames)
                    self.batcher.report_service_time(time.perf_counter() - t0)
                    return
            stage1_version = None
            if count and self._cascade_active:
                keep = self._cascade_keep_mask(frames, count, batch_tid)
                if keep is not None:
                    stage1_version = (getattr(self.pipeline, "last_cascade_info", None)
                                      or {}).get("version")
                if keep is not None and not keep.all():
                    batch, rejected = self._split_rejected(batch, keep)
                    # the rejected frames leave this batch before they
                    # settle, so a crash while they publish settles each once
                    metas, count, trace_ids = batch.metas, batch.count, batch.trace_ids
                    self._complete_empty(rejected, batch_tid)
                    if not count:
                        # no survivor: the whole batch exits at stage 1; the
                        # scores' readback waited for the buffer's copy
                        self.metrics.incr(mn.CASCADE_BATCH_EXITS)
                        if batch_tid:
                            tracer.emit(batch_tid, "dispatch", topic=tracing.BATCH_TOPIC,
                                        dur=time.perf_counter() - t0, bucket=0, frames=0,
                                        exit="cascade", brownout=self._brownout_level)
                        accounted = True
                        self._mark_completed()
                        self.batcher.recycle(frames)
                        self.batcher.report_service_time(time.perf_counter() - t0)
                        return
            bucket = self._pick_bucket(count)
            if batch_tid and self.ingest is not None:
                # which staging rung carried the batch (rung >= bucket)
                tracer.emit(batch_tid, "stage", topic=tracing.BATCH_TOPIC, rung=len(frames),
                            bucket=bucket, frames=count)
            readback = self._dispatch_with_retry(frames[:bucket], batch_tid)
            if readback is None:
                # retries spent or a permanent error: the batch is abandoned
                self.metrics.incr(mn.FRAMES_FAILED, count)
                self._trace_settle(trace_ids[:count], mn.FRAMES_FAILED, "dispatch.abandoned",
                                   batch=batch_tid)
                self._journal_drop("failed", self._drop_entries(
                    metas[:count], batch.enqueue_ts[:count], trace_ids[:count],
                    "dispatch.abandoned"))
                accounted = True
                self._mark_completed()
                if self.ingest is not None:
                    # an attempt's upload may still be reading the buffer
                    self.batcher.forfeit(frames)
                else:
                    self.batcher.recycle(frames)
                return
            t_disp = time.perf_counter()
            self.metrics.observe(mn.DISPATCH, t_disp - t0)
            # dispatch provenance: a step cache miss after warmup captured
            # (or re-captured) on the serving thread; the snapshot the step
            # matched against stamps the results
            info = getattr(self.pipeline, "last_dispatch_info", None) or {}
            snapshot = getattr(self.pipeline, "last_snapshot", None)
            if snapshot is not None:
                stamp = int(snapshot.embedder_version)
            ran = dict(getattr(self.pipeline, "last_model_versions", None) or {})
            if stage1_version is not None:
                ran["cascade"] = stage1_version
            stamp = self._model_stamp(stamp, ran)
            deadline = time.monotonic() + self.resilience.readback_deadline_s
            with self._inflight_cv:
                self._inflight.append(_Inflight(readback, frames, metas, count,
                                                batch.enqueue_ts, t0, t_disp, deadline,
                                                stamp, trace_ids, batch_tid,
                                                batch.priorities, snapshot))
                accounted = True
                self._inflight_cv.notify_all()
        except BaseException:
            if not accounted:
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, count)
                self._trace_settle(trace_ids[:count], mn.FRAMES_DROPPED_CRASHED,
                                   "dispatch.crashed", batch=batch_tid)
                # a copy of the buffer may still be pending: never recycled
                self.batcher.forfeit(frames)
                self._mark_completed()
            raise
        self.metrics.incr(mn.BATCHES_DISPATCHED)
        self.metrics.incr(mn.FRAMES_PROCESSED, count)
        if batch_tid:
            tracer.emit(batch_tid, "dispatch", topic=tracing.BATCH_TOPIC, dur=t_disp - t0,
                        bucket=bucket, frames=count, cache_hit=info.get("cache_hit"),
                        mode=info.get("mode"), exit="full", brownout=self._brownout_level)
        if self._warmed and info.get("cache_hit") is False:
            self._note_recompile(bucket, count, info.get("mode"))
        if bucket < self.batcher.batch_size:
            self.metrics.incr(mn.BATCHES_BUCKETED)
        if self._use_worker:
            with self._inflight_cv:
                while self._running and len(self._inflight) > self.inflight_depth:
                    self._inflight_cv.wait(timeout=self._drain_poll_s)
        else:
            self._drain()

    def _dispatch_with_retry(self, frames, batch_tid: int = 0) -> Optional[_Readback]:
        """One batch through the device under the resilience policy; the
        readback of its packed output, or None when abandoned. With the
        ingest, every attempt uploads the host staging view again."""
        policy = self.resilience
        attempt = 0
        while True:
            try:
                send = frames
                if self.ingest is not None:
                    send, up_bytes, up_dur = self.ingest.upload(frames)
                    if batch_tid:
                        self.tracer.emit(batch_tid, "upload", topic=tracing.BATCH_TOPIC,
                                         dur=up_dur, bytes=up_bytes, dtype=str(frames.dtype))
                if self._faults is not None:
                    self._faults.on_dispatch()
                readback = self._start_readback(self.pipeline.recognize_batch_packed(send))
            except Exception as exc:  # noqa: BLE001 - classified below
                self.metrics.incr(mn.DISPATCH_FAILURES)
                self._consecutive_dispatch_failures += 1
                if (self._consecutive_dispatch_failures >= policy.degraded_after
                        and not self._degraded):
                    self._enter_degraded(exc)
                transient = is_transient_error(exc)
                if not transient or attempt >= policy.dispatch_retries:
                    log.exception("recognition batch abandoned (%s, attempt %d)",
                                  "transient" if transient else "permanent", attempt)
                    self.metrics.incr(mn.BATCHES_FAILED)
                    return None
                self.metrics.incr(mn.DISPATCH_RETRIES)
                self._backoff_wait(policy.backoff(attempt))
                attempt += 1
                if not self._running:
                    self.metrics.incr(mn.BATCHES_FAILED)
                    return None
                continue
            self._consecutive_dispatch_failures = 0
            if self._degraded:
                self._exit_degraded()
            if self._faults is not None:
                # the readback boundary: the batch's readback may never land
                # (stuck) or land late (slow)
                readback = self._faults.on_readback(readback)
            return readback

    def _start_readback(self, packed) -> _Readback:
        if not isinstance(packed, torch.Tensor) and hasattr(packed, "result"):
            return packed  # already a readback (a scripted pipeline's)
        return _Readback(packed)

    def _backoff_wait(self, seconds: float) -> None:
        """Sleep in slices, bailing out on stop(); the fallback path keeps
        draining finished batches meanwhile."""
        deadline = time.monotonic() + seconds
        while self._running and time.monotonic() < deadline:
            if not self._use_worker:
                self._drain()
            time.sleep(min(0.01, max(0.0, deadline - time.monotonic())))

    # ---- degraded mode ----

    def _enter_degraded(self, exc: BaseException) -> None:
        self._degraded = True
        self.metrics.incr(mn.DEGRADED_TRANSITIONS)
        status = {"status": "degraded",
                  "consecutive_failures": self._consecutive_dispatch_failures,
                  "error": repr(exc)}
        if self.resilience.probe_backend_on_degraded:
            usable, reason = self._probe_backend()
            status["backend_usable"] = usable
            status["backend_reason"] = reason
            if not usable:
                # the reference's state for a CPU fallback that did not
                # happen: the port has none (ROADMAP C), it stays degraded
                status["cpu_fallback"] = False
        self._publish_status(status)

    def _probe_backend(self) -> tuple:
        """Bounded verdict on the card: the injected fn, else the
        subprocess probe."""
        if self._backend_probe_fn is not None:
            return self._backend_probe_fn()
        from opencv_facerecognizer_tpu_torch.utils.backend_probe import probe_for_recovery

        return probe_for_recovery()

    def _exit_degraded(self) -> None:
        self._degraded = False
        self.metrics.incr(mn.DEGRADED_RECOVERIES)
        self._publish_status({"status": "recovered"})

    def _publish_status(self, status: Dict[str, Any]) -> None:
        """A raising status consumer costs a log line, never the loop."""
        try:
            self.connector.publish(STATUS_TOPIC, status)
        except Exception:  # noqa: BLE001 - the transport or a subscriber failed
            log.exception("status publish failed")

    def _dead_letter(self, entry: _Inflight) -> None:
        """Abandon a batch whose readback missed its deadline (or failed):
        counted, completed, announced with the frames' metas and enqueue
        times so producers can resend, and journaled. A dead-letter dumps
        the flight recorder; the dump's path rides the journal record.
        Its staging buffer is forfeited, not recycled: the copy of it to
        the card may still be pending."""
        self.batcher.forfeit(entry.frames)
        count = entry.count
        self.metrics.incr(mn.BATCHES_DEAD_LETTERED)
        self.metrics.incr(mn.FRAMES_DEAD_LETTERED, count)
        self._mark_completed()
        # every list sliced to count: metas is padded, and a trimmed
        # batch's lists still hold its settled frames
        trace_ids = list(entry.trace_ids[:count])
        self._trace_settle(trace_ids, mn.FRAMES_DEAD_LETTERED, "readback.dead_letter",
                           batch=entry.batch_tid)
        dump = None
        if self.tracer is not None:
            if entry.batch_tid:
                self.tracer.emit(entry.batch_tid, "dead_letter", topic=tracing.BATCH_TOPIC,
                                 frames=count)
            dump = self.tracer.dump("dead_letter", extra={"frames": count,
                                                          "ledger": self.ledger()})
        entries = self._drop_entries(list(entry.metas[:count]), entry.enqueue_ts[:count],
                                     trace_ids, "readback.dead_letter")
        self._journal_drop("dead_letter", entries, **({"dump": dump} if dump else {}))
        self._publish_status({"status": "dead_letter", "frames": count,
                              "frame_ids": [e["meta"] for e in entries],
                              "enqueued_at": [e["enqueue_ts"] for e in entries]})

    # ---- identity cache ----

    @staticmethod
    def _track_stream_key(meta):
        """A frame's tracking scope: ``meta["stream"]``, else ``meta["topic"]``;
        None (untracked) otherwise."""
        if isinstance(meta, dict):
            key = meta.get("stream")
            return meta.get("topic") if key is None else key
        return None

    def _split_cached(self, batch, stamp):
        """The frames the tracker can answer, and the batch of the others,
        compacted to the front of the staging buffer: (batch, cached)."""
        frames, metas = batch.frames, batch.metas
        cached, keep = [], []
        for i in range(batch.count):
            hit = None
            key = self._track_stream_key(metas[i])
            if key is not None:
                try:
                    hit = self.tracker.lookup(key, frames[i], embedder_version=stamp)
                except Exception:  # noqa: BLE001 - fail open to the full path
                    log.exception("tracker lookup failed")
                    self.metrics.incr(mn.TRACK_ERRORS)
            if hit is None:
                keep.append(i)
            else:
                cached.append((metas[i], batch.enqueue_ts[i], batch.trace_ids[i],
                               batch.priorities[i], hit))
        if not cached:
            return batch, cached
        return self._compact(batch, keep), cached

    @staticmethod
    def _compact(batch, keep):
        """The batch of the frames at indices ``keep`` (ascending), moved to
        the front of its staging buffer in place (the fancy-index gather
        copies them out before the front rows are written)."""
        frames, metas = batch.frames, batch.metas
        kept = len(keep)
        if kept:
            frames[:kept] = frames[np.asarray(keep, dtype=np.intp)]
        return batch._replace(metas=[metas[i] for i in keep] + [None] * (len(metas) - kept),
                              count=kept, enqueue_ts=[batch.enqueue_ts[i] for i in keep],
                              trace_ids=[batch.trace_ids[i] for i in keep],
                              priorities=[batch.priorities[i] for i in keep])

    # ---- the cascade's stage-1 gate ----

    def _effective_cascade_threshold(self) -> float:
        """The stage-1 threshold, one notch higher (at most 0.99) from
        brownout level 1 up, the SLO boost included: rejecting borderline
        frames at stage 1 is the cheapest shed."""
        thr = self.cascade_threshold
        if (self.brownout_policy is not None and self.cascade_brownout_notch
                and self._effective_brownout_level() >= 1):
            thr = min(0.99, thr + self.cascade_brownout_notch)
        return thr

    def _cascade_keep_mask(self, frames, count: int, batch_tid: int) -> Optional[np.ndarray]:
        """One stage-1 pass over the batch at its rung: the keep mask of the
        first ``count`` frames, or None when the pass failed (the batch
        fails open to the full step, ``cascade_errors``). The ``[B]``
        readback is the decision point; its host seconds, readback
        included, go to the ``cascade_score`` window. The pass copies the
        staging buffer to the card on the serving stream, so once the
        readback returned the host may write the buffer."""
        thr = self._effective_cascade_threshold()
        t0 = time.perf_counter()
        bucket = self._pick_bucket(count)
        try:
            scores = self.pipeline.cascade_scores(frames[:bucket])
            if isinstance(scores, torch.Tensor):
                scores = scores.cpu()  # the designed decision readback
        except Exception:  # noqa: BLE001 - fail open: the full step serves the batch
            log.exception("cascade stage-1 scoring failed; serving the full batch")
            self.metrics.incr(mn.CASCADE_ERRORS)
            return None
        dur = time.perf_counter() - t0
        self.metrics.observe(mn.CASCADE_SCORE, dur)
        info = getattr(self.pipeline, "last_cascade_info", None) or {}
        if self._warmed and info.get("cache_hit") is False:
            self._note_recompile(bucket, count, "cascade")
        keep = np.asarray(scores)[:count] >= thr
        if self._faults is not None:
            keep = self._faults.on_cascade(keep)
        rejected = count - int(keep.sum())
        self._cascade_scored += count
        self._cascade_rejected += rejected
        self.metrics.incr(mn.CASCADE_FRAMES_SCORED, count)
        reject_rate = self._cascade_rejected / max(1, self._cascade_scored)
        self.metrics.set_gauge(mn.CASCADE_REJECT_RATE, reject_rate)
        self.metrics.set_gauge(mn.CASCADE_PASS_RATE, 1.0 - reject_rate)
        self.metrics.set_gauge(mn.CASCADE_THRESHOLD, thr)
        if batch_tid:
            self.tracer.emit(batch_tid, "cascade", topic=tracing.BATCH_TOPIC, dur=dur,
                             frames=count, rejected=rejected, threshold=round(thr, 4))
        return keep

    def _split_rejected(self, batch, keep: np.ndarray):
        """(the batch of the survivors, compacted, and the rejected rows
        ``(meta, enqueue_ts, trace_id, priority)``)."""
        rejected = [(batch.metas[i], batch.enqueue_ts[i], batch.trace_ids[i],
                     batch.priorities[i]) for i in np.flatnonzero(~keep)]
        return self._compact(batch, [int(i) for i in np.flatnonzero(keep)]), rejected

    def _complete_empty(self, rejected, batch_tid: int = 0) -> None:
        """Settle stage-1 rejects as ``completed_empty``: each publishes an
        empty result (``exit: "cascade"``) and is a miss for its stream's
        tracks; a crash mid-run settles the rest as crashed drops."""
        if self.tracker is not None:
            for meta, _ts, _tid, _pri in rejected:
                key = self._track_stream_key(meta)
                if key is not None:
                    try:
                        self.tracker.note_miss(key)
                    except Exception:  # noqa: BLE001 - the cache only: fail open
                        log.exception("tracker note_miss failed")
                        self.metrics.incr(mn.TRACK_ERRORS)
        published = 0
        try:
            for meta, _ts, _tid, _pri in rejected:
                self.connector.publish(RESULT_TOPIC, {"meta": meta, "faces": [],
                                                      "exit": "cascade"})
                published += 1
        finally:
            self.metrics.incr(mn.FRAMES_COMPLETED_EMPTY, published)
            self._trace_settle([r[2] for r in rejected[:published]],
                               tracing.OUTCOME_COMPLETED_EMPTY, "cascade.reject",
                               batch=batch_tid)
            if published < len(rejected):
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, len(rejected) - published)
                self._trace_settle([r[2] for r in rejected[published:]],
                                   mn.FRAMES_DROPPED_CRASHED, "cascade.publish_crashed",
                                   batch=batch_tid)
            now = time.monotonic()
            for _meta, ts, _tid, pri in rejected[:published]:
                if ts is not None:
                    self._observe_e2e(ts, pri, now)

    # ---- model stamps ----

    def _model_stamp(self, gallery_ver, ran: Optional[Dict[str, int]] = None):
        """What results and the identity cache are stamped with: the
        embedder version alone without a registry, else the sorted
        ``(role, version)`` pairs of every role, the embedder's from
        ``gallery_ver`` and those in ``ran`` (what the batch's passes
        recorded running) over the manifest's."""
        reg = self.registry
        if reg is None:
            return gallery_ver
        stamp = reg.stamp()
        for role, version in (ran or {}).items():
            if role in stamp and version is not None:
                stamp[role] = int(version)
        if gallery_ver is not None:
            stamp["embedder"] = int(gallery_ver)
        return tuple(sorted(stamp.items()))

    @staticmethod
    def _stamp_fields(stamp):
        """(``embedder_version``, the ``registry`` dict or None) of a stamp."""
        if isinstance(stamp, tuple):
            roles = {str(k): int(v) for k, v in stamp}
            return roles.get("embedder"), roles
        return stamp, None

    def flush_model_caches(self, stamp=None, reason: str = "registry") -> int:
        """A registry cutover's eager cache flush (its ``flush_fn``): every
        identity-cache verdict came from the old model set. Returns the
        tracks flushed."""
        del stamp  # the flush is total; the stamp is provenance only
        flushed = 0
        if self.tracker is not None:
            try:
                flushed = self.tracker.flush_all(reason=reason)
            except Exception:  # noqa: BLE001 - the cache only: fail open
                log.exception("tracker flush on a registry cutover failed")
                self.metrics.incr(mn.TRACK_ERRORS)
        self.metrics.incr(mn.REGISTRY_CACHE_FLUSHES)
        return flushed

    def _complete_cached(self, cached, batch_tid: int = 0) -> None:
        """Publish each cache hit's identities (``exit: track_cache``)."""
        published = 0
        try:
            for meta, _ts, _tid, _pri, hit in cached:
                payload = {"meta": meta, "faces": hit["faces"], "exit": "track_cache",
                           "track_id": hit["track_id"]}
                emb_ver, roles = self._stamp_fields(hit.get("embedder_version"))
                if emb_ver is not None:
                    payload["embedder_version"] = emb_ver
                if roles is not None:
                    payload["registry"] = roles
                self.connector.publish(RESULT_TOPIC, payload)
                published += 1
                self.metrics.incr(mn.FACES_FOUND, len(hit["faces"]))
        finally:
            self.metrics.incr(mn.FRAMES_COMPLETED_CACHED, published)
            self._trace_settle([r[2] for r in cached[:published]],
                               tracing.OUTCOME_COMPLETED_CACHED, "track_cache.hit",
                               batch=batch_tid)
            if published < len(cached):
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, len(cached) - published)
                self._trace_settle([r[2] for r in cached[published:]],
                                   mn.FRAMES_DROPPED_CRASHED, "track_cache.publish_crashed",
                                   batch=batch_tid)
            now = time.monotonic()
            for _meta, ts, _tid, pri, _hit in cached[:published]:
                self._observe_e2e(ts, pri, now)

    # ---- readback ----

    @staticmethod
    def _is_ready(readback) -> bool:
        """Non-blocking readiness; a raising query reports ready, so that
        ``result()`` surfaces the error where it is dead-lettered."""
        try:
            return bool(readback.ready())
        except Exception:  # noqa: BLE001 - deferred to result()
            return True

    def _readback_thread(self) -> None:
        try:
            self._readback_loop()
        except Exception:  # noqa: BLE001 - flag the crash for the supervisor
            log.exception("readback worker crashed")
            self.metrics.incr(mn.LOOP_CRASHES)
            self._crashed = True
            self._publish_status({"status": "crashed"})

    def _readback_loop(self) -> None:
        """Wait for each in-flight batch in dispatch order (bounded by its
        deadline), then publish. Runs until stopped and the queue is empty."""
        while True:
            with self._inflight_cv:
                while self._running and not self._inflight:
                    self._inflight_cv.wait(timeout=self._drain_poll_s)
                if not self._inflight:
                    return
                entry = self._inflight[0]
            try:
                ready = self._await_ready(entry.readback, entry.deadline)
            except Exception:  # noqa: BLE001 - an outage at the readback costs this batch
                log.exception("readback wait failed")
                self.metrics.incr(mn.READBACK_ERRORS)
                ready = False
            with self._inflight_cv:
                self._inflight.popleft()
                self._inflight_cv.notify_all()
            if not ready:
                self._dead_letter(entry)
                continue
            self._complete_head(entry)

    def _await_ready(self, readback, deadline: float) -> bool:
        """Wait for one batch's copy until ``deadline``; False if it missed."""
        if not readback.pending:
            return True
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return self._is_ready(readback)
        blocker = self._blocker or _ReadbackBlocker()
        self._blocker = blocker
        outcome = blocker.block(readback, remaining)
        if outcome == "ready":
            return True
        if outcome == "timeout":
            # the old one may be stuck in the wait: it exits when that
            # returns, and ``stop`` joins it
            self._retire_blocker(blocker)
            self._blocker = _ReadbackBlocker()
            # a starved blocker may not have reported a readback that landed
            # in time: only one still not ready is dead-lettered
            return self._is_ready(readback)
        # "raised": poll until the deadline; a failed computation reports
        # ready and raises again in result()
        while self._running and time.monotonic() < deadline:
            if self._is_ready(readback):
                return True
            time.sleep(self._readback_poll_s)
        return self._is_ready(readback)

    def _retire_blocker(self, blocker: _ReadbackBlocker) -> None:
        blocker.close()
        with self._inflight_cv:
            self._retired_blockers.append(blocker)

    def _join_blockers(self) -> None:
        """Join every closed blocker, all within one readback deadline
        (ROADMAP C.28): a wait that returns in that time leaves no thread
        behind ``stop``. One still inside a wait past it (a CUDA call
        cannot be cancelled) stays listed, and a later ``stop`` tries it
        again."""
        with self._inflight_cv:
            blockers, self._retired_blockers = self._retired_blockers, []
        bound = time.monotonic() + self.resilience.readback_deadline_s
        stuck = [b for b in blockers if not b.join(bound - time.monotonic())]
        if stuck:
            log.warning("%d readback blocker(s) still inside a wait after stop", len(stuck))
            with self._inflight_cv:
                self._retired_blockers.extend(stuck)

    def _drain(self, force: bool = False) -> None:
        """Inline fallback (``readback_worker=False``): publish finished head
        batches; dead-letter a head past its deadline; over depth (or
        forced) poll the head until ready or its deadline."""
        while self._inflight:
            entry = self._inflight[0]
            ready = self._is_ready(entry.readback)
            if not ready:
                if time.monotonic() < entry.deadline and not (
                        force or len(self._inflight) > self.inflight_depth):
                    break
                while not ready and time.monotonic() < entry.deadline:
                    time.sleep(self._readback_poll_s)
                    ready = self._is_ready(entry.readback)
            with self._inflight_cv:
                self._inflight.popleft()
                self._inflight_cv.notify_all()
            if not ready:
                self._dead_letter(entry)
                continue
            self._complete_head(entry)

    def _complete_head(self, entry: _Inflight) -> None:
        """Materialize and publish one popped batch and settle it."""
        try:
            packed = entry.readback.result()
        except Exception:  # noqa: BLE001 - a device error carried by the result
            log.exception("readback materialize failed")
            self.metrics.incr(mn.READBACK_ERRORS)
            self._dead_letter(entry)
            return
        # the existing wait, from dispatch to the result on the host
        ready_dur = time.perf_counter() - entry.t_disp
        self.metrics.observe(mn.READY_WAIT, ready_dur)
        if entry.batch_tid:
            self.tracer.emit(entry.batch_tid, "ready_wait", topic=tracing.BATCH_TOPIC,
                             dur=ready_dur, frames=entry.count)
        t_pub = time.perf_counter()
        try:
            self._publish(packed, entry.frames, entry.metas, entry.count, entry.stamp,
                          entry.trace_ids, entry.batch_tid)
        except BaseException:
            self._mark_completed()
            self.batcher.recycle(entry.frames)
            raise
        self._mark_completed()
        now = time.perf_counter()
        if entry.batch_tid:
            self.tracer.emit(entry.batch_tid, "publish", topic=tracing.BATCH_TOPIC,
                             dur=now - t_pub, frames=entry.count)
        self.metrics.observe(mn.PUBLISH, now - t_pub)
        self.metrics.observe(mn.BATCH_LATENCY, now - entry.t0)
        mono = time.monotonic()
        for ts, pri in zip(entry.enqueue_ts[:entry.count], entry.priorities[:entry.count]):
            self._observe_e2e(ts, pri, mono)
        self.batcher.report_service_time(now - entry.t0)
        self.batcher.recycle(entry.frames)

    def _publish(self, packed: np.ndarray, frames, metas, count: int,
                 stamp=None, trace_ids=(), batch_tid: int = 0) -> None:
        """One result message per real frame: ``{"meta", "faces": [{"box"
        (x0, y0, x1, y1), "detection_score", "label", "name",
        "similarity"}], "embedder_version", "registry"}``, the reference's
        schema (``registry`` with a registry attached)."""
        result = unpack_result(packed, self.pipeline.top_k)
        rollout = self.rollout
        registry_swap = self.registry_swap
        emb_ver, roles = self._stamp_fields(stamp)
        published = 0
        try:
            for i in range(count):
                faces = []
                for j in range(result.boxes.shape[1]):
                    if not result.valid[i, j]:
                        continue
                    sim = float(result.similarities[i, j, 0])
                    label = int(result.labels[i, j, 0])
                    known = sim >= self.similarity_threshold and label >= 0
                    name = (self.subject_names[label]
                            if known and label < len(self.subject_names)
                            else ("unknown" if not known else str(label)))
                    y0, x0, y1, x1 = (float(v) for v in result.boxes[i, j])
                    faces.append({
                        "box": [x0, y0, x1, y1],  # x-first, like the reference API
                        "detection_score": float(result.det_scores[i, j]),
                        "label": label if known else -1,
                        "name": name,
                        "similarity": sim,
                    })
                self._maybe_collect_enrolment(frames[i], faces)
                payload = {"meta": metas[i], "faces": faces}
                if emb_ver is not None:
                    payload["embedder_version"] = emb_ver
                if roles is not None:
                    payload["registry"] = roles
                self.connector.publish(RESULT_TOPIC, payload)
                published += 1
                self.metrics.incr(mn.FACES_FOUND, len(faces))
                key = self._track_stream_key(metas[i])
                if self.tracker is not None and key is not None:
                    try:
                        self.tracker.update(key, faces, frames[i], embedder_version=stamp)
                    except Exception:  # noqa: BLE001 - the cache only: fail open
                        log.exception("tracker update failed")
                        self.metrics.incr(mn.TRACK_ERRORS)
                if rollout is not None and faces:
                    # live dual-score parity (rate-limited and copied inside,
                    # scored on the rollout thread): observation only
                    try:
                        rollout.offer_live(frames[i], faces)
                    except Exception:  # noqa: BLE001 - costs a counter, never the publish
                        log.exception("rollout live-parity offer failed")
                        self.metrics.incr(mn.ROLLOUT_OBSERVE_ERRORS)
                if registry_swap is not None:
                    # detection parity on whole frames (face-free ones too)
                    # with the serving detector's boxes: observation only
                    try:
                        registry_swap.offer_live(frames[i], faces)
                    except Exception:  # noqa: BLE001 - costs a counter, never the publish
                        log.exception("registry live-parity offer failed")
                        self.metrics.incr(mn.REGISTRY_OBSERVE_ERRORS)
        finally:
            # settled here, whatever exits; the spans mirror the split
            self.metrics.incr(mn.FRAMES_COMPLETED, published)
            self._trace_settle(trace_ids[:published], tracing.OUTCOME_COMPLETED, "publish",
                               batch=batch_tid)
            if published < count:
                self.metrics.incr(mn.FRAMES_DROPPED_CRASHED, count - published)
                self._trace_settle(trace_ids[published:count], mn.FRAMES_DROPPED_CRASHED,
                                   "publish.crashed", batch=batch_tid)

    # ---- enrolment ----

    def _run_embed_chunk(self, crops: np.ndarray) -> np.ndarray:
        """One fixed-size chunk of face crops [ENROL_CHUNK, h, w] -> unit
        embeddings, on the pipeline's device (the unfused embedder, as
        the reference's enrolment graph)."""
        pipeline = self.pipeline
        with torch.no_grad():
            x = torch.as_tensor(crops, dtype=torch.float32, device=pipeline.device)
            emb = pipeline.embed_net(normalize_faces(x, pipeline.face_size))
        return emb.float().cpu().numpy()

    def _maybe_collect_enrolment(self, frame: np.ndarray, faces: List[dict]) -> None:
        with self._enrol_lock:
            enrolment = self._enrolment
        if enrolment is None or not faces:
            return
        best = max(faces, key=lambda f: f["detection_score"])
        x0, y0, x1, y1 = (int(round(v)) for v in best["box"])
        h, w = frame.shape
        y0, y1 = max(0, y0), min(h, y1)
        x0, x1 = max(0, x0), min(w, x1)
        if y1 - y0 < 4 or x1 - x0 < 4:
            return
        # a copy: the frame's staging buffer is reused once the batch completes
        enrolment.crops.append(frame[y0:y1, x0:x1].copy())
        if len(enrolment.crops) >= enrolment.needed:
            with self._enrol_lock:
                self._enrolment = None
            threading.Thread(target=self._finish_enrolment, args=(enrolment,),
                             daemon=True, name="ocvf-enrol").start()

    def _finish_enrolment(self, enrolment: _Enrolment) -> None:
        """Embed the crops, add them to the gallery, publish ``enrolled``;
        off the serving threads."""
        face_size = self.pipeline.face_size
        # the embedder version these crops are embedded by: the state store
        # refuses them if a cutover changed the gallery's meanwhile
        enrol_version = getattr(self.pipeline.gallery, "embedder_version", None)
        crops = np.stack([image_ops.resize(torch.as_tensor(c, dtype=torch.float32),
                                           face_size).numpy() for c in enrolment.crops])
        embeddings = []
        for start in range(0, len(crops), ENROL_CHUNK):
            part = crops[start:start + ENROL_CHUNK]
            padded = np.zeros((ENROL_CHUNK, *face_size), np.float32)
            padded[:len(part)] = part
            embeddings.append(self._run_embed_chunk(padded)[:len(part)])
        emb = np.concatenate(embeddings)
        with self._enrol_lock:
            if enrolment.subject_name in self.subject_names:
                label = self.subject_names.index(enrolment.subject_name)
            else:
                label = len(self.subject_names)
                self.subject_names.append(enrolment.subject_name)
        gallery = self.pipeline.gallery
        before_grow = gallery.grow_count
        labels = np.full(len(emb), label, np.int32)
        try:
            if self.state is not None:
                # write-ahead: the WAL record (fsynced per policy) lands
                # before the rows, so ``enrolled`` below promises they
                # survive a crash; a failed append raises
                self.state.append_enrollment(emb, labels, subject=enrolment.subject_name,
                                             label=label,
                                             apply_fn=lambda: gallery.add(emb, labels),
                                             embedder_version=enrol_version)
            else:
                gallery.add(emb, labels)
        except Exception as exc:
            # the gallery holds no rows for a name reserved above: drop it
            with self._enrol_lock:
                if (label == len(self.subject_names) - 1
                        and self.subject_names[label] == enrolment.subject_name):
                    self.subject_names.pop()
            if isinstance(exc, (DurabilityDegradedError, OSError)):
                # refused closed, never acknowledged
                log.warning("enrollment %r refused closed: %r", enrolment.subject_name, exc)
                self._publish_status({
                    "status": "enroll_failed", "subject": enrolment.subject_name,
                    "reason": ("durability_degraded"
                               if isinstance(exc, DurabilityDegradedError) else "wal_error"),
                    "error": repr(exc)})
                return
            raise
        if gallery.grow_count > before_grow:
            self.metrics.incr(mn.GALLERY_GROWN, gallery.grow_count - before_grow)
        self.metrics.incr(mn.SUBJECTS_ENROLLED)
        self.connector.publish(STATUS_TOPIC, {"status": "enrolled",
                                              "subject": enrolment.subject_name,
                                              "label": label,
                                              "gallery_size": gallery.size})
        self._run_commit_hooks()

    # ---- reload without drop ----

    def reload_gallery(self, new_gallery) -> None:
        """Swap in a rebuilt gallery between batches (``swap_from``); the
        identity cache starts cold, and with a state store a forced
        checkpoint makes the swap durable (until it lands, a crash
        recovers the previous gallery plus every acknowledged
        enrolment)."""
        self.pipeline.gallery.swap_from(new_gallery)
        if self.tracker is not None:
            self.tracker.flush_all()
        self.connector.publish(STATUS_TOPIC, {"status": "reloaded",
                                              "gallery_size": self.pipeline.gallery.size})
        self._run_commit_hooks()
        if self.state is not None:
            self.state.maybe_checkpoint(force=True)

    def _run_commit_hooks(self) -> None:
        """A raising hook costs a log line, never the enrolment or reload."""
        for hook in list(self.commit_hooks):
            try:
                hook()
            except Exception:  # noqa: BLE001 - watcher bugs stay theirs
                log.exception("commit hook failed")
