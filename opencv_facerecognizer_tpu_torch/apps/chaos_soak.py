"""Chaos soak: the serving loop under seeded, logged fault injection; exits
nonzero on a wedge, a crash or broken accounting. Port of
``scripts/chaos_soak.py``.

``run_soak`` builds a serving stack (``build_stack``: the reference's tiny
untrained nets and gallery, on ``device``; or a prebuilt pipeline), arms a
``FaultInjector`` at the receive, put, dispatch and readback boundaries
with rates drawn from the logged seed, wraps the service in a
``ServiceSupervisor`` and offers frames for ``seconds``. The same seed
replays the same fault sequence. It passes when:

1. **no wedge**: after the chaos window the injector is disarmed and a
   probe burst of clean frames all come back within a bounded wait;
2. **no unsupervised crash**: ``loop_crashes`` equals
   ``supervisor_restarts`` and the supervisor never gave up;
3. **accounting**: the batcher's delivered batches equal dispatched plus
   failed, the admission ledger's ``in_system`` is 0 at quiescence, and
   the flight dumps parse with their settle spans matching the ledger.

The other eight scenarios run on the deterministic fakes
(``runtime.fakes``), as in the reference, and launch nothing on a card:
``overload`` (a seeded ``receive: flood`` against the admission, brownout
and journal stack), ``recovery`` (kills at every durability boundary),
``replication`` (a writer and two WAL-tailing readers behind the topic
router), ``rollout`` (a live embedder rollout), ``registry`` (model
registry swaps), ``disk`` (a disk that stays broken), ``partition`` (the
network fails) and ``video`` (the identity cache under attack). Their pass
criteria and report keys are the reference's.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.chaos_soak --seconds 30
    python -m opencv_facerecognizer_tpu_torch.apps.chaos_soak --seconds 30 --seed 7
    python -m opencv_facerecognizer_tpu_torch.apps.chaos_soak --scenario overload \
        --seconds 6 --device cpu

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the soak's stack on the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time

#: the checkout's root (the split-brain probe's child process runs there)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check_flight_dumps(trace_dir: str, failures: list,
                        require: int = 1) -> list:
    """Every scenario must leave at least ``require`` flight-recorder
    dumps that parse as JSON with a span map — the observability
    acceptance: after an induced crash/wedge/dead-letter there is always
    evidence of what was in flight. Returns the dump paths."""
    dumps = sorted(glob.glob(os.path.join(trace_dir, "flight-*.json")))
    parsed = 0
    for path in dumps:
        try:
            with open(path) as fh:
                record = json.load(fh)
            if not isinstance(record.get("spans"), dict):
                raise ValueError("no span map")
            parsed += 1
        except (OSError, ValueError) as exc:
            failures.append(f"flight dump unparseable: {path} ({exc})")
    if parsed < require:
        failures.append(f"flight recorder: {parsed} parseable dumps, "
                        f"expected >= {require}")
    return dumps


def _check_span_accounting(dump_path: str, ring_size: int, ledger: dict,
                           failures: list, where: str) -> dict:
    """Span-level mirror of the admission-ledger invariant, read from the
    FLIGHT DUMP itself (the acceptance artifact, not live tracer state):
    with sample=1.0 and no ring eviction, the dump's terminal ``settle``
    spans must reproduce ``completed`` and every per-reason drop count
    exactly — each admitted frame has exactly one terminal span."""
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC
    from opencv_facerecognizer_tpu_torch.utils import tracing

    try:
        with open(dump_path) as fh:
            spans = json.load(fh)["spans"].get(FRAME_TOPIC, [])
    except (OSError, ValueError, KeyError, TypeError) as exc:
        failures.append(f"{where}: final dump unreadable: {exc}")
        return {}
    acct = tracing.account_spans(spans)
    if len(spans) >= ring_size:
        # The ring wrapped: early spans were evicted, exact accounting is
        # no longer provable — size the ring up instead of asserting lies.
        acct["ring_wrapped"] = True
        return acct
    if acct["completed"] != int(ledger["completed"]):
        failures.append(
            f"{where}: {acct['completed']} completed settle spans != "
            f"ledger completed {ledger['completed']}")
    if acct["completed_empty"] != int(ledger.get("completed_empty", 0)):
        failures.append(
            f"{where}: {acct['completed_empty']} completed_empty settle "
            f"spans != ledger completed_empty "
            f"{ledger.get('completed_empty', 0)}")
    if acct["completed_cached"] != int(ledger.get("completed_cached", 0)):
        failures.append(
            f"{where}: {acct['completed_cached']} completed_cached settle "
            f"spans != ledger completed_cached "
            f"{ledger.get('completed_cached', 0)}")
    want_drops = {k: int(v) for k, v in ledger["drops_by_reason"].items()}
    if acct["drops"] != want_drops:
        failures.append(f"{where}: settle-span drops {acct['drops']} != "
                        f"ledger drops {want_drops}")
    if acct["traced"] != int(ledger["admitted"]):
        failures.append(f"{where}: {acct['traced']} admitted receive "
                        f"spans != ledger admitted {ledger['admitted']}")
    return acct


def _finish_observability(tracer, trace_dir: str, reason: str, ledger: dict,
                          quiesced: bool, failures: list,
                          report: dict) -> None:
    """The shared end-of-scenario observability acceptance: force a final
    dump (rate limits must never suppress the LAST dump of a run), verify
    every dump parses, cross-check the final dump's settle spans against
    the settled ledger (only when the run actually quiesced), and clean
    the temp trace dir. One body — the soak and overload scenarios must
    enforce the identical contract."""
    final_dump = tracer.dump(reason, extra={"ledger": ledger}, force=True)
    flight_dumps = _check_flight_dumps(trace_dir, failures, require=1)
    report["flight_dumps"] = len(flight_dumps)
    if quiesced and final_dump:
        report["span_accounting"] = _check_span_accounting(
            final_dump, tracer.ring_size, ledger, failures,
            "span accounting")
    shutil.rmtree(trace_dir, ignore_errors=True)


def build_stack(frame_shape=(64, 64), face=(16, 16), capacity=64, seed=0,
                device="cuda", params=None):
    """The reference's tiny untrained serving stack on ``device``: chaos
    exercises the loop's control flow, not recognition quality. The nets'
    weights come from a torch generator seeded with ``seed`` (the
    reference inits them with ``jax.random``); ``params``, the
    reference's ``(detector, embedder)`` flax trees, loads them instead.
    Returns ``(pipeline, device)``."""
    import numpy as np
    import torch

    from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector
    from opencv_facerecognizer_tpu_torch.models.embedder import FaceEmbedNet
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device
    from opencv_facerecognizer_tpu_torch.utils.params import (
        detector_params_from_flax, embedder_params_from_flax)

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    det = CNNFaceDetector(features=(4, 8), head_features=8, max_faces=2,
                          score_threshold=0.5, space_to_depth=4, device=dev, generator=gen)
    net = FaceEmbedNet(embed_dim=16, stem_features=4, stage_features=(4, 8),
                       stage_blocks=(1, 1), input_size=face, generator=gen).to(dev)
    if params is not None:
        detector_params_from_flax(params[0], det.net)
        embedder_params_from_flax(params[1], net)
    gallery = ShardedGallery(capacity=capacity, dim=16, device=dev)
    g_rng = np.random.default_rng(seed)
    emb = g_rng.normal(size=(8, 16)).astype(np.float32)
    gallery.add(emb, np.arange(8, dtype=np.int32) % 4)
    pipe = RecognitionPipeline(det, net, gallery, face_size=face, device=dev)
    return pipe, dev


def instrument_locks(service, monitor):
    """Swap the locks of ``service`` (its own, its batcher's, its metrics',
    its pipeline's and gallery's, and its staging ring's) for
    ``DebugLock``s of ``monitor`` (``utils.debug_lock``), named with the
    ids ``tools/ocvf_lint``'s lock graph gives them. Call before the
    service starts; returns a function that puts the original locks back.
    The readback blocker's condition is left alone: its thread is parked
    on it from ``start`` on."""
    import threading

    saved = []

    def swap(obj, attr, name, condition=False):
        if obj is None or getattr(obj, attr, None) is None:
            return None
        saved.append((obj, attr, getattr(obj, attr)))
        lock = monitor.debug_lock(name)
        setattr(obj, attr, threading.Condition(lock) if condition else lock)
        return lock

    metrics = service.metrics
    swap(metrics, "_lock", "utils.metrics.Metrics._lock")
    swap(metrics, "_sink_lock", "utils.metrics.Metrics._sink_lock")
    for attr in ("_enrol_lock", "_reject_lock", "_dedup_lock"):
        swap(service, attr, f"runtime.recognizer.RecognizerService.{attr}")
    swap(service, "_inflight_cv", "runtime.recognizer.RecognizerService._inflight_cv",
         condition=True)
    batcher = service.batcher
    lock = swap(batcher, "_lock", "runtime.batcher.FrameBatcher._lock")
    saved.append((batcher, "_not_empty", batcher._not_empty))
    batcher._not_empty = threading.Condition(lock)
    pipeline = service.pipeline
    swap(getattr(pipeline, "gallery", None), "_write_lock",
         "parallel.gallery.ShardedGallery._write_lock")
    for attr in ("_weights_lock", "_capture_lock"):
        swap(pipeline, attr, f"parallel.pipeline.RecognitionPipeline.{attr}")
    if service.ingest is not None:
        swap(service.ingest.staging, "_lock", "runtime.ingest.StagingRing._lock")

    def restore():
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)

    return restore


def run_soak(seconds: float = 10.0, seed: int | None = None, frame_shape=(64, 64),
             device="cuda", *, pipeline=None, batch_size: int = 2, frames=None,
             offer_fps: float = 100.0, service_kwargs=None, prepare=None,
             on_start=None, handles=None) -> dict:
    """One supervised chaos run; the JSON-able report with ``report["ok"]``
    as the verdict.

    Keyword-only, for a caller that drives a prebuilt stack (no CLI flag):
    ``pipeline`` replaces ``build_stack``'s, ``batch_size`` is the
    service's, ``frames`` (arrays of ``frame_shape``) are offered in turn
    instead of seeded noise (the probe burst takes the first ones),
    ``offer_fps`` paces the offers, ``service_kwargs`` add to the
    service's arguments, ``prepare(service)`` runs before the supervisor
    starts it and ``on_start(service)`` once it has started (after the
    warmup), and ``handles`` (a dict) receives the service, connector,
    supervisor and injector, the probe's results and each offer's
    ``time.monotonic()`` (``sent_at`` by seq, ``probe_sent_at`` by probe
    index)."""
    import random as random_mod

    import numpy as np

    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC, RecognizerService)
    from opencv_facerecognizer_tpu_torch.runtime.resilience import (
        ResiliencePolicy, ServiceSupervisor)
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak seed={seed} seconds={seconds}", file=sys.stderr)

    # moderate rates: every boundary sees faults in a few hundred frames,
    # and healthy traffic still dominates, so the probe shows that serving
    # went on through the chaos
    rate_rng = random_mod.Random(seed)
    rates = {
        "receive": {"corrupt": 0.05 * rate_rng.random(),
                    "drop": 0.05 * rate_rng.random(),
                    "duplicate": 0.05 * rate_rng.random()},
        "put": {"corrupt": 0.05 * rate_rng.random()},
        "dispatch": {"unavailable": 0.10 * rate_rng.random()},
        "readback": {"stuck": 0.05 * rate_rng.random()},
    }
    injector = FaultInjector(seed=seed, rates=rates)
    if pipeline is None:
        pipeline, _dev = build_stack(frame_shape=frame_shape, seed=seed % 997,
                                     device=device)
    connector = FakeConnector()
    # sample 1.0: the span accounting covers every admitted frame, and each
    # dead-letter or crash leaves a parseable flight dump
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 16, sample=1.0, seed=seed, dump_dir=trace_dir,
                    min_dump_interval_s=0.1)
    service = RecognizerService(
        pipeline, connector, batch_size=batch_size, frame_shape=frame_shape,
        flush_timeout=0.02, inflight_depth=2,
        resilience=ResiliencePolicy(
            dispatch_retries=2, backoff_base_s=0.01, backoff_max_s=0.05,
            readback_deadline_s=0.5, degraded_after=3),
        fault_injector=injector, tracer=tracer, **(service_kwargs or {}))
    supervisor = ServiceSupervisor(service, max_restarts=1000, poll_interval_s=0.05)
    if handles is not None:
        handles.update(service=service, connector=connector, supervisor=supervisor,
                       injector=injector, sent_at={}, probe_sent_at={})
    if prepare is not None:
        prepare(service)
    supervisor.start()

    frame_rng = np.random.default_rng(seed)
    payloads = None if frames is None else [encode_frame(f) for f in frames]

    def next_payload(i):
        if payloads is not None:
            return payloads[i % len(payloads)]
        return encode_frame(frame_rng.uniform(0, 255, frame_shape).astype(np.float32))

    report = {"seed": seed, "seconds": seconds, "rates": rates, "ok": False}
    try:
        if on_start is not None:
            on_start(service)
        sent = 0
        interval = 1.0 / float(offer_fps)
        t_next = time.monotonic()
        deadline = t_next + seconds
        while time.monotonic() < deadline:
            if handles is not None:
                handles["sent_at"][sent] = time.monotonic()
            connector.inject(FRAME_TOPIC, {**next_payload(sent), "meta": {"seq": sent}})
            sent += 1
            t_next += interval
            time.sleep(max(0.0, t_next - time.monotonic()))

        # ---- liveness probe: clean traffic after the chaos window ----
        injector.disarm()
        # the chaos window's backlog first: liveness means progress, not an
        # empty queue the instant chaos ends; the probe is the verdict
        service.drain(timeout=max(15.0, 3.0 * seconds))
        probe_n = 6
        for i in range(probe_n):
            if handles is not None:
                handles["probe_sent_at"][i] = time.monotonic()
            connector.inject(FRAME_TOPIC, {**next_payload(i), "meta": {"probe": i}})
        # wait on the probe's own results: backlog results must not count
        probe_deadline = time.monotonic() + 15.0
        probe_results: list = []
        while time.monotonic() < probe_deadline:
            probe_results = [r for r in connector.messages(RESULT_TOPIC)
                             if isinstance(r.get("meta"), dict) and "probe" in r["meta"]]
            if len(probe_results) >= probe_n:
                break
            time.sleep(0.05)
        results = connector.messages(RESULT_TOPIC)
        wedged = len(probe_results) < probe_n
        # quiesce once more and read the ledger while the service is up:
        # every admitted frame in exactly one bucket, in_system 0
        ledger_quiesced = service.drain(timeout=15.0)
        ledger = service.ledger()
    finally:
        supervisor.stop()
    if handles is not None:
        handles["probe_results"] = probe_results

    counters = service.metrics.counters()
    report["sent"] = sent
    report["results"] = len(results)
    report["injected"] = injector.summary()
    report["counters"] = counters
    report["ledger"] = ledger
    report["supervisor_restarts"] = supervisor.restarts

    failures = []
    _finish_observability(tracer, trace_dir, "soak_end", ledger, ledger_quiesced,
                          failures, report)
    if wedged:
        failures.append(f"wedged: liveness probe got {len(probe_results)}/{probe_n} results")
    crashes = counters.get("loop_crashes", 0)
    if crashes != counters.get("supervisor_restarts", 0) or supervisor.gave_up:
        failures.append(f"unsupervised crash: {crashes} crashes vs "
                        f"{counters.get('supervisor_restarts', 0)} restarts "
                        f"(gave_up={supervisor.gave_up})")
    delivered = service.batcher.delivered_batches
    # every popped batch ends dispatched (then published or dead-lettered)
    # or abandoned (batches_failed): nothing vanishes
    accounted = counters.get("batches_dispatched", 0) + counters.get("batches_failed", 0)
    if delivered != accounted:
        failures.append(f"accounting: delivered={delivered} != "
                        f"dispatched+failed={accounted}")
    # the admission ledger at quiescence (only then: an undrained service
    # has frames in flight, and a stalled probe already failed above)
    if ledger_quiesced and abs(ledger["in_system"]) > 1e-6:
        failures.append(f"ledger: admitted={ledger['admitted']} != "
                        f"completed={ledger['completed']} + drops="
                        f"{ledger['drops_by_reason']} (in_system={ledger['in_system']})")
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_overload(seconds: float = 6.0, seed: int | None = None,
                 journal_path: str | None = None) -> dict:
    """Overload scenario: a ~4x offered-load flood —
    seed-logged ``receive: flood`` fault amplifying a mixed interactive/
    bulk stream — against the full overload-protection stack (admission
    bound, priority shedding, brownout, stale drops, dead-letter journal)
    over a deterministic capacity-limited fake backend.

    Pass criteria (any miss -> ``ok: False``):

    1. **no wedge** — post-flood liveness probe completes;
    2. **no crash** — ``loop_crashes == 0``;
    3. **interactive latency held** — flood-phase interactive e2e p99 stays
       within 2x the unloaded baseline (+50 ms scheduler-noise floor);
    4. **bulk actually shed** — a 4x flood must produce explicit sheds;
    5. **ledger exact** — at quiescence ``admitted == completed +
       Σ drops_by_reason`` (every shed frame has a named reason);
    6. **journal covers the sheds** — journaled frame count equals the
       shed/dead-letter counters it mirrors.
    """
    import random as random_mod

    import numpy as np

    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.journal import DeadLetterJournal
    from opencv_facerecognizer_tpu_torch.runtime.resilience import ServiceSupervisor
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        TrafficRecorder, build_overload_stack,
    )

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak overload seed={seed} seconds={seconds}",
          file=sys.stderr)

    frame_shape = (32, 32)
    batch_size = 8
    dispatch_s = 0.04          # hard capacity: 8 / 0.04 = 200 frames/s
    capacity_fps = batch_size / dispatch_s
    flood_factor = 8
    # Effective offered load ~= base * (1 + p*(factor-1)); p in [0.4, 0.6]
    # from the logged seed lands the total at roughly 3-4.5x capacity.
    rate_rng = random_mod.Random(seed)
    flood_p = 0.4 + 0.2 * rate_rng.random()
    base_hz = 4.0 * capacity_fps / (1.0 + flood_p * (flood_factor - 1))

    injector = FaultInjector(seed=seed,
                             rates={"receive": {"flood": flood_p}},
                             flood_factor=flood_factor)
    injector.disarm()  # armed only for the flood phase
    temp_journal = journal_path is None
    if temp_journal:
        fd, journal_path = tempfile.mkstemp(prefix="ocvf_dead_letter_",
                                            suffix=".jsonl")
        os.close(fd)
    journal = DeadLetterJournal(journal_path, max_bytes=1 << 20)
    # Full-fidelity tracing through the flood: shed frames must still
    # settle exactly once each, and the run must leave a parseable
    # flight-recorder dump.
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 17, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.25)
    # SLO burn-rate monitor under test (signals-layer acceptance): tight
    # windows + fine-sliced metrics rings so a few seconds of flood
    # provably burns the budget to critical AND a few seconds of calm
    # provably recovers it — the production defaults just stretch the
    # same clocks. The monitor is ticked by the serving loop (the wiring
    # under test), fires the critical flight dump via this tracer, and at
    # critical adds one level of brownout intake pressure.
    from opencv_facerecognizer_tpu_torch.runtime.slo import SLO, SLOMonitor
    from opencv_facerecognizer_tpu_torch.utils import metric_names as mn
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    metrics = Metrics(window_s=6.0, window_slices=12)
    slo = SLOMonitor(metrics, [
        SLO(name="queue_wait_p99", kind="latency", window=mn.QUEUE_WAIT,
            threshold_s=0.05, target=0.9, short_s=1.0, long_s=3.0,
            warn_burn=1.0, critical_burn=2.5),
        SLO(name="completion", kind="ratio", target=0.95,
            bad_counters=mn.LEDGER_DROP_COUNTERS,
            total_counters=(mn.FRAMES_ADMITTED,),
            short_s=1.0, long_s=3.0, warn_burn=1.0, critical_burn=2.5),
    ], tracer=tracer, interval_s=0.25, recovery_evals=2)
    # the service under test: the overload harness of runtime.fakes
    pipeline, service, connector = build_overload_stack(
        frame_shape=frame_shape, batch_size=batch_size,
        dispatch_s=dispatch_s, fault_injector=injector, journal=journal,
        tracer=tracer, slo_monitor=slo, metrics=metrics)
    supervisor = ServiceSupervisor(service, max_restarts=100,
                                   poll_interval_s=0.05)
    supervisor.start(warmup=False)

    # Shared seq-tagged recorder (runtime.fakes.TrafficRecorder): the
    # bench's overload_sweep measures through the same code.
    recorder = TrafficRecorder(connector)
    frame = np.zeros(frame_shape, np.float32)
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    frame_msg = encode_frame(frame)

    def offer(seq, priority):
        recorder.offer(connector, frame_msg, seq, priority)

    report = {"scenario": "overload", "seed": seed, "seconds": seconds,
              "flood_p": round(flood_p, 3), "flood_factor": flood_factor,
              "capacity_fps": capacity_fps,
              "offered_base_hz": round(base_hz, 1), "ok": False}
    try:
        # ---- phase A: unloaded interactive baseline ----
        base_seqs = []
        seq = 0
        base_end = time.monotonic() + min(1.5, seconds)
        while time.monotonic() < base_end:
            offer(seq, "interactive")
            base_seqs.append(seq)
            seq += 1
            time.sleep(1.0 / 40.0)
        service.drain(timeout=15.0)
        base_p99_ms = recorder.percentile_ms(base_seqs, 99)

        # SLO baseline sanity: after the clean phase the monitor must be
        # sitting at ok (a monitor that starts alarmed proves nothing
        # about the flood).
        slo_baseline_state = slo.state

        # ---- phase B: the flood (seed-logged fault amplification) ----
        injector.arm()
        flood_interactive, flood_bulk = [], []
        interval = 1.0 / base_hz
        flood_end = time.monotonic() + seconds
        i = 0
        slo_max_state = slo.state_code
        while time.monotonic() < flood_end:
            if i % 10 == 0:
                offer(seq, "interactive")
                flood_interactive.append(seq)
            else:
                offer(seq, "bulk")
                flood_bulk.append(seq)
            seq += 1
            i += 1
            slo_max_state = max(slo_max_state, slo.state_code)
            time.sleep(interval)
        injector.disarm()

        # ---- phase C: recovery, liveness probe, ledger ----
        service.drain(timeout=max(15.0, 3.0 * seconds))
        # Brownout must recover on its own once the flood stops (the
        # hysteresis path) — and the probe below must run OUTSIDE
        # brownout, or the level-2 ladder cap would legitimately trim
        # probe frames and read as a false wedge.
        recover_deadline = time.monotonic() + 15.0
        while (service.brownout_level > 0
               and time.monotonic() < recover_deadline):
            slo_max_state = max(slo_max_state, slo.state_code)
            time.sleep(0.05)
        brownout_recovered = service.brownout_level == 0
        # The SLO state machine must also walk back to ok once the
        # rolling windows clear the flood (hysteresis: recovery_evals
        # consecutive calmer evaluations per level) — bounded wait, the
        # serving loop keeps ticking the monitor on idle iterations.
        slo_deadline = time.monotonic() + 20.0
        while slo.state_code > 0 and time.monotonic() < slo_deadline:
            time.sleep(0.05)
        slo_recovered_state = slo.state
        probe_seqs = []
        for _ in range(6):
            offer(seq, "interactive")
            probe_seqs.append(seq)
            seq += 1
        probe_deadline = time.monotonic() + 15.0
        while time.monotonic() < probe_deadline:
            if recorder.completed(probe_seqs) == len(probe_seqs):
                break
            time.sleep(0.05)
        wedged = recorder.completed(probe_seqs) < len(probe_seqs)
        quiesced = service.drain(timeout=15.0)
        ledger = service.ledger()
        flood_p99_ms = recorder.percentile_ms(flood_interactive, 99)
        bulk_completed = recorder.completed(flood_bulk)
    finally:
        supervisor.stop()
        journal.close()

    counters = service.metrics.counters()
    journaled = sum(len(r.get("frames", ())) for r in journal.records())
    journal_expected = sum(counters.get(k, 0) for k in (
        "frames_dead_lettered", "frames_failed", "frames_dropped_brownout",
        "batcher_dropped_stale", "batcher_dropped_overflow"))
    rejected = service.metrics.counters_with_prefix("frames_rejected_")
    shed_total = journal_expected + sum(rejected.values())
    if temp_journal:
        for path in ([journal.path]
                     + [f"{journal.path}.{i}" for i in range(1, 4)]):
            try:
                os.remove(path)
            except OSError:
                pass

    def _ms_or_none(value):
        # NaN (no completions) must not leak into the JSON report —
        # json.dumps would emit the non-RFC 'NaN' token.
        return None if value != value else round(value, 1)

    report.update({
        "offered": seq,
        "baseline_interactive_p99_ms": _ms_or_none(base_p99_ms),
        "flood_interactive_p99_ms": _ms_or_none(flood_p99_ms),
        "flood_bulk_offered": len(flood_bulk),
        "flood_bulk_completed": bulk_completed,
        "rejected": rejected,
        "injected": injector.summary(),
        "ledger": ledger,
        "journal_frames": journaled,
        "journal_path": journal.path,
        "counters": counters,
    })

    report["brownout_recovered"] = brownout_recovered
    from opencv_facerecognizer_tpu_torch.runtime.slo import (
        STATE_CRITICAL, STATE_NAMES, STATE_OK,
    )

    report["slo"] = {
        "baseline_state": slo_baseline_state,
        "max_state": STATE_NAMES[slo_max_state],
        "recovered_state": slo_recovered_state,
        "evaluations": slo.verdict().get("evaluations"),
        "transitions": int(counters.get("slo_transitions", 0)),
    }
    # The critical-transition flight dump: globbed BEFORE
    # _finish_observability tears the trace dir down.
    slo_dumps = sorted(glob.glob(
        os.path.join(trace_dir, "flight-*slo_critical*.json")))
    slo_dump_ok = False
    for path in slo_dumps:
        try:
            with open(path) as fh:
                rec = json.load(fh)
            verdict = rec.get("extra", {}).get("verdict", {})
            if (isinstance(rec.get("spans"), dict)
                    and verdict.get("objectives")):
                slo_dump_ok = True
        except (OSError, ValueError):
            continue
    report["slo"]["critical_dumps"] = len(slo_dumps)
    failures = []
    _finish_observability(tracer, trace_dir, "overload_end", ledger,
                          quiesced, failures, report)
    if wedged:
        failures.append(f"wedged: liveness probe got "
                        f"{recorder.completed(probe_seqs)}/"
                        f"{len(probe_seqs)} results")
    if not brownout_recovered:
        failures.append("brownout never recovered after the flood stopped")
    # ---- SLO acceptance (signals layer) ----
    if slo_baseline_state != STATE_NAMES[STATE_OK]:
        failures.append(f"SLO monitor not ok after the clean baseline "
                        f"phase (was {slo_baseline_state})")
    if slo_max_state < STATE_CRITICAL:
        failures.append(f"SLO monitor never reached critical under a ~4x "
                        f"flood (max {STATE_NAMES[slo_max_state]})")
    if slo_recovered_state != STATE_NAMES[STATE_OK]:
        failures.append(f"SLO monitor never recovered to ok after the "
                        f"flood (stuck at {slo_recovered_state})")
    if slo_max_state >= STATE_CRITICAL and not slo_dump_ok:
        failures.append("critical transition left no parseable "
                        "slo_critical flight dump with a verdict")
    if counters.get("loop_crashes", 0):
        failures.append(f"crashed: loop_crashes={counters['loop_crashes']}")
    # NaN percentiles mean zero completions in that phase — each is its
    # own failure; the latency comparison only runs with both present (a
    # NaN baseline must not let the criterion pass vacuously).
    if base_p99_ms != base_p99_ms:
        failures.append("no baseline interactive frame completed")
    if flood_p99_ms != flood_p99_ms:
        failures.append("no flood-phase interactive frame completed")
    elif (base_p99_ms == base_p99_ms
          and flood_p99_ms > 2.0 * base_p99_ms + 50.0):
        failures.append(f"interactive p99 blew the budget: flood "
                        f"{flood_p99_ms:.0f} ms > 2x baseline "
                        f"{base_p99_ms:.0f} ms + 50 ms")
    if shed_total <= 0:
        failures.append("a 4x flood produced zero explicit sheds/rejects")
    if quiesced and abs(ledger["in_system"]) > 1e-6:
        failures.append(f"ledger: in_system={ledger['in_system']} != 0 "
                        f"(admitted={ledger['admitted']}, "
                        f"completed={ledger['completed']}, "
                        f"drops={ledger['drops_by_reason']})")
    if not quiesced:
        failures.append("final drain never quiesced")
    if journaled != journal_expected:
        failures.append(f"journal: {journaled} frames journaled != "
                        f"{journal_expected} counted sheds")
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_recovery(seconds: float = 4.0, seed: int | None = None,
                 state_dir: str | None = None) -> dict:
    """Crash-recovery scenario (state lifecycle acceptance): seeded kill
    points injected at every durability boundary — mid-WAL-append (torn
    and before-write), mid-checkpoint (torn tmp, crash-before-rename, and
    crash-after-rename-before-WAL-truncate), post-rename media corruption
    of the newest checkpoint, and a kill mid-restore — across repeated
    simulated process lifetimes over ONE state directory.

    Invariant asserted every "restart": recovery lands on a
    checksum-verified gallery holding EXACTLY the acknowledged enrollment
    history (an ``append_enrollment`` that returned, WAL at ``always``) —
    bit-equal rows, zero loss, zero phantoms — with ``checkpoints_corrupt``
    incremented whenever a corrupt newest checkpoint forced fallback.

    Ends with a **graceful-drain phase**: a live service (deterministic
    ``InstantPipeline`` backend) takes frames, then the SIGTERM path
    (``state_store.graceful_shutdown``) must complete in-flight frames,
    settle the admission ledger exactly, write a final checkpoint, and
    leave the WAL empty.
    """
    import random as random_mod

    import numpy as np

    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.state_store import (
        StateLifecycle, graceful_shutdown)
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import InstantPipeline
    from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak recovery seed={seed} seconds={seconds}",
          file=sys.stderr)
    rng = random_mod.Random(seed)
    frame_rng = np.random.default_rng(seed)

    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_recovery_")
    DIM = 8

    #: acknowledged history: (seq, raw embeddings, labels, subject, label)
    #: — only appended AFTER append_enrollment returns (the fsync ack).
    acked: list = []
    report = {"scenario": "recovery", "seed": seed, "seconds": seconds,
              "state_dir": state_dir, "ok": False}
    failures: list = []
    counts = {"rounds": 0, "kills": 0, "wal_torn": 0, "wal_crash": 0,
              "ckpt_torn": 0, "ckpt_crash": 0, "ckpt_late": 0,
              "media_corrupt": 0, "mid_restore_kills": 0,
              "checkpoints_corrupt": 0, "replayed_rows": 0}

    def expected_rows():
        """The normalized row matrix + labels recovery must reproduce."""
        if not acked:
            return np.zeros((0, DIM), np.float32), np.zeros((0,), np.int32)
        emb = np.concatenate([e for _s, e, _l, _su, _la in acked])
        lab = np.concatenate([l for _s, _e, l, _su, _la in acked])
        norm = emb / np.maximum(
            np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return norm.astype(np.float32), lab.astype(np.int32)

    def verify_recovered(gallery, where: str) -> None:
        want_emb, want_lab = expected_rows()
        got_emb, got_lab, got_val, got_size = gallery.snapshot()
        if got_size != len(want_lab):
            failures.append(
                f"{where}: recovered {got_size} rows, expected "
                f"{len(want_lab)} acknowledged rows (seed={seed})")
            return
        if got_size and not np.array_equal(got_lab[:got_size], want_lab):
            failures.append(f"{where}: recovered labels differ")
            return
        if got_size and not np.allclose(got_emb[:got_size], want_emb,
                                        rtol=0, atol=1e-6):
            failures.append(f"{where}: recovered embeddings differ")

    # Rounds derive from the time budget DETERMINISTICALLY (not from the
    # wall clock): the kill schedule is a pure function of (seed, seconds),
    # so a replay with the printed seed reproduces the exact same crash
    # sequence regardless of machine speed.
    n_rounds = max(6, min(60, int(seconds * 5)))
    metrics = None
    try:
        while counts["rounds"] < n_rounds:
            counts["rounds"] += 1
            injector = FaultInjector(seed=seed + counts["rounds"])
            metrics = Metrics()
            # ---- "restart": fresh process state over the same dir ----
            if acked and rng.random() < 0.25:
                # Kill mid-restore: run a recovery, discard everything it
                # built, restart again — recovery is read-only on the
                # durable files (quarantine renames are idempotent), so a
                # second restore must land identically.
                counts["mid_restore_kills"] += 1
                counts["kills"] += 1
                scratch = ShardedGallery(capacity=64, dim=DIM, device="cpu")
                # Shares the round's metrics: a corrupt checkpoint
                # quarantined by THIS (killed) restore must still show up
                # in the counted fallbacks.
                StateLifecycle(state_dir, metrics=metrics).recover(
                    scratch, [])
            gallery = ShardedGallery(capacity=64, dim=DIM, device="cpu")
            names: list = []
            state = StateLifecycle(
                state_dir, metrics=metrics, keep_checkpoints=3,
                # Manual checkpoints only: the kill schedule owns timing.
                checkpoint_wal_rows=1 << 30, checkpoint_every_s=1e9,
                fault_injector=injector)
            rec = state.recover(gallery, names)
            counts["checkpoints_corrupt"] += int(
                metrics.counter("checkpoints_corrupt"))
            counts["replayed_rows"] += rec["replayed_rows"]
            verify_recovered(gallery, f"round {counts['rounds']} recovery")
            # Subject names must match the acknowledged mapping too.
            for _seq, _e, _l, subject, label in acked:
                if label < len(names) and names[label] != subject:
                    failures.append(
                        f"round {counts['rounds']}: name[{label}] = "
                        f"{names[label]!r}, expected {subject!r}")
                    break

            # ---- live phase: enrollments with seeded kill points ----
            died = False
            for _ in range(rng.randint(2, 5)):
                n = rng.randint(1, 3)
                emb = frame_rng.normal(size=(n, DIM)).astype(np.float32)
                label = len(names)
                subject = f"subject_{len(acked)}"
                labels = np.full(n, label, np.int32)
                kill = rng.random()
                if kill < 0.15:
                    injector.script("wal", "torn")
                elif kill < 0.25:
                    injector.script("wal", "crash")
                try:
                    seq = state.append_enrollment(
                        emb, labels, subject=subject, label=label,
                        apply_fn=lambda e=emb, l=labels: gallery.add(e, l))
                except InjectedCrashError:
                    # Process died mid-append: NOT acknowledged — the
                    # enrollment may or may not survive; what recovery
                    # must never do is lose an ACKED one or invent rows
                    # (a torn record never replays: crc/json guard).
                    counts["kills"] += 1
                    counts["wal_torn" if kill < 0.15 else "wal_crash"] += 1
                    died = True
                    break
                names.append(subject)
                acked.append((seq, emb, labels, subject, label))
            if died:
                continue  # abandoned without close(): a real crash

            # ---- checkpoint attempts with seeded kill points ----
            if rng.random() < 0.7:
                kill = rng.random()
                fault = None
                if kill < 0.2:
                    fault, key = "torn", "ckpt_torn"
                elif kill < 0.35:
                    fault, key = "crash", "ckpt_crash"
                elif kill < 0.5:
                    fault, key = "late", "ckpt_late"
                if fault is not None:
                    injector.script("checkpoint", fault)
                try:
                    state.checkpoint_now(wait=True)
                except InjectedCrashError:
                    counts["kills"] += 1
                    counts[key] += 1
                    if fault == "late":
                        # The checkpoint INSTALLED; the WAL truncate never
                        # ran. Sometimes additionally corrupt the newest
                        # file on disk (the torn-rename/media shape): the
                        # next recovery must fall back past it — the WAL
                        # still covers everything.
                        if rng.random() < 0.6:
                            files = state.store.checkpoint_files()
                            if files:
                                path = files[0][1]
                                blob = open(path, "rb").read()
                              
                                with open(path, "wb") as fh:
                                    fh.write(blob[:int(len(blob) * 0.6)])
                                counts["media_corrupt"] += 1
                    continue  # died: next round restarts
            # Clean shutdown of this lifetime (no close: daemon-style exit)

        # ---- final full verification over a clean recovery ----
        final_metrics = Metrics()
        gallery = ShardedGallery(capacity=64, dim=DIM, device="cpu")
        names = []
        state = StateLifecycle(state_dir, metrics=final_metrics)
        state.recover(gallery, names)
        # A media corruption injected in the LAST round is quarantined by
        # THIS recovery — fold its fallback count in too.
        counts["checkpoints_corrupt"] += int(
            final_metrics.counter("checkpoints_corrupt"))
        verify_recovered(gallery, "final recovery")
        if not state.checkpoint_now(wait=True):
            failures.append("final checkpoint failed")
        # Offline verification must pass on what recovery left installed.
        from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint as verify_mod

        vreport = verify_mod.verify_state_dir(state_dir)
        report["verify"] = {"ok": vreport["ok"],
                            "checkpoints": len(vreport["checkpoints"]),
                            "corrupt": vreport["corrupt"]}
        if not vreport["ok"]:
            failures.append(f"offline verification failed: "
                            f"{vreport['corrupt']}")

        # ---- graceful-drain phase (the SIGTERM path) ----
        frame_shape = (16, 16)
        drain_metrics = Metrics()
        pipe = InstantPipeline(frame_shape, dispatch_s=0.002)
        pipe.gallery = gallery
        connector = FakeConnector()
        # Tracing through the drain: SIGTERM must force a final flight
        # dump whose lifecycle spans show the WAL append + final
        # checkpoint this phase performs.
        from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

        trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
        tracer = Tracer(ring_size=1 << 14, sample=1.0, seed=seed,
                        dump_dir=trace_dir)
        drain_state = StateLifecycle(state_dir, metrics=drain_metrics,
                                     checkpoint_wal_rows=1 << 30,
                                     checkpoint_every_s=1e9,
                                     tracer=tracer)
        service = RecognizerService(
            pipe, connector, batch_size=4, frame_shape=frame_shape,
            flush_timeout=0.02, state_store=drain_state, tracer=tracer)
        # recover() was already run for this dir; bind fresh seq state so
        # the drain-phase enrollment sequences continue, not collide.
        drain_state.recover(gallery, names)
        service.subject_names = names
        service.start(warmup=False)
        frame = np.zeros(frame_shape, np.float32)
        sent = 24
        for i in range(sent):
            connector.inject(FRAME_TOPIC,
                             {**encode_frame(frame), "meta": {"seq": i}})
        # One in-flight enrollment through the write-ahead path.
        emb = frame_rng.normal(size=(2, DIM)).astype(np.float32)
        label = len(names)
        drain_state.append_enrollment(
            emb, np.full(2, label, np.int32), subject="drain_subject",
            label=label,
            apply_fn=lambda: gallery.add(emb, np.full(2, label, np.int32)))
        names.append("drain_subject")
        acked.append((drain_state.wal_seq, emb, np.full(2, label, np.int32),
                      "drain_subject", label))
        shutdown = graceful_shutdown(service, state=drain_state,
                                     drain_timeout=30.0)
        results = len(connector.messages(RESULT_TOPIC))
        report["drain"] = {"sent": sent, "results": results,
                           "shutdown": {k: v for k, v in shutdown.items()}}
        # Observability acceptance for the recovery scenario: the SIGTERM
        # drain forces a flight dump; it must parse, and its lifecycle
        # spans must show the durable work this phase performed.
        _check_flight_dumps(trace_dir, failures, require=1)
        dump_path = shutdown.get("flight_dump")
        if not dump_path:
            failures.append("graceful shutdown produced no flight dump")
        else:
            try:
                with open(dump_path) as fh:
                    dump_rec = json.load(fh)
                life = [s["stage"] for s in
                        dump_rec["spans"].get("_lifecycle", ())]
                if "wal_append" not in life or "checkpoint" not in life:
                    failures.append(f"drain dump lifecycle spans missing "
                                    f"wal_append/checkpoint: {life}")
                report["drain"]["flight_dump_lifecycle"] = sorted(set(life))
            except (OSError, ValueError, KeyError) as exc:
                failures.append(f"drain flight dump unreadable: {exc}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        if not shutdown["drained"]:
            failures.append("graceful drain timed out")
        if results != sent:
            failures.append(f"drain: {results}/{sent} frames published")
        if abs(shutdown["ledger"]["in_system"]) > 1e-6:
            failures.append(f"drain ledger unsettled: "
                            f"{shutdown['ledger']}")
        if not shutdown.get("final_checkpoint"):
            failures.append("no final checkpoint on graceful shutdown")
        # WAL must be empty after the final checkpoint truncated it.
        leftover = sum(1 for _ in drain_state.wal.enrollments())
        if leftover:
            failures.append(f"WAL holds {leftover} records after final "
                            f"checkpoint")
        # And the post-shutdown state must recover the drain enrollment.
        g2 = ShardedGallery(capacity=64, dim=DIM, device="cpu")
        StateLifecycle(state_dir, metrics=Metrics()).recover(g2, [])
        verify_recovered(g2, "post-drain recovery")
    finally:
        if temp_dir:
            shutil.rmtree(state_dir, ignore_errors=True)

    if counts["checkpoints_corrupt"] < 1 <= counts["media_corrupt"]:
        failures.append("corrupt newest checkpoint never counted "
                        "checkpoints_corrupt")
    report["counts"] = counts
    report["acked_enrollments"] = len(acked)
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_replication(seconds: float = 6.0, seed: int | None = None,
                    state_dir: str | None = None) -> dict:
    """Replication scenario: 1 writer + 2
    WAL-tailing read replicas serving one logical gallery out of a shared
    state dir, camera topics spread across all three by the rendezvous
    topic router, enrollment traffic riding the writer's WAL — then kill
    a read replica mid-traffic AND kill the writer mid-enrollment.

    Pass criteria (any miss -> ``ok: False``):

    1. **failover holds latency** — interactive p99 over frames routed
       after each kill stays within 2x the unloaded baseline (+100 ms
       absolute floor: the restart window carries recovery churn on a
       1-core box) on the surviving replicas;
    2. **zero acked loss** — after the dust settles, every enrollment
       whose ``append_enrollment`` returned is present, bit-equal and in
       order, on EVERY survivor (the restarted writer's recovery, the
       surviving reader's tail, and a freshly resynced replacement
       replica), with replay-dedup exactness (no phantom rows);
    3. **split-brain fails closed** — while the writer lease is held, a
       second writer in a REAL second process must refuse to start;
    4. **ledgers settle** — each replica's admission ledger reaches
       ``in_system == 0`` (the killed reader settles what it had);
    5. **observability** — the failover leaves a parseable flight dump
       and the replicas' ``wal_tail`` lifecycle spans recorded the tail.
    """
    import random as random_mod
    import subprocess
    import threading

    import numpy as np

    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReadReplica, ReplicaHandle, TopicRouter, WriterLease)
    from opencv_facerecognizer_tpu_torch.runtime.resilience import ResiliencePolicy
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        InstantPipeline, TrafficRecorder,
    )
    from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        service_health_probe,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak replication seed={seed} seconds={seconds}",
          file=sys.stderr)
    rng = random_mod.Random(seed)
    frame_rng = np.random.default_rng(seed)

    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_replication_")
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 16, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.1)
    DIM = 8
    frame_shape = (32, 32)
    dispatch_s = 0.01  # 800 frames/s per replica: traffic stays unloaded
    offered_hz = 60.0
    topics = 12

    report = {"scenario": "replication", "seed": seed, "seconds": seconds,
              "state_dir": state_dir, "ok": False}
    failures: list = []

    #: acknowledged enrollment history (seq, emb, labels, subject, label)
    #: — appended only AFTER append_enrollment returns.
    acked: list = []

    def expected_rows():
        if not acked:
            return (np.zeros((0, DIM), np.float32),
                    np.zeros((0,), np.int32))
        emb = np.concatenate([e for _s, e, _l, _su, _la in acked])
        lab = np.concatenate([l for _s, _e, l, _su, _la in acked])
        norm = emb / np.maximum(
            np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return norm.astype(np.float32), lab.astype(np.int32)

    def verify_gallery(gallery, where: str) -> None:
        want_emb, want_lab = expected_rows()
        got_emb, got_lab, _v, got_size = gallery.snapshot()
        if got_size != len(want_lab):
            failures.append(f"{where}: {got_size} rows, expected "
                            f"{len(want_lab)} acked (seed={seed})")
            return
        if got_size and not np.array_equal(got_lab[:got_size], want_lab):
            failures.append(f"{where}: labels differ")
        elif got_size and not np.allclose(got_emb[:got_size], want_emb,
                                          rtol=0, atol=1e-6):
            failures.append(f"{where}: embeddings differ")

    def make_service(gallery, metrics, replica=None):
        pipe = InstantPipeline(frame_shape, dispatch_s=dispatch_s)
        pipe.gallery = gallery
        svc = RecognizerService(
            pipe, FakeConnector(), batch_size=8, frame_shape=frame_shape,
            flush_timeout=0.02, inflight_depth=2, similarity_threshold=0.0,
            metrics=metrics,
            resilience=ResiliencePolicy(readback_deadline_s=2.0),
            replica=replica)
        return svc

    # ---- writer: lease + lifecycle + a serving service over the same
    # gallery (enrollment rides a dedicated thread through the WAL) ----
    injector = FaultInjector(seed=seed)
    writer_metrics = Metrics()
    lease = WriterLease(state_dir, metrics=writer_metrics).acquire()
    writer_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
    writer_names: list = []
    state = StateLifecycle(state_dir, metrics=writer_metrics,
                           checkpoint_wal_rows=16, checkpoint_every_s=1e9,
                           fault_injector=injector, tracer=tracer)
    state.bind(writer_gallery, writer_names)
    writer_box = {"svc": make_service(writer_gallery, writer_metrics)}

    # ---- two read replicas over the same state dir ----
    readers = []
    for i in range(2):
        rmetrics = Metrics()
        rgallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        rnames: list = []
        rep = ReadReplica(state_dir, rgallery, rnames, metrics=rmetrics,
                          tracer=tracer, poll_interval_s=0.05,
                          name=f"reader-{i}")
        rep.poll(force=True)  # initial sync before serving starts
        readers.append({"replica": rep, "gallery": rgallery,
                        "names": rnames, "metrics": rmetrics,
                        "svc": make_service(rgallery, rmetrics,
                                            replica=rep)})

    # ---- router over all three serving replicas ----
    router_metrics = Metrics()
    handles = [ReplicaHandle(
        "writer", writer_box["svc"].connector,
        health_fn=lambda: service_health_probe(writer_box["svc"])(),
        writer=True)]
    for i, reader in enumerate(readers):
        handles.append(ReplicaHandle(
            f"reader-{i}", reader["svc"].connector,
            health_fn=service_health_probe(reader["svc"])))
    router = TopicRouter(handles, metrics=router_metrics, tracer=tracer,
                         health_interval_s=0.05)
    recorder = TrafficRecorder(router)
    frame_msg = encode_frame(np.zeros(frame_shape, np.float32))

    seq_box = {"seq": 0}

    def offer() -> int:
        seq = seq_box["seq"]
        seq_box["seq"] = seq + 1
        recorder.send_t[seq] = time.monotonic()
        router.publish(f"camera/{seq % topics}",
                       {**frame_msg, "priority": "interactive",
                        "meta": {"seq": seq}})
        return seq

    # ---- enrollment traffic thread (the writer's WAL write path) ----
    enroll_stop = threading.Event()
    writer_died = threading.Event()

    def enroll_loop():
        while not enroll_stop.is_set():
            n = rng.randint(1, 2)
            emb = frame_rng.normal(size=(n, DIM)).astype(np.float32)
            label = len(writer_names)
            subject = f"subject_{len(acked)}"
            labels = np.full(n, label, np.int32)
            writer_names.append(subject)
            try:
                seq = state.append_enrollment(
                    emb, labels, subject=subject, label=label,
                    apply_fn=lambda e=emb, l=labels:
                        writer_gallery.add(e, l))
            except InjectedCrashError:
                # The writer process "died" mid-enrollment: NOT acked.
                writer_names.pop()
                writer_died.set()
                return
            acked.append((seq, emb, labels, subject, label))
            time.sleep(0.015)

    writer_box["svc"].start(warmup=False)
    for reader in readers:
        reader["svc"].start(warmup=False)
    router.start()
    enroll_thread = threading.Thread(target=enroll_loop, daemon=True)

    def warm_enroll(n: int) -> None:
        """Synchronous enrollments BEFORE the baseline clock: the first
        gallery.add per shape pays one-off costs, and charging them to
        the baseline p99 would inflate the whole latency budget into
        meaninglessness."""
        for _ in range(n):
            emb = frame_rng.normal(size=(1, DIM)).astype(np.float32)
            label = len(writer_names)
            subject = f"subject_{len(acked)}"
            labels = np.full(1, label, np.int32)
            writer_names.append(subject)
            seq = state.append_enrollment(
                emb, labels, subject=subject, label=label,
                apply_fn=lambda e=emb, l=labels: writer_gallery.add(e, l))
            acked.append((seq, emb, labels, subject, label))
        for reader in readers:
            reader["replica"].poll(force=True)

    try:
        warm_enroll(3)
        # ---- phase A: baseline interactive p99 across the healthy
        # fleet. Enrollment churn runs from the START — the baseline and
        # the survivor phases must differ only in the kills, or the
        # comparison charges replication's background gallery applies to
        # the failover ----
        enroll_thread.start()
        base_seqs = []
        base_end = time.monotonic() + min(1.0, seconds / 4)
        while time.monotonic() < base_end:
            base_seqs.append(offer())
            time.sleep(1.0 / 40.0)
        for svc in [writer_box["svc"]] + [r["svc"] for r in readers]:
            svc.drain(timeout=15.0)
        base_p99_ms = recorder.percentile_ms(base_seqs, 99)

        # ---- phase B: traffic + enrollment, kill a reader, kill the
        # writer ----
        interval = 1.0 / offered_hz
        t0 = time.monotonic()
        reader_kill_at = t0 + seconds * 0.33
        writer_kill_at = t0 + seconds * 0.62
        end_at = t0 + seconds
        reader_killed_t = writer_killed_t = None
        writer_restarted_t = None
        writer_lost_at_death = 0
        survivor_seqs_a: list = []   # after the reader kill
        survivor_seqs_b: list = []   # after the writer kill + failover
        split_brain_rc = None
        while True:
            now = time.monotonic()
            if now >= end_at and writer_restarted_t is not None \
                    and now >= writer_restarted_t + max(0.6, seconds * 0.15):
                break
            if now >= t0 + seconds * 3 + 30.0:
                break  # hard stop: the kill schedule wedged somewhere
            seq = offer()
            if reader_killed_t is not None and now > reader_killed_t + 0.3 \
                    and (writer_killed_t is None):
                survivor_seqs_a.append(seq)
            if writer_restarted_t is not None \
                    and now > writer_restarted_t + 0.5:
                survivor_seqs_b.append(seq)
            if reader_killed_t is None and now >= reader_kill_at:
                # Kill read replica 1 mid-traffic (simulated process
                # death: its serving loop and WAL tail stop cold).
                readers[1]["svc"].stop()
                reader_killed_t = time.monotonic()
            if writer_killed_t is None and now >= writer_kill_at:
                # Kill the writer mid-enrollment: the next WAL append
                # dies torn (the enrollment thread exits un-acked), and
                # the writer's serving side stops with it.
                injector.script("wal", "torn")
                deadline = time.monotonic() + 10.0
                while (not writer_died.is_set()
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                writer_box["svc"].stop()
                # Frames physically inside the dying writer (queued or
                # in-flight) die with the "process": the shared writer
                # metrics will carry them as in_system forever — record
                # the exact remainder for the ledger check.
                dead_writer = writer_box["svc"]
                with dead_writer._inflight_cv:
                    writer_lost_at_death = (
                        dead_writer.batcher.pending
                        + sum(entry[3] for entry in dead_writer._inflight))
                lease.release()  # a dead process's flock vanishes with it
                writer_killed_t = time.monotonic()
            if (writer_killed_t is not None and writer_restarted_t is None
                    and now >= writer_killed_t + max(0.3, seconds * 0.08)):
                # ---- writer restart: recover + re-acquire the lease ----
                new_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
                new_names: list = []
                lease = WriterLease(state_dir,
                                    metrics=writer_metrics).acquire()
                state = StateLifecycle(
                    state_dir, metrics=writer_metrics,
                    checkpoint_wal_rows=16, checkpoint_every_s=1e9,
                    tracer=tracer)
                state.recover(new_gallery, new_names)
                verify_gallery(new_gallery, "writer recovery")
                writer_gallery = new_gallery
                writer_names = new_names
                new_svc = make_service(new_gallery, writer_metrics)
                new_svc.start(warmup=False)
                # Rewire the router at the restarted service's fresh
                # connector (fan-in re-subscribes there — results from
                # the new writer must reach the recorder, or the
                # post-restart p99 would silently measure readers only);
                # the dynamic probe sees the new service via writer_box.
                writer_box["svc"] = new_svc
                router.replace_connector("writer", new_svc.connector)
                writer_restarted_t = time.monotonic()
                # Resume enrollment on the recovered writer.
                enroll_stop.clear()
                writer_died.clear()

                def enroll_loop2(state=state, gallery=new_gallery,
                                 names=new_names):
                    while not enroll_stop.is_set():
                        n = rng.randint(1, 2)
                        emb = frame_rng.normal(size=(n, DIM)).astype(
                            np.float32)
                        label = len(names)
                        subject = f"subject_{len(acked)}"
                        labels = np.full(n, label, np.int32)
                        names.append(subject)
                        try:
                            seq = state.append_enrollment(
                                emb, labels, subject=subject, label=label,
                                apply_fn=lambda e=emb, l=labels:
                                    gallery.add(e, l))
                        except InjectedCrashError:
                            names.pop()
                            return
                        acked.append((seq, emb, labels, subject, label))
                        time.sleep(0.015)

                enroll_thread = threading.Thread(target=enroll_loop2,
                                                 daemon=True)
                enroll_thread.start()
            time.sleep(interval)
        enroll_stop.set()
        enroll_thread.join(timeout=5.0)

        # ---- phase C: settle, catch up, verify ----
        # Split-brain probe in a REAL second process while the
        # (re-acquired) lease is live: acquiring must fail closed (rc 3).
        # Run here, not mid-traffic — the child pays ~4 s of imports and
        # must probe while a lease is provably held, never during the
        # crash window between release and re-acquire.
        code = (
            "import sys\n"
            "from opencv_facerecognizer_tpu_torch.runtime.replication "
            "import WriterLease, WriterLeaseHeldError\n"
            "try:\n"
            f"    WriterLease({state_dir!r}).acquire()\n"
            "except WriterLeaseHeldError:\n"
            "    sys.exit(3)\n"
            "sys.exit(0)\n")
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, timeout=120,
            cwd=_REPO_ROOT)
        split_brain_rc = proc.returncode
        writer_box["svc"].drain(timeout=15.0)
        readers[0]["svc"].drain(timeout=15.0)
        target_seq = state.wal_seq
        catch_deadline = time.monotonic() + 15.0
        while (readers[0]["replica"].applied_seq < target_seq
               and time.monotonic() < catch_deadline):
            time.sleep(0.02)
        # A replacement replica (the killed reader's "process restart"):
        # fresh gallery, full resync from checkpoint + WAL.
        replacement_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        replacement = ReadReplica(state_dir, replacement_gallery, [],
                                  metrics=Metrics(), tracer=tracer,
                                  poll_interval_s=0.0, name="replacement")
        replacement.poll(force=True)

        verify_gallery(writer_gallery, "writer (post-restart)")
        verify_gallery(readers[0]["gallery"], "surviving reader")
        verify_gallery(replacement_gallery, "replacement replica")
        if readers[0]["replica"].applied_seq < target_seq:
            failures.append(
                f"surviving reader never caught up: applied "
                f"{readers[0]['replica'].applied_seq} < {target_seq}")

        p99_a = recorder.percentile_ms(survivor_seqs_a, 99)
        p99_b = recorder.percentile_ms(survivor_seqs_b, 99)
        ledgers = {
            "writer": writer_box["svc"].ledger(),
            "reader-0": readers[0]["svc"].ledger(),
            "reader-1": readers[1]["svc"].ledger(),
        }
        # The killed reader's remainder: frames physically inside the
        # dead service — queued in its batcher or riding an in-flight
        # batch its readback worker never completed. A real kill loses
        # them with the process; the in-process emulation keeps the
        # metrics alive, so its exactness check is in_system == that
        # remainder (every OTHER admitted frame is completed or in a
        # named drop bucket).
        dead_svc = readers[1]["svc"]
        with dead_svc._inflight_cv:
            inflight_frames = sum(entry[3] for entry in dead_svc._inflight)
        reader1_queued_at_death = dead_svc.batcher.pending + inflight_frames
    finally:
        enroll_stop.set()
        router.stop()
        for svc in [writer_box["svc"]] + [r["svc"] for r in readers]:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                import traceback

                traceback.print_exc()
        lease.release()
        state.close()

    report.update({
        "offered": seq_box["seq"],
        "acked_enrollments": len(acked),
        "baseline_p99_ms": None if base_p99_ms != base_p99_ms
        else round(base_p99_ms, 1),
        "survivor_p99_after_reader_kill_ms":
            None if p99_a != p99_a else round(p99_a, 1),
        "survivor_p99_after_writer_restart_ms":
            None if p99_b != p99_b else round(p99_b, 1),
        "split_brain_rc": split_brain_rc,
        "ledgers": ledgers,
        "router": {k: v for k, v in router_metrics.counters().items()},
        "reader0": readers[0]["replica"].stats(),
        "replacement": replacement.stats(),
    })

    # ---- pass criteria ----
    if base_p99_ms != base_p99_ms:
        failures.append("no baseline frame completed")
    # +100 ms absolute floor (vs the overload soak's 50): the writer
    # restart window legitimately carries recovery churn on a 1-core
    # box, and a sub-50 ms baseline would turn that scheduler noise into
    # a false failure.
    for label, p99 in (("reader kill", p99_a), ("writer restart", p99_b)):
        if p99 != p99:
            failures.append(f"no survivor frame completed after {label}")
        elif base_p99_ms == base_p99_ms and p99 > 2.0 * base_p99_ms + 100.0:
            failures.append(
                f"survivor p99 after {label} blew the budget: "
                f"{p99:.0f} ms > 2x baseline {base_p99_ms:.0f} ms + 100 ms")
    if split_brain_rc != 3:
        failures.append(f"split-brain second writer did NOT fail closed "
                        f"(subprocess rc={split_brain_rc}, expected 3)")
    for name, ledger in ledgers.items():
        # Survivors settle to exactly zero; the KILLED reader settles to
        # exactly its queued-at-death remainder (those frames died with
        # the "process" — every other admitted frame is completed or in a
        # named drop bucket).
        expect = {"reader-1": reader1_queued_at_death,
                  "writer": writer_lost_at_death}.get(name, 0)
        if abs(ledger["in_system"] - expect) > 1e-6:
            failures.append(f"{name} ledger unsettled (expected in_system="
                            f"{expect}): {ledger}")
    report["reader1_queued_at_death"] = reader1_queued_at_death
    report["writer_lost_at_death"] = writer_lost_at_death
    wal_tail_spans = [s for s in tracer.snapshot(topic="_lifecycle")
                     if s.get("stage") == "wal_tail"]
    if not wal_tail_spans:
        failures.append("no wal_tail lifecycle spans recorded")
    failover_dumps = glob.glob(os.path.join(trace_dir,
                                            "flight-*failover*.json"))
    if not failover_dumps:
        failures.append("failover left no flight-recorder dump")
    _check_flight_dumps(trace_dir, failures, require=1)
    tracer.dump("replication_end", extra={"acked": len(acked)}, force=True)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if temp_dir:
        shutil.rmtree(state_dir, ignore_errors=True)

    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_rollout(seconds: float = 6.0, seed: int | None = None,
                state_dir: str | None = None) -> dict:
    """Embedder-rollout scenario: 1 writer + 2
    WAL-tailing read replicas behind the topic router serve live traffic
    while the writer rolls a NEW embedder out — staged background
    re-embed, dual-score parity window, WAL cutover fence, atomic swap,
    replica re-anchor — with deterministic kills at every rollout
    boundary:

    - **kill mid-re-embed** (torn stage append + full writer restart):
      the restarted writer's coordinator must RESUME from the durable
      watermark and the fleet stays on the old version, zero acked loss;
    - **kill mid-cutover** (crash after the WAL fence record, before the
      in-memory swap/checkpoint): the restarted writer's recovery must
      COMPLETE the cutover from the staged shard set — the fleet lands on
      the new version with every acked enrollment re-embedded, zero loss;
    - **kill a reader mid-re-anchor** (stopped while parked on the
      fence): its replacement resyncs straight onto the new-version
      checkpoint (the late-start shape) and matches bit-for-bit.

    Pass criteria (any miss -> ``ok: False``):

    1. **zero acked loss** — after the dust settles, writer, surviving
       reader and the replacement replica all hold exactly: every
       pre-cutover acked enrollment RE-EMBEDDED into the new space, plus
       every post-cutover acked enrollment, in order;
    2. **no mixed-version scores** — every published result carries the
       ``embedder_version`` its batch was scored against, and each
       replica's stamp stream is a clean old->new monotonic step (never
       interleaved, never any version outside {old, new});
    3. **serving never blanks** — fleet-wide, the gap between consecutive
       completed frames through the whole cutover window stays bounded,
       and every surviving replica keeps completing frames after its
       re-anchor (the router cordon drained it through the checkpoint
       reload instead of letting its queue rot);
    4. **fencing live** — an enrollment stamped with the OLD embedder
       version after the cutover is refused closed
       (``EmbedderVersionMismatchError``), and the offline verifier's
       version walk passes over the final state dir (rc 0).
    """
    import random as random_mod
    import threading

    import numpy as np

    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReadReplica, ReplicaHandle, TopicRouter, WriterLease)
    from opencv_facerecognizer_tpu_torch.runtime.resilience import ResiliencePolicy
    from opencv_facerecognizer_tpu_torch.runtime.rollout import RolloutCoordinator
    from opencv_facerecognizer_tpu_torch.runtime.state_store import (
        EmbedderVersionMismatchError, StateLifecycle)
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        InstantPipeline, TrafficRecorder,
    )
    from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RESULT_TOPIC
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        service_health_probe,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak rollout seed={seed} seconds={seconds}",
          file=sys.stderr)
    rng = random_mod.Random(seed)
    frame_rng = np.random.default_rng(seed)

    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_rollout_")
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 16, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.1)
    DIM = 8
    frame_shape = (32, 32)
    dispatch_s = 0.01
    offered_hz = 50.0
    topics = 12
    OLD_V, NEW_V = 1, 2

    # The two embedding spaces: old = the row itself; new = a fixed
    # orthogonal rotation of it (seeded — deterministic across the
    # scenario's restarts, as the stage-resume contract requires). The
    # parity embedders map a synthetic "crop" (an identity's code folded
    # to 2x4) into each space the same way.
    Q, _ = np.linalg.qr(frame_rng.normal(size=(DIM, DIM)))
    Q = Q.astype(np.float32)

    def reembed(rows):
        return np.asarray(rows, np.float32) @ Q

    def old_embed(crops):
        return np.asarray(crops, np.float32).reshape(len(crops), -1)[:, :DIM]

    def new_embed(crops):
        return old_embed(crops) @ Q

    report = {"scenario": "rollout", "seed": seed, "seconds": seconds,
              "state_dir": state_dir, "ok": False}
    failures: list = []

    #: acked enrollments: (version_at_ack, emb, labels, subject, label)
    acked: list = []

    def expected_rows(current_version):
        """Every acked row in the CURRENT version's space: pre-cutover
        rows re-embedded through Q, post-cutover rows as enrolled."""
        if not acked:
            return (np.zeros((0, DIM), np.float32),
                    np.zeros((0,), np.int32))
        embs, labs = [], []
        for ver, emb, labels, _su, _la in acked:
            norm = emb / np.maximum(
                np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
            if current_version == NEW_V and ver == OLD_V:
                norm = norm @ Q
                norm = norm / np.maximum(
                    np.linalg.norm(norm, axis=-1, keepdims=True), 1e-12)
            embs.append(norm)
            labs.append(labels)
        return (np.concatenate(embs).astype(np.float32),
                np.concatenate(labs).astype(np.int32))

    def verify_gallery(gallery, current_version, where):
        want_emb, want_lab = expected_rows(current_version)
        got_emb, got_lab, _v, got_size = gallery.snapshot()
        if got_size != len(want_lab):
            failures.append(f"{where}: {got_size} rows, expected "
                            f"{len(want_lab)} acked (seed={seed})")
            return
        if got_size and not np.array_equal(got_lab[:got_size], want_lab):
            failures.append(f"{where}: labels differ")
        elif got_size and not np.allclose(got_emb[:got_size], want_emb,
                                          rtol=0, atol=1e-5):
            failures.append(f"{where}: embeddings differ")

    def make_service(gallery, metrics):
        pipe = InstantPipeline(frame_shape, dispatch_s=dispatch_s,
                               faces_per_frame=1)
        pipe.gallery = gallery
        return RecognizerService(
            pipe, FakeConnector(), batch_size=8, frame_shape=frame_shape,
            flush_timeout=0.02, inflight_depth=2, similarity_threshold=0.0,
            metrics=metrics,
            resilience=ResiliencePolicy(readback_deadline_s=2.0))

    # ---- fleet: writer + 2 readers + router ----
    injector = FaultInjector(seed=seed)
    writer_metrics = Metrics()
    lease = WriterLease(state_dir, metrics=writer_metrics).acquire()
    writer_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu",
                                    embedder_version=OLD_V)
    writer_names: list = []
    state = StateLifecycle(state_dir, metrics=writer_metrics,
                           checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9,
                           fault_injector=injector, tracer=tracer)
    state.bind(writer_gallery, writer_names)
    writer_box = {"svc": make_service(writer_gallery, writer_metrics)}

    def enroll_burst(n):
        """Synchronous acked enrollments in the CURRENT serving space
        (after the cutover the 'new model' produces new-space vectors
        directly). Deterministic — the kill schedule owns all timing."""
        for _ in range(n):
            rows = rng.randint(1, 2)
            emb = frame_rng.normal(size=(rows, DIM)).astype(np.float32)
            label = len(writer_names)
            subject = f"subject_{len(acked)}"
            labels = np.full(rows, label, np.int32)
            version = int(writer_gallery.embedder_version)
            writer_names.append(subject)
            state.append_enrollment(
                emb, labels, subject=subject, label=label,
                embedder_version=version,
                apply_fn=lambda e=emb, l=labels: writer_gallery.add(e, l))
            acked.append((version, emb, labels, subject, label))

    enroll_burst(4)

    readers = []
    for i in range(2):
        rmetrics = Metrics()
        rgallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        rnames: list = []
        rep = ReadReplica(state_dir, rgallery, rnames, metrics=rmetrics,
                          tracer=tracer, poll_interval_s=0.02,
                          name=f"reader-{i}")
        rep.poll(force=True)
        readers.append({"replica": rep, "gallery": rgallery,
                        "names": rnames, "metrics": rmetrics,
                        "svc": None})
        readers[i]["svc"] = RecognizerService(
            InstantPipeline(frame_shape, dispatch_s=dispatch_s,
                            faces_per_frame=1),
            FakeConnector(), batch_size=8, frame_shape=frame_shape,
            flush_timeout=0.02, inflight_depth=2,
            similarity_threshold=0.0, metrics=rmetrics,
            resilience=ResiliencePolicy(readback_deadline_s=2.0),
            replica=rep)
        readers[i]["svc"].pipeline.gallery = rgallery

    router_metrics = Metrics()
    handles = [ReplicaHandle(
        "writer", writer_box["svc"].connector,
        health_fn=lambda: service_health_probe(writer_box["svc"])(),
        writer=True)]
    for i, reader in enumerate(readers):
        handles.append(ReplicaHandle(
            f"reader-{i}", reader["svc"].connector,
            health_fn=service_health_probe(reader["svc"])))
    router = TopicRouter(handles, metrics=router_metrics, tracer=tracer,
                         health_interval_s=0.05)
    # Cordon choreography: each reader's re-anchor drains its topics to
    # peers through the checkpoint reload (the never-blanks contract).
    for i, reader in enumerate(readers):
        reader["replica"].on_resync = router.cordon_hook(f"reader-{i}")
    recorder = TrafficRecorder(router)
    frame_msg = encode_frame(np.zeros(frame_shape, np.float32))

    #: per-replica-name published (monotonic time, embedder_version)
    #: stamps — the no-mixed-scores evidence.
    stamps: dict = {"writer": [], "reader-0": [], "reader-1": []}
    stamp_lock = threading.Lock()

    def watch_stamps(name, connector):
        def on_result(_t, message, _name=name):
            ver = message.get("embedder_version")
            if ver is not None:
                with stamp_lock:
                    stamps[_name].append((time.monotonic(), int(ver)))

        connector.subscribe(RESULT_TOPIC, on_result)

    watch_stamps("writer", writer_box["svc"].connector)
    for i, reader in enumerate(readers):
        watch_stamps(f"reader-{i}", reader["svc"].connector)

    seq_box = {"seq": 0}

    def pump(duration_s):
        """Offer interactive frames across the topic set for a while —
        traffic flows through EVERY phase, kills included."""
        interval = 1.0 / offered_hz
        end = time.monotonic() + duration_s
        while time.monotonic() < end:
            seq = seq_box["seq"]
            seq_box["seq"] = seq + 1
            recorder.send_t[seq] = time.monotonic()
            router.publish(f"camera/{seq % topics}",
                           {**frame_msg, "priority": "interactive",
                            "meta": {"seq": seq}})
            time.sleep(interval)

    def restart_writer(where):
        """Full writer 'process' restart: stop, drop the lease, recover a
        fresh gallery/lifecycle from disk, re-acquire, rewire the
        router."""
        nonlocal lease, state, writer_gallery, writer_names
        writer_box["svc"].stop()
        lease.release()
        state.close()
        new_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        new_names: list = []
        lease = WriterLease(state_dir, metrics=writer_metrics).acquire()
        state = StateLifecycle(state_dir, metrics=writer_metrics,
                               checkpoint_wal_rows=1 << 30,
                               checkpoint_every_s=1e9,
                               fault_injector=injector, tracer=tracer)
        recovery = state.recover(new_gallery, new_names)
        writer_gallery = new_gallery
        writer_names = new_names
        new_svc = make_service(new_gallery, writer_metrics)
        new_svc.start(warmup=False)
        writer_box["svc"] = new_svc
        router.replace_connector("writer", new_svc.connector)
        watch_stamps("writer", new_svc.connector)
        verify_gallery(new_gallery,
                       int(recovery.get("embedder_version", OLD_V)),
                       f"writer recovery ({where})")
        return recovery

    phase_t = {}
    try:
        writer_box["svc"].start(warmup=False)
        for reader in readers:
            reader["svc"].start(warmup=False)
        router.start()

        # ---- phase A: steady state on the old embedder ----
        pump(max(0.5, seconds * 0.15))
        enroll_burst(3)

        # ---- phase B: staged re-embed, killed mid-chunk ----
        coordinator = RolloutCoordinator(
            state, writer_gallery, reembed, NEW_V,
            old_embed_fn=old_embed, new_embed_fn=new_embed,
            parity_min_samples=8, parity_threshold=0.95, chunk_rows=3,
            metrics=writer_metrics, tracer=tracer, fault_injector=injector)
        coordinator.run_stage(max_chunks=2)  # some durable progress first
        if coordinator.stage.watermark <= 0:
            failures.append("stage made no durable progress before the "
                            "scripted kill")
        injector.script("stage", "torn")
        killed_mid_stage = False
        try:
            coordinator.run_stage(max_chunks=2)
        except InjectedCrashError:
            killed_mid_stage = True
        if not killed_mid_stage:
            failures.append("scripted stage kill never fired")
        watermark_at_kill = coordinator.stage.watermark
        report["watermark_at_stage_kill"] = watermark_at_kill
        pump(max(0.3, seconds * 0.1))  # fleet serves on through the kill
        restart_writer("after stage kill")
        # The restarted writer resumes staging from the durable watermark.
        coordinator = RolloutCoordinator(
            state, writer_gallery, reembed, NEW_V,
            old_embed_fn=old_embed, new_embed_fn=new_embed,
            parity_min_samples=8, parity_threshold=0.95, chunk_rows=3,
            metrics=writer_metrics, tracer=tracer, fault_injector=injector)
        writer_box["svc"].rollout = coordinator  # live-parity publish hook
        if not coordinator.stage.resumed \
                or coordinator.stage.watermark < watermark_at_kill:
            failures.append(
                f"stage did not resume from the durable watermark "
                f"(resumed={coordinator.stage.resumed}, watermark "
                f"{coordinator.stage.watermark} < {watermark_at_kill})")
        enroll_burst(2)  # rows landing BEHIND the stage: the delta path
        coordinator.run_stage()
        if not coordinator.caught_up:
            failures.append("stage never caught up after resume")

        # ---- phase C: dual-score parity window over live traffic ----
        pump(max(0.3, seconds * 0.1))  # the publish hook samples crops
        # Direct identity queries: noisy copies of enrolled rows folded
        # into crop shape — the parity signal the gate decides on.
        crops = []
        for ver, emb, _labels, _su, _la in acked[:8]:
            row = emb[0] / max(np.linalg.norm(emb[0]), 1e-12)
            if ver != OLD_V:
                continue  # queries arrive in the OLD space pre-cutover
            crops.append(row.reshape(2, 4))
        coordinator.score_parity(crops)
        report["parity"] = coordinator.status()["parity"]
        if not coordinator.parity_ok():
            failures.append(f"parity gate never opened: "
                            f"{report['parity']}")

        # ---- phase D: cutover, killed after the WAL fence ----
        phase_t["cutover_start"] = time.monotonic()
        injector.script("cutover", "crash_after_record")
        try:
            coordinator.cutover()
            failures.append("scripted cutover kill never fired")
        except InjectedCrashError:
            pass
        pump(max(0.3, seconds * 0.1))  # readers park on the fence; serve on
        awaiting = [bool(r["replica"].stats()["awaiting_cutover"])
                    for r in readers]
        report["readers_awaiting_at_fence"] = awaiting
        if not any(awaiting):
            failures.append("no reader parked on the cutover fence while "
                            "the writer was down")
        # Kill reader-1 mid-re-anchor: parked on the fence, dies before
        # the new-version checkpoint ever lands.
        readers[1]["svc"].stop()
        recovery = restart_writer("after cutover kill")
        if not recovery.get("completed_cutover"):
            failures.append(f"recovery did not complete the fenced "
                            f"cutover: {recovery}")
        if int(recovery.get("embedder_version", 0)) != NEW_V:
            failures.append(f"writer recovered at v"
                            f"{recovery.get('embedder_version')}, not "
                            f"v{NEW_V}")
        # The post-cutover checkpoint (recover latched a forced one; take
        # it synchronously so the reader re-anchor window is bounded).
        if not state.checkpoint_now(wait=True):
            failures.append("post-cutover checkpoint failed")
        enroll_burst(3)  # the new model enrolls straight into v2

        # ---- phase E: surviving reader re-anchors through the cordon ----
        deadline = time.monotonic() + 15.0
        while (readers[0]["replica"].embedder_version != NEW_V
               and time.monotonic() < deadline):
            pump(0.1)
        phase_t["reanchor_end"] = time.monotonic()
        if readers[0]["replica"].embedder_version != NEW_V:
            failures.append("surviving reader never re-anchored onto the "
                            "new-version checkpoint")
        pump(max(0.3, seconds * 0.1))  # post-re-anchor serving
        # Catch-up: the reader applies the post-cutover v2 enrollments.
        target = state.wal_seq
        deadline = time.monotonic() + 10.0
        while (readers[0]["replica"].applied_seq < target
               and time.monotonic() < deadline):
            readers[0]["replica"].poll(force=True)
            time.sleep(0.02)

        # ---- phase F: live fence + replacement replica + verification --
        try:
            state.append_enrollment(
                np.zeros((1, DIM), np.float32), np.zeros(1, np.int32),
                embedder_version=OLD_V)
            failures.append("old-version enrollment was NOT refused after "
                            "the cutover (fence breach)")
        except EmbedderVersionMismatchError:
            report["stale_enroll_refused"] = True
        replacement_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        replacement = ReadReplica(state_dir, replacement_gallery, [],
                                  metrics=Metrics(), tracer=tracer,
                                  poll_interval_s=0.0, name="replacement")
        replacement.poll(force=True)
        for svc in [writer_box["svc"], readers[0]["svc"]]:
            svc.drain(timeout=15.0)
        verify_gallery(writer_gallery, NEW_V, "writer (post-rollout)")
        verify_gallery(readers[0]["gallery"], NEW_V, "surviving reader")
        verify_gallery(replacement_gallery, NEW_V, "replacement replica")
        if replacement.embedder_version != NEW_V:
            failures.append("late-start replacement did not anchor at the "
                            "new version")
    finally:
        router.stop()
        for svc in [writer_box["svc"]] + [r["svc"] for r in readers]:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                import traceback

                traceback.print_exc()
        lease.release()
        state.close()

    # ---- verdicts ----
    with stamp_lock:
        stamp_view = {k: list(v) for k, v in stamps.items()}
    report["result_stamps"] = {
        k: {"total": len(v),
            "versions": sorted({ver for _t, ver in v})}
        for k, v in stamp_view.items()}
    for name, series in stamp_view.items():
        versions = [ver for _t, ver in series]
        if not versions:
            failures.append(f"{name}: published no version-stamped results")
            continue
        if any(v not in (OLD_V, NEW_V) for v in versions):
            failures.append(f"{name}: stamp outside {{v1, v2}}: "
                            f"{sorted(set(versions))}")
        if versions != sorted(versions):
            # One clean old->new step per replica — an interleaved stream
            # means a result was scored against one version while the
            # stamp (or the gallery) said another.
            failures.append(f"{name}: version stamps interleave "
                            f"(mixed-version serving): {versions}")
    # reader-1 died pre-cutover: it must never have stamped v2.
    if any(ver == NEW_V for _t, ver in stamp_view["reader-1"]):
        failures.append("the reader killed mid-re-anchor published a "
                        "new-version result")
    # Serving continuity through the cutover window: fleet-wide completed
    # frames never gap beyond a bound, and the survivors kept completing
    # AFTER their re-anchor.
    window = (phase_t.get("cutover_start"), phase_t.get("reanchor_end"))
    if None not in window:
        done_ts = sorted(t for t in recorder.done_t.values()
                         if window[0] - 0.5 <= t <= window[1] + 0.5)
        report["cutover_window_completions"] = len(done_ts)
        if len(done_ts) < 2:
            failures.append("serving blanked through the cutover window "
                            f"({len(done_ts)} completions)")
        else:
            max_gap = max(b - a for a, b in zip(done_ts, done_ts[1:]))
            report["cutover_window_max_gap_s"] = round(max_gap, 3)
            if max_gap > 2.0:
                failures.append(f"completed-frames gap {max_gap:.2f}s "
                                f"through the cutover (serving blanked)")
        for name in ("writer", "reader-0"):
            after = [1 for t, _v in stamp_view[name]
                     if t > window[1]]
            if not after:
                failures.append(f"{name}: no completions after its "
                                f"re-anchor (never drained back in)")
    if not router_metrics.counter("router_cutover_drains"):
        failures.append("router never cordoned a replica through its "
                        "re-anchor (the drain choreography is unwired)")

    # Offline verifier: the final state dir's version fences must parse
    # clean (checkpoint header + WAL version walk).
    from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint as verify_mod

    vreport = verify_mod.verify_state_dir(state_dir)
    report["verify"] = {"ok": vreport["ok"],
                        "embedder_version": vreport.get("embedder_version"),
                        "violations": (vreport.get("wal") or {}).get(
                            "version_violations")}
    if not vreport["ok"]:
        failures.append(f"offline verifier failed on the final state dir: "
                        f"{report['verify']}")
    if vreport.get("embedder_version") != NEW_V:
        failures.append(f"final checkpoint serves v"
                        f"{vreport.get('embedder_version')}, not v{NEW_V}")

    cutover_spans = [s for s in tracer.snapshot(topic="_lifecycle")
                     if s.get("stage") in ("cutover", "rollout_phase")]
    if not cutover_spans:
        failures.append("no rollout lifecycle spans recorded")
    _check_flight_dumps(trace_dir, failures, require=0)
    tracer.dump("rollout_end", extra={"acked": len(acked)}, force=True)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if temp_dir:
        shutil.rmtree(state_dir, ignore_errors=True)

    report["acked_enrollments"] = len(acked)
    report["offered"] = seq_box["seq"]
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_registry(seconds: float = 6.0, seed: int | None = None,
                 state_dir: str | None = None) -> dict:
    """Model-registry scenario: 1 writer + 2
    WAL-tailing read replicas behind the topic router serve live traffic
    while the writer swaps the DETECTOR through the versioned model
    registry — live detection-parity window, ``registry_cutover`` WAL
    fence, atomic manifest install, replica re-anchor — with
    deterministic kills at every swap boundary:

    - **kill before the fence** (``crash_before_record``): nothing was
      fenced, the fleet stays on the old detector, no seq burned;
    - **kill mid-swap** (``crash_after_record`` — after the WAL fence,
      before the manifest install): the restarted writer's recovery must
      COMPLETE the swap from the fence + staged params (sha256 verifies),
      and the parked readers re-anchor onto the post-swap checkpoint;
    - **kill mid-swap with damaged params** (cascade role): recovery must
      CLEANLY ABANDON — ``registry_abort`` tombstone, the role stays at
      the old version, the candidate number is retired, never reused;
    - **parity-regressing candidate**: a detector that passes the
      pre-cutover gate but regresses on post-cutover traffic is
      auto-rolled-back inside the watch window at the next monotonic
      version, with a parseable flight-recorder dump carrying the full
      swap status.

    Pass criteria (any miss -> ``ok: False``):

    1. **zero acked loss, bit-equal** — writer, both surviving readers
       and a late-start replacement replica hold byte-identical
       galleries covering every acked enrollment (registry swaps never
       re-embed: rows are untouched by construction, so equality is
       EXACT, not approximate);
    2. **never mixed-version serving** — every published result carries
       the full registry stamp of the model set its batch was dispatched
       under; per replica the detector stamp stream is monotonic
       non-decreasing, every stamped version was fenced, and the
       ABANDONED cascade candidate version never appears in any
       published result (no result from an unfenced model version);
    3. **exact per-replica ledgers** — each replica's stamped-result
       ledger and applied-row count are reported exactly, and the
       offline verifier's multi-role registry walk passes over the final
       state dir (manifest checksum + per-role fence continuity, rc 0).
    """
    import random as random_mod
    import threading

    import numpy as np

    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.registry import (
        ModelRegistry, RegistrySwapCoordinator, registry_params_path)
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        ReadReplica, ReplicaHandle, TopicRouter, WriterLease)
    from opencv_facerecognizer_tpu_torch.runtime.resilience import ResiliencePolicy
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        InstantPipeline, TrafficRecorder,
    )
    from opencv_facerecognizer_tpu_torch.runtime.faults import InjectedCrashError
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RESULT_TOPIC
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        service_health_probe,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak registry seed={seed} seconds={seconds}",
          file=sys.stderr)
    rng = random_mod.Random(seed)
    frame_rng = np.random.default_rng(seed)

    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_registry_")
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 16, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.1)
    DIM = 8
    frame_shape = (32, 32)
    dispatch_s = 0.01
    offered_hz = 50.0
    topics = 12

    # Synthetic detectors: yxyx verdict boxes over the 32x32 frames. The
    # serving detector is a version-keyed closure over ``serving_box`` —
    # install_fn IS the one attribute publish the real pipeline does
    # (same-architecture swap, zero recompiles).
    serving_box = {"detector": 1}

    def detect_v1(frame):
        del frame
        return [(8.0, 8.0, 24.0, 24.0)]

    def detect_v2(frame):
        del frame
        return [(9.0, 9.0, 25.0, 25.0)]  # IoU ~0.78 vs v1: agrees

    #: the regressing candidate: agrees while the pre-cutover parity
    #: window looks, then drifts on post-cutover traffic (the exact
    #: failure the watch window + auto-rollback exist for).
    behave = {"good": True}

    def detect_v3(frame):
        if behave["good"]:
            return [(8.0, 9.0, 24.0, 25.0)]
        return [(0.0, 0.0, 6.0, 6.0)]  # disjoint: verdict mismatch

    report = {"scenario": "registry", "seed": seed, "seconds": seconds,
              "state_dir": state_dir, "ok": False}
    failures: list = []

    #: acked enrollments: (emb, labels, subject, label, detector_version)
    acked: list = []

    def make_service(gallery, metrics, registry=None, replica=None):
        pipe = InstantPipeline(frame_shape, dispatch_s=dispatch_s,
                               faces_per_frame=1)
        pipe.gallery = gallery
        svc = RecognizerService(
            pipe, FakeConnector(), batch_size=8, frame_shape=frame_shape,
            flush_timeout=0.02, inflight_depth=2, similarity_threshold=0.0,
            metrics=metrics,
            resilience=ResiliencePolicy(readback_deadline_s=2.0),
            replica=replica)
        svc.registry = registry
        return svc

    # ---- fleet: writer (registry attached) + 2 readers + router ----
    injector = FaultInjector(seed=seed)
    writer_metrics = Metrics()
    lease = WriterLease(state_dir, metrics=writer_metrics).acquire()
    writer_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
    writer_names: list = []
    state = StateLifecycle(state_dir, metrics=writer_metrics,
                           checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9,
                           fault_injector=injector, tracer=tracer)
    state.attach_registry(ModelRegistry(state_dir, metrics=writer_metrics))
    state.bind(writer_gallery, writer_names)
    writer_box = {"svc": make_service(writer_gallery, writer_metrics,
                                      registry=state.registry)}

    def enroll_burst(n):
        """Synchronous acked enrollments, stamped with the CURRENT
        registry (rows are never re-embedded by a registry swap — the
        ledger is bit-exact)."""
        for _ in range(n):
            rows = rng.randint(1, 2)
            emb = frame_rng.normal(size=(rows, DIM)).astype(np.float32)
            label = len(writer_names)
            subject = f"subject_{len(acked)}"
            labels = np.full(rows, label, np.int32)
            writer_names.append(subject)
            state.append_enrollment(
                emb, labels, subject=subject, label=label,
                embedder_version=1,
                apply_fn=lambda e=emb, l=labels: writer_gallery.add(e, l))
            acked.append((emb, labels, subject, label,
                          state.registry.version("detector")))

    enroll_burst(4)

    readers = []
    for i in range(2):
        rmetrics = Metrics()
        rgallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        rnames: list = []
        rep = ReadReplica(state_dir, rgallery, rnames, metrics=rmetrics,
                          tracer=tracer, poll_interval_s=0.02,
                          name=f"reader-{i}")
        rep.registry = ModelRegistry(state_dir, metrics=rmetrics,
                                     readonly=True)
        rep.poll(force=True)
        svc = make_service(rgallery, rmetrics, registry=rep.registry,
                           replica=rep)
        rep.on_registry_change = svc.flush_model_caches
        readers.append({"replica": rep, "gallery": rgallery,
                        "names": rnames, "metrics": rmetrics, "svc": svc})

    router_metrics = Metrics()
    handles = [ReplicaHandle(
        "writer", writer_box["svc"].connector,
        health_fn=lambda: service_health_probe(writer_box["svc"])(),
        writer=True)]
    for i, reader in enumerate(readers):
        handles.append(ReplicaHandle(
            f"reader-{i}", reader["svc"].connector,
            health_fn=service_health_probe(reader["svc"])))
    router = TopicRouter(handles, metrics=router_metrics, tracer=tracer,
                         health_interval_s=0.05)
    for i, reader in enumerate(readers):
        reader["replica"].on_resync = router.cordon_hook(f"reader-{i}")
    recorder = TrafficRecorder(router)
    frame_msg = encode_frame(np.zeros(frame_shape, np.float32))

    #: per-replica published (monotonic time, detector_v, cascade_v)
    #: registry-stamp ledger — the never-mixed-version evidence.
    stamps: dict = {"writer": [], "reader-0": [], "reader-1": []}
    stamp_lock = threading.Lock()

    def watch_stamps(name, connector):
        def on_result(_t, message, _name=name):
            reg = message.get("registry")
            if isinstance(reg, dict):
                with stamp_lock:
                    stamps[_name].append(
                        (time.monotonic(), int(reg.get("detector", 0)),
                         int(reg.get("cascade", 0))))

        connector.subscribe(RESULT_TOPIC, on_result)

    watch_stamps("writer", writer_box["svc"].connector)
    for i, reader in enumerate(readers):
        watch_stamps(f"reader-{i}", reader["svc"].connector)

    seq_box = {"seq": 0}

    def pump(duration_s):
        interval = 1.0 / offered_hz
        end = time.monotonic() + duration_s
        while time.monotonic() < end:
            seq = seq_box["seq"]
            seq_box["seq"] = seq + 1
            recorder.send_t[seq] = time.monotonic()
            router.publish(f"camera/{seq % topics}",
                           {**frame_msg, "priority": "interactive",
                            "meta": {"seq": seq}})
            time.sleep(interval)

    def stage_params(role, version):
        """Stage a deterministic candidate params blob at the runbook
        path and return (path, bytes) — durable BEFORE any fence, as the
        swap protocol requires."""
        from opencv_facerecognizer_tpu_torch.utils.serialization import (
            atomic_write_bytes,
        )
        path = registry_params_path(state_dir, role, version)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        blob = f"{role}-v{version}-params-{seed}".encode() * 64
        atomic_write_bytes(path, blob)
        return path

    def restart_writer(where):
        """Full writer 'process' restart: stop, drop the lease, recover
        from disk (recovery completes or abandons any fenced swap),
        re-acquire, rewire the router."""
        nonlocal lease, state, writer_gallery, writer_names
        writer_box["svc"].stop()
        lease.release()
        state.close()
        new_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        new_names: list = []
        lease = WriterLease(state_dir, metrics=writer_metrics).acquire()
        state = StateLifecycle(state_dir, metrics=writer_metrics,
                               checkpoint_wal_rows=1 << 30,
                               checkpoint_every_s=1e9,
                               fault_injector=injector, tracer=tracer)
        recovery = state.recover(new_gallery, new_names)
        if state.registry is None:
            failures.append(f"writer recovery ({where}) attached no "
                            f"registry despite the durable manifest")
            state.attach_registry(
                ModelRegistry(state_dir, metrics=writer_metrics))
        writer_gallery = new_gallery
        writer_names = new_names
        new_svc = make_service(new_gallery, writer_metrics,
                               registry=state.registry)
        new_svc.start(warmup=False)
        writer_box["svc"] = new_svc
        router.replace_connector("writer", new_svc.connector)
        watch_stamps("writer", new_svc.connector)
        return recovery

    def await_reader_registry(role, version, where, deadline_s=15.0):
        """Poll the readers through their re-anchor until both manifest
        views serve ``role`` at ``version``."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            views = [r["replica"].stats()["registry"] for r in readers]
            if all(v is not None and v.get(role) == version for v in views):
                return
            pump(0.1)
            for r in readers:
                r["replica"].poll(force=True)
        failures.append(
            f"{where}: readers never re-anchored onto {role} v{version}: "
            f"{[r['replica'].stats()['registry'] for r in readers]}")

    parity_frames = [frame_rng.normal(size=frame_shape).astype(np.float32)
                     for _ in range(24)]
    phase_t = {}
    try:
        writer_box["svc"].start(warmup=False)
        for reader in readers:
            reader["svc"].start(warmup=False)
        router.start()

        # ---- phase A: steady state, everything at v1 ----
        pump(max(0.4, seconds * 0.1))

        # ---- phase B0: kill BEFORE the fence (nothing durable moves) --
        v2_path = stage_params("detector", 2)
        coordinator = RegistrySwapCoordinator(
            state, state.registry, "detector", 2,
            old_detect_fn=detect_v1, new_detect_fn=detect_v2,
            params_path=v2_path, parity_min_samples=8,
            install_fn=lambda: serving_box.__setitem__("detector", 2),
            metrics=writer_metrics, tracer=tracer)
        coordinator.score_parity(parity_frames[:12])
        if not coordinator.parity_ok():
            failures.append("detector v2 parity gate never opened: "
                            f"{coordinator.status()['parity']}")
        injector.script("cutover", "crash_before_record")
        try:
            coordinator.cutover()
            failures.append("scripted pre-fence kill never fired")
        except InjectedCrashError:
            pass
        if state.registry.version("detector") != 1:
            failures.append("pre-fence kill moved the manifest")
        seq_before = state.wal_seq

        # ---- phase B: kill mid-swap (fenced, manifest not installed) --
        phase_t["swap_start"] = time.monotonic()
        injector.script("cutover", "crash_after_record")
        try:
            coordinator.cutover()
            failures.append("scripted mid-swap kill never fired")
        except InjectedCrashError:
            pass
        if state.wal_seq <= seq_before:
            failures.append("mid-swap kill burned no fence seq")
        pump(max(0.3, seconds * 0.1))  # readers hit the fence; serve on
        for r in readers:
            r["replica"].poll(force=True)
        awaiting = [bool(r["replica"].stats()["awaiting_cutover"])
                    for r in readers]
        report["readers_parked_at_fence"] = awaiting
        if not any(awaiting):
            failures.append("no reader parked on the registry fence "
                            "while the writer was down")
        recovery = restart_writer("after mid-swap kill")
        completed = recovery.get("completed_registry_swaps") or []
        if not any(e["role"] == "detector" and e["to_version"] == 2
                   for e in completed):
            failures.append(f"recovery did not complete the fenced "
                            f"detector swap: {recovery}")
        if state.registry.version("detector") != 2:
            failures.append(f"writer recovered with detector v"
                            f"{state.registry.version('detector')}, not v2")
        if not state.checkpoint_now(wait=True):
            failures.append("post-swap checkpoint failed")
        enroll_burst(3)  # rows stamped under detector v2
        await_reader_registry("detector", 2, "after completed swap")

        # ---- phase C: kill mid-swap, candidate DAMAGED -> abandon ----
        c2_path = stage_params("cascade", 2)
        coordinator = RegistrySwapCoordinator(
            state, state.registry, "cascade", 2, params_path=c2_path,
            metrics=writer_metrics, tracer=tracer)
        injector.script("cutover", "crash_after_record")
        try:
            coordinator.cutover(force=True)  # cascade: no parity fns wired
            failures.append("scripted cascade-swap kill never fired")
        except InjectedCrashError:
            pass
        with open(c2_path, "ab") as fh:
            fh.write(b"bitrot")  # the staged candidate no longer verifies
        recovery = restart_writer("after damaged-candidate kill")
        abandoned = recovery.get("abandoned_registry_swaps") or []
        if not any(e["role"] == "cascade" and e["to_version"] == 2
                   for e in abandoned):
            failures.append(f"recovery did not cleanly abandon the "
                            f"damaged cascade swap: {recovery}")
        if state.registry.version("cascade") != 1:
            failures.append(f"abandoned swap moved cascade to v"
                            f"{state.registry.version('cascade')}")
        if not state.checkpoint_now(wait=True):
            failures.append("post-abandon checkpoint failed")
        enroll_burst(2)  # still stamped cascade v1
        await_reader_registry("cascade", 1, "after abandoned swap")
        try:
            state.registry.install("cascade", 2)
            failures.append("retired cascade v2 was re-installable "
                            "(fence ambiguity)")
        except ValueError:
            report["retired_version_refused"] = True

        # ---- phase D: parity-regressing candidate -> auto-rollback ----
        v3_path = stage_params("detector", 3)
        coordinator = RegistrySwapCoordinator(
            state, state.registry, "detector", 3,
            old_detect_fn=detect_v2, new_detect_fn=detect_v3,
            params_path=v3_path, parity_min_samples=8,
            watch_min_samples=8,
            install_fn=lambda: serving_box.__setitem__("detector", 3),
            rollback_install_fn=lambda: serving_box.__setitem__(
                "detector", 2),
            flush_fn=writer_box["svc"].flush_model_caches,
            metrics=writer_metrics, tracer=tracer)
        writer_box["svc"].registry_swap = coordinator
        coordinator.score_parity(parity_frames[:12])
        if not coordinator.parity_ok():
            failures.append("regressing candidate failed the PRE-cutover "
                            "gate (the watch window is what must catch it)")
        coordinator.cutover()
        pump(max(0.3, seconds * 0.1))  # fleet serves v3 inside the watch
        behave["good"] = False  # the candidate drifts on live traffic
        coordinator.score_parity(parity_frames[12:])
        if coordinator.phase != "rolled_back":
            failures.append(f"watch regression did not auto-roll-back "
                            f"(phase {coordinator.phase})")
        if state.registry.version("detector") != 4:
            failures.append(f"rollback landed detector v"
                            f"{state.registry.version('detector')}, "
                            f"not the next monotonic v4")
        if serving_box["detector"] != 2:
            failures.append("rollback did not restore the previous "
                            "params in memory")
        writer_box["svc"].registry_swap = None
        report["auto_rollback"] = coordinator.status()
        enroll_burst(2)  # stamped detector v4
        await_reader_registry("detector", 4, "after auto-rollback")
        phase_t["swap_end"] = time.monotonic()
        pump(max(0.3, seconds * 0.1))

        # ---- phase E: drain + replacement replica + verification ----
        target = state.wal_seq
        deadline = time.monotonic() + 10.0
        while (any(r["replica"].applied_seq < target for r in readers)
               and time.monotonic() < deadline):
            for r in readers:
                r["replica"].poll(force=True)
            time.sleep(0.02)
        replacement_gallery = ShardedGallery(capacity=1024, dim=DIM, device="cpu")
        replacement_names: list = []
        replacement = ReadReplica(state_dir, replacement_gallery,
                                  replacement_names, metrics=Metrics(),
                                  tracer=tracer, poll_interval_s=0.0,
                                  name="replacement")
        replacement.registry = ModelRegistry(state_dir, readonly=True)
        replacement.poll(force=True)
        for svc in [writer_box["svc"]] + [r["svc"] for r in readers]:
            svc.drain(timeout=15.0)

        # Zero acked loss, bit-equal: registry swaps never touch rows,
        # so every gallery must hold byte-identical state.
        want_rows = sum(len(labels) for _e, labels, _s, _l, _d in acked)
        w_emb, w_lab, _v, w_size = writer_gallery.snapshot()
        if w_size != want_rows:
            failures.append(f"writer holds {w_size} rows, "
                            f"{want_rows} acked")
        ledgers = {}
        for name, gal, names_list in (
                [("writer", writer_gallery, writer_names)]
                + [(f"reader-{i}", r["gallery"], r["names"])
                   for i, r in enumerate(readers)]
                + [("replacement", replacement_gallery,
                    replacement_names)]):
            emb, lab, _v, size = gal.snapshot()
            ledgers[name] = {"rows": int(size),
                             "subjects": len(names_list)}
            if size != w_size:
                failures.append(f"{name}: {size} rows, writer has "
                                f"{w_size} (acked loss)")
                continue
            if not np.array_equal(emb[:size], w_emb[:w_size]) \
                    or not np.array_equal(lab[:size], w_lab[:w_size]):
                failures.append(f"{name}: gallery differs from the "
                                f"writer's bit-for-bit")
            if list(names_list) != list(writer_names):
                failures.append(f"{name}: subject ledger differs")
        report["replica_ledgers"] = ledgers
        final_stamp = replacement.stats()["registry"]
        if final_stamp is None or final_stamp.get("detector") != 4 \
                or final_stamp.get("cascade") != 1:
            failures.append(f"late-start replacement anchored on "
                            f"{final_stamp}, expected detector v4 / "
                            f"cascade v1")
    finally:
        router.stop()
        for svc in [writer_box["svc"]] + [r["svc"] for r in readers]:
            try:
                svc.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                import traceback

                traceback.print_exc()
        lease.release()
        state.close()

    # ---- verdicts ----
    with stamp_lock:
        stamp_view = {k: list(v) for k, v in stamps.items()}
    #: detector versions that were ever FENCED into the manifest; the
    #: abandoned cascade v2 is deliberately absent from the cascade set.
    fenced_detector = {1, 2, 3, 4}
    report["result_stamps"] = {
        k: {"total": len(v),
            "detector_versions": sorted({d for _t, d, _c in v}),
            "cascade_versions": sorted({c for _t, _d, c in v})}
        for k, v in stamp_view.items()}
    for name, series in stamp_view.items():
        if not series:
            failures.append(f"{name}: published no registry-stamped "
                            f"results")
            continue
        detectors = [d for _t, d, _c in series]
        if any(d not in fenced_detector for d in detectors):
            failures.append(f"{name}: detector stamp outside the fenced "
                            f"set: {sorted(set(detectors))}")
        if detectors != sorted(detectors):
            failures.append(f"{name}: detector stamps interleave "
                            f"(mixed-version serving): {detectors}")
        if any(c != 1 for _t, _d, c in series):
            failures.append(f"{name}: a result was published under the "
                            f"ABANDONED cascade candidate (unfenced "
                            f"model version)")
    # Serving continuity across all three swap windows.
    window = (phase_t.get("swap_start"), phase_t.get("swap_end"))
    if None not in window:
        done_ts = sorted(t for t in recorder.done_t.values()
                         if window[0] - 0.5 <= t <= window[1] + 0.5)
        report["swap_window_completions"] = len(done_ts)
        if len(done_ts) < 2:
            failures.append("serving blanked through the swap window "
                            f"({len(done_ts)} completions)")
        else:
            max_gap = max(b - a for a, b in zip(done_ts, done_ts[1:]))
            report["swap_window_max_gap_s"] = round(max_gap, 3)
            if max_gap > 2.0:
                failures.append(f"completed-frames gap {max_gap:.2f}s "
                                f"through the swaps (serving blanked)")

    # Offline verifier: manifest checksum + the multi-role registry walk
    # over the final WAL must pass (fence continuity per role).
    from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint as verify_mod

    vreport = verify_mod.verify_state_dir(state_dir)
    report["verify"] = {"ok": vreport["ok"],
                        "registry": vreport.get("registry"),
                        "violations": (vreport.get("wal") or {}).get(
                            "version_violations")}
    if not vreport["ok"]:
        failures.append(f"offline verifier failed on the final state "
                        f"dir: {report['verify']}")
    roles = (vreport.get("registry") or {}).get("roles") or {}
    if roles.get("detector") != 4 or roles.get("cascade") != 1:
        failures.append(f"verifier read manifest {roles}, expected "
                        f"detector v4 / cascade v1")

    # The auto-rollback's forensic artifact: a parseable flight dump
    # whose extra carries the full swap status.
    dumps = _check_flight_dumps(trace_dir, failures, require=1)
    rollback_dumps = [p for p in dumps if "registry_auto_rollback" in p]
    if not rollback_dumps:
        failures.append("auto-rollback left no flight dump")
    else:
        with open(rollback_dumps[-1]) as fh:
            dump = json.load(fh)
        swap_status = (dump.get("extra") or {}).get("registry_swap")
        if not isinstance(swap_status, dict) \
                or swap_status.get("role") != "detector" \
                or swap_status.get("to_version") != 3:
            failures.append(f"auto-rollback flight dump carries no "
                            f"parseable swap status: {swap_status}")
        else:
            report["rollback_dump"] = {
                "path": os.path.basename(rollback_dumps[-1]),
                "role": swap_status["role"],
                "to_version": swap_status["to_version"],
                "parity": swap_status.get("parity")}
    tracer.dump("registry_end", extra={"acked": len(acked)}, force=True)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if temp_dir:
        shutil.rmtree(state_dir, ignore_errors=True)

    report["acked_enrollments"] = len(acked)
    report["offered"] = seq_box["seq"]
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_disk(seconds: float = 6.0, seed: int | None = None,
             state_dir: str | None = None) -> dict:
    """Storage-fault scenario: the disk STAYS broken
    — ENOSPC mid-enrollment, EIO mid-checkpoint, slow fsync under load,
    disk-watermark pressure — and the writer must degrade, not die:

    - sustained WAL ENOSPC flips ``durability_degraded``: every
      enrollment is refused CLOSED (explicit status, zero acked loss),
      serving traffic keeps completing, non-critical sinks (dead-letter
      journal, span JSONL, flight dumps) shed with exact per-sink
      counters;
    - EIO on a checkpoint save counts ``checkpoint_failures`` and keeps
      the previous checkpoint last-known-good;
    - slow fsync slows acks but never lies (enrollments still durable);
    - the watermark ladder (deterministic fake statvfs): warn fires one
      preemptive WAL compaction + retention shrink, critical pre-empts
      the degraded flip BEFORE ENOSPC and 503s ``/health``; recovery
      restores retention, the probe re-arms, and a final restart
      recovers EXACTLY the acknowledged history bit-equal with offline
      verification rc 0.
    """
    import random as random_mod
    import types
    import urllib.error
    import urllib.request

    import numpy as np

    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.expo import ExpoServer
    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
    from opencv_facerecognizer_tpu_torch.runtime.resilience import (
        DurabilityDegradedError, DurabilityMonitor)
    from opencv_facerecognizer_tpu_torch.runtime.slo import SLOMonitor, disk_free_objective
    from opencv_facerecognizer_tpu_torch.runtime.state_store import (
        StateLifecycle, graceful_shutdown)
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import InstantPipeline
    from opencv_facerecognizer_tpu_torch.runtime.journal import DeadLetterJournal
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import (
        Tracer, make_span_journal,
    )

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak disk seed={seed} seconds={seconds}", file=sys.stderr)
    frame_rng = np.random.default_rng(seed)

    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_disk_")
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    DIM = 8
    frame_shape = (16, 16)
    #: deterministic pump size per phase, derived from the budget (not the
    #: wall clock) so a replay with the printed seed is exact.
    burst = max(12, min(48, int(seconds * 4)))
    watermark = 64 << 20

    report = {"scenario": "disk", "seed": seed, "seconds": seconds,
              "state_dir": state_dir, "ok": False}
    failures: list = []
    acked: list = []  # (seq, emb, labels, subject, label) — fsync-acked only

    metrics = Metrics(window_s=60.0, window_slices=20)
    injector = FaultInjector(seed=seed, slow_fsync_s=0.02)
    span_journal = make_span_journal(os.path.join(state_dir, "spans.jsonl"),
                                    metrics=metrics, fault_injector=injector)
    tracer = Tracer(ring_size=1 << 14, sample=1.0, seed=seed,
                    dump_dir=trace_dir, span_sink=span_journal,
                    metrics=metrics, fault_injector=injector)
    journal = DeadLetterJournal(os.path.join(state_dir, "dead_letter.jsonl"),
                                metrics=metrics, fault_injector=injector)
    gallery = ShardedGallery(capacity=64, dim=DIM, device="cpu")
    names: list = []
    state = StateLifecycle(state_dir, metrics=metrics,
                           checkpoint_wal_rows=1 << 30,
                           checkpoint_every_s=1e9,
                           fault_injector=injector, tracer=tracer)
    state.recover(gallery, names)

    # Deterministic disk: the watermark ladder runs on a scripted statvfs
    # (the real volume's free space must not decide a chaos verdict).
    fake_disk = {"free": float(watermark * 10)}

    def statvfs_fn(_path):
        return types.SimpleNamespace(f_bavail=int(fake_disk["free"]),
                                     f_frsize=1)

    monitor = DurabilityMonitor(state, metrics=metrics, tracer=tracer,
                                degraded_after=2, probe_interval_s=0.05,
                                low_watermark_bytes=watermark,
                                fault_injector=injector,
                                statvfs_fn=statvfs_fn)
    monitor.attach_sinks(journal=journal, span_sink=span_journal,
                         tracer=tracer)
    slo = SLOMonitor(metrics,
                     [disk_free_objective(monitor.free_bytes, watermark,
                                          short_s=0.2, long_s=0.4)],
                     tracer=tracer, interval_s=0.05)

    pipe = InstantPipeline(frame_shape, dispatch_s=0.002)
    pipe.gallery = gallery
    connector = FakeConnector()
    service = RecognizerService(
        pipe, connector, batch_size=4, frame_shape=frame_shape,
        flush_timeout=0.02, state_store=state, dead_letter_journal=journal,
        tracer=tracer, slo_monitor=slo, metrics=metrics)
    service.subject_names = names
    service.start(warmup=False)
    expo = ExpoServer(service, tracer=tracer, metrics=metrics, slo=slo,
                      port=0)
    expo.start()

    frame = np.zeros(frame_shape, np.float32)

    def pump(n: int, tag: str) -> None:
        before = len(connector.messages(RESULT_TOPIC))
        for i in range(n):
            connector.inject(FRAME_TOPIC, {**encode_frame(frame),
                                           "meta": {"seq": f"{tag}-{i}"}})
        deadline = time.monotonic() + 30
        while (len(connector.messages(RESULT_TOPIC)) < before + n
               and time.monotonic() < deadline):
            time.sleep(0.01)
        got = len(connector.messages(RESULT_TOPIC)) - before
        if got != n:
            failures.append(f"{tag}: serving stalled — {got}/{n} frames "
                            f"published")

    def enroll(tag: str):
        """One write-ahead enrollment; returns the refusal exception or
        None (acked — appended to the acknowledged history)."""
        emb = frame_rng.normal(size=(2, DIM)).astype(np.float32)
        label = len(names)
        subject = f"{tag}_{len(acked)}"
        labels = np.full(2, label, np.int32)
        try:
            seq = state.append_enrollment(
                emb, labels, subject=subject, label=label,
                apply_fn=lambda e=emb, l=labels: gallery.add(e, l))
        except (DurabilityDegradedError, OSError) as exc:
            return exc
        names.append(subject)
        acked.append((seq, emb, labels, subject, label))
        return None

    def statuses(kind: str) -> list:
        return [s for s in connector.messages(STATUS_TOPIC)
                if s.get("status") == kind]

    def health_code() -> int:
        try:
            with urllib.request.urlopen(
                    f"http://{expo.host}:{expo.port}/health",
                    timeout=2.0) as resp:
                return resp.status
        except urllib.error.HTTPError as exc:
            return exc.code
        except OSError:
            return -1

    try:
        # ---- phase A: clean baseline ----
        pump(burst, "baseline")
        for _ in range(3):
            if enroll("baseline") is not None:
                failures.append("baseline enrollment refused on a healthy "
                                "disk")
        if not state.checkpoint_now(wait=True):
            failures.append("baseline checkpoint failed")

        # ---- phase B: full disk mid-enrollment (sustained ENOSPC) ----
        injector.rates["storage"] = {"enospc": 1.0}
        refused_os = refused_closed = 0
        for _ in range(6):
            exc = enroll("fulldisk")
            if exc is None:
                failures.append("enrollment ACKED against a full disk — "
                                "the ack lied")
            elif isinstance(exc, DurabilityDegradedError):
                refused_closed += 1
            else:
                refused_os += 1
        report["enospc_refusals"] = {"oserror": refused_os,
                                     "closed": refused_closed}
        if refused_os != monitor.degraded_after:
            failures.append(
                f"expected exactly {monitor.degraded_after} OSError "
                f"refusals before the flip, got {refused_os}")
        if refused_closed != 6 - monitor.degraded_after:
            failures.append(f"expected {6 - monitor.degraded_after} "
                            f"refused-closed, got {refused_closed}")
        if int(metrics.counter("wal_append_errors")) != refused_os:
            failures.append(
                f"wal_append_errors {metrics.counter('wal_append_errors')} "
                f"!= {refused_os} failed appends (exact accounting)")
        if not monitor.degraded:
            failures.append("sustained ENOSPC never flipped "
                            "durability_degraded")
        if not statuses("durability_degraded"):
            failures.append("no durability_degraded announcement")
        # Serving continues straight through the storage outage.
        pump(burst, "during_enospc")
        # The enroll COMMAND is refused closed at the front door.
        connector.inject(CONTROL_TOPIC, {"cmd": "enroll",
                                         "subject": "must_refuse",
                                         "count": 1})
        time.sleep(0.2)
        if not any(s.get("reason") == "durability_degraded"
                   for s in statuses("rejected")):
            failures.append("enroll command not refused with an explicit "
                            "durability_degraded status")
        # Non-critical sinks shed with exact per-sink accounting.
        if tracer.dump("degraded_probe") is not None:
            failures.append("flight dump landed while degraded (must shed)")
        journal.append("disk_chaos", [])
        for counter in ("trace_dumps_shed", "journal_shed",
                        "trace_spans_shed"):
            if metrics.counter(counter) < 1:
                failures.append(f"{counter} never counted while degraded")
        if int(metrics.counter("enrollments_refused_degraded")) < refused_closed + 1:
            failures.append("enrollments_refused_degraded undercounts the "
                            "closed refusals")

        # ---- phase B': space returns — the probe re-arms ----
        injector.rates["storage"] = {}
        deadline = time.monotonic() + 10
        # the flag clears before the monitor announces the re-arm: wait
        # for both (the reference checked between them and could miss it)
        while ((monitor.degraded or not statuses("durability_restored"))
               and time.monotonic() < deadline):
            time.sleep(0.02)
        if monitor.degraded:
            failures.append("recovery probe never re-armed durability "
                            "after the fault cleared")
        if not statuses("durability_restored"):
            failures.append("no durability_restored announcement")
        if enroll("rearmed") is not None:
            failures.append("enrollment refused after re-arm")

        # ---- phase C: EIO mid-checkpoint ----
        # The span sink is the only background storage writer; detach it
        # for the scripted window so the one queued EIO deterministically
        # lands on the checkpoint save.
        saved_sink, tracer.span_sink = tracer.span_sink, None
        before_fail = metrics.counter("checkpoint_failures")
        injector.script("storage", "eio")
        if state.checkpoint_now(wait=True):
            failures.append("checkpoint save succeeded under injected EIO")
        tracer.span_sink = saved_sink
        if metrics.counter("checkpoint_failures") != before_fail + 1:
            failures.append("EIO checkpoint not counted checkpoint_failures")
        if state.store.load_latest() is None:
            failures.append("previous checkpoint lost after the EIO save")

        # ---- phase D: slow fsync under load ----
        injector.rates["storage"] = {"slow_fsync": 1.0}
        pump(burst, "slow_fsync")
        if enroll("slowfsync") is not None:
            failures.append("enrollment refused under slow_fsync (slow "
                            "durable is still durable)")
        if monitor.degraded:
            failures.append("slow fsync flipped durability (latency is "
                            "not loss)")
        injector.rates["storage"] = {}

        # ---- phase E: disk-pressure watermark ladder (scripted statvfs) --
        # Ticks are claim-serialized against the monitor's background
        # thread (a manual forced tick may lose the claim and skip), so
        # every transition is awaited, never asserted off one tick —
        # while the exactly-once counters stay exact BECAUSE of that
        # serialization.
        from opencv_facerecognizer_tpu_torch.runtime.resilience import (
            DISK_CRITICAL, DISK_OK, DISK_WARN,
        )

        def await_disk(predicate, what: str) -> None:
            deadline = time.monotonic() + 10
            while not predicate() and time.monotonic() < deadline:
                monitor.tick(force=True)
                time.sleep(0.01)
            if not predicate():
                failures.append(f"disk watermark ladder never reached "
                                f"{what}")

        await_disk(lambda: monitor.disk_state == DISK_OK, "baseline ok")
        ckpts_before = metrics.counter("checkpoints_written")
        fake_disk["free"] = watermark * 0.5  # below low watermark: warn
        await_disk(lambda: monitor.disk_state == DISK_WARN, "warn")
        if metrics.counter("disk_pressure_retention_shrinks") != 1:
            failures.append("warn watermark did not shrink retention "
                            "exactly once")
        if metrics.counter("disk_pressure_compactions") != 1:
            failures.append("warn watermark did not force one WAL "
                            "compaction checkpoint")
        if state.store.keep != 1:
            failures.append("checkpoint retention not shrunk under disk "
                            "pressure")
        deadline = time.monotonic() + 10
        while (metrics.counter("checkpoints_written") <= ckpts_before
               and time.monotonic() < deadline):
            time.sleep(0.02)  # the forced compaction checkpoint lands
        if metrics.counter("checkpoints_written") <= ckpts_before:
            failures.append("preemptive compaction checkpoint never landed")
        fake_disk["free"] = watermark / 12.0  # below watermark/6: critical
        await_disk(lambda: (monitor.disk_state == DISK_CRITICAL
                            and monitor.degraded
                            and monitor.degraded_reason == "disk_critical"),
                   "critical degraded flip")
        if not isinstance(enroll("critical"), DurabilityDegradedError):
            failures.append("enrollment not refused closed at the critical "
                            "watermark")
        slo.evaluate()
        critical_code = health_code()
        if critical_code != 503:
            failures.append(f"/health did not 503 at critical disk "
                            f"pressure (got {critical_code})")
        fake_disk["free"] = float(watermark * 10)  # space returns
        deadline = time.monotonic() + 10
        while monitor.degraded and time.monotonic() < deadline:
            time.sleep(0.02)
        if monitor.degraded:
            failures.append("durability never re-armed after disk pressure "
                            "cleared")
        if state.store.keep == 1:
            failures.append("retention not restored after pressure cleared")
        deadline = time.monotonic() + 10
        while health_code() != 200 and time.monotonic() < deadline:
            slo.evaluate()
            time.sleep(0.05)
        if health_code() != 200:
            failures.append("/health never recovered after the pressure "
                            "cleared")
        if enroll("final") is not None:
            failures.append("enrollment refused after full recovery")

        # ---- settle + verify: zero acked loss, exact ledger ----
        shutdown = graceful_shutdown(service, state=state, drain_timeout=30.0)
        report["shutdown"] = {"drained": shutdown["drained"],
                              "ledger": shutdown["ledger"]}
        if not shutdown["drained"]:
            failures.append("graceful drain timed out")
        ledger = shutdown["ledger"]
        if abs(ledger["in_system"]) > 1e-6:
            failures.append(f"ledger unsettled at shutdown: {ledger}")
        if ledger["drops_by_reason"]:
            failures.append(f"clean traffic dropped frames: "
                            f"{ledger['drops_by_reason']}")
        g2 = ShardedGallery(capacity=64, dim=DIM, device="cpu")
        names2: list = []
        StateLifecycle(state_dir, metrics=Metrics()).recover(g2, names2)
        want_emb = (np.concatenate([e for _s, e, _l, _su, _la in acked])
                    if acked else np.zeros((0, DIM), np.float32))
        want_emb = want_emb / np.maximum(
            np.linalg.norm(want_emb, axis=-1, keepdims=True), 1e-12)
        want_lab = (np.concatenate([l for _s, _e, l, _su, _la in acked])
                    if acked else np.zeros((0,), np.int32))
        got_emb, got_lab, _val, got_size = g2.snapshot()
        if got_size != len(want_lab):
            failures.append(f"recovered {got_size} rows, expected "
                            f"{len(want_lab)} acked rows (zero-loss breach)")
        elif got_size and (
                not np.array_equal(got_lab[:got_size], want_lab)
                or not np.allclose(got_emb[:got_size],
                                   want_emb.astype(np.float32),
                                   rtol=0, atol=1e-6)):
            failures.append("recovered rows differ from the acknowledged "
                            "history (bit-exactness breach)")
        for i, (_seq, _e, _l, subject, label) in enumerate(acked):
            if label >= len(names2) or names2[label] != subject:
                failures.append(f"subject name {i} lost: "
                                f"{names2[label] if label < len(names2) else None!r}"
                                f" != {subject!r}")
                break
        from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint as verify_mod

        vreport = verify_mod.verify_state_dir(state_dir)
        report["verify"] = {"ok": vreport["ok"],
                            "checkpoints": len(vreport["checkpoints"])}
        if not vreport["ok"]:
            failures.append(f"offline verification failed: "
                            f"{vreport.get('corrupt')}")
        report["acked_enrollments"] = len(acked)
        report["injected"] = injector.summary()
        report["durability"] = monitor.status()
        report["sink_accounting"] = {
            k: int(metrics.counter(k))
            for k in ("journal_shed", "trace_spans_shed", "trace_dumps_shed",
                      "trace_span_errors", "journal_errors",
                      "wal_append_errors", "checkpoint_failures",
                      "enrollments_refused_degraded", "durability_rearms",
                      "durability_degraded_transitions")}
        _finish_observability(
            tracer, trace_dir, "disk_done", ledger,
            quiesced=shutdown["drained"] and abs(ledger["in_system"]) < 1e-6,
            failures=failures, report=report)
    finally:
        try:
            expo.stop()
        except Exception:
            pass
        span_journal.close()
        if temp_dir:
            shutil.rmtree(state_dir, ignore_errors=True)
        shutil.rmtree(trace_dir, ignore_errors=True)

    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_partition(seconds: float = 8.0, seed: int | None = None,
                  state_dir: str | None = None) -> dict:
    """Partition scenario: a 3-replica serving
    fleet behind the topic router with link supervision, hedged
    interactive dispatch and frame-id dedup armed, pounded through a
    transport fault boundary — then the network, not any process, is
    what fails.

    Phases: (B) hard partition of the busiest replica (both directions)
    → pong deadline fails the link, its topics reroute, the blackout's
    interactive frames are rescued by hedging; heal → link recovers.
    (C) flapping link (partition toggled faster than traffic can adapt)
    — the fleet must simply survive it and converge link-up. (D)
    duplicate storm (rate-drawn ``transport: duplicate`` on every
    crossing) — intake dedup + fan-in dedup must keep delivery
    exactly-once. (E) half-open writer: a ``StateLifecycle`` whose state
    dir (home of ``writer.lease``) stops answering reads flips
    durability-degraded (reason ``lease_unreachable``) instead of
    acking enrollments, and re-arms when the volume heals.

    Pass criteria (any miss -> ``ok: False``):

    1. **failover is bounded** — link-down detection within
       ``link_deadline + 4 health cycles`` of the partition (+0.5 s
       scheduler floor), and survivor interactive p99 after detection
       stays within 2x the unloaded baseline (+100 ms floor);
    2. **hedging rescues the blackout** — at least one hedge fired and
       won during the detection window;
    3. **exactly-once delivery** — a raw result-delivery counter above
       the router's fan-in sees EVERY completed seq exactly once (zero
       duplicate publishes), while the dedup counters prove duplicates
       actually arrived and were absorbed;
    4. **ledgers settle exactly** — every replica ends
       ``in_system == 0`` with ``admitted == completed +
       completed_empty + Σ drops``;
    5. **split-brain fails closed** — the half-open writer refuses
       enrollment while degraded and recovers on heal;
    6. **observability** — the link failure leaves a parseable
       ``failover`` flight dump; link state is visible in the registry.
    """
    import random as random_mod
    import threading

    import numpy as np

    from opencv_facerecognizer_tpu_torch.runtime.faults import FaultInjector
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle
    from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        TrafficRecorder, build_replica_fleet,
    )
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import RESULT_TOPIC
    from opencv_facerecognizer_tpu_torch.runtime.resilience import (
        DurabilityDegradedError, DurabilityMonitor,
    )
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak partition seed={seed} seconds={seconds}",
          file=sys.stderr)

    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 16, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.1)
    link_deadline_s = 0.25
    hedge_deadline_s = 0.12
    health_interval_s = 0.05
    offered_hz = 60.0
    topics = 12

    report = {"scenario": "partition", "seed": seed, "seconds": seconds,
              "ok": False}
    failures: list = []

    netfi = FaultInjector(seed=seed)
    router_metrics = Metrics()
    router, stacks = build_replica_fleet(
        3, dispatch_s=0.01, health_interval_s=health_interval_s,
        router_metrics=router_metrics, tracer=tracer,
        router_fault_injector=netfi, link_deadline_s=link_deadline_s,
        hedge_deadline_s=hedge_deadline_s)
    recorder = TrafficRecorder(router)
    #: raw delivery counter ABOVE the fan-in dedup — ``TrafficRecorder``
    #: setdefaults duplicate results away silently, so the exactly-once
    #: assertion needs its own count of every upstream dispatch.
    raw_lock = threading.Lock()
    raw_deliveries: dict = {}

    def count_raw(topic, message):
        seq = (message.get("meta") or {}).get("seq")
        if seq is not None:
            with raw_lock:
                raw_deliveries[seq] = raw_deliveries.get(seq, 0) + 1

    router.subscribe(RESULT_TOPIC, count_raw)
    frame_msg = encode_frame(np.zeros((32, 32), np.float32))
    seq_box = {"seq": 0}

    def offer() -> int:
        seq = seq_box["seq"]
        seq_box["seq"] = seq + 1
        recorder.send_t[seq] = time.monotonic()
        router.publish(f"camera/{seq % topics}",
                       {**frame_msg, "priority": "interactive",
                        "meta": {"seq": seq}})
        return seq

    def link_up(name: str) -> bool:
        return next(r["link_up"] for r in router.registry()
                    if r["name"] == name)

    def drain_all(timeout: float = 15.0) -> None:
        for _p, svc, _c, _m in stacks:
            svc.drain(timeout=timeout)

    interval = 1.0 / offered_hz
    base_p99_ms = p99_survivor = float("nan")
    failover_s = None
    blackout_seqs: list = []
    survivor_seqs: list = []
    storm_seqs: list = []
    try:
        for _p, svc, _c, _m in stacks:
            svc.start(warmup=False)
        router.start()

        # ---- phase A: unloaded baseline across the healthy fleet ----
        base_seqs = []
        base_end = time.monotonic() + min(1.0, seconds / 4)
        while time.monotonic() < base_end:
            base_seqs.append(offer())
            time.sleep(interval)
        drain_all()
        base_p99_ms = recorder.percentile_ms(base_seqs, 99)

        # ---- phase B: hard partition of the busiest replica ----
        busiest = max(router.registry(), key=lambda r: len(r["topics"]))
        victim = busiest["name"]
        netfi.set_partition(victim)
        t_part = time.monotonic()
        detect_budget = link_deadline_s + 4 * health_interval_s + 0.5
        heal_at = t_part + max(1.0, seconds * 0.2)
        t_detect = None
        while time.monotonic() < heal_at:
            seq = offer()
            if t_detect is None:
                if not link_up(victim):
                    t_detect = time.monotonic()
                    failover_s = t_detect - t_part
                else:
                    blackout_seqs.append(seq)
            elif time.monotonic() > t_detect + 2 * health_interval_s:
                survivor_seqs.append(seq)
            time.sleep(interval)
        if t_detect is None:
            failures.append(f"link to {victim} never failed over "
                            f"(partitioned at t+0, waited "
                            f"{heal_at - t_part:.1f}s)")
        elif failover_s > detect_budget:
            failures.append(f"failover took {failover_s:.2f}s > "
                            f"{detect_budget:.2f}s budget")
        netfi.heal_partition(victim)
        recover_deadline = time.monotonic() + detect_budget
        while (not link_up(victim)
               and time.monotonic() < recover_deadline):
            time.sleep(health_interval_s)
        if not link_up(victim):
            failures.append(f"link to {victim} never recovered after heal")

        # ---- phase C: flapping link on a second replica ----
        others = [r["name"] for r in router.registry() if r["name"] != victim]
        flappy = others[0]
        for _ in range(3):
            netfi.set_partition(flappy)
            flap_end = time.monotonic() + 2 * health_interval_s
            while time.monotonic() < flap_end:
                offer()
                time.sleep(interval)
            netfi.heal_partition(flappy)
            flap_end = time.monotonic() + 2 * health_interval_s
            while time.monotonic() < flap_end:
                offer()
                time.sleep(interval)
        recover_deadline = time.monotonic() + detect_budget
        while (not link_up(flappy)
               and time.monotonic() < recover_deadline):
            time.sleep(health_interval_s)
        if not link_up(flappy):
            failures.append(f"flapped link to {flappy} never converged up")

        # ---- phase D: duplicate storm on every transport crossing ----
        netfi.rates["transport"] = {"duplicate": 0.5}
        storm_end = time.monotonic() + max(1.0, seconds * 0.2)
        while time.monotonic() < storm_end:
            storm_seqs.append(offer())
            time.sleep(interval)
        netfi.rates["transport"] = {}
        drain_all()
        # Let straggler hedge results and pongs settle before judging.
        time.sleep(4 * health_interval_s)
        p99_survivor = recorder.percentile_ms(survivor_seqs, 99)
    finally:
        try:
            router.stop()
        finally:
            for _p, svc, _c, _m in stacks:
                try:
                    svc.stop()
                except Exception:  # noqa: BLE001 — teardown must finish
                    import traceback

                    traceback.print_exc()

    # ---- phase E: half-open writer — split-brain fails closed ----
    temp_dir = state_dir is None
    if temp_dir:
        state_dir = tempfile.mkdtemp(prefix="ocvf_partition_")
    from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery

    storefi = FaultInjector(seed=seed)
    writer_metrics = Metrics()
    DIM = 8
    writer_gallery = ShardedGallery(capacity=64, dim=DIM, device="cpu")
    state = StateLifecycle(state_dir, metrics=writer_metrics,
                           checkpoint_every_s=1e9, fault_injector=storefi)
    state.bind(writer_gallery, [])
    monitor = DurabilityMonitor(state, metrics=writer_metrics,
                                degraded_after=2, probe_interval_s=0.01,
                                fault_injector=storefi)
    frame_rng = np.random.default_rng(seed)
    split_brain = {"refused": False, "degraded_reason": None,
                   "rearmed": False, "recovered_ack": False}

    def enroll_once(tag: str):
        emb = frame_rng.normal(size=(1, DIM)).astype(np.float32)
        return state.append_enrollment(
            emb, np.zeros(1, np.int32), subject=tag, label=0)

    try:
        enroll_once("pre_partition")  # the volume provably works first
        # The state dir goes half-open: reads fail (the lease can no
        # longer be proven held), writes fail (the probe cannot re-arm).
        storefi.rates["storage"] = {"read_error": 1.0, "eio": 1.0}
        flip_deadline = time.monotonic() + 5.0
        while not monitor.degraded and time.monotonic() < flip_deadline:
            monitor.tick(force=True, probe=True)
            time.sleep(0.01)
        split_brain["degraded_reason"] = monitor.degraded_reason
        if not monitor.degraded:
            failures.append("half-open writer never flipped degraded")
        elif monitor.degraded_reason != "lease_unreachable":
            failures.append(f"writer degraded for the wrong reason: "
                            f"{monitor.degraded_reason!r}")
        try:
            enroll_once("during_partition")
            failures.append("degraded writer ACKED an enrollment — "
                            "split-brain window is open")
        except DurabilityDegradedError:
            split_brain["refused"] = True
        # Heal the volume: the recovery probe re-arms, enrollment flows.
        storefi.rates["storage"] = {}
        rearm_deadline = time.monotonic() + 5.0
        while monitor.degraded and time.monotonic() < rearm_deadline:
            monitor.tick(force=True, probe=True)
            time.sleep(0.01)
        split_brain["rearmed"] = not monitor.degraded
        if monitor.degraded:
            failures.append("healed writer never re-armed")
        else:
            try:
                enroll_once("post_heal")
                split_brain["recovered_ack"] = True
            except Exception as exc:  # noqa: BLE001 — any refusal here is the failure being tested
                failures.append(f"healed writer refused enrollment: {exc!r}")
    finally:
        state.close()
        if temp_dir:
            shutil.rmtree(state_dir, ignore_errors=True)

    # ---- verdicts over the fleet phases ----
    rc = router_metrics.counters()
    per_replica = []
    deduped_total = 0.0
    for i, (_p, svc, _c, metrics) in enumerate(stacks):
        ledger = svc.ledger()
        deduped = metrics.counters().get("frames_deduped", 0.0)
        deduped_total += deduped
        per_replica.append({"name": f"replica-{i}", "ledger": ledger,
                            "frames_deduped": deduped})
        if abs(ledger["in_system"]) > 1e-6:
            failures.append(f"replica-{i} ledger unsettled: {ledger}")
    deduped_total += rc.get("router_results_deduped", 0.0)

    if base_p99_ms != base_p99_ms:
        failures.append("no baseline frame completed")
    if p99_survivor != p99_survivor:
        failures.append("no survivor frame completed after failover")
    elif base_p99_ms == base_p99_ms \
            and p99_survivor > 2.0 * base_p99_ms + 100.0:
        failures.append(f"survivor p99 after failover blew the budget: "
                        f"{p99_survivor:.0f} ms > 2x baseline "
                        f"{base_p99_ms:.0f} ms + 100 ms")
    if not rc.get("router_hedges"):
        failures.append("no hedge fired during the blackout window")
    dup_seqs = {s: n for s, n in raw_deliveries.items() if n > 1}
    if dup_seqs:
        failures.append(f"duplicate result publishes for "
                        f"{len(dup_seqs)} seq(s): "
                        f"{dict(list(dup_seqs.items())[:5])}")
    if deduped_total < 1:
        failures.append("duplicate storm produced zero dedups — the "
                        "dedup layer was never exercised")
    if not rc.get("link_failures") or not rc.get("link_recoveries"):
        failures.append(f"link supervision never cycled: {rc}")

    failover_dumps = glob.glob(os.path.join(trace_dir,
                                            "flight-*failover*.json"))
    if not failover_dumps:
        failures.append("link failover left no flight-recorder dump")
    _check_flight_dumps(trace_dir, failures, require=1)
    shutil.rmtree(trace_dir, ignore_errors=True)

    report.update({
        "offered": seq_box["seq"],
        "baseline_p99_ms": None if base_p99_ms != base_p99_ms
        else round(base_p99_ms, 1),
        "survivor_p99_ms": None if p99_survivor != p99_survivor
        else round(p99_survivor, 1),
        "failover_s": None if failover_s is None else round(failover_s, 3),
        "blackout_offered": len(blackout_seqs),
        "blackout_rescued": recorder.completed(blackout_seqs),
        "storm_offered": len(storm_seqs),
        "storm_completed": recorder.completed(storm_seqs),
        "deduped_total": deduped_total,
        "duplicate_publishes": len(dup_seqs),
        "split_brain": split_brain,
        "router": {k: v for k, v in rc.items()},
        "replicas": per_replica,
        "transport_injected": {k: v for k, v in netfi.injected.items()},
    })
    report["failures"] = failures
    report["ok"] = not failures
    return report


def run_video(seconds: float = 6.0, seed: int | None = None,
              state_dir: str | None = None) -> dict:
    """Video scenario: the temporal identity cache
    under the attacks it was designed to survive. Four arms, all
    closed-loop (one frame offered, drained, then the next — so every
    full result lands before the following lookup, making the guarantees
    exactly checkable with zero pipeline-lag slack):

    1. **identity swap, drift armed** — coherent single-stream video
       whose subject is swapped IN PLACE (same box, new identity)
       mid-run: the appearance-drift check must force the full verify on
       the very next frame — ZERO cached publishes of the old identity
       after the swap frame, with an ``identity`` flush recorded.
    2. **identity swap, drift disabled** — the same attack with the
       drift check neutered (threshold inf): the scheduled re-verify is
       now the only defense, and every stale cached publish must fall
       WITHIN the re-verify window after the swap — never past it — and
       the cache must recover onto the new identity afterwards.
    3. **ambiguity** — two identities converge until their tracks
       overlap above the IoU ceiling: the next full-path frame (at
       latest the scheduled re-verify) flushes BOTH tracks
       (``ambiguity`` x2 minimum) and no cached serve lands past the
       window edge — poisoning cannot cross tracks.
    4. **failover cold-start** — replica A serves the stream cache-hot,
       is killed, and the stream resumes on fresh replica B (the router's
       rendezvous routing pins topic->replica, so failover lands on a
       replica whose tracker is empty by construction): B's first frames
       MUST take the full path before any cached serve, both replicas'
       extended ledgers settle exactly, and an embedder-version bump on
       B flushes its cache (``version``) without serving a stale entry.

    Observability: arm 1 runs traced at sample=1.0 and must leave a
    parseable flight dump whose settle spans reproduce the extended
    ledger (``completed_cached`` included) exactly.
    """
    import random as random_mod

    import numpy as np

    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.fakes import (
        InstantPipeline, synthetic_video_stream,
    )
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC, RecognizerService,
    )
    from opencv_facerecognizer_tpu_torch.runtime.tracker import (
        IdentityTracker, TrackerConfig,
    )
    from opencv_facerecognizer_tpu_torch.utils import metric_names as mn
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics
    from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

    if seed is None:
        seed = random_mod.SystemRandom().randrange(1 << 31)
    print(f"chaos_soak video seed={seed} seconds={seconds}",
          file=sys.stderr)

    frame_hw = (64, 64)
    reverify = 6
    n_frames = max(36, int(seconds * 12))
    # Offset the swap off the re-verify period (6): were they aligned,
    # the scheduled verify would land ON the swap frame and the
    # drift-disabled arm would never observe the stale window it exists
    # to bound.
    swap_at = n_frames // 2 + 3
    names = ["id0", "id1", "id2", "id3"]
    trace_dir = tempfile.mkdtemp(prefix="ocvf_flight_")
    tracer = Tracer(ring_size=1 << 15, sample=1.0, seed=seed,
                    dump_dir=trace_dir, min_dump_interval_s=0.1)
    report = {"scenario": "video", "seed": seed, "seconds": seconds,
              "reverify_frames": reverify, "ok": False}
    failures: list = []

    def build(drift_threshold=None, svc_tracer=None):
        metrics = Metrics()
        pipeline = InstantPipeline(frame_hw, cascade_stub=True,
                                   video_oracle=True)
        connector = FakeConnector()
        kwargs = {"reverify_frames": reverify}
        if drift_threshold is not None:
            kwargs["drift_threshold"] = drift_threshold
        tracker = IdentityTracker(TrackerConfig(**kwargs), metrics=metrics)
        service = RecognizerService(
            pipeline, connector, batch_size=4, frame_shape=frame_hw,
            flush_timeout=0.01, inflight_depth=2,
            similarity_threshold=0.0, metrics=metrics, tracer=svc_tracer,
            bucket_sizes=(1, 2, 4), cascade=True, subject_names=names,
            tracker=tracker)
        pipeline.prewarm_batch_shapes(service._bucket_ladder, frame_hw,
                                      service.batcher.dtype)
        service._warmed = True
        results = []
        connector.subscribe(RESULT_TOPIC,
                            lambda t, m: results.append(m))
        service.start(warmup=False)
        return service, connector, metrics, tracker, results

    def drive(service, connector, frames, start_seq, where):
        """Closed-loop offer: one frame, one drain — full determinism."""
        for i, (frame, key, _k) in enumerate(frames):
            connector.inject(FRAME_TOPIC, {
                "frame": frame,
                "meta": {"seq": start_seq + i, "stream": key}})
            if not service.drain(timeout=10.0):
                failures.append(f"{where}: drain wedged at frame "
                                f"{start_seq + i}")
                return False
        return True

    def cached_of(results, label=None, min_seq=None):
        out = []
        for m in results:
            if m.get("exit") != "track_cache":
                continue
            if min_seq is not None and m["meta"]["seq"] < min_seq:
                continue
            if label is not None and not any(
                    f["label"] == label for f in m["faces"]):
                continue
            out.append(m["meta"]["seq"])
        return out

    def check_ledger(service, where):
        ledger = service.ledger()
        drops = sum(ledger["drops_by_reason"].values())
        settled = (ledger["completed"] + ledger["completed_empty"]
                   + ledger["completed_cached"] + drops)
        if ledger["admitted"] != settled or ledger["in_system"] != 0:
            failures.append(f"{where}: extended ledger not exact: {ledger}")
        return ledger

    # -- arm 1: identity swap with the drift check armed (traced) --
    service, conn, metrics, _tracker, results = build(svc_tracer=tracer)
    stream = synthetic_video_stream(
        n_frames, frame_hw, streams=1, coherence=1.0,
        identity_swap_at=swap_at, seed=seed % 100003)
    quiesced = drive(service, conn, stream, 0, "swap/drift")
    service.stop()
    # The generator's first identity is 0; the in-place swap moves it to
    # 1 — a cached publish of label 0 at or past the swap frame IS the
    # stale serve the drift check exists to prevent (the swap frame
    # itself counts: its content is already the new identity when the
    # lookup runs).
    stale = cached_of(results, label=0, min_seq=swap_at)
    warm = cached_of(results, min_seq=None)
    if not warm or (warm and min(warm) > swap_at):
        failures.append("swap/drift: cache never engaged before the swap")
    if stale:
        failures.append(f"swap/drift: stale identity served from cache "
                        f"after the swap at seqs {stale[:5]}")
    if metrics.counter(mn.TRACK_FLUSHES_PREFIX + "identity") < 1:
        failures.append("swap/drift: no identity flush recorded")
    ledger = check_ledger(service, "swap/drift")
    report["swap_drift"] = {
        "frames": n_frames, "swap_at": swap_at,
        "cached_total": len(warm), "stale_after_swap": len(stale),
        "identity_flushes": int(metrics.counter(
            mn.TRACK_FLUSHES_PREFIX + "identity")),
        "reverifies": int(metrics.counter(mn.TRACK_REVERIFIES)),
    }

    # -- arm 2: same swap, drift DISABLED -> the window is the bound --
    service2, conn2, _m2, _t2, results2 = build(drift_threshold=1e9)
    stream2 = synthetic_video_stream(
        n_frames, frame_hw, streams=1, coherence=1.0,
        identity_swap_at=swap_at, seed=seed % 100003)
    drive(service2, conn2, stream2, 0, "swap/window")
    service2.stop()
    stale2 = cached_of(results2, label=0, min_seq=swap_at)
    recovered = cached_of(results2, label=1, min_seq=swap_at + 1)
    if stale2 and max(stale2) > swap_at + reverify:
        failures.append(
            f"swap/window: stale identity served PAST the re-verify "
            f"window (seq {max(stale2)} > {swap_at + reverify})")
    if not recovered:
        failures.append("swap/window: cache never recovered onto the "
                        "new identity after the verify")
    check_ledger(service2, "swap/window")
    report["swap_window"] = {
        "stale_within_window": len(stale2),
        "last_stale_seq": max(stale2) if stale2 else None,
        "window_edge_seq": swap_at + reverify,
        "recovered_cached": len(recovered),
    }

    # -- arm 3: nested faces -> ambiguity flushes BOTH --
    # Two live tracks over the IoU ceiling, neither failing the identity
    # cross-check: a smaller face moves INSIDE a larger one (think a
    # face passing in front of a close-up). The big blob's border ring
    # stays visible so its detected box stays full-size; the nested box
    # overlaps it at IoU ~0.69 while both faces keep matching their own
    # tracks — only the ambiguity sweep can catch this. The contract is
    # the bounded one the cache is designed around: the overlap is
    # detected on the next FULL-path frame (drift-forced, or at latest
    # the scheduled re-verify), BOTH tracks flush, and the cache stays
    # off for the rest of the overlap — so no cached serve can land
    # more than one re-verify interval past the merge. (Whether the
    # march's drift trips early is noise-sensitive — a stale track box
    # over a sliding fill straddles the median threshold — so the
    # window edge, not the merge frame, is the assertable line.)
    service3, conn3, m3, _t3, results3 = build()
    rng = np.random.default_rng(seed ^ 0x5EED)
    path = ([(10, 36)] * 6                       # separate: confirm + cache
            + [(10, 28), (10, 20), (12, 12), (12, 6)]  # march inside
            + [(12, 6)] * (reverify + 4))        # hold nested past the window
    merge_seq = 9                                # (12, 6) first nests here
    conv = []
    for yb, xb in path:
        frame = rng.integers(20, 90, size=frame_hw).astype(np.uint8)
        frame[10:34, 4:28] = 160                 # identity 0: 24x24, static
        frame[yb:yb + 20, xb:xb + 20] = 184      # identity 1: 20x20, moving
        conv.append((frame, "cam0", 2))
    drive(service3, conn3, conv, 0, "ambiguity")
    service3.stop()
    amb_flushes = int(m3.counter(mn.TRACK_FLUSHES_PREFIX + "ambiguity"))
    if amb_flushes < 2:
        failures.append(f"ambiguity: expected both tracks flushed, got "
                        f"{amb_flushes} ambiguity flushes")
    overlapped = cached_of(results3, min_seq=merge_seq + reverify + 1)
    if overlapped:
        failures.append(f"ambiguity: cached serve past the re-verify "
                        f"window edge (seq {merge_seq + reverify}), "
                        f"seqs {overlapped[:5]}")
    warm3 = cached_of(results3)
    if not warm3 or min(warm3) > merge_seq:
        failures.append("ambiguity: cache never engaged before the merge")
    check_ledger(service3, "ambiguity")
    report["ambiguity"] = {"flushes": amb_flushes,
                           "cached_before_merge": len(warm3),
                           "cached_past_window": len(overlapped)}

    # -- arm 4: replica kill -> failover cold-start + version fence --
    svc_a, conn_a, _ma, _ta, res_a = build()
    svc_b, conn_b, mb, _tb, res_b = build()
    # Stamp a concrete embedder version on B before it serves: entries
    # verified under version None are fence-exempt by design (the fence
    # only fires on a MISMATCH of known versions), and the cutover
    # sub-check below needs stamped entries to invalidate.
    svc_b.pipeline.gallery.embedder_version = 1
    half = max(16, n_frames // 2)
    stream4 = synthetic_video_stream(2 * half, frame_hw, streams=1,
                                     coherence=1.0, seed=(seed + 7) % 100003)
    drive(svc_a, conn_a, stream4[:half], 0, "failover/A")
    svc_a.stop()  # the kill: rendezvous routing re-pins the topic to B
    hot_a = cached_of(res_a)
    if not hot_a:
        failures.append("failover/A: cache never engaged before the kill")
    drive(svc_b, conn_b, stream4[half:], half, "failover/B")
    cached_b = cached_of(res_b)
    # Cold start: B cannot serve from cache until its own tracker has
    # confirmed the track from full frames (confirm_hits=2) — the first
    # two frames after failover MUST be full-path.
    early = [s for s in cached_b if s < half + 2]
    if early:
        failures.append(f"failover/B: cached serve before the cold "
                        f"cache could have confirmed (seqs {early})")
    if not cached_b:
        failures.append("failover/B: cache never re-engaged after "
                        "failover")
    # Embedder-version fence: a cutover bump on B's gallery must flush
    # its tracks (reason ``version``) instead of serving entries
    # verified under the old embedder.
    svc_b.pipeline.gallery.embedder_version = 2
    tail_seq = half + len(stream4[half:])
    extra = synthetic_video_stream(6, frame_hw, streams=1, coherence=1.0,
                                   seed=(seed + 7) % 100003)
    drive(svc_b, conn_b, extra, tail_seq, "failover/version")
    svc_b.stop()
    if int(mb.counter(mn.TRACK_FLUSHES_PREFIX + "version")) < 1:
        failures.append("failover/version: no version flush after the "
                        "embedder bump")
    check_ledger(svc_a, "failover/A")
    check_ledger(svc_b, "failover/B")
    report["failover"] = {
        "a_cached": len(hot_a), "b_cached": len(cached_b),
        "b_first_cached_seq": min(cached_b) if cached_b else None,
        "version_flushes": int(mb.counter(
            mn.TRACK_FLUSHES_PREFIX + "version")),
    }

    # -- observability: arm 1's dump mirrors the extended ledger --
    _finish_observability(tracer, trace_dir, "video_end", ledger,
                          quiesced, failures, report)

    report["failures"] = failures
    report["ok"] = not failures
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=None,
                        help="replay a previous run exactly (logged on stderr)")
    parser.add_argument("--scenario", choices=["soak", "overload", "recovery",
                                               "replication", "rollout",
                                               "registry",
                                               "disk", "partition",
                                               "video"],
                        default="soak",
                        help="soak: randomized fault soak (default); "
                             "overload: 4x flood against the admission/"
                             "brownout/journal stack (run_overload); "
                             "recovery: seeded kills at every durability "
                             "boundary, zero-loss recovery + graceful "
                             "drain (run_recovery); replication: 1 writer "
                             "+ 2 WAL-tailing read replicas behind the "
                             "topic router — kill a reader mid-traffic "
                             "and the writer mid-enrollment, assert "
                             "survivor p99, zero acked loss, split-brain "
                             "fail-closed (run_replication); rollout: "
                             "live embedder rollout — kills mid-re-embed, "
                             "mid-cutover, and a reader mid-re-anchor; "
                             "assert zero acked loss, no mixed-version "
                             "scores, serving continuity (run_rollout); "
                             "registry: versioned model-registry swaps — "
                             "kill before/after the detector-swap fence "
                             "(recovery completes), damaged candidate "
                             "(recovery cleanly abandons), parity-"
                             "regressing candidate (auto-rollback + "
                             "flight dump); assert bit-equal zero acked "
                             "loss, never mixed-version serving, exact "
                             "per-replica ledgers (run_registry); "
                             "disk: the disk STAYS broken — ENOSPC "
                             "mid-enrollment, EIO mid-checkpoint, slow "
                             "fsync under load, watermark pressure; "
                             "assert refused-closed enrollments, serving "
                             "continuity, exact per-sink shed accounting, "
                             "automatic re-arm, zero acked loss "
                             "(run_disk); partition: the NETWORK fails — "
                             "router<->replica partition + heal, flapping "
                             "link, duplicate storm, half-open writer; "
                             "assert bounded failover, hedge rescue, "
                             "exactly-once delivery, exact ledgers, "
                             "split-brain fail-closed (run_partition); "
                             "video: the temporal identity cache under "
                             "attack — in-place identity swap with the "
                             "drift check armed (zero stale) and disabled "
                             "(stale bounded by the re-verify window), "
                             "ambiguity flushing both tracks, replica "
                             "kill + failover cold-start, embedder-"
                             "version fence; exact extended ledgers and "
                             "span accounting incl. completed_cached "
                             "(run_video)")
    parser.add_argument("--journal", default=None,
                        help="overload scenario: write the dead-letter "
                             "journal here instead of a temp file")
    parser.add_argument("--state-dir", default=None,
                        help="recovery scenario: run over this state dir "
                             "(kept afterwards) instead of a temp dir")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the soak scenario's stack (default cuda; "
                             "raises without a card). cpu runs the plain PyTorch path")
    args = parser.parse_args(argv)
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card: fail here, never a quiet CPU run
    if args.scenario == "overload":
        report = run_overload(seconds=args.seconds, seed=args.seed,
                              journal_path=args.journal)
    elif args.scenario == "recovery":
        report = run_recovery(seconds=args.seconds, seed=args.seed,
                              state_dir=args.state_dir)
    elif args.scenario == "replication":
        report = run_replication(seconds=args.seconds, seed=args.seed,
                                 state_dir=args.state_dir)
    elif args.scenario == "rollout":
        report = run_rollout(seconds=args.seconds, seed=args.seed,
                             state_dir=args.state_dir)
    elif args.scenario == "registry":
        report = run_registry(seconds=args.seconds, seed=args.seed,
                              state_dir=args.state_dir)
    elif args.scenario == "disk":
        report = run_disk(seconds=args.seconds, seed=args.seed,
                          state_dir=args.state_dir)
    elif args.scenario == "partition":
        report = run_partition(seconds=args.seconds, seed=args.seed,
                               state_dir=args.state_dir)
    elif args.scenario == "video":
        report = run_video(seconds=args.seconds, seed=args.seed,
                           state_dir=args.state_dir)
    else:
        report = run_soak(seconds=args.seconds, seed=args.seed, device=args.device)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
