"""The port's ingest (``runtime.ingest``: the staging ring, the upload, the
JPEG decode pool, and their wiring into the batcher, the admission and the
service) against the JAX package's.

Every case of the reference's ``tests/test_ingest.py`` runs on both
packages and the outcomes are compared: ring stats and allocation counts,
counters, ledgers, journals and spans. Cases with the services' threads
(the decode pool is threads) compare the counts that do not depend on how
frames fell into batches; the ring cases and the hand-driven services
(``readback_worker=False``, batches popped with ``get_batch(block=False)``
under one ``FakeClock``) compare everything. Tolerance: exact (counts,
bytes, journal rows). Not mirrored: the ``ocvf-lint`` wiring case, and the
``scripts/bench_compare.py`` and ``bench_serving.py`` cases, which test
the JAX package's benchmark tooling (no benchmark is ported).
"""

import time
import types
import warnings

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.runtime import admission as jax_adm
from opencv_facerecognizer_tpu.runtime import batcher as jax_batcher
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import ingest as jax_ingest
from opencv_facerecognizer_tpu.runtime import journal as jax_journal
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import resilience as jax_res
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils import metric_names as jax_names
from opencv_facerecognizer_tpu.utils import tracing as jax_tracing
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.runtime import admission as port_adm
from opencv_facerecognizer_tpu_torch.runtime import batcher as port_batcher
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import ingest as port_ingest
from opencv_facerecognizer_tpu_torch.runtime import journal as port_journal
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_res
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakeClock
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing as port_tracing

FRAME_HW = (16, 16)
PACKAGES = ("jax", "port")
PKG = {
    "jax": types.SimpleNamespace(rec=jax_rec, fakes=jax_fakes, ingest=jax_ingest,
                                 faults=jax_faults, res=jax_res, adm=jax_adm,
                                 journal=jax_journal, batcher=jax_batcher, Metrics=JaxMetrics,
                                 Conn=JaxConnector, tracing=jax_tracing),
    "port": types.SimpleNamespace(rec=port_rec, fakes=port_fakes, ingest=port_ingest,
                                  faults=port_faults, res=port_res, adm=port_adm,
                                  journal=port_journal, batcher=port_batcher,
                                  Metrics=mn.Metrics, Conn=PortConnector, tracing=port_tracing),
}
BOTH = pytest.mark.parametrize("pkg", PACKAGES)

needs_jpeg = pytest.mark.skipif(not port_ingest.jpeg_supported(),
                                reason="no JPEG codec (PIL/cv2) available")


def _wait(cond, timeout=10.0, interval=0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _frame():
    return np.zeros(FRAME_HW, np.float32)


def _service(pkg, pipeline=None, **kwargs):
    """The reference's ``_service`` helper in package ``pkg``: a threaded
    service over an ``InstantPipeline`` and a fake connector."""
    p = PKG[pkg]
    pipeline = pipeline or p.fakes.InstantPipeline(FRAME_HW)
    connector = p.Conn()
    kwargs.setdefault("batch_size", 4)
    kwargs.setdefault("metrics", p.Metrics())
    kwargs.setdefault("resilience", p.res.ResiliencePolicy(readback_deadline_s=2.0))
    if isinstance(kwargs.get("ingest"), dict):
        kwargs["ingest"] = p.ingest.IngestConfig(**kwargs["ingest"])
    service = p.rec.RecognizerService(pipeline, connector, frame_shape=FRAME_HW,
                                      flush_timeout=0.02, similarity_threshold=0.0, **kwargs)
    return pipeline, service, connector


def _settled(service) -> bool:
    return service.ledger()["in_system"] == 0


def _ledger(service):
    return dict(service.ledger())


def _strip(records):
    """Journal records without their wall-clock and trace stamps."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("ts", "dump")}
        r["frames"] = [{k: v for k, v in e.items() if k not in ("enqueue_ts", "trace_id")}
                       for e in r["frames"]]
        out.append(r)
    return out


# ---------- StagingRing ----------


def _ring_script(pkg):
    p = PKG[pkg]
    metrics = p.Metrics()
    ring = p.ingest.StagingRing([4, 8], FRAME_HW, np.uint8, depth=2, metrics=metrics)
    got = [ring.preallocated, metrics.counter(mn.INGEST_STAGING_ALLOCS)]
    buf = ring.acquire(3)
    big = ring.acquire(5)
    got += [buf.shape, buf.dtype.str, big.shape]
    ring.release(buf)
    again = ring.acquire(2)
    got += [again.shape, ring.alloc_count == ring.preallocated]
    ring.release(np.zeros((4, 3, 3), np.uint8))
    ring.release(np.zeros((4, *FRAME_HW), np.float32))
    got += [ring.stats(), metrics.counters(), metrics.gauge(mn.INGEST_STAGING_FREE)]
    return got


def test_staging_ring_preallocates_per_rung_and_recycles():
    port, ref = _ring_script("port"), _ring_script("jax")
    assert port == ref
    assert port[0] == 4 and port[2] == (4, *FRAME_HW) and port[4] == (8, *FRAME_HW)
    assert port[7]["free"] == {4: 1, 8: 1}
    assert port[8][mn.INGEST_STAGING_REUSE] >= 3


def _exhaustion_script(pkg):
    p = PKG[pkg]
    metrics = p.Metrics()
    ring = p.ingest.StagingRing([4], FRAME_HW, np.uint8, depth=1, metrics=metrics)
    held = ring.acquire(4)
    got = [held is not None, ring.acquire(1) is None, ring.alloc_count == ring.preallocated,
           metrics.counter(mn.INGEST_STAGING_EXHAUSTED), ring.free_slots()]
    woken = []
    ring.add_notify(lambda: woken.append(1))
    ring.release(held)
    got += [woken, ring.acquire(1) is not None, ring.acquire(4) is None]
    ring.forfeit(held)
    replacement = ring.acquire(4)
    got += [replacement is not None and replacement is not held,
            ring.alloc_count - ring.preallocated, ring.stats(), metrics.counters()]
    return got


def test_staging_ring_exhaustion_never_allocates_and_heals_on_forfeit():
    port, ref = _exhaustion_script("port"), _exhaustion_script("jax")
    assert port == ref
    assert port[:5] == [True, True, True, 1, 0]
    assert port[5] == [1] and port[6] and port[7] and port[8] and port[9] == 1
    assert port[11][mn.INGEST_STAGING_FORFEITS] == 1
    assert port[11][mn.INGEST_STAGING_ALLOCS] == 2


@BOTH
@pytest.mark.parametrize("batch, dtype", [(4, np.float32), (8, np.uint8)])
def test_batcher_rejects_mismatched_ring(pkg, batch, dtype):
    p = PKG[pkg]
    ring = p.ingest.StagingRing([4], FRAME_HW, np.uint8, depth=1)
    with pytest.raises(ValueError):
        p.batcher.FrameBatcher(batch, FRAME_HW, dtype=dtype, staging_ring=ring)


def test_free_slots_tracks_the_top_rung_only():
    got = {}
    for pkg in PACKAGES:
        ring = PKG[pkg].ingest.StagingRing([4, 8], FRAME_HW, np.uint8, depth=1)
        seq = [ring.free_slots()]
        held = ring.acquire(8)
        seq += [ring.free_slots(), ring.acquire(2) is not None]
        ring.forfeit(held)
        seq.append(ring.free_slots())
        got[pkg] = seq
    assert got["port"] == got["jax"] == [1, 0, True, 1]


def test_exhaustion_counts_episodes_not_polls():
    got = {}
    for pkg in PACKAGES:
        metrics = PKG[pkg].Metrics()
        ring = PKG[pkg].ingest.StagingRing([4], FRAME_HW, np.uint8, depth=1, metrics=metrics)
        ring.acquire(4)
        misses = [ring.acquire(4) is None] + [ring.acquire(4, quiet=True) is None
                                              for _ in range(10)]
        got[pkg] = (misses, metrics.counter(mn.INGEST_STAGING_EXHAUSTED))
    assert got["port"] == got["jax"] == ([True] * 11, 1)


def test_ring_depth_auto_sizes_to_cover_pipeline_overlap():
    for pkg in PACKAGES:
        cfg = PKG[pkg].ingest.IngestConfig
        assert cfg(mode="uint8").resolve_ring_depth(4) == 6
        assert cfg(mode="uint8", ring_depth=1).resolve_ring_depth(4) == 1
        _p, service, _c = _service(pkg, inflight_depth=3, ingest={"mode": "uint8"})
        assert service.ingest.staging.depth == 5
        assert service.ingest.staging.rungs == [2, 4] or service.ingest.staging.rungs == [4]


class _Fence:
    def __init__(self):
        self.done = False

    def query(self) -> bool:
        return self.done


def test_fenced_buffer_returns_only_after_its_upload_passed():
    """The port's lifetime rule: a buffer released while its upload may
    still read it is parked, not freed; the next acquire after the fence
    passed finds it again, and no allocation happened meanwhile."""
    metrics = mn.Metrics()
    ring = port_ingest.StagingRing([4], FRAME_HW, np.uint8, depth=1, metrics=metrics)
    buf = ring.acquire(4)
    fence = _Fence()
    ring.fence(buf[:2], fence)  # a bucket view starts at the buffer
    woken = []
    ring.add_notify(lambda: woken.append(1))
    ring.release(buf)
    assert ring.acquire(4) is None and woken == []
    fence.done = True
    again = ring.acquire(4)
    assert again is buf and ring.alloc_count == ring.preallocated == 1
    # a forfeit drops the fence with the buffer
    ring.fence(again, _Fence())
    ring.forfeit(again)
    assert ring.acquire(4) is not None and ring._fences == {}
    assert metrics.counter(mn.INGEST_STAGING_ALLOCS) == 2


def test_cpu_upload_is_the_staged_bytes_and_counts_them():
    metrics = mn.Metrics()
    ingest = port_ingest.IngestPipeline(port_ingest.IngestConfig("uint8"), [4], FRAME_HW,
                                        metrics=metrics, device="cpu")
    assert not ingest.staging.pinned
    buf = ingest.staging.acquire(4)
    buf[:] = 7
    out, nbytes, dur = ingest.upload(buf[:2])
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert out.data_ptr() == buf.ctypes.data and nbytes == 2 * 16 * 16 and dur >= 0
    assert metrics.counter(mn.INGEST_UPLOAD_BYTES) == nbytes
    assert ingest.stats()["pinned"] is False


# ---------- uint8 mode end to end ----------


@pytest.mark.parametrize("prewarm", ["uint8", "float32"])
def test_uint8_mode_allocs_and_the_watchdog_match_reference(prewarm):
    """Prewarmed at the ring's dtype, steady serving allocates nothing and
    captures nothing after warmup; prewarmed at f32 while staging uint8,
    the watchdog trips (the dtype is part of the step key)."""
    got = {}
    n = 64 if prewarm == "uint8" else 1
    for pkg in PACKAGES:
        metrics = PKG[pkg].Metrics()
        pipeline, service, connector = _service(pkg, metrics=metrics,
                                                ingest={"mode": "uint8"})
        assert service.batcher.dtype == np.uint8
        pipeline.prewarm_batch_shapes(service._bucket_ladder, FRAME_HW, np.dtype(prewarm))
        service._warmed = True
        service.start(warmup=False)
        try:
            for i in range(n):
                connector.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": i}})
            assert service.drain(timeout=20.0)
        finally:
            service.stop()
        c = metrics.counters()
        assert _settled(service)
        got[pkg] = (c[mn.FRAMES_COMPLETED],
                    c[mn.INGEST_STAGING_ALLOCS] == service.ingest.staging.preallocated,
                    c.get(mn.RECOMPILES_POST_WARMUP, 0) > 0, c[mn.INGEST_UPLOAD_BYTES] > 0)
    assert got["port"] == got["jax"] == (n, True, prewarm != "uint8", True)


@pytest.mark.parametrize("alias", [False, True])
def test_uint8_staging_rides_the_ring_like_the_reference(alias):
    """The ``--transfer-uint8`` alias's path is the ring's: the batcher
    stages in the ring's buffers and allocates nothing once warm."""
    got = {}
    for pkg in PACKAGES:
        ing = PKG[pkg].ingest
        mode = ing.resolve_ingest_mode(None, transfer_uint8=True, warn=False) if alias \
            else "uint8"
        metrics = PKG[pkg].Metrics()
        _p, service, connector = _service(pkg, metrics=metrics,
                                          ingest=ing.IngestConfig(mode=mode))
        assert service.batcher._ring is service.ingest.staging
        service.start(warmup=False)
        try:
            for i in range(24):
                connector.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": i}})
            assert service.drain(timeout=20.0)
        finally:
            service.stop()
        c = metrics.counters()
        got[pkg] = (c[mn.FRAMES_COMPLETED], c[mn.INGEST_STAGING_ALLOCS],
                    service.ingest.staging.preallocated, _settled(service))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 24 and got["port"][1] == got["port"][2]


# ---------- the hand-driven service: ring exhaustion and admission ----------


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jax_adm, jax_batcher, jax_fakes, jax_rec, port_batcher, port_fakes, port_rec,
                port_ingest, jax_ingest):
        monkeypatch.setattr(mod, "time", c)
    return c


def _hand_services(**kw):
    out = {}
    for pkg in PACKAGES:
        p = PKG[pkg]
        args = {k: (v(pkg) if callable(v) else v) for k, v in kw.items()}
        if isinstance(args.get("ingest"), dict):
            args["ingest"] = p.ingest.IngestConfig(**args["ingest"])
        pipeline = p.fakes.InstantPipeline(FRAME_HW)
        conn = p.Conn()
        service = p.rec.RecognizerService(
            pipeline, conn, batch_size=4, frame_shape=FRAME_HW, flush_timeout=0.02,
            similarity_threshold=0.0, metrics=p.Metrics(), readback_worker=False,
            bucket_sizes=(2, 4),
            resilience=p.res.ResiliencePolicy(readback_deadline_s=2.0, dispatch_retries=0,
                                              degraded_after=99), **args)
        service._running = True
        out[pkg] = (service, conn, pipeline)
    return out


def _serve_all(service, clock, drain=True):
    clock.advance(0.03)
    while True:
        batch = service.batcher.get_batch(block=False)
        if batch is None:
            break
        service._serve_one(batch)
        if drain:
            service._drain(force=True)


def test_ring_exhaustion_backpressures_through_admission(clock):
    """Every staging buffer in flight: the next batch waits queued, the
    admission rejects new intake with reason ``staging``, nothing is
    allocated; once the readbacks drain, everything settles. Equal in both
    packages, step for step."""
    pair = _hand_services(admission=lambda pkg: PKG[pkg].adm.AdmissionController(),
                          ingest={"mode": "uint8", "ring_depth": 1}, inflight_depth=8)
    for _s, _c, pipeline in pair.values():
        pipeline.compute_s = 0.5  # readbacks stay pending: the buffers in flight
    trace = {pkg: [] for pkg in PACKAGES}
    for step in range(6):
        for pkg, (service, conn, _p) in pair.items():
            for j in range(4):
                conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(),
                                                  "meta": {"step": step, "j": j}})
            _serve_all(service, clock, drain=False)  # batches stay in flight
            trace[pkg].append((service.ingest.staging.free_slots(),
                               service.batcher.pending, service.metrics.counters()))
    clock.advance(1.0)
    for pkg, (service, _c, _p) in pair.items():
        service._drain(force=True)
        _serve_all(service, clock)
        _serve_all(service, clock)
    assert trace["port"] == trace["jax"]
    (js, jc, _), (ps, pc, _) = pair["jax"], pair["port"]
    c = ps.metrics.counters()
    assert c == js.metrics.counters()
    assert c[mn.FRAMES_REJECTED_PREFIX + "staging"] > 0
    assert c[mn.INGEST_STAGING_ALLOCS] == ps.ingest.staging.preallocated
    assert _ledger(ps) == _ledger(js) and ps.ledger()["in_system"] == 0
    assert [m["meta"] for m in pc.messages(port_rec.RESULT_TOPIC)] == [
        m["meta"] for m in jc.messages(jax_rec.RESULT_TOPIC)]


@pytest.mark.parametrize("failure", ["dead_letter", "abandoned", "crash"])
def test_lost_batches_forfeit_and_the_ring_heals(clock, failure):
    """A dead-lettered readback, an abandoned dispatch and a dispatch crash
    each forfeit their staging buffer (a copy of it may be pending); the
    next batch heals the ring with one allocation. Equal in both
    packages."""
    injectors = {"jax": jax_faults.FaultInjector(), "port": port_faults.FaultInjector()}
    pair = _hand_services(ingest={"mode": "uint8", "ring_depth": 1},
                          fault_injector=lambda pkg: injectors[pkg])
    for pkg, (service, conn, pipeline) in pair.items():
        if pkg == "jax":
            pipeline.fault_injector = injectors[pkg]
        for j in range(4):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"j": j}})
        clock.advance(0.03)
        batch = service.batcher.get_batch(block=False)
        if failure == "dead_letter":
            pipeline.compute_s = 10.0
            service._serve_one(batch)
            clock.advance(5.0)
            service._drain(force=True)
            pipeline.compute_s = 0.0
        elif failure == "abandoned":
            injectors[pkg].script("dispatch", "unavailable")
            service._serve_one(batch)
        else:
            def boom(*_a, **_k):
                raise RuntimeError("dispatch loop bug")
            service._pick_bucket = boom
            with pytest.raises(RuntimeError):
                service._serve_one(batch)
            del service._pick_bucket
        for j in range(4):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"k": j}})
        _serve_all(service, clock)
    (js, _jc, _), (ps, _pc, _) = pair["jax"], pair["port"]
    assert ps.metrics.counters() == js.metrics.counters()
    assert ps.ingest.staging.stats() == js.ingest.staging.stats()
    c = ps.metrics.counters()
    assert c[mn.INGEST_STAGING_FORFEITS] == 1 and c[mn.INGEST_STAGING_ALLOCS] == 3
    assert c[mn.FRAMES_COMPLETED] == 4 and ps.ledger()["in_system"] == 0


def test_ingest_spans_match_reference(clock):
    """A traced batch carries a ``stage`` span (its rung) and an
    ``upload`` span per attempt (bytes and dtype), as in the reference."""
    tracers = {"jax": jax_tracing.Tracer(sample=1.0), "port": port_tracing.Tracer(sample=1.0)}
    pair = _hand_services(ingest={"mode": "uint8"}, tracer=lambda pkg: tracers[pkg])
    for pkg, (service, conn, _p) in pair.items():
        for j in range(3):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"j": j}})
        _serve_all(service, clock)
    spans = {}
    for pkg in PACKAGES:
        spans[pkg] = [{k: s[k] for k in s if k not in ("trace", "parent", "t0", "dur", "batch")}
                      for s in tracers[pkg].snapshot(topic=jax_tracing.BATCH_TOPIC)
                      if s["stage"] in ("stage", "upload")]
    assert spans["port"] == spans["jax"]
    assert [s["stage"] for s in spans["port"]] == ["stage", "upload"]
    assert spans["port"][0]["rung"] == 4 and spans["port"][0]["bucket"] == 4
    assert spans["port"][1]["bytes"] == 4 * 16 * 16 and spans["port"][1]["dtype"] == "uint8"


# ---------- compressed-frame intake ----------


@needs_jpeg
def test_synthetic_jpeg_generator_is_seeded_and_roundtrips():
    a = port_fakes.synthetic_jpeg_frames(3, FRAME_HW, seed=5, faces_per_frame=1)
    ref = jax_fakes.synthetic_jpeg_frames(3, FRAME_HW, seed=5, faces_per_frame=1)
    assert [p for p, _ in a] == [p for p, _ in ref]  # one codec, the same bytes
    assert all(np.array_equal(x, y) for (_p, x), (_q, y) in zip(a, ref))
    assert [p for p, _ in a] != [p for p, _ in port_fakes.synthetic_jpeg_frames(
        3, FRAME_HW, seed=6, faces_per_frame=1)]
    payload, src = a[0]
    decoded = port_ingest.decode_jpeg(payload)
    assert decoded.shape == FRAME_HW
    assert np.array_equal(decoded, jax_ingest.decode_jpeg(payload))
    assert float(np.abs(decoded.astype(np.int32) - src.astype(np.int32)).mean()) < 16.0
    msg = port_ingest.encode_jpeg_message(payload)
    assert msg == jax_ingest.encode_jpeg_message(payload)
    assert port_ingest.decode_jpeg_payload(msg) == payload


def _jpeg_run(pkg, payloads, bad=(), journal_path=None, injector=None, **ingest):
    """Serve JPEG payloads (and ``bad`` raw byte strings) through a traced
    service of ``pkg``; returns its counters, ledger, journal and spans."""
    p = PKG[pkg]
    metrics = p.Metrics()
    tracer = p.tracing.Tracer(sample=1.0)
    journal = (p.journal.DeadLetterJournal(journal_path, metrics=metrics)
               if journal_path else None)
    _pipe, service, conn = _service(pkg, metrics=metrics, tracer=tracer,
                                    dead_letter_journal=journal, fault_injector=injector,
                                    ingest={"mode": "jpeg", **ingest})
    service.start(warmup=False)
    try:
        for i, payload in enumerate(payloads):
            conn.inject(jax_rec.FRAME_TOPIC, {**p.ingest.encode_jpeg_message(payload),
                                              "meta": {"seq": i}})
        for k, raw in enumerate(bad):
            conn.inject(jax_rec.FRAME_TOPIC, {**p.ingest.encode_jpeg_message(raw),
                                              "meta": {"seq": 96 + k}})
        assert service.drain(timeout=30.0)
    finally:
        service.stop()
        if journal is not None:
            journal.close()
    spans = tracer.snapshot(topic=jax_rec.FRAME_TOPIC)
    return dict(counters=metrics.counters(), ledger=_ledger(service),
                journal=_strip(journal.records()) if journal else None,
                decode=sorted(s["ok"] for s in spans if s["stage"] == "decode"),
                settle=sorted(s.get("outcome") for s in spans if s["stage"] == "settle"),
                results=sorted(m["meta"]["seq"] for m in conn.messages(jax_rec.RESULT_TOPIC)),
                latency=metrics.percentile(mn.DECODE_LATENCY, 50))


_FRAME_COUNTS = (mn.FRAMES_ADMITTED, mn.FRAMES_COMPLETED, mn.FRAMES_DROPPED_DECODE,
                 mn.DECODE_FRAMES, mn.DECODE_ERRORS, mn.FRAMES_MALFORMED)


def _frame_counts(run):
    return {k: run["counters"].get(k, 0) for k in _FRAME_COUNTS}


@needs_jpeg
def test_jpeg_intake_decodes_off_thread_and_completes():
    payloads = [p for p, _ in jax_fakes.synthetic_jpeg_frames(16, FRAME_HW, seed=2)]
    runs = {pkg: _jpeg_run(pkg, payloads) for pkg in PACKAGES}
    port, ref = runs["port"], runs["jax"]
    assert _frame_counts(port) == _frame_counts(ref)
    assert port["counters"][mn.DECODE_FRAMES] == port["counters"][mn.FRAMES_COMPLETED] == 16
    assert port["decode"] == ref["decode"] == [True] * 16
    assert port["results"] == ref["results"] == list(range(16))
    assert port["ledger"] == ref["ledger"] and port["ledger"]["in_system"] == 0
    assert not np.isnan(port["latency"])


@needs_jpeg
def test_corrupt_jpeg_dead_letters_with_exact_settlement(tmp_path):
    good = [p for p, _ in jax_fakes.synthetic_jpeg_frames(4, FRAME_HW, seed=9)]
    bad = (good[0][:12], b"not a jpeg")
    runs = {pkg: _jpeg_run(pkg, good, bad, journal_path=str(tmp_path / f"{pkg}.jsonl"))
            for pkg in PACKAGES}
    port, ref = runs["port"], runs["jax"]
    assert _frame_counts(port) == _frame_counts(ref)
    c = port["counters"]
    assert (c[mn.FRAMES_COMPLETED], c[mn.FRAMES_DROPPED_DECODE], c[mn.DECODE_ERRORS]) == (4, 2, 2)
    assert port["ledger"] == ref["ledger"] and port["ledger"]["in_system"] == 0
    key = lambda r: r["frames"][0]["meta"]["seq"]  # noqa: E731 - sort key
    assert sorted(port["journal"], key=key) == sorted(ref["journal"], key=key)
    records = [r for r in port["journal"] if r["reason"] == "decode_error"]
    assert {e["meta"]["seq"] for r in records for e in r["frames"]} == {96, 97}
    assert all(e["stage"] == "ingest.decode" for r in records for e in r["frames"])
    assert port["settle"] == ref["settle"]
    assert port["settle"].count(mn.FRAMES_DROPPED_DECODE) == 2
    assert port["settle"].count("completed") == 4


@needs_jpeg
def test_decode_fault_pair_slow_and_corrupt_chaos():
    payloads = [p for p, _ in jax_fakes.synthetic_jpeg_frames(3, FRAME_HW, seed=4)]
    runs, injected = {}, {}
    for pkg in PACKAGES:
        injector = PKG[pkg].faults.FaultInjector(slow_decode_s=0.15)
        injector.script("decode", "slow", "corrupt")
        t0 = time.monotonic()
        runs[pkg] = _jpeg_run(pkg, payloads, injector=injector, decode_workers=1)
        assert time.monotonic() - t0 >= 0.15  # the slow fault really stalled
        injected[pkg] = dict(injector.injected)
    assert injected["port"] == injected["jax"] == {"decode:slow": 1, "decode:corrupt": 1}
    assert _frame_counts(runs["port"]) == _frame_counts(runs["jax"])
    c = runs["port"]["counters"]
    assert c[mn.FRAMES_COMPLETED] == 2 and c[mn.FRAMES_DROPPED_DECODE] == 1
    assert runs["port"]["ledger"]["in_system"] == 0


@needs_jpeg
def test_decode_backlog_overflow_is_an_explicit_ledger_drop(tmp_path):
    payloads = [p for p, _ in jax_fakes.synthetic_jpeg_frames(8, FRAME_HW, seed=7)]
    runs = {}
    for pkg in PACKAGES:
        injector = PKG[pkg].faults.FaultInjector(slow_decode_s=0.2)
        injector.script("decode", *["slow"] * 8)
        runs[pkg] = _jpeg_run(pkg, payloads, injector=injector, decode_workers=1,
                              decode_queue=2, journal_path=str(tmp_path / f"{pkg}.jsonl"))
    for run in runs.values():
        c = run["counters"]
        assert c[mn.FRAMES_DROPPED_DECODE] >= 1
        assert run["ledger"]["in_system"] == 0
        assert c[mn.FRAMES_DROPPED_DECODE] == len(
            [r for r in run["journal"] if r["reason"] == "decode_backlog"])
        assert all(e["stage"] == "ingest.decode_backlog" for r in run["journal"]
                   for e in r["frames"])


@needs_jpeg
def test_raising_sink_never_kills_a_decode_worker():
    payloads = [p for p, _ in jax_fakes.synthetic_jpeg_frames(3, FRAME_HW, seed=8)]
    got = {}
    for pkg in PACKAGES:
        p = PKG[pkg]
        metrics = p.Metrics()
        pool = p.ingest.DecodeWorkerPool(workers=1, metrics=metrics)
        settled = []

        def bad_sink(frame, message, priority, tid):
            raise RuntimeError("intake bug")

        def on_error(message, priority, tid, reason, settled=settled):
            settled.append((message.get("meta")["seq"], reason))
            if len(settled) == 2:
                raise RuntimeError("settlement bug too")

        pool.start(bad_sink, on_error)
        try:
            for i, payload in enumerate(payloads):
                assert pool.submit({**p.ingest.encode_jpeg_message(payload),
                                    "meta": {"seq": i}}, 0, 0)
            assert _wait(pool.idle, timeout=10.0)
        finally:
            pool.stop()
        got[pkg] = (settled, metrics.counter(mn.DECODE_ERRORS))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [(0, "decode_error"), (1, "decode_error"), (2, "decode_error")]
    assert got["port"][1] >= 3


def test_decode_pool_without_a_codec_raises_at_construction(monkeypatch):
    monkeypatch.setattr(port_ingest, "_CODEC_CACHE", (None, None))
    with pytest.raises(RuntimeError, match="JPEG codec"):
        port_ingest.DecodeWorkerPool()
    assert port_ingest.DecodeWorkerPool(decode_fn=lambda b: np.zeros(FRAME_HW)).workers == 2


def test_jpeg_payload_without_decode_pool_counts_malformed():
    got = {}
    for pkg in PACKAGES:
        metrics = PKG[pkg].Metrics()
        _p, service, conn = _service(pkg, metrics=metrics, ingest={"mode": "uint8"})
        service.start(warmup=False)
        try:
            conn.inject(jax_rec.FRAME_TOPIC, {PKG[pkg].ingest.JPEG_KEY: "AAAA",
                                              "meta": {"seq": 0}})
            assert service.drain(timeout=10.0)
        finally:
            service.stop()
        got[pkg] = (metrics.counter(mn.FRAMES_MALFORMED), _ledger(service))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1 and got["port"][1]["in_system"] == 0


def test_publish_crash_recycles_the_staging_buffer():
    """A publish crash after a completed readback returns the buffer to the
    ring (no heal credit would replace it), and after the restart the same
    buffer serves."""
    got = {}
    for pkg in PACKAGES:
        p = PKG[pkg]

        class ExplodingConnector(p.Conn):
            explode = True

            def publish(self, topic, message):
                if topic == jax_rec.RESULT_TOPIC and self.explode:
                    raise RuntimeError("result sink down")
                super().publish(topic, message)

        metrics = p.Metrics()
        connector = ExplodingConnector()
        service = p.rec.RecognizerService(
            p.fakes.InstantPipeline(FRAME_HW), connector, batch_size=4,
            frame_shape=FRAME_HW, flush_timeout=0.02, similarity_threshold=0.0,
            metrics=metrics, resilience=p.res.ResiliencePolicy(readback_deadline_s=2.0),
            ingest=p.ingest.IngestConfig(mode="uint8", ring_depth=1))
        service.start(warmup=False)
        try:
            connector.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": 0}})
            assert _wait(lambda: service.loop_crashed, timeout=10.0)
            assert _wait(lambda: service.ingest.staging.free_slots() == 1, timeout=5.0)
            connector.explode = False
            service.restart_loop()
            connector.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": 1}})
            assert _wait(lambda: metrics.counter(mn.FRAMES_COMPLETED) >= 1, timeout=10.0)
        finally:
            service.stop()
        got[pkg] = (service.ingest.staging.alloc_count, metrics.counter(mn.FRAMES_COMPLETED),
                    any(m.get("status") == "crashed"
                        for m in connector.messages(jax_rec.STATUS_TOPIC)))
    assert got["port"] == got["jax"] == (1, 1, True)


# ---------- the CLI's mode resolution and the names ----------


def test_transfer_uint8_flag_aliases_to_uint8_ingest_mode():
    for ing in (jax_ingest, port_ingest):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert ing.resolve_ingest_mode(None, transfer_uint8=True) == "uint8"
        assert any(issubclass(w.category, DeprecationWarning) for w in caught)
        assert ing.resolve_ingest_mode("jpeg", transfer_uint8=True, warn=False) == "jpeg"
        assert ing.resolve_ingest_mode(None, transfer_uint8=False) == "f32"
        with pytest.raises(ValueError):
            ing.resolve_ingest_mode("bf16")
        with pytest.raises(ValueError):
            ing.IngestConfig(mode="bf16")
    assert port_ingest.INGEST_MODES == jax_ingest.INGEST_MODES
    assert port_ingest.JPEG_KEY == jax_ingest.JPEG_KEY
    from opencv_facerecognizer_tpu_torch.apps.recognize import build_parser

    args = build_parser().parse_args(["--model", "m", "--detector", "d", "--gallery", "g",
                                      "--transfer-uint8"])
    assert args.ingest_mode is None and args.transfer_uint8
    cfg = port_ingest.IngestConfig(
        mode=port_ingest.resolve_ingest_mode(args.ingest_mode, args.transfer_uint8,
                                             warn=False),
        ring_depth=args.ingest_ring_depth or None, decode_workers=args.ingest_decode_workers)
    assert cfg.transfer_dtype == np.uint8 and cfg.ring_depth is None
    assert port_ingest.IngestConfig().transfer_dtype == np.float32


INGEST_NAMES = ("INGEST_STAGING_ALLOCS", "INGEST_STAGING_REUSE", "INGEST_STAGING_EXHAUSTED",
                "INGEST_STAGING_FORFEITS", "INGEST_STAGING_FREE", "INGEST_UPLOAD",
                "INGEST_UPLOAD_BYTES", "DECODE_LATENCY", "DECODE_QUEUE_DEPTH", "DECODE_FRAMES",
                "DECODE_ERRORS", "FRAMES_DROPPED_DECODE")


@pytest.mark.parametrize("name", INGEST_NAMES)
def test_ingest_metric_names_equal_the_reference(name):
    assert getattr(mn, name) == getattr(jax_names, name)


def test_decode_drop_is_a_ledger_bucket_in_the_reference_order():
    assert mn.FRAMES_DROPPED_DECODE in port_rec.mn.LEDGER_DROP_COUNTERS
    assert mn.LEDGER_DROP_COUNTERS == jax_names.LEDGER_DROP_COUNTERS
