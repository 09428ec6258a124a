"""The port's tracer against the JAX package's: the sampled frames for a
seed, the spans a service emits (stages, order, outcomes) for the same
scripted traffic, the flight-recorder dump, the rings, the span sink,
``account_spans``, ``device_busy_fraction`` and ``fold_attribution``
given one stage table.

The services run without their threads under one ``FakeClock`` (as in
``test_torch_overload``); span ids and timings are compared only where
both packages take them from that clock.
"""

import ast
import json
import os

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import batcher as jax_batcher
from opencv_facerecognizer_tpu.runtime import expo as jax_expo
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import journal as jax_journal
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import resilience as jax_res
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils import tracing as jax_tracing
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.runtime import batcher as port_batcher
from opencv_facerecognizer_tpu_torch.runtime import expo as port_expo
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import journal as port_journal
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_res
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakeClock
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing as port_tracing

FRAME_HW = (16, 16)
PKG = {"jax": (jax_tracing, jax_rec, jax_fakes, JaxConnector, JaxMetrics, jax_res, jax_journal),
       "port": (port_tracing, port_rec, port_fakes, PortConnector, mn.Metrics, port_res,
                port_journal)}


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jax_batcher, jax_fakes, jax_rec, jax_tracing, port_batcher, port_fakes,
                port_rec, port_tracing):
        monkeypatch.setattr(mod, "time", c)
    return c


# ---------- sampling ----------


@pytest.mark.parametrize("seed, rate", [(0, 0.5), (42, 0.5), (43, 0.5), (7, 0.1), (7, 0.9),
                                        (123, 0.25)])
def test_sampled_frames_equal_for_a_seed(seed, rate):
    ref = jax_tracing.Tracer(sample=rate, seed=seed)
    port = port_tracing.Tracer(sample=rate, seed=seed)
    a = [ref.start_trace("t") for _ in range(2000)]
    b = [port.start_trace("t") for _ in range(2000)]
    assert a == b
    assert 0 < sum(1 for t in a if t) < 2000


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_sampling_edge_rates_match(rate):
    ref = jax_tracing.Tracer(sample=rate)
    port = port_tracing.Tracer(sample=rate)
    assert [port.start_trace("t") for _ in range(50)] == [ref.start_trace("t") for _ in range(50)]
    assert port.new_trace() == ref.new_trace() == 2


# ---------- spans through the service ----------


def _service(name, tracer, **kw):
    tracing, rec, fakes, conn_cls, metrics_cls, res, _j = PKG[name]
    pipeline = fakes.InstantPipeline(FRAME_HW, compute_s=kw.pop("compute_s", 0.0))
    conn = conn_cls()
    kw.setdefault("resilience", res.ResiliencePolicy(readback_deadline_s=0.3,
                                                      dispatch_retries=0, degraded_after=99))
    service = rec.RecognizerService(pipeline, conn, batch_size=4, frame_shape=FRAME_HW,
                                    flush_timeout=0.01, similarity_threshold=0.0,
                                    metrics=metrics_cls(), tracer=tracer, readback_worker=False,
                                    **kw)
    service._running = True
    return service, conn


def _serve(service, clock):
    clock.advance(0.02)
    while True:
        batch = service.batcher.get_batch(block=False)
        if batch is None:
            return
        service._serve_one(batch)
        service._drain(force=True)


#: the attributes whose values come from the scripted traffic alone
_KEYS = ("trace", "span", "stage", "verdict", "priority", "outcome", "where", "batch", "bucket",
         "frames", "exit", "level", "from_level", "cache_hit", "hits", "t0", "dur")


def _comparable(spans):
    return [{k: s[k] for k in _KEYS if k in s} for s in spans]


def _spans_of(name, clock, scenario, tmp_path):
    clock.reset()
    tracing = PKG[name][0]
    tracer = tracing.Tracer(sample=1.0, dump_dir=str(tmp_path / name / "flight"),
                            min_dump_interval_s=0.0)
    kw = {}
    if scenario == "dead_letter":
        kw["compute_s"] = 10.0
    if scenario == "brownout":
        kw["brownout"] = PKG[name][5].BrownoutPolicy(queue_wait_s=0.005, dwell_s=0.0)
        kw["shed_stale_after_s"] = 0.05
    service, conn = _service(name, tracer, **kw)
    frame = np.zeros(FRAME_HW, np.float32)
    if scenario == "drops":
        conn.inject(jax_rec.FRAME_TOPIC, {"__frame__": "corrupt!", "shape": [1],
                                          "dtype": "float32", "meta": {}})
        conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros((3, 3), np.float32)})
    for i in range(10):
        clock.advance(0.001)
        pri = "bulk" if scenario == "brownout" and i % 2 else "interactive"
        conn.inject(jax_rec.FRAME_TOPIC, {"frame": frame, "meta": {"seq": i}, "priority": pri})
        if scenario == "brownout" and i == 3:
            clock.advance(0.1)  # the queued frames go stale
            _serve(service, clock)
    _serve(service, clock)
    if scenario == "dead_letter":
        clock.advance(1.0)
        service._drain(force=True)
    return tracer, service


@pytest.mark.parametrize("scenario", ["completed", "drops", "dead_letter", "brownout"])
def test_service_spans_match_reference(clock, tmp_path, scenario):
    spans, ledgers = {}, {}
    for name in ("jax", "port"):
        tracer, service = _spans_of(name, clock, scenario, tmp_path)
        spans[name] = tracer.snapshot()
        ledgers[name] = service.ledger()
    assert _comparable(spans["port"]) == _comparable(spans["jax"])
    acct = port_tracing.account_spans(spans["port"])
    assert acct == jax_tracing.account_spans(spans["jax"])
    led = ledgers["port"]
    assert acct["traced"] == led["admitted"]
    assert acct["completed"] == led["completed"]
    assert {k: float(v) for k, v in acct["drops"].items()} == led["drops_by_reason"]
    by_trace = {}
    for s in spans["port"]:
        if s["trace"] % 2:
            by_trace.setdefault(s["trace"], []).append(s["stage"])
    for stages in by_trace.values():
        assert stages[0] == "receive" and stages[-1] == "settle" and stages.count("settle") == 1


def test_flight_dump_on_dead_letter_matches_reference(clock, tmp_path):
    records = {}
    for name in ("jax", "port"):
        _tracer, service = _spans_of(name, clock, "dead_letter", tmp_path)
        names = sorted(os.listdir(tmp_path / name / "flight"))
        assert names and "dead_letter" in names[0]
        rec = json.loads((tmp_path / name / "flight" / names[0]).read_text())
        records[name] = (rec["reason"], rec["extra"]["frames"],
                         {t: _comparable(v) for t, v in rec["spans"].items()})
    assert records["port"] == records["jax"]


def test_dead_letter_journals_the_dump_and_the_stage(clock, tmp_path):
    rows = {}
    for name in ("jax", "port"):
        clock.reset()
        tracing, _rec, _f, _c, _m, res, journal_mod = PKG[name]
        tracer = tracing.Tracer(sample=1.0, dump_dir=str(tmp_path / name))
        journal = journal_mod.DeadLetterJournal(str(tmp_path / f"{name}.jsonl"))
        service, conn = _service(name, tracer, compute_s=10.0, dead_letter_journal=journal)
        for i in range(3):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros(FRAME_HW, np.float32),
                                              "meta": {"seq": i}})
        _serve(service, clock)
        clock.advance(1.0)
        service._drain(force=True)
        journal.close()
        (row,) = [r for r in journal.records() if r["reason"] == "dead_letter"]
        assert os.path.basename(row["dump"]).startswith("flight-")
        rows[name] = [(f["meta"], f["trace_id"], f["stage"]) for f in row["frames"]]
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 3


# ---------- the tracer alone ----------


@pytest.mark.parametrize("ring, n", [(16, 100), (4096, 10), (1, 3)])
def test_rings_bounded_like_the_reference(ring, n):
    out = {}
    for name in ("jax", "port"):
        tracer = PKG[name][0].Tracer(ring_size=ring, sample=1.0)
        for i in range(n):
            tracer.emit(tracer.new_trace(), "stage", topic="t" if i % 3 else "u", t0=float(i),
                        seq=i)
        out[name] = (tracer.snapshot(topic="t"), tracer.snapshot(), tracer.snapshot(limit=5),
                     tracer.topics(), tracer.stats())
    assert out["port"] == out["jax"]


def test_dump_rate_limit_and_retention_match(tmp_path):
    out = {}
    for name in ("jax", "port"):
        tracer = PKG[name][0].Tracer(sample=1.0, dump_dir=str(tmp_path / name), keep_dumps=3,
                                     min_dump_interval_s=60.0, metrics=PKG[name][4]())
        tracer.emit(tracer.new_trace(), "s", topic="t", t0=1.0)
        got = [tracer.dump("dead_letter") is not None, tracer.dump("dead_letter") is not None,
               tracer.dump("dead_letter", force=True) is not None]
        got += [tracer.dump("end", force=True) is not None for _ in range(5)]
        tracer.shed_fn = lambda: True
        got.append(tracer.dump("shed", force=True))
        out[name] = (got, sorted(os.listdir(tmp_path / name)), tracer.metrics.counters())
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 3


def test_lifecycle_spans_match(clock):
    out = {}
    for name in ("jax", "port"):
        tracer = PKG[name][0].Tracer(sample=1.0)
        with tracer.lifecycle("checkpoint", wal_seq=7) as attrs:
            attrs["rows"] = 3
        with pytest.raises(RuntimeError):
            with tracer.lifecycle("checkpoint"):
                raise RuntimeError("boom")
        out[name] = tracer.snapshot(topic=PKG[name][0].LIFECYCLE_TOPIC)
    assert out["port"] == out["jax"]


def test_span_sink_lines_match(tmp_path, clock):
    lines = {}
    for name in ("jax", "port"):
        tracing = PKG[name][0]
        sink = tracing.make_span_journal(str(tmp_path / f"{name}.jsonl"), metrics=PKG[name][4]())
        tracer = tracing.Tracer(sample=1.0, span_sink=sink)
        tid = tracer.new_trace()
        tracer.emit(tid, "receive", topic="frames", verdict="admitted")
        tracer.emit(tid, "settle", topic="frames", outcome="completed")
        sink.shed_fn = lambda: True
        tracer.emit(tid, "lost", topic="frames")
        sink.close()
        lines[name] = ((tmp_path / f"{name}.jsonl").read_text(), sink.metrics.counters())
    assert lines["port"] == lines["jax"]
    assert lines["port"][1] == {mn.TRACE_SPANS_SHED: 1.0}


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_device_busy_fraction_matches(seed):
    rng = np.random.default_rng(seed)
    spans = [{"stage": str(rng.choice(["ready_wait", "dispatch"])),
              "t0": float(rng.uniform(0, 100)), "dur": float(rng.exponential(2.0))}
             for _ in range(60)]
    for window in (5.0, 30.0, 120.0):
        assert (port_tracing.device_busy_fraction(spans, window_s=window, now=100.0)
                == jax_tracing.device_busy_fraction(spans, window_s=window, now=100.0))


def _quote_table(path):
    per_batch = {"8": {s: {"ms_per_batch": ms} for s, ms in
                       zip(port_expo.DEVICE_STAGES, (0.39, 0.14, 0.29, 0.32))},
                 "32": {s: {"ms_per_batch": ms} for s, ms in
                        zip(port_expo.DEVICE_STAGES, (0.70, 0.38, 0.85, 0.42))}}
    path.write_text(json.dumps({"card": "test", "stage_attribution": {"per_batch": per_batch}}))
    return str(path)


@pytest.mark.parametrize("buckets", [(8,), (32,), (8, 32), (16, 128)])
def test_fold_attribution_matches_given_one_table(tmp_path, buckets):
    path = _quote_table(tmp_path / "quotes.json")
    out = {}
    for name, expo, fold_kw in (("jax", jax_expo, "bench_path"), ("port", port_expo,
                                                                   "quotes_path")):
        tracing = PKG[name][0]
        tracer = tracing.Tracer(sample=1.0)
        for b in buckets:
            tid = tracer.new_trace()
            tracer.emit(tid, "dispatch", topic=tracing.BATCH_TOPIC, dur=0.001, bucket=b,
                        frames=b)
            tracer.emit(tid, "ready_wait", topic=tracing.BATCH_TOPIC, dur=0.01)
        metrics = PKG[name][4]()
        gauges = expo.fold_attribution(tracer, metrics, **{fold_kw: path})
        out[name] = gauges
    shares = {k: v for k, v in out["port"].items() if k.startswith(mn.STAGE_SHARE_PREFIX)}
    assert shares == {k: v for k, v in out["jax"].items() if k.startswith(mn.STAGE_SHARE_PREFIX)}
    assert len(shares) == 4 * len(buckets)
    assert out["port"][mn.DEVICE_BUSY_FRACTION] == pytest.approx(
        out["jax"][mn.DEVICE_BUSY_FRACTION], abs=1e-3)


def test_fold_attribution_without_a_table_sets_no_shares(tmp_path):
    tracer = port_tracing.Tracer(sample=1.0)
    tracer.emit(tracer.new_trace(), "dispatch", topic=port_tracing.BATCH_TOPIC, bucket=8)
    gauges = port_expo.fold_attribution(tracer, mn.Metrics(),
                                        quotes_path=str(tmp_path / "none.json"))
    assert list(gauges) == [mn.DEVICE_BUSY_FRACTION]
    assert port_expo.load_stage_quotes(str(tmp_path / "none.json")) == {}
    # the port's default table is its own (measured on the card), never the TPU's
    assert os.path.basename(port_expo.DEFAULT_QUOTES_PATH) == "stage_quotes_h100.json"
    port_dir = os.path.dirname(os.path.dirname(port_expo.__file__))
    for root, _dirs, files in os.walk(port_dir):
        for fn in files:
            if fn.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, fn)).read())
                assert not any(isinstance(n, ast.Constant) and isinstance(n.value, str)
                               and n.value.endswith("BENCH_DETAIL.json")
                               for n in ast.walk(tree)), fn
