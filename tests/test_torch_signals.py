"""The signals layer of the port against the JAX package's: ``SLOMonitor``
verdicts over one series of observations under one fake clock, the
Prometheus text of equal ``Metrics`` byte for byte, ``lint_prometheus_text``
on good and bad texts, and the exposition's read-only contract (405 for
any verb but GET, ``/health`` 503 on critical, the ``/spans`` bounds), the
supervisor's health announcements and the recompile watchdog.
"""

import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import expo as jax_expo
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import promtext as jax_prom
from opencv_facerecognizer_tpu.runtime import resilience as jax_res
from opencv_facerecognizer_tpu.runtime import slo as jax_slo
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.runtime.recognizer import FRAME_TOPIC, STATUS_TOPIC
from opencv_facerecognizer_tpu.utils import histogram as jax_hist
from opencv_facerecognizer_tpu.utils import metrics as jax_metrics
from opencv_facerecognizer_tpu.utils import tracing as jax_tracing
from opencv_facerecognizer_tpu_torch.runtime import expo as port_expo
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import promtext as port_prom
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_res
from opencv_facerecognizer_tpu_torch.runtime import slo as port_slo
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakeClock
from opencv_facerecognizer_tpu_torch.utils import histogram as port_hist
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing as port_tracing

FRAME_HW = (16, 16)
PKG = {"jax": (jax_slo, jax_metrics, jax_hist, jax_tracing),
       "port": (port_slo, mn, port_hist, port_tracing)}


def _metrics(name, clock, window_s=600.0, slices=20):
    """A ``Metrics`` whose windows run on ``clock``."""
    _slo, metrics_mod, hist_mod, _t = PKG[name]
    m = metrics_mod.Metrics(None, window_s, slices)
    m._latencies.default_factory = lambda: hist_mod.RollingHistogram(window_s, slices,
                                                                      clock=clock)
    return m


def _strip(verdict):
    return None if verdict is None else {k: v for k, v in verdict.items() if k != "ts"}


# ---------- SLO verdicts ----------


def _latency(slo_mod, **kw):
    return slo_mod.SLO(name="p99", kind="latency", window="w", threshold_s=0.1,
                       **{"target": 0.99, "short_s": 30.0, "long_s": 60.0, **kw})


def _ratio(slo_mod, target=0.9):
    return slo_mod.SLO(name="completion", kind="ratio", target=target,
                       bad_counters=(mn.FRAMES_DROPPED_BROWNOUT,),
                       total_counters=(mn.FRAMES_ADMITTED,), short_s=5.0, long_s=30.0)


def _script_latency(m, step, rng):
    for _ in range(int(rng.integers(0, 40))):
        m.observe("w", float(rng.choice([0.01, 0.05, 0.5, 2.0], p=[0.6, 0.3, 0.08, 0.02])))
    if step in (6, 7):
        for _ in range(200):
            m.observe("w", 1.0)


def _script_ratio(m, step, rng):
    m.incr(mn.FRAMES_ADMITTED, 50)
    m.incr(mn.FRAMES_DROPPED_BROWNOUT, 25 if step in (3, 4) else int(rng.integers(0, 3)))


def _script_floor(m, step, _rng):
    m.incr(mn.FRAMES_ADMITTED, 2 if step < 4 else 100)
    m.incr(mn.FRAMES_DROPPED_BROWNOUT, 1 if step < 4 else 50)


SLO_CASES = {
    # objectives(slo_mod, gauge_box), per-step script, monitor kwargs
    "latency_breach_and_recovery": (lambda s, g: [_latency(s)], _script_latency,
                                    dict(interval_s=5.0, recovery_evals=2)),
    "ratio_with_hysteresis": (lambda s, g: [_ratio(s)], _script_ratio,
                              dict(interval_s=5.0, recovery_evals=2)),
    "min_events_floor": (lambda s, g: [_ratio(s, target=0.999)], _script_floor,
                         dict(interval_s=5.0)),
    "gauge_and_dead_probe": (
        lambda s, g: [s.SLO(name="lag", kind="gauge", value_fn=lambda: g["value"](),
                            bound=1024.0)],
        lambda m, step, rng: None, dict(interval_s=5.0, recovery_evals=1)),
    "default_objectives": (
        lambda s, g: s.default_objectives(drop_counters=mn.LEDGER_DROP_COUNTERS,
                                          short_s=30.0, long_s=600.0),
        lambda m, step, rng: (_script_ratio(m, step, rng), m.observe(
            mn.QUEUE_WAIT, 0.4 if step > 5 else 0.01), m.observe(
            mn.E2E_LATENCY_INTERACTIVE, 0.05)), dict(interval_s=5.0)),
    "watchdog_events": (lambda s, g: [], lambda m, step, rng: None,
                        dict(interval_s=1.0, recovery_evals=1, event_window_s=10.0)),
}


@pytest.mark.parametrize("case", list(SLO_CASES))
def test_slo_verdict_sequences_match_reference(case):
    build, script, kw = SLO_CASES[case]
    clock = FakeClock(0.0)
    runs = {}
    for name in ("jax", "port"):
        clock.reset(0.0)
        slo_mod = PKG[name][0]
        m = _metrics(name, clock)
        values = iter([2048.0, 512.0, 7000.0, None, 100.0] * 4)

        def value():
            v = next(values)
            if v is None:
                raise RuntimeError("probe died")
            return v

        monitor = slo_mod.SLOMonitor(m, build(slo_mod, {"value": value}), clock=clock, **kw)
        rng = np.random.default_rng(3)
        verdicts = []
        for step in range(14):
            clock.advance(5.0)
            script(m, step, rng)
            if case == "watchdog_events" and step in (2, 3):
                monitor.note_event("recompile_post_warmup")
            verdicts.append(_strip(monitor.tick()))
            verdicts.append(_strip(monitor.tick()))  # inside the interval: None
        runs[name] = (verdicts, monitor.state, m.counters(), m.summary().get(mn.HEALTH_STATE))
    assert runs["port"] == runs["jax"]
    assert {v["state"] for v in runs["port"][0] if v} - {"ok"} or case == "min_events_floor"


def test_slo_transitions_span_and_dump_like_the_reference(tmp_path):
    clock = FakeClock(0.0)
    out = {}
    for name in ("jax", "port"):
        clock.reset(0.0)
        slo_mod, _m, _h, tracing = PKG[name]
        m = _metrics(name, clock)
        tracer = tracing.Tracer(sample=1.0, dump_dir=str(tmp_path / name),
                                min_dump_interval_s=0.0)
        monitor = slo_mod.SLOMonitor(m, [_ratio(slo_mod)], tracer=tracer, clock=clock)
        m.incr(mn.FRAMES_ADMITTED, 100)
        monitor.evaluate()
        clock.advance(40.0)
        m.incr(mn.FRAMES_ADMITTED, 50)
        m.incr(mn.FRAMES_DROPPED_BROWNOUT, 50)
        monitor.evaluate()
        spans = [(s["stage"], s["from_state"], s["to_state"])
                 for s in tracer.snapshot(topic=tracing.LIFECYCLE_TOPIC)]
        dumps = [p.name.split("-", 2)[2] for p in (tmp_path / name).iterdir()]
        out[name] = (spans, dumps, m.counter(mn.SLO_TRANSITIONS))
    assert out["port"] == out["jax"] == ([("health", "ok", "critical")],
                                         ["slo_critical.json"], 1.0)


@pytest.mark.parametrize("kwargs", [
    dict(name="x", kind="nope"),
    dict(name="x", kind="latency"),
    dict(name="x", kind="gauge"),
    dict(name="x", kind="gauge", value_fn=lambda: 0.0, bound=0.0),
    dict(name="x", kind="latency", window="w", target=1.5),
    dict(name="x", kind="latency", window="w", threshold_s=0.1, short_s=600.0, long_s=60.0),
])
def test_slo_validation_matches_reference(kwargs):
    for slo_mod in (jax_slo, port_slo):
        with pytest.raises(ValueError):
            slo_mod.SLO(**kwargs)


@pytest.mark.parametrize("window_s, slices, short_s, long_s, ok", [
    (60.0, 20, 30.0, 120.0, False), (600.0, 20, 5.0, 60.0, False),
    (600.0, 20, 30.0, 60.0, True), (3600.0, 120, 30.0, 3600.0, True)])
def test_monitor_window_checks_match_reference(window_s, slices, short_s, long_s, ok):
    for name in ("jax", "port"):
        slo_mod, metrics_mod = PKG[name][0], PKG[name][1]
        obj = slo_mod.SLO(name="p99", kind="latency", window="w", threshold_s=0.1,
                          short_s=short_s, long_s=long_s)
        if ok:
            slo_mod.SLOMonitor(metrics_mod.Metrics(window_s=window_s, window_slices=slices),
                               [obj])
        else:
            with pytest.raises(ValueError):
                slo_mod.SLOMonitor(metrics_mod.Metrics(window_s=window_s,
                                                       window_slices=slices), [obj])


def test_add_objective_and_stock_constructors_match_reference():
    class Service:
        loop_staleness_s = 45.0

    class Replica:
        lag_rows = 3000.0

    class Coordinator:
        class parity:
            disagreement = 0.05

    out = {}
    for name in ("jax", "port"):
        slo_mod, metrics_mod = PKG[name][0], PKG[name][1]
        monitor = slo_mod.SLOMonitor(metrics_mod.Metrics(), [], interval_s=5.0,
                                     clock=FakeClock(0.0))
        for obj in (slo_mod.loop_liveness_objective(Service(), stale_s=30.0),
                    slo_mod.replication_lag_objective(Replica(), rows_bound=1024.0),
                    slo_mod.disk_free_objective(lambda: 1 << 20, 4 << 20),
                    slo_mod.disk_free_objective(lambda: float("inf"), 4 << 20),
                    slo_mod.link_health_objective(lambda: 0.75),
                    slo_mod.rollout_parity_objective(Coordinator()),
                    slo_mod.registry_parity_objective(object())):
            monitor.add_objective(obj)
        out[name] = (_strip(monitor.evaluate()), monitor._counter_ring.maxlen,
                     monitor.event_window_s)
    assert out["port"] == out["jax"]


# ---------- Prometheus text ----------


def _fill(m, case):
    if case in ("counters", "all"):
        m.incr(mn.FRAMES_COMPLETED, 5)
        m.incr(mn.FRAMES_REJECTED_PREFIX + "overload", 2)
        m.incr(mn.BATCHER_DROPPED_PREFIX + "stale", 3)
        m.incr(mn.SLO_EVENTS_PREFIX + "recompile_post_warmup")
        m.incr(mn.TRACK_FLUSHES_PREFIX + "identity", 4)
        m.incr(mn.EXPO_REQUESTS, 0.5)
    if case in ("gauges", "all"):
        m.set_gauge(mn.BROWNOUT_LEVEL, 1)
        m.set_gauge(mn.SLO_BURN_PREFIX + "completion", 1.5)
        m.set_gauge(mn.STAGE_SHARE_PREFIX + "b32_embed", 0.36)
        m.set_gauge(mn.STAGE_SHARE_PREFIX + "bogus", 2.0)
        m.set_gauge(mn.DEVICE_BUSY_FRACTION, float("nan"))
        m.set_gauge(mn.DISK_FREE_BYTES, float("inf"))
    if case in ("histograms", "all"):
        for v in (0.001, 0.01, 0.1, 3.0, 1e-7):
            m.observe(mn.QUEUE_WAIT, v)
            m.observe(mn.E2E_LATENCY_INTERACTIVE, v * 2)
    if case == "escapes":
        m.incr(mn.FRAMES_REJECTED_PREFIX + 'bad"reason\\with\nnewline')
        m.incr("weird name-with.dots")


@pytest.mark.parametrize("case", ["empty", "counters", "gauges", "histograms", "escapes", "all"])
def test_prom_render_equal_byte_for_byte(case):
    clock = FakeClock(0.0)
    texts = {}
    for name in ("jax", "port"):
        m = _metrics(name, clock)
        _fill(m, case)
        texts[name] = (port_prom if name == "port" else jax_prom).render(m)
    assert texts["port"] == texts["jax"]
    assert port_prom.lint_prometheus_text(texts["port"]) == []


LINT_TEXTS = {
    "clean": "# HELP ocvf_x_total help\n# TYPE ocvf_x_total counter\nocvf_x_total 1\n",
    "no TYPE": "ocvf_x_total 1\n",
    "TYPE after samples": "ocvf_x_total 1\n# TYPE ocvf_x_total counter\n",
    "duplicate TYPE": "# TYPE ocvf_x counter\n# TYPE ocvf_x counter\nocvf_x 1\n",
    "bogus kind": "# TYPE ocvf_x bogus\nocvf_x 1\n",
    "unparseable value": "# TYPE ocvf_x gauge\nocvf_x twelve\n",
    "bad labels": '# TYPE ocvf_x gauge\nocvf_x{a=b} 1\n',
    "illegal escape": ('# TYPE ocvf_h histogram\nocvf_h_bucket{le="a\\q"} 1\n'
                       'ocvf_h_bucket{le="+Inf"} 1\nocvf_h_sum 1\nocvf_h_count 1\n'),
    "missing +Inf": ('# TYPE ocvf_h histogram\nocvf_h_bucket{le="0.1"} 1\n'
                     'ocvf_h_sum 1\nocvf_h_count 1\n'),
    "non-cumulative": ('# TYPE ocvf_h histogram\nocvf_h_bucket{le="0.1"} 5\n'
                       'ocvf_h_bucket{le="+Inf"} 3\nocvf_h_sum 1\nocvf_h_count 3\n'),
    "+Inf != count": ('# TYPE ocvf_h histogram\nocvf_h_bucket{le="0.1"} 1\n'
                      'ocvf_h_bucket{le="+Inf"} 2\nocvf_h_sum 1\nocvf_h_count 3\n'),
    "no sum": ('# TYPE ocvf_h histogram\nocvf_h_bucket{le="+Inf"} 2\nocvf_h_count 2\n'),
    "histogram without suffix": '# TYPE ocvf_h histogram\nocvf_h 1\n',
    "special values": '# TYPE ocvf_g gauge\nocvf_g NaN\nocvf_g{a="b"} +Inf\n',
}


@pytest.mark.parametrize("label", list(LINT_TEXTS))
def test_lint_agrees_with_reference(label):
    text = LINT_TEXTS[label]
    got = port_prom.lint_prometheus_text(text)
    assert got == jax_prom.lint_prometheus_text(text)
    assert bool(got) == (label not in ("clean", "special values"))


# ---------- the exposition ----------


def _expo_pair(critical: bool, tmp_path):
    """An ``ExpoServer`` of each package over one fake pipeline's service,
    a tracer with 20 spans and a monitor whose verdict is ok or critical."""
    out = {}
    for name, expo_mod, fakes, res in (("jax", jax_expo, jax_fakes, jax_res),
                                       ("port", port_expo, port_fakes, port_res)):
        slo_mod, metrics_mod, _h, tracing = PKG[name]
        metrics = metrics_mod.Metrics()
        tracer = tracing.Tracer(sample=1.0)
        for _ in range(20):
            tracer.emit(tracer.new_trace(), "receive", topic="t")
        monitor = slo_mod.SLOMonitor(metrics, [slo_mod.SLO(
            name="queue_wait_p99", kind="latency", window=mn.QUEUE_WAIT, threshold_s=0.5,
            target=0.9, short_s=30.0, long_s=60.0)], tracer=tracer)
        if critical:
            for _ in range(200):
                metrics.observe(mn.QUEUE_WAIT, 5.0)
        monitor.evaluate()
        _p, service, _c = fakes.build_overload_stack(
            frame_shape=FRAME_HW, batch_size=4, metrics=metrics, slo_monitor=monitor,
            tracer=tracer)
        kw = {"bench_path" if name == "jax" else "quotes_path": str(tmp_path / "none.json")}
        expo = expo_mod.ExpoServer(service, port=0, refresh_s=60.0, **kw)
        expo.start()
        out[name] = expo
    return out


def _request(expo, path, method="GET"):
    req = urllib.request.Request(f"http://{expo.host}:{expo.port}{path}", method=method,
                                 data=b"{}" if method != "GET" else None)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read().decode()


@pytest.fixture(scope="module")
def expos(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expo")
    pairs = {"ok": _expo_pair(False, tmp), "critical": _expo_pair(True, tmp)}
    yield pairs
    for pair in pairs.values():
        for expo in pair.values():
            expo.stop()


@pytest.mark.parametrize("method", ["POST", "PUT", "DELETE", "PATCH"])
def test_expo_refuses_every_verb_but_get(expos, method):
    got = {name: _request(expo, "/metrics", method) for name, expo in expos["ok"].items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 405


@pytest.mark.parametrize("verdict", ["ok", "critical"])
def test_expo_health_code_matches_reference(expos, verdict):
    got = {}
    for name, expo in expos[verdict].items():
        status, ctype, body = _request(expo, "/health")
        body = json.loads(body)
        got[name] = (status, ctype, body["state"], body["objectives"]["queue_wait_p99"]["burn"])
    assert got["port"] == got["jax"]
    assert got["port"][0] == (503 if verdict == "critical" else 200)


@pytest.mark.parametrize("query, want", [("topic=t&limit=5", 5), ("n=7", 7),
                                         ("limit=999999", 20), ("", 20), ("limit=abc", 400),
                                         ("limit=0", 400), ("limit=-3", 400),
                                         ("limit=1.5", 400)])
def test_expo_spans_bounds_match_reference(expos, query, want):
    got = {}
    for name, expo in expos["ok"].items():
        status, _ctype, body = _request(expo, f"/spans?{query}")
        body = json.loads(body)
        got[name] = (status, len(body["spans"]) if status == 200 else body["error"])
    assert got["port"] == got["jax"]
    assert (got["port"][0] == 400) if want == 400 else (got["port"] == (200, want))


@pytest.mark.parametrize("path", ["/", "/ledger", "/brownout", "/replicas", "/rollout",
                                  "/registry", "/tracks", "/nope"])
def test_expo_paths_match_reference(expos, path):
    got = {}
    for name, expo in expos["ok"].items():
        status, ctype, body = _request(expo, path)
        body = json.loads(body)
        if path == "/":
            body.pop("uptime_s")
            body.pop("endpoints")
        got[name] = (status, ctype, body)
    assert got["port"] == got["jax"]


def test_expo_prom_lints_clean_and_matches(expos):
    got = {}
    for name, expo in expos["ok"].items():
        status, ctype, text = _request(expo, "/prom")
        got[name] = (status, ctype, port_prom.lint_prometheus_text(text))
    assert got["port"] == got["jax"] and got["port"][2] == []


def test_expo_health_without_monitor_matches():
    got = {}
    for name, expo_mod in (("jax", jax_expo), ("port", port_expo)):
        expo = expo_mod.ExpoServer(metrics=PKG[name][1].Metrics(), port=0, refresh_s=60.0)
        expo.start()
        try:
            got[name] = _request(expo, "/health")
        finally:
            expo.stop()
    assert got["port"] == got["jax"] and json.loads(got["port"][2])["state"] is None


# ---------- the supervisor's announcements and the recompile watchdog ----------


def test_supervisor_health_announcements_match_reference():
    out = {}
    for name, fakes, res in (("jax", jax_fakes, jax_res), ("port", port_fakes, port_res)):
        slo_mod, metrics_mod = PKG[name][0], PKG[name][1]
        metrics = metrics_mod.Metrics()
        clock = FakeClock(0.0)
        monitor = slo_mod.SLOMonitor(metrics, [], interval_s=0.01, recovery_evals=1,
                                     event_window_s=0.05, clock=clock)
        _p, service, conn = fakes.build_overload_stack(frame_shape=FRAME_HW, batch_size=4,
                                                       metrics=metrics, slo_monitor=monitor)
        supervisor = res.ServiceSupervisor(service, poll_interval_s=10.0)
        for step in range(6):
            clock.advance(0.02)
            if step == 2:
                monitor.note_event("recompile_post_warmup")
            supervisor._check_health(service, STATUS_TOPIC)
            supervisor._check_health(service, STATUS_TOPIC)
        out[name] = [m for m in conn.messages(STATUS_TOPIC) if m.get("status") == "health"]
    assert out["port"] == out["jax"]
    assert [m["state"] for m in out["port"]] == ["warn", "ok"]


def test_recompile_watchdog_matches_reference():
    out = {}
    for name, fakes in (("jax", jax_fakes), ("port", port_fakes)):
        slo_mod, metrics_mod, _h, tracing = PKG[name]
        metrics = metrics_mod.Metrics()
        tracer = tracing.Tracer(sample=1.0)
        monitor = slo_mod.SLOMonitor(metrics, [], interval_s=3600.0, tracer=tracer)
        pipeline = fakes.InstantPipeline(FRAME_HW)
        conn = (JaxConnector if name == "jax" else PortConnector)()
        service = (jax_rec if name == "jax" else port_rec).RecognizerService(
            pipeline, conn, batch_size=4, frame_shape=FRAME_HW, flush_timeout=0.0,
            metrics=metrics, slo_monitor=monitor, tracer=tracer, readback_worker=False,
            bucket_sizes=(2, 4))
        pipeline.prewarm_batch_shapes(service._bucket_ladder, FRAME_HW, np.float32)
        service._warmed = True
        service._running = True
        frame = np.zeros(FRAME_HW, np.float32)

        def serve(seqs):
            for i in seqs:
                conn.inject(FRAME_TOPIC, {"frame": frame, "meta": {"seq": i}})
            while True:
                batch = service.batcher.get_batch(block=False)
                if batch is None:
                    break
                service._serve_one(batch)
                service._drain(force=True)

        serve(range(8))
        silent = metrics.counter(mn.RECOMPILES_POST_WARMUP)
        pipeline.compiled_batch_sizes.clear()
        serve(range(8, 12))
        spans = [s["bucket"] for s in tracer.snapshot(topic=tracing.LIFECYCLE_TOPIC)
                 if s["stage"] == "recompile"]
        out[name] = (silent, metrics.counter(mn.RECOMPILES_POST_WARMUP),
                     metrics.counter(mn.SLO_EVENTS_PREFIX + "recompile_post_warmup"), spans)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and out["port"][1] >= 1


@pytest.mark.parametrize("value", [1e-9, 0.002, 0.25, 7.0, 1e6])
def test_histogram_family_renders_bounds_like_the_reference(value):
    """The ``le`` bounds of a rendered histogram are the shared bucket
    schema in seconds, ``+Inf`` last, for any observation."""
    texts = {}
    for name, metrics_mod, prom in (("jax", jax_metrics, jax_prom), ("port", mn, port_prom)):
        m = metrics_mod.Metrics()
        m.observe(mn.DISPATCH, value)
        texts[name] = [line for line in prom.render(m).splitlines()
                       if line.startswith("ocvf_dispatch_seconds")]
    assert texts["port"] == texts["jax"]
    les = [line.split('le="')[1].split('"')[0] for line in texts["port"] if "le=" in line]
    assert les[-1] == "+Inf" and all(math.isfinite(float(v)) for v in les[:-1])
