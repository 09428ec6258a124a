"""Overload control of the port against the JAX package's: the token
bucket and the admission reasons, priority eviction and the stale shed,
the brownout controller, the dead-letter journal and the admission
ledger under mixed faults and overload.

Both packages run the same scripted inputs under one ``FakeClock``
(installed as each module's ``time``). The services are driven by hand,
without their threads: frames are injected on the fake connector
(handlers run synchronously), batches are popped without blocking and
served inline (``readback_worker=False``), so every outcome is
deterministic and must be equal in both packages.
"""

import json

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import admission as jax_adm
from opencv_facerecognizer_tpu.runtime import batcher as jax_batcher
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import journal as jax_journal
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import resilience as jax_res
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.runtime import admission as port_adm
from opencv_facerecognizer_tpu_torch.runtime import batcher as port_batcher
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import journal as port_journal
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_res
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakeClock
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

FRAME_HW = (16, 16)
PACKAGES = ("jax", "port")


@pytest.fixture
def clock(monkeypatch):
    """One fake clock as the ``time`` of every module whose timing the
    tests script, in both packages."""
    c = FakeClock()
    for mod in (jax_adm, jax_batcher, jax_fakes, jax_rec, port_batcher, port_fakes, port_rec):
        monkeypatch.setattr(mod, "time", c)
    return c


# ---------- priorities, the token bucket, admission ----------


@pytest.mark.parametrize("value", [None, "interactive", "Bulk", "enroll", 3, -2, "garbage",
                                   object(), 1.7, "INTERACTIVE"])
def test_parse_priority_matches_reference(value):
    assert port_adm.parse_priority(value) == jax_adm.parse_priority(value)
    assert (port_adm.PRIORITY_INTERACTIVE, port_adm.PRIORITY_BULK) == (
        jax_adm.PRIORITY_INTERACTIVE, jax_adm.PRIORITY_BULK)


@pytest.mark.parametrize("rate, burst", [(1000.0, 3), (50.0, 50), (10.0, 0.5)])
def test_token_bucket_matches_reference(clock, rate, burst):
    ref = jax_adm.TokenBucket(rate, burst)
    port = port_adm.TokenBucket(rate, burst, clock=clock)
    rng = np.random.default_rng(int(rate))
    got = []
    for _ in range(400):
        clock.advance(float(rng.exponential(1.0 / rate)) * rng.integers(0, 3))
        n = float(rng.choice([1.0, 1.0, 2.0]))
        got.append((ref.try_acquire(n), port.try_acquire(n)))
    assert [a for a, _b in got] == [b for _a, b in got]
    assert any(a for a, _b in got) and not all(a for a, _b in got)


@pytest.mark.parametrize("inflight, priority", [(0, 0), (74, 1), (75, 1), (80, 0), (99, 0),
                                                (100, 0), (100, 1), (250, 1)])
def test_admission_bound_and_reserve_match_reference(inflight, priority):
    kw = dict(max_inflight_frames=100, interactive_reserve=0.25,
              inflight_fn=lambda: inflight)
    ref = jax_adm.AdmissionController(**kw).admit("t", priority)
    assert port_adm.AdmissionController(**kw).admit("t", priority) == ref
    assert ref in (None, "overload")


def test_admission_rate_limit_and_staging_match_reference(clock):
    ref = jax_adm.AdmissionController(rate_limit_fps={"a": 50.0, "b": 0.0},
                                      burst_seconds=0.2, staging_free_fn=lambda: 1)
    port = port_adm.AdmissionController(rate_limit_fps={"a": 50.0, "b": 0.0},
                                        burst_seconds=0.2, staging_free_fn=lambda: 1,
                                        clock=clock)
    seq = []
    for i in range(120):
        clock.advance(0.004 if i % 3 else 0.0)
        topic = "a" if i % 4 else "b"
        seq.append((ref.admit(topic), port.admit(topic)))
    assert [a for a, _ in seq] == [b for _, b in seq]
    assert "rate_limit" in {a for a, _ in seq}
    starved = dict(staging_free_fn=lambda: 0)
    assert (port_adm.AdmissionController(**starved).admit("t")
            == jax_adm.AdmissionController(**starved).admit("t") == "staging")


# ---------- the batcher: priority eviction and the stale shed ----------


def _frame():
    return np.zeros(FRAME_HW, np.float32)


def _batchers(**kw):
    logs = {"jax": [], "port": []}
    out = {}
    for name, mod, metrics in (("jax", jax_batcher, JaxMetrics()),
                               ("port", port_batcher, mn.Metrics())):
        out[name] = mod.FrameBatcher(2, FRAME_HW, metrics=metrics,
                                     drop_log=lambda r, e, name=name: logs[name].append((r, e)),
                                     **kw)
    return out, logs


def _batcher_counters(b):
    return {k: v for k, v in b.metrics.counters().items() if k.startswith("batcher_")}


SCENARIOS = {
    # (kwargs, [(meta, priority, advance_s)], pops)
    "evicts_lowest_priority_first": (
        dict(flush_timeout=10.0, max_pending=3),
        [("bulk0", 1, 0), ("inter0", 0, 0), ("bulk1", 1, 0), ("inter1", 0, 0)], 2),
    "rejects_incoming_bulk": (
        dict(flush_timeout=10.0, max_pending=2),
        [("inter0", 0, 0), ("inter1", 0, 0), ("bulk0", 1, 0)], 1),
    "without_priorities_drops_oldest": (
        dict(flush_timeout=10.0, max_pending=2),
        [("a", 0, 0), ("b", 0, 0), ("c", 0, 0)], 1),
    "stale_frames_never_dispatched": (
        dict(flush_timeout=0.01, max_pending=8, stale_after_s=0.05),
        [("old0", 0, 0), ("old1", 1, 0.03), ("fresh", 0, 0.04)], 2),
    "stale_eviction_preferred_at_overflow": (
        dict(flush_timeout=10.0, max_pending=2, stale_after_s=0.05),
        [("old", 0, 0), ("mid", 1, 0.06), ("new", 0, 0.001)], 1),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_batcher_shedding_matches_reference(clock, scenario):
    kw, puts, pops = SCENARIOS[scenario]
    batchers, logs = _batchers(**kw)
    accepted = {name: [] for name in PACKAGES}
    for meta, priority, advance in puts:
        clock.advance(advance)
        for name in PACKAGES:
            accepted[name].append(batchers[name].put(_frame(), meta=meta, priority=priority,
                                                     trace_id=0))
    clock.advance(0.02)
    batches = {name: [] for name in PACKAGES}
    for _ in range(pops):
        for name in PACKAGES:
            b = batchers[name].get_batch(block=False)
            batches[name].append(None if b is None else (b.metas[:b.count], b.count,
                                                         b.enqueue_ts, b.priorities))
    assert accepted["port"] == accepted["jax"]
    assert batches["port"] == batches["jax"]
    assert logs["port"] == logs["jax"]
    assert _batcher_counters(batchers["port"]) == _batcher_counters(batchers["jax"])
    assert batchers["port"].pending == batchers["jax"].pending
    assert batchers["port"].stats == {k: v for k, v in batchers["jax"].stats.items()}


# ---------- services driven by hand ----------


def _services(journal_dir=None, **kw):
    """The same service in both packages over ``InstantPipeline``s and fake
    connectors, without threads. ``kw`` values that are callables get the
    package name and build the package's own object."""
    out = {}
    for name, rec, fakes, conn_cls, metrics in (
            ("jax", jax_rec, jax_fakes, JaxConnector, JaxMetrics()),
            ("port", port_rec, port_fakes, PortConnector, mn.Metrics())):
        args = {k: (v(name) if callable(v) else v) for k, v in kw.items()}
        if journal_dir is not None:
            mod = jax_journal if name == "jax" else port_journal
            args["dead_letter_journal"] = mod.DeadLetterJournal(str(journal_dir / f"{name}.jsonl"))
        args.setdefault("resilience", (jax_res if name == "jax" else port_res).ResiliencePolicy(
            readback_deadline_s=2.0, dispatch_retries=0, degraded_after=99))
        pipeline = fakes.InstantPipeline(FRAME_HW)
        if name == "jax" and args.get("fault_injector") is not None:
            # the reference's start() installs its dispatch boundary here
            pipeline.fault_injector = args["fault_injector"]
        conn = conn_cls()
        service = rec.RecognizerService(pipeline, conn, batch_size=4, frame_shape=FRAME_HW,
                                        flush_timeout=0.02, similarity_threshold=0.0,
                                        metrics=metrics, readback_worker=False,
                                        bucket_sizes=(2, 4), **args)
        service._running = True  # the loop's flag, without its thread
        out[name] = (service, conn, pipeline)
    return out


def _serve_all(service, clock, flush: bool = True):
    """Pop and serve every flushable batch inline."""
    if flush:
        clock.advance(0.03)
    while True:
        batch = service.batcher.get_batch(block=False)
        if batch is None:
            break
        service._serve_one(batch)
        service._drain(force=True)


def _ledger(service):
    return dict(service.ledger())


def _statuses(conn, topic):
    return [m for m in conn.messages(topic)]


def _policy(**kw):
    return lambda name: (jax_res if name == "jax" else port_res).BrownoutPolicy(**kw)


def _admission(**kw):
    def build(name):
        if name == "jax":
            return jax_adm.AdmissionController(**kw)
        return port_adm.AdmissionController(**kw)
    return build


def test_rejections_are_aggregated_like_the_reference(clock):
    pair = _services(admission=_admission(max_inflight_frames=6))
    for i in range(20):
        clock.advance(0.1 if i == 12 else 0.01)
        for name, (service, conn, _p) in pair.items():
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": i},
                                              "priority": "bulk" if i % 2 else None})
    for service, _c, _p in pair.values():
        service._flush_rejections(force=True)
    (js, jc, _), (ps, pc, _) = pair["jax"], pair["port"]
    assert _statuses(pc, port_rec.STATUS_TOPIC) == _statuses(jc, jax_rec.STATUS_TOPIC)
    assert ps.metrics.counters() == {k: v for k, v in js.metrics.counters().items()}
    assert _ledger(ps) == _ledger(js)
    assert ps.frames_in_system() == js.frames_in_system() == 6


BROWNOUT_CASES = {
    # policy, [(queue_wait_s, advance_s)], frames after each step (priorities)
    "enter_then_recover_with_hysteresis": (
        dict(queue_wait_s=0.05, exit_ratio=0.5, dwell_s=1.0, bulk_skip=2, max_level=2),
        [(0.2, 0.0), (0.2, 0.5), (0.04, 1.0), (0.04, 0.2), (0.0, 1.0), (0.0, 0.1), (0.0, 1.0)]),
    "max_level_sheds_all_bulk": (
        dict(queue_wait_s=0.05, dwell_s=0.01, max_level=2),
        [(0.5, 0.02), (0.5, 0.02), (0.5, 0.02), (0.5, 0.02)]),
    "idle_ticks_recover": (
        dict(queue_wait_s=0.05, dwell_s=0.02, max_level=1, ewma_alpha=0.9),
        [(0.5, 0.03), (0.5, 0.03)] + [(0.0, 0.03)] * 4),
}


@pytest.mark.parametrize("case", list(BROWNOUT_CASES))
def test_brownout_levels_match_reference(clock, case):
    policy, steps = BROWNOUT_CASES[case]
    pair = _services(brownout=_policy(**policy), slo_monitor=None)
    levels = {name: [] for name in PACKAGES}
    for i, (wait, advance) in enumerate(steps):
        clock.advance(advance)
        for name, (service, conn, _p) in pair.items():
            service._note_queue_wait(wait)
            for j, pri in enumerate(("bulk", "interactive", "bulk", "bulk")):
                conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "priority": pri,
                                                  "meta": {"step": i, "j": j}})
            levels[name].append(service.brownout_level)
    assert levels["port"] == levels["jax"]
    assert max(levels["port"]) >= 1
    (js, jc, _), (ps, pc, _) = pair["jax"], pair["port"]
    assert _statuses(pc, port_rec.STATUS_TOPIC) == _statuses(jc, jax_rec.STATUS_TOPIC)
    assert _ledger(ps) == _ledger(js)
    assert ps.metrics.gauge(mn.BROWNOUT_LEVEL) == js.metrics.gauge(mn.BROWNOUT_LEVEL)
    # the intake shed never takes an interactive frame
    assert (ps.metrics.counter(mn.FRAMES_DROPPED_BROWNOUT)
            <= ps.metrics.counter(mn.FRAMES_ADMITTED) * 3 / 4)


def test_max_level_caps_the_ladder_at_a_warm_rung(clock):
    pair = _services(brownout=_policy(queue_wait_s=0.05, dwell_s=0.0, max_level=2))
    for service, _c, pipeline in pair.values():
        # the warmup's ladder (the reference's fake pipeline has no embedder)
        pipeline.prewarm_batch_shapes(service._bucket_ladder, FRAME_HW, np.float32)
        service._warmed = True
        service._note_queue_wait(0.5)
        service._note_queue_wait(0.5)
        assert service.brownout_level == 2
    for i in range(5):
        for service, conn, _p in pair.values():
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": {"seq": i}})
    for service, _c, _p in pair.values():
        _serve_all(service, clock)
    (js, jc, jp), (ps, pc, pp) = pair["jax"], pair["port"]
    assert pp.batch_sizes_seen == jp.batch_sizes_seen and max(pp.batch_sizes_seen) == 2
    assert ps.metrics.counter(mn.RECOMPILES_POST_WARMUP) == 0  # the cap lands on a warm rung
    assert _ledger(ps) == _ledger(js)
    assert ([m["meta"] for m in pc.messages(port_rec.RESULT_TOPIC)]
            == [m["meta"] for m in jc.messages(jax_rec.RESULT_TOPIC)])


def test_dedup_window_matches_reference(clock):
    pair = _services(dedup_window=3)
    fids = [0, 1, 0, 2, 3, 4, 0, 1, "x", "x", None]
    for fid in fids:
        for service, conn, _p in pair.values():
            meta = {"_fid": fid} if fid is not None else {"k": 1}
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _frame(), "meta": meta})
    (js, _jc, _), (ps, _pc, _) = pair["jax"], pair["port"]
    assert ps.metrics.counter(mn.FRAMES_DEDUPED) == js.metrics.counter(mn.FRAMES_DEDUPED) == 2
    assert _ledger(ps) == _ledger(js)


def test_stats_command_carries_ledger_and_brownout(clock):
    pair = _services(brownout=_policy(queue_wait_s=0.5))
    for service, conn, _p in pair.values():
        conn.inject(jax_rec.CONTROL_TOPIC, {"cmd": "stats"})
    stats = {name: next(m for m in conn.messages(jax_rec.STATUS_TOPIC)
                        if m["status"] == "stats") for name, (_s, conn, _p) in pair.items()}
    for key in ("brownout_level", "degraded"):
        assert stats["port"][key] == stats["jax"][key]
    assert stats["port"]["ledger"]["in_system"] == stats["jax"]["ledger"]["in_system"] == 0


# ---------- the dead-letter journal ----------


def _entries(mod, n, stage="batcher.stale"):
    return [mod.DeadLetterJournal.frame_entry(meta={"seq": i}, enqueue_ts=float(i), priority=i % 2,
                                              trace_id=2 * i + 1, stage=stage) for i in range(n)]


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def test_journal_records_and_replay_match_reference(tmp_path):
    out = {}
    for name, mod in (("jax", jax_journal), ("port", port_journal)):
        j = mod.DeadLetterJournal(str(tmp_path / f"{name}.jsonl"), metrics=(
            JaxMetrics() if name == "jax" else mn.Metrics()))
        j.append("stale", _entries(mod, 3))
        j.append("dead_letter", _entries(mod, 2, "readback.dead_letter"), dump="/x/flight.json")
        j.append("brownout", _entries(mod, 1, "intake.brownout"), level=2)
        replayed = []
        n = j.replay(lambda e, replayed=replayed: replayed.append(e), reasons=("stale", "brownout"))
        out[name] = (_strip_ts(j.records()), n, _strip_ts(replayed),
                     {k: v for k, v in j.metrics.counters().items() if k.startswith("journal_")})
        j.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == 4


@pytest.mark.parametrize("backups", [0, 1, 2])
def test_journal_rotation_matches_reference(tmp_path, backups):
    files = {}
    for name, mod in (("jax", jax_journal), ("port", port_journal)):
        d = tmp_path / name
        d.mkdir()
        j = mod.DeadLetterJournal(str(d / "j.jsonl"), max_bytes=600, backups=backups)
        for i in range(20):
            j.append("stale", _entries(mod, 2))
        files[name] = (sorted(p.name for p in d.iterdir()), len(list(j.records())))
        j.close()
    assert files["port"] == files["jax"]


def test_journal_failure_never_raises_like_the_reference(tmp_path):
    counts = {}
    for name, mod, metrics in (("jax", jax_journal, JaxMetrics()),
                               ("port", port_journal, mn.Metrics())):
        blocker = tmp_path / f"{name}_dir"
        blocker.write_text("a file where the journal's directory would be")
        j = mod.DeadLetterJournal(str(tmp_path / f"{name}.jsonl"), metrics=metrics)
        j.path = str(blocker / "j.jsonl")  # every write fails
        j.append("stale", _entries(mod, 1))
        j.shed_fn = lambda: True
        j.append("stale", _entries(mod, 1))
        counts[name] = metrics.counters()
    assert counts["port"] == counts["jax"] == {mn.JOURNAL_ERRORS: 1.0, mn.JOURNAL_SHED: 1.0}


@pytest.mark.parametrize("argv", [[], ["--reason", "stale"], ["--trace", "3"],
                                  ["--stage", "readback.dead_letter"],
                                  ["--stage", "batcher.stale", "--trace", "5"],
                                  ["--reason", "dead_letter", "--trace", "3"]])
def test_journal_cli_matches_reference(tmp_path, capsys, argv):
    outs = {}
    for name, mod in (("jax", jax_journal), ("port", port_journal)):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod.DeadLetterJournal(path)
        j.append("stale", _entries(mod, 3))
        j.append("dead_letter", _entries(mod, 2, "readback.dead_letter"), dump="/f.json")
        j.close()
        assert mod.main([path, *argv]) == 0
        outs[name] = _strip_ts(json.loads(line) for line in capsys.readouterr().out.splitlines())
    assert outs["port"] == outs["jax"]


# ---------- the ledger under mixed faults and overload ----------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_buckets_match_reference_under_faults_and_overload(clock, tmp_path, seed):
    """Admission bound, brownout, the stale shed, a poisoned dispatch and
    malformed frames in one scripted storm: every admitted frame lands in
    one bucket, the buckets and the journals are equal in both packages."""
    injectors = {"jax": jax_faults.FaultInjector(seed=seed),
                 "port": port_faults.FaultInjector(seed=seed)}
    pair = _services(journal_dir=tmp_path,
                     admission=_admission(max_inflight_frames=12),
                     brownout=_policy(queue_wait_s=0.04, dwell_s=0.1),
                     shed_stale_after_s=0.2,
                     fault_injector=lambda name: injectors[name])
    rng = np.random.default_rng(seed)
    for step in range(60):
        op = rng.integers(0, 10)
        clock.advance(float(rng.choice([0.0, 0.005, 0.05, 0.25])))
        for name, (service, conn, _p) in pair.items():
            if op == 0:
                conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros((3, 3), np.float32),
                                                  "meta": {"step": step}})
            elif op == 1:
                conn.inject(jax_rec.FRAME_TOPIC, {"__frame__": "!!", "shape": [1],
                                                  "dtype": "float32", "meta": {}})
            elif op == 2:
                injectors[name].script("dispatch", "unavailable")
            elif op in (3, 4):
                _serve_all(service, clock, flush=False)
            else:
                conn.inject(jax_rec.FRAME_TOPIC, {
                    "frame": _frame(), "meta": {"step": step, "_fid": step % 50},
                    "priority": "bulk" if op % 2 else "interactive"})
    for name, (service, _conn, _p) in pair.items():
        injectors[name].disarm()
        _serve_all(service, clock)
        _serve_all(service, clock)
        service.journal.close()
    (js, jc, _), (ps, pc, _) = pair["jax"], pair["port"]
    led = _ledger(ps)
    assert led == _ledger(js)
    assert led["in_system"] == 0 and led["admitted"] > 0
    assert led["completed"] == len(pc.messages(port_rec.RESULT_TOPIC))
    assert led["admitted"] == led["completed"] + sum(led["drops_by_reason"].values())
    assert ([m["meta"] for m in pc.messages(port_rec.RESULT_TOPIC)]
            == [m["meta"] for m in jc.messages(jax_rec.RESULT_TOPIC)])
    assert (_strip_ts(ps.journal.records()) == _strip_ts(js.journal.records()))
    assert _statuses(pc, port_rec.STATUS_TOPIC) == _statuses(jc, jax_rec.STATUS_TOPIC)
