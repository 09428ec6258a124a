"""The port's durability monitor, supervisor, fault injector, journal,
writer lease and backend probe (``runtime.resilience``, ``runtime.faults``,
``runtime.journal``, ``runtime.replication``, ``utils.backend_probe``)
against the JAX package's, and their wiring into ``RecognizerService``.

The same scripted faults drive both packages' monitors; their statuses
and counters are held equal. The service cases run stub pipelines on the
CPU (one face per frame, a linear stand-in for the embedder). Tolerance:
exact (states, counters, gallery mirrors).
"""

import errno
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import replication as jax_replication
from opencv_facerecognizer_tpu.runtime import resilience as jax_resilience
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.utils import metrics as jax_metrics
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import journal as port_journal
from opencv_facerecognizer_tpu_torch.runtime import replication as port_replication
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_resilience
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.utils import backend_probe
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

DIM = 16


def _jax_gallery(capacity=64):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    return JaxGallery(capacity=capacity, dim=DIM, mesh=mesh)


PKGS = {
    "jax": types.SimpleNamespace(state=jax_state, faults=jax_faults, res=jax_resilience,
                                 Metrics=jax_metrics.Metrics, gallery=_jax_gallery,
                                 lease=jax_replication),
    "torch": types.SimpleNamespace(state=port_state, faults=port_faults, res=port_resilience,
                                   Metrics=mn.Metrics,
                                   gallery=lambda capacity=64: PortGallery(capacity, DIM,
                                                                           device="cpu"),
                                   lease=port_replication),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def _rows(rng, n):
    return rng.normal(size=(n, DIM)).astype(np.float32)


# ---------- the fault injector and the journal ----------

@BOTH
@pytest.mark.parametrize("fault, code", [("enospc", errno.ENOSPC), ("eio", errno.EIO)])
def test_storage_write_faults_raise_the_right_errno(pkg, fault, code):
    inj = PKGS[pkg].faults.FaultInjector(seed=0)
    inj.script("storage", fault)
    with pytest.raises(OSError) as exc:
        inj.on_storage("journal_append")
    assert exc.value.errno == code
    inj.on_storage("journal_append")  # consumed exactly once
    assert inj.injected[f"storage:{fault}"] == 1


@BOTH
def test_storage_reads_and_writes_draw_their_own_kinds(pkg):
    inj = PKGS[pkg].faults.FaultInjector(seed=0)
    inj.script("storage", "read_error")
    inj.on_storage("write")  # a write crossing leaves the read fault queued
    with pytest.raises(OSError) as exc:
        inj.on_storage_read("checkpoint_read")
    assert exc.value.errno == errno.EIO
    with pytest.raises(ValueError):
        PKGS[pkg].faults.FaultInjector(rates={"storage": {"melt": 0.5}})
    with pytest.raises(ValueError):
        inj.script("wal", "enospc")


def test_dispatch_fault_is_retried_as_an_outage():
    """An injected ``UNAVAILABLE`` at the dispatch boundary takes the
    service's transient-retry path, as in the reference."""
    inj = port_faults.FaultInjector(seed=0)
    inj.script("dispatch", "unavailable", "unavailable")
    conn, service = _serve_frames(_OneFacePipeline(), 4, fault_injector=inj,
                                  resilience=port_resilience.ResiliencePolicy(
                                      backoff_base_s=0.001, backoff_max_s=0.002))
    c = service.metrics.counters()
    assert c[mn.DISPATCH_RETRIES] == 2 and c.get(mn.BATCHES_FAILED, 0) == 0
    assert len(conn.messages(RESULT_TOPIC)) == 4
    assert inj.summary() == {"dispatch:unavailable": 2}


def test_journal_sheds_lenient_appends_and_seals_torn_tails(tmp_path):
    path = str(tmp_path / "j.jsonl")
    m = mn.Metrics()
    j = port_journal.RotatingJournal(path, metrics=m)
    assert j.append_line('{"a": 1}')
    j.shed_fn = lambda: True
    assert not j.append_line('{"a": 2}')
    assert j.append_line('{"a": 3}', strict=True)  # strict appends never shed
    j.close()
    with open(path, "a") as fh:
        fh.write('{"torn": ')
    j2 = port_journal.RotatingJournal(path, metrics=m)
    assert j2.append_line('{"a": 4}')
    assert [r["a"] for r in j2.records()] == [1, 3, 4]
    assert m.counter(mn.JOURNAL_SHED) == 1 and m.counter(mn.JOURNAL_TORN_TAILS) == 1
    inj = port_faults.FaultInjector(seed=0)
    inj.script("storage", "enospc")
    j2._faults = inj
    assert not j2.append_line('{"a": 5}')
    with pytest.raises(OSError):
        inj.script("storage", "eio")
        j2.append_line('{"a": 6}', strict=True)
    assert m.counter(mn.JOURNAL_ERRORS) == 2


# ---------- the writer lease ----------

@pytest.mark.parametrize("holder, second", [("jax", "torch"), ("torch", "jax"),
                                            ("torch", "torch")])
def test_second_writer_fails_closed(holder, second, tmp_path):
    """Either package's lease excludes a second writer of either package;
    released, it can be taken again."""
    first = PKGS[holder].lease.WriterLease(str(tmp_path)).acquire()
    other = PKGS[second].lease.WriterLease(str(tmp_path), metrics=mn.Metrics()
                                           if second == "torch" else None)
    with pytest.raises(PKGS[second].lease.WriterLeaseHeldError, match="writer.lease"):
        other.acquire()
    first.release()
    other.acquire()
    assert other.held
    other.release()


# ---------- the durability monitor ----------

def _monitored(pkg, root, **kwargs):
    p = PKGS[pkg]
    inj = p.faults.FaultInjector(seed=0)
    m = p.Metrics()
    st = p.state.StateLifecycle(root, metrics=m, fault_injector=inj)
    g = p.gallery()
    st.bind(g, [])
    announced = []
    mon = p.res.DurabilityMonitor(st, metrics=m, publish=announced.append,
                                  fault_injector=inj, **kwargs)
    return st, g, mon, inj, m, announced


def _try_enroll(pkg, st, g, rng, label):
    emb = _rows(rng, 1)
    try:
        st.append_enrollment(emb, np.array([label], np.int32), subject=f"s{label}",
                             label=label, apply_fn=lambda: g.add(emb, np.array([label], np.int32)))
        return "ok"
    except PKGS[pkg].res.DurabilityDegradedError:
        return "refused"
    except OSError:
        return "wal_error"


def _wal_episode(pkg, root):
    st, g, mon, inj, m, announced = _monitored(pkg, root)
    rng = np.random.default_rng(0)
    trail = [_try_enroll(pkg, st, g, rng, 0)]
    # each failed append's best-effort tombstone crosses the boundary too
    inj.script("storage", *["enospc"] * 6)
    trail += [_try_enroll(pkg, st, g, rng, i) for i in (1, 2, 3, 4)]
    trail.append(mon.status()["degraded"])
    inj.script("storage", "eio")
    trail.append(mon.probe_now())  # still broken: no re-arm
    trail.append(mon.probe_now())  # healed
    trail += [mon.status()["degraded"], _try_enroll(pkg, st, g, rng, 5)]
    counters = {k: m.counter(k) for k in (
        mn.WAL_APPEND_ERRORS, mn.ENROLLMENTS_REFUSED_DEGRADED, mn.DURABILITY_DEGRADED_TRANSITIONS,
        mn.DURABILITY_REARMS, mn.DURABILITY_PROBES, mn.DURABILITY_PROBE_FAILURES,
        mn.WAL_APPENDS, mn.WAL_ABORTS)}
    st.close()
    return trail, [a["status"] for a in announced], counters, g.size


def test_monitor_flips_after_three_wal_failures_and_the_probe_rearms(tmp_path):
    """Three injected ENOSPC appends flip durability to degraded (the fourth
    enrolment is refused closed without touching the disk); a probe that
    fails keeps it degraded, one that succeeds re-arms it; the same trail,
    announcements and counters as the JAX package's monitor."""
    got = {pkg: _wal_episode(pkg, str(tmp_path / pkg)) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    trail, announced, counters, size = got["torch"]
    assert trail == ["ok", "wal_error", "wal_error", "wal_error", "refused", True, False, True,
                     False, "ok"]
    assert announced == ["durability_degraded", "durability_restored"]
    assert counters[mn.DURABILITY_DEGRADED_TRANSITIONS] == 1 and counters[mn.DURABILITY_REARMS] == 1
    assert size == 2


class _Statvfs:
    def __init__(self, holder):
        self.holder = holder

    def __call__(self, path):
        return types.SimpleNamespace(f_bavail=self.holder["free"], f_frsize=1)


def _watermark_episode(pkg, root):
    holder = {"free": 10_000}
    st, g, mon, _inj, m, announced = _monitored(
        pkg, root, low_watermark_bytes=6000, probe_interval_s=0.0, statvfs_fn=_Statvfs(holder))
    st.store.keep = 3
    trail = []
    for free in (10_000, 5_000, 4_000, 900, 5_000, 20_000):
        holder["free"] = free
        mon.tick(force=True)
        trail.append((mon.disk_state, mon.degraded, st.store.keep))
    counters = {k: m.counter(k) for k in (mn.DISK_PRESSURE_COMPACTIONS,
                                          mn.DISK_PRESSURE_RETENTION_SHRINKS,
                                          mn.DURABILITY_DEGRADED_TRANSITIONS)}
    st.close()
    return trail, [a["status"] for a in announced], counters


def test_watermarks_act_on_a_patched_statvfs(tmp_path):
    """Warn: one forced checkpoint and one retention shrink per episode;
    critical (below a sixth of the watermark): the degraded flip; the disk
    recovered: retention restored. As the JAX monitor does."""
    got = {pkg: _watermark_episode(pkg, str(tmp_path / pkg)) for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    trail, announced, counters = got["torch"]
    assert trail == [(0, False, 3), (1, False, 1), (1, False, 1), (2, True, 1), (1, True, 1),
                     (0, True, 3)]
    assert announced == ["disk_pressure", "durability_degraded"]
    assert counters == {mn.DISK_PRESSURE_COMPACTIONS: 1, mn.DISK_PRESSURE_RETENTION_SHRINKS: 1,
                        mn.DURABILITY_DEGRADED_TRANSITIONS: 1}


def test_serving_tick_never_probes_and_lease_loss_degrades(tmp_path, monkeypatch):
    st, _g, mon, inj, m, _a = _monitored("torch", str(tmp_path), probe_interval_s=0.0)
    mon._flip_degraded("test")
    mon.tick(force=True)  # the serving loop's tick: no probe
    assert m.counter(mn.DURABILITY_PROBES) == 0 and mon.degraded
    mon.tick(force=True, probe=True)  # the background thread's: probes, re-arms
    assert m.counter(mn.DURABILITY_PROBES) == 1 and not mon.degraded
    inj.script("storage", "read_error", "read_error", "read_error")
    for _ in range(3):
        mon._check_lease()
    assert mon.degraded and mon.degraded_reason == "lease_unreachable"
    st.close()


# ---------- service wiring ----------

class _OneFacePipeline:
    """Every frame: one face at (10, 10)-(50, 50), gallery label 0 at
    similarity 0.9; the embedder is a fixed linear map of the crop."""

    top_k = 1
    face_size = (8, 8)
    device = torch.device("cpu")

    def __init__(self, gallery=None):
        self.gallery = gallery
        self.swapped = False
        w = torch.Generator().manual_seed(0)
        self._proj = torch.randn(64, DIM, generator=w)

    def recognize_batch_packed(self, frames):
        packed = torch.zeros((len(frames), 4, 8))
        packed[:, 0] = torch.tensor([10.0, 10.0, 50.0, 50.0, 0.8, 1.0, 0.0, 0.9])
        return packed

    def prewarm_batch_shapes(self, sizes, frame_shape, dtype):
        return len(sizes)

    def embed_net(self, faces):
        return faces.reshape(len(faces), -1) @ self._proj


def _serve_frames(pipeline, n, supervisor=False, hook=None, **kw):
    conn = FakeConnector()
    if hook is not None:
        conn.subscribe(RESULT_TOPIC, hook)
    service = RecognizerService(pipeline, conn, batch_size=4, frame_shape=(64, 64),
                                flush_timeout=0.005, bucket_sizes=(), **kw)
    service.start()
    try:
        for i in range(n):
            conn.inject(FRAME_TOPIC, {"frame": np.full((64, 64), i, np.uint8), "meta": i})
        assert service.drain(timeout=30)
    finally:
        service.stop()
    return conn, service


def test_durable_enrolment_and_degraded_refusal_through_the_service(tmp_path):
    """``enroll`` on the control topic lands in the WAL before the gallery
    (a fresh recovery finds it); while durability is degraded the command
    is refused (``rejected``, ``durability_degraded``); ``stats`` carries
    the durable state's status."""
    gallery = PortGallery(16, DIM, device="cpu")
    st = port_state.StateLifecycle(str(tmp_path), metrics=mn.Metrics())
    mon = port_resilience.DurabilityMonitor(st, probe_interval_s=60.0)
    conn = FakeConnector()
    service = RecognizerService(_OneFacePipeline(gallery), conn, batch_size=1,
                                frame_shape=(64, 64), flush_timeout=0.001, bucket_sizes=(),
                                state_store=st, subject_names=["base"])
    service.start()
    try:
        conn.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": "carol", "count": 2})
        for i in range(3):
            conn.inject(FRAME_TOPIC, {"frame": np.full((64, 64), i, np.uint8), "meta": i})
        assert _wait(lambda: any(m["status"] == "enrolled"
                                 for m in conn.messages(STATUS_TOPIC)))
        mon._flip_degraded("test")
        conn.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": "dave", "count": 2})
        conn.inject(CONTROL_TOPIC, {"cmd": "stats"})
        assert service.drain(timeout=10)
    finally:
        service.stop()
    statuses = conn.messages(STATUS_TOPIC)
    assert [s["reason"] for s in statuses if s["status"] == "rejected"] == ["durability_degraded"]
    assert mon.publish == service._publish_status
    stats = [s for s in statuses if s["status"] == "stats"][0]
    assert stats["durability"]["degraded"] and stats["durability"]["wal_seq"] == 1
    g2, names = PortGallery(4, DIM, device="cpu"), ["base"]
    rep = port_state.StateLifecycle(str(tmp_path)).recover(g2, names)
    assert rep["replayed_records"] == 1 and names == ["base", "carol"]
    np.testing.assert_array_equal(g2.snapshot()[0][:2], gallery.snapshot()[0][:2])


def test_wal_failure_publishes_enroll_failed_and_drops_the_name(tmp_path):
    gallery = PortGallery(16, DIM, device="cpu")
    inj = port_faults.FaultInjector(seed=0)
    st = port_state.StateLifecycle(str(tmp_path), metrics=mn.Metrics(), fault_injector=inj)
    conn = FakeConnector()
    service = RecognizerService(_OneFacePipeline(gallery), conn, batch_size=1,
                                frame_shape=(64, 64), flush_timeout=0.001, bucket_sizes=(),
                                state_store=st)
    inj.script("storage", "enospc")
    service.start()
    try:
        conn.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": "carol", "count": 1})
        conn.inject(FRAME_TOPIC, {"frame": np.zeros((64, 64), np.uint8), "meta": 0})
        assert _wait(lambda: any(m["status"] == "enroll_failed"
                                 for m in conn.messages(STATUS_TOPIC)))
    finally:
        service.stop()
    failed = [m for m in conn.messages(STATUS_TOPIC) if m["status"] == "enroll_failed"]
    assert failed[0]["reason"] == "wal_error" and service.subject_names == []
    assert gallery.size == 0


@pytest.mark.parametrize("crash", ["readback", "dispatch"])
def test_supervisor_restores_and_replays_the_acked_tail_after_a_loop_crash(crash, tmp_path):
    """One injected crash: a result subscriber that raises once kills the
    readback worker ("readback"), or a state tick that raises once with a
    batch in hand kills the dispatch loop ("dispatch"). The supervisor
    restores its last-known-good snapshot, replays the enrolment
    acknowledged after it and restarts the dead thread; every frame gets
    one result or one ledger drop, later frames are served, and the
    graceful shutdown after it is clean."""
    gallery = PortGallery(16, DIM, device="cpu")
    gallery.add(np.eye(DIM, dtype=np.float32)[:2], np.array([0, 1], np.int32))
    m = mn.Metrics()
    st = port_state.StateLifecycle(str(tmp_path), metrics=m, checkpoint_wal_rows=1 << 30,
                                   checkpoint_every_s=1e9)
    conn = FakeConnector()
    raised = []

    def hook(_topic, message):
        if crash == "readback" and message["meta"] == 3 and not raised:
            raised.append(message["meta"])
            raise RuntimeError("subscriber bug")

    conn.subscribe(RESULT_TOPIC, hook)
    service = RecognizerService(_OneFacePipeline(gallery), conn, batch_size=4,
                                frame_shape=(64, 64), flush_timeout=1.0, bucket_sizes=(),
                                state_store=st, subject_names=["a", "b"], metrics=m)
    if crash == "dispatch":
        get_batch, tick = service.batcher.get_batch, st.tick

        def get_batch_then_arm(*args, **kwargs):
            batch = get_batch(*args, **kwargs)
            if batch is not None and not raised:
                raised.append(batch.count)
                st.tick = failing_tick
            return batch

        def failing_tick():
            st.tick = tick
            raise RuntimeError("tick bug")

        service.batcher.get_batch = get_batch_then_arm
    sup = port_resilience.ServiceSupervisor(service, state=st, poll_interval_s=0.02,
                                            restart_backoff_s=0.0)
    sup.start()
    try:
        emb = np.ones((2, DIM), np.float32)
        st.append_enrollment(emb, np.full(2, 2, np.int32), subject="late", label=2,
                             apply_fn=lambda: gallery.add(emb, np.full(2, 2, np.int32)))
        service.subject_names.append("late")
        for i in range(4):  # one batch; the crash hits it
            conn.inject(FRAME_TOPIC, {"frame": np.zeros((64, 64), np.uint8), "meta": i})
        assert _wait(lambda: m.counter(mn.SUPERVISOR_RESTARTS) == 1)
        for i in range(4, 8):
            conn.inject(FRAME_TOPIC, {"frame": np.zeros((64, 64), np.uint8), "meta": i})
        assert service.drain(timeout=10)
        assert _wait(lambda: len(conn.messages(RESULT_TOPIC)) >= 4)
    finally:
        report = port_state.graceful_shutdown(service, st, supervisor=sup)
    assert m.counter(mn.LOOP_CRASHES) == 1 and sup.restarts == 1
    assert gallery.size == 4 and service.subject_names == ["a", "b", "late"]
    assert m.counter(mn.WAL_TAIL_REPLAYED_ROWS) == 2
    metas = sorted(r["meta"] for r in conn.messages(RESULT_TOPIC))
    ledger = service.ledger()
    if crash == "readback":
        # the connector recorded frame 3's result before its subscriber
        # raised; the ledger settles that frame as a crash drop
        assert metas == list(range(8))
        assert ledger["drops_by_reason"] == {mn.FRAMES_DROPPED_CRASHED: 1}
    else:
        assert raised == [4] and metas == list(range(4, 8))
        assert ledger["drops_by_reason"] == {mn.FRAMES_DROPPED_CRASHED: 4}
    assert ledger["admitted"] == 8 and ledger["in_system"] == 0
    assert "supervisor_restart" in [s["status"] for s in conn.messages(STATUS_TOPIC)]
    assert report["clean"] and report["final_checkpoint"]


def test_supervisor_gives_up_after_max_restarts():
    gallery = PortGallery(16, DIM, device="cpu")
    conn = FakeConnector()
    conn.subscribe(RESULT_TOPIC, lambda _t, _m: (_ for _ in ()).throw(RuntimeError("bug")))
    service = RecognizerService(_OneFacePipeline(gallery), conn, batch_size=1,
                                frame_shape=(64, 64), flush_timeout=0.001, bucket_sizes=())
    sup = port_resilience.ServiceSupervisor(service, max_restarts=1, poll_interval_s=0.02,
                                            restart_backoff_s=0.0)
    sup.start()
    try:
        conn.inject(FRAME_TOPIC, {"frame": np.zeros((64, 64), np.uint8), "meta": 0})
        assert _wait(lambda: sup.restarts == 1)
        conn.inject(FRAME_TOPIC, {"frame": np.zeros((64, 64), np.uint8), "meta": 1})
        assert _wait(lambda: sup.gave_up)
    finally:
        sup.stop()
    statuses = [s["status"] for s in conn.messages(STATUS_TOPIC)]
    assert statuses.count("supervisor_gave_up") == 1
    assert service.metrics.counter(mn.SUPERVISOR_GAVE_UP) == 1


# ---------- the backend probe and degraded mode ----------

def test_probe_reports_the_missing_card_within_its_timeout():
    t0 = time.monotonic()
    usable, reason = backend_probe.probe_default_backend(timeout_s=120)
    assert time.monotonic() - t0 < 120
    if torch.cuda.is_available():
        assert usable, reason
    else:
        assert not usable and "no CUDA device" in reason


@pytest.mark.parametrize("source, want", [
    ("import time; time.sleep(30)", "deadline"),
    ("import sys; sys.exit(3)", "fewer than"),
    ("import sys; sys.exit(9)", "rc=9"),
    ("import sys; sys.exit(0)", "ok")])
def test_probe_verdicts_by_child_exit(source, want, monkeypatch):
    monkeypatch.setenv(backend_probe.RECOVERY_TIMEOUT_ENV, "4")
    usable, reason = backend_probe.probe_for_recovery(probe_source=source)
    assert usable == (want == "ok") and want in reason


class _DeadPipeline(_OneFacePipeline):
    def recognize_batch_packed(self, frames):
        raise RuntimeError("CUDA error: device unavailable")


def test_probe_on_degraded_reports_no_cpu_fallback_and_never_swaps():
    """``probe_backend_on_degraded``: the degraded status carries the
    probe's verdict and ``cpu_fallback: false``; the pipeline is never
    swapped (the port has no CPU fallback)."""
    pipeline = _DeadPipeline(PortGallery(16, DIM, device="cpu"))
    calls = []

    def probe():
        calls.append(1)
        return False, "no CUDA device"

    policy = port_resilience.ResiliencePolicy(dispatch_retries=3, degraded_after=2,
                                              backoff_base_s=0.001, backoff_max_s=0.002,
                                              probe_backend_on_degraded=True)
    conn, service = _serve_frames(pipeline, 2, resilience=policy, backend_probe_fn=probe)
    degraded = [s for s in conn.messages(STATUS_TOPIC) if s["status"] == "degraded"]
    assert len(degraded) == 1 and calls == [1]
    assert degraded[0]["backend_usable"] is False and degraded[0]["cpu_fallback"] is False
    assert service.pipeline is pipeline
    assert service.ledger()["in_system"] == 0


def test_force_cpu_override_is_not_ported(monkeypatch):
    """The reference's ``OCVF_DRYRUN_FORCE_CPU`` reports the backend dead to
    send callers to a CPU fallback; the port has none, so its probe still
    asks the card (ROADMAP C.8)."""
    from opencv_facerecognizer_tpu.utils import backend_probe as jax_probe

    monkeypatch.setenv(jax_probe.FORCE_CPU_ENV, "1")
    assert jax_probe.probe_default_backend(probe_source="import sys; sys.exit(0)")[0] is False
    assert backend_probe.probe_default_backend(
        timeout_s=30, probe_source="import sys; sys.exit(0)") == (True, "ok")
    assert not hasattr(backend_probe, "FORCE_CPU_ENV")
    assert (backend_probe.TIMEOUT_ENV, backend_probe.RECOVERY_TIMEOUT_ENV) == (
        jax_probe.TIMEOUT_ENV, jax_probe.RECOVERY_TIMEOUT_ENV)
    assert (backend_probe._RC_OK, backend_probe._RC_TOO_FEW_DEVICES,
            backend_probe._RC_CPU_FALLBACK) == (jax_probe._RC_OK, jax_probe._RC_TOO_FEW_DEVICES,
                                                jax_probe._RC_CPU_FALLBACK)


def test_reload_gallery_swaps_and_forces_a_durable_checkpoint(tmp_path):
    """``reload_gallery``: the rebuilt gallery's rows serve (an f32 donor
    cast to the serving bf16), ``reloaded`` is published, the commit hooks
    run, and a forced checkpoint makes the swap durable; a donor of
    another dim is refused."""
    serving = PortGallery(8, DIM, store_dtype=torch.bfloat16, device="cpu")
    serving.add(np.eye(DIM, dtype=np.float32)[:2], np.array([0, 1], np.int32))
    st = port_state.StateLifecycle(str(tmp_path))
    conn = FakeConnector()
    service = RecognizerService(_OneFacePipeline(serving), conn, batch_size=1,
                                frame_shape=(64, 64), state_store=st, subject_names=["a", "b"])
    hooks = []
    service.commit_hooks.append(lambda: hooks.append(1))
    donor = PortGallery(16, DIM, device="cpu")
    rows = _rows(np.random.default_rng(3), 5)
    donor.add(rows, np.arange(5, dtype=np.int32) % 2)
    service.reload_gallery(donor)
    assert serving.size == 5 and serving.capacity == 16
    assert serving.data.embeddings.dtype == torch.bfloat16
    assert [m["status"] for m in conn.messages(STATUS_TOPIC)] == ["reloaded"] and hooks == [1]
    assert _wait(lambda: not st._force_pending and not st._ckpt_lock.locked()
                 and st.store.checkpoint_files())
    g2 = PortGallery(4, DIM, device="cpu")
    port_state.StateLifecycle(str(tmp_path)).recover(g2, [])
    np.testing.assert_array_equal(g2.snapshot()[0], donor.snapshot()[0])
    from opencv_facerecognizer_tpu_torch.parallel.gallery import EmbeddingDimMismatchError

    with pytest.raises(EmbeddingDimMismatchError):
        serving.swap_from(PortGallery(4, DIM * 2, device="cpu"))
    st.close()
