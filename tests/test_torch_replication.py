"""The port's read replicas against the JAX package's: both packages'
``WALTailer`` over one scripted WAL, both packages' ``ReadReplica`` over
one writer's state dir (a JAX writer and a port writer) through dedup,
abort tombstones before and after apply, a compaction reopen, an embedder
cutover fence, stacked cutovers, a late start and a registry fence, the
service's replica role (the poll between batches, enrolment refused, the
link echo), and the registry re-anchor's weights (ROADMAP C.15).

After every poll both replicas must hold equal gallery mirrors (rows,
labels, valid flags, size, bit for bit), names, ``applied_seq``,
``seen_seq``, ``lag_rows``, stats and replication metrics. Both replicas
read one ``runtime.fakes.FakeClock`` (installed as each replication
module's ``time``), so their lag seconds agree too.
"""

import os
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import registry as jax_registry
from opencv_facerecognizer_tpu.runtime import replication as jax_repl
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline, unpack_result
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import registry as port_registry
from opencv_facerecognizer_tpu_torch.runtime import replication as port_repl
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

DIM = 8
HW = (16, 16)


def _jax_gallery(capacity=64):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    return JaxGallery(capacity=capacity, dim=DIM, mesh=mesh)


def _port_gallery(capacity=64):
    return PortGallery(capacity, DIM, device="cpu")


PKG = {
    "jax": types.SimpleNamespace(repl=jax_repl, state=jax_state, registry=jax_registry,
                                 rec=jax_rec, fakes=jax_fakes, Conn=JaxConnector,
                                 Metrics=JaxMetrics, gallery=_jax_gallery),
    "port": types.SimpleNamespace(repl=port_repl, state=port_state, registry=port_registry,
                                  rec=port_rec, fakes=port_fakes, Conn=PortConnector,
                                  Metrics=mn.Metrics, gallery=_port_gallery),
}

#: the replication counters and gauges both replicas must agree on
METRIC_NAMES = (mn.REPLICATION_POLLS, mn.REPLICATION_RECORDS_APPLIED,
                mn.REPLICATION_ROWS_APPLIED, mn.REPLICATION_CORRUPT_RECORDS,
                mn.REPLICATION_WAL_REOPENS, mn.REPLICATION_RESYNCS,
                mn.REPLICATION_ABORTS_AFTER_APPLY, mn.ROLLOUT_REPLICA_REANCHORS,
                mn.CHECKPOINTS_CORRUPT)
GAUGE_NAMES = (mn.REPLICATION_LAG_ROWS, mn.REPLICATION_LAG_S, mn.ROLLOUT_REPLICA_AWAITING)


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both replication modules."""
    fake = port_fakes.FakeClock()
    for mod in (jax_repl, port_repl):
        monkeypatch.setattr(mod, "time", fake)
    return fake


# ---------- the tailer ----------


def _tailer_script(path):
    """Steps that write the WAL file as a writer, a torn append, a sealed
    remnant, a compaction swap and a shrink would."""

    def write(text, mode="a"):
        def step():
            with open(path, mode) as fh:
                fh.write(text)
        return step

    def swap(text):
        def step():
            with open(path + ".tmp", "w") as fh:
                fh.write(text)
            os.replace(path + ".tmp", path)
        return step

    return [
        lambda: None,  # missing
        write('{"kind": "enroll", "seq": 1}\n{"kind": "enr', "w"),
        lambda: None,  # the partial line stays pending
        write('oll", "seq": 2}\n'),
        write('garbage-torn-line\n[1, 2]\n{"kind": "abort", "seq": 2}\n\n'),
        write('{"kind": "enroll", "seq": 3, "x": "\\u00e9"}'),  # no newline yet
        write('\n'),
        swap('{"kind": "enroll", "seq": 4}\n'),  # compaction: a new inode
        write('{"kind": "enroll", "seq": 5}\n'),
        write('{"kind": "enroll", "seq": 6}\n', "w"),  # a shrink on the same inode
        lambda: None,
    ]


def test_tailers_read_one_scripted_wal_alike(tmp_path):
    path = str(tmp_path / "enroll.wal")
    jt = jax_repl.WALTailer(path, metrics=JaxMetrics())
    pt = port_repl.WALTailer(path, metrics=mn.Metrics())
    seen = []
    for step in _tailer_script(path):
        step()
        got_j, got_p = jt.poll(), pt.poll()
        assert got_p == got_j
        assert (pt.reopens, pt.malformed_lines) == (jt.reopens, jt.malformed_lines)
        seen.append(got_p)
    assert [r["seq"] for recs, _ in seen for r in recs] == [1, 2, 2, 3, 4, 5, 6]
    assert pt.malformed_lines == 2 and pt.reopens == 2
    assert pt.metrics.counter(mn.REPLICATION_WAL_REOPENS) == 2


def test_tailers_count_a_read_error_alike(tmp_path):
    """The storage boundary's read side: an injected EIO is a counted poll
    error, and the next poll reads on."""
    from opencv_facerecognizer_tpu.runtime import faults as jax_faults
    from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults

    path = str(tmp_path / "enroll.wal")
    with open(path, "w") as fh:
        fh.write('{"kind": "enroll", "seq": 1}\n')
    out = {}
    for name, faults in (("jax", jax_faults), ("port", port_faults)):
        injector = faults.FaultInjector()
        injector.script("storage", "read_error")
        metrics = PKG[name].Metrics()
        tailer = PKG[name].repl.WALTailer(path, metrics=metrics, fault_injector=injector)
        out[name] = [tailer.poll(), tailer.poll(), metrics.counter(mn.REPLICATION_POLL_ERRORS)]
    assert out["port"] == out["jax"]
    assert out["port"][0] == ([], {"reopened": False, "partial": False, "error": True})


# ---------- two readers over one writer ----------


class _Writer:
    """A writer of one package over a small gallery, with a registry."""

    def __init__(self, name, root):
        p = PKG[name]
        self.name, self.root = name, root
        self.gallery = p.gallery()
        self.names = []
        self.state = p.state.StateLifecycle(root, metrics=p.Metrics(),
                                            checkpoint_wal_rows=1 << 30,
                                            checkpoint_every_s=1e9)
        self.state.bind(self.gallery, self.names)
        self.registry = p.registry.ModelRegistry(root)
        self.state.attach_registry(self.registry)
        self.rng = np.random.default_rng(0)
        self.subjects = 0

    def enroll(self, n=1):
        emb = self.rng.normal(size=(n, DIM)).astype(np.float32)
        i = self.subjects
        self.subjects += 1
        labels = np.full(n, i, np.int32)
        self.names.append(f"s{i}")
        self.state.append_enrollment(emb, labels, subject=f"s{i}", label=i,
                                     apply_fn=lambda: self.gallery.add(emb, labels))

    def raw_enroll_then_abort(self, together=True):
        """A burned seq: the enroll record (and its tombstone)."""
        emb = self.rng.normal(size=(1, DIM)).astype(np.float32)
        seq = self.state.wal_seq + 1
        self.state._wal_seq = seq
        self.state.wal.append_enroll(seq, emb, np.zeros(1, np.int32))
        if together:
            self.state.wal.append_abort(seq)
        return seq

    def cutover(self, version):
        emb, lab, val, size = self.gallery.snapshot()
        self.state.perform_cutover(version, lambda: (emb, lab, val, size))

    def registry_swap(self, role, version):
        self.state.perform_registry_cutover(role, version)

    def checkpoint(self):
        assert self.state.checkpoint_now(wait=True)


def _replica(name, root, registry=True, gallery=None, **kw):
    p = PKG[name]
    rep = p.repl.ReadReplica(root, p.gallery() if gallery is None else gallery, [],
                             metrics=p.Metrics(), poll_interval_s=0.0, name="r", **kw)
    if registry:
        rep.registry = p.registry.ModelRegistry(root, metrics=rep.metrics, readonly=True)
    return rep


def _view(rep, result):
    emb, lab, val, size = rep.gallery.snapshot()
    m = rep.metrics
    return dict(result=result, emb=np.asarray(emb), lab=np.asarray(lab), val=np.asarray(val),
                size=int(size), capacity=int(rep.gallery.capacity),
                names=list(rep.subject_names), stats=rep.stats(),
                counters={n: m.counter(n) for n in METRIC_NAMES},
                gauges={n: m.gauge(n) for n in GAUGE_NAMES})


def _assert_same(jv, pv, where):
    for key in ("emb", "lab", "val"):
        np.testing.assert_array_equal(pv[key], jv[key], err_msg=f"{where}: {key}")
    for key in ("result", "size", "capacity", "names", "stats", "counters", "gauges"):
        assert pv[key] == jv[key], f"{where}: {key}"


def _writer_mirrors_equal(writer, rep):
    we, wl, wv, ws = writer.gallery.snapshot()
    re_, rl, rv, rs = rep.gallery.snapshot()
    assert ws == rs
    np.testing.assert_array_equal(np.asarray(re_)[:rs], np.asarray(we)[:ws])
    np.testing.assert_array_equal(np.asarray(rl)[:rs], np.asarray(wl)[:ws])
    assert list(rep.subject_names) == list(writer.names)


def _scenario(kind):
    """(steps, late): each step acts on the writer, then both pairs of
    replicas poll; ``late`` starts a second pair after the steps."""
    if kind == "tail_dedup_compaction":
        return [lambda w: [w.enroll(2) for _ in range(3)], lambda w: None,
                lambda w: [w.enroll() for _ in range(3)], lambda w: None,
                lambda w: w.checkpoint(), lambda w: [w.enroll() for _ in range(2)],
                lambda w: None], True
    if kind == "aborts":
        return [lambda w: w.enroll(), lambda w: w.raw_enroll_then_abort(True),
                lambda w: w.raw_enroll_then_abort(False),
                lambda w: w.state.wal.append_abort(w.state.wal_seq),
                lambda w: w.enroll(), lambda w: w.checkpoint(),
                lambda w: w.state.wal.truncate_below(w.state.wal_seq),
                lambda w: w.enroll()], True
    if kind == "cutover":
        return [lambda w: [w.enroll() for _ in range(3)], lambda w: w.cutover(2),
                lambda w: w.enroll(), lambda w: None, lambda w: w.checkpoint(),
                lambda w: w.enroll(), lambda w: None], True
    if kind == "stacked_cutovers":
        return [lambda w: [w.enroll() for _ in range(3)], lambda w: w.cutover(2),
                lambda w: None, lambda w: w.cutover(3), lambda w: w.checkpoint(),
                lambda w: w.enroll()], True
    if kind == "late_start":
        return [lambda w: [w.enroll() for _ in range(3)], lambda w: w.cutover(2),
                lambda w: w.checkpoint(), lambda w: w.enroll()], True
    if kind == "registry_fence":
        return [lambda w: [w.enroll() for _ in range(2)],
                lambda w: w.registry_swap("detector", 2), lambda w: w.enroll(),
                lambda w: None, lambda w: w.checkpoint(),
                lambda w: w.registry_swap("cascade", 2), lambda w: w.checkpoint(),
                lambda w: w.enroll()], True
    raise ValueError(kind)


SCENARIOS = ("tail_dedup_compaction", "aborts", "cutover", "stacked_cutovers", "late_start",
             "registry_fence")


@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
@pytest.mark.parametrize("kind", SCENARIOS)
def test_replicas_of_both_packages_tail_one_writer_alike(tmp_path, clock, writer_pkg, kind):
    root = str(tmp_path / "state")
    writer = _Writer(writer_pkg, root)
    steps, late = _scenario(kind)
    start = 0 if kind != "late_start" else len(steps)
    reps = {}
    for i, step in enumerate(steps + ([lambda w: None] if late else [])):
        if i < len(steps):
            step(writer)
        clock.advance(0.25)
        if i == start:
            reps = {n: _replica(n, root) for n in ("jax", "port")}
        if not reps:
            continue
        views = {n: _view(r, r.poll(force=True)) for n, r in reps.items()}
        _assert_same(views["jax"], views["port"], f"{kind} step {i}")
    port = reps["port"]
    assert port.lag_rows == 0 and port.stats()["awaiting_cutover"] is None
    if kind != "late_start":
        # caught up with the writer's own gallery at the end
        _writer_mirrors_equal(writer, port)
    late_reps = {n: _replica(n, root) for n in ("jax", "port")}
    views = {n: _view(r, r.poll(force=True)) for n, r in late_reps.items()}
    _assert_same(views["jax"], views["port"], f"{kind} late replica")
    _writer_mirrors_equal(writer, late_reps["port"])
    if kind == "aborts":
        assert port.metrics.counter(mn.REPLICATION_ABORTS_AFTER_APPLY) == 1
    if kind in ("cutover", "stacked_cutovers"):
        assert port.embedder_version == writer.gallery.embedder_version > 1
        # the gallery's re-anchor, and the manifest's embedder mirror moving
        assert port.metrics.counter(mn.ROLLOUT_REPLICA_REANCHORS) == 2
    if kind == "registry_fence":
        assert port.registry.stamp() == {"embedder": 1, "detector": 2, "cascade": 2}
    writer.state.close()


def test_a_parked_replica_keeps_its_rows_and_counts_its_lag(tmp_path, clock):
    """Parked on a fence, neither replica applies the rows behind it, both
    count them in ``lag_rows``, and the awaiting gauge reads 1."""
    root = str(tmp_path / "state")
    writer = _Writer("jax", root)
    writer.enroll()
    reps = {n: _replica(n, root) for n in ("jax", "port")}
    for r in reps.values():
        r.poll(force=True)
    for step in (lambda: writer.cutover(2), lambda: [writer.enroll() for _ in range(2)]):
        step()
        views = {n: _view(r, r.poll(force=True)) for n, r in reps.items()}
        _assert_same(views["jax"], views["port"], "parked")
    port = reps["port"]
    assert port.lag_rows == 3 and port.gallery.size == 1
    assert port.metrics.gauge(mn.ROLLOUT_REPLICA_AWAITING) == 1
    assert views["port"]["result"] == {"records": 0, "rows": 0, "awaiting_version": 2}
    writer.state.close()


def test_resync_keeps_its_stage_seconds_and_calls_the_drain_hook(tmp_path):
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll(2)
    writer.checkpoint()
    writer.enroll()
    calls = []
    rep = _replica("port", root)
    rep.on_resync = calls.append
    report = rep.resync()
    assert report["applied_rows"] == 1 and report["checkpoint"]
    assert set(rep.last_resync_s) == {"read_verify", "decode", "load_snapshot", "registry",
                                      "tail"}
    assert calls == ["begin", "end"]
    writer.state.close()


def test_a_resync_onto_another_dim_raises(tmp_path):
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll()
    writer.checkpoint()
    rep = port_repl.ReadReplica(root, PortGallery(64, DIM * 2, device="cpu"), [])
    with pytest.raises(ValueError, match="dim"):
        rep.resync()
    writer.state.close()


# ---------- the service's replica role ----------


def _reader_service(name, root, **kw):
    p = PKG[name]
    pipe = p.fakes.InstantPipeline(HW, faces_per_frame=1)
    rep = _replica(name, root)
    pipe.gallery = rep.gallery
    conn = p.Conn()
    service = p.rec.RecognizerService(pipe, conn, batch_size=2, frame_shape=HW,
                                      flush_timeout=0.02, metrics=rep.metrics,
                                      readback_worker=False, bucket_sizes=(2,), replica=rep,
                                      **kw)
    service._running = True
    return service, conn, rep


def test_reader_services_refuse_enrolment_and_echo_pings_alike(tmp_path):
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll()
    out = {}
    for name in ("jax", "port"):
        service, conn, rep = _reader_service(name, root)
        rep.poll(force=True)
        conn.inject(PKG[name].rec.CONTROL_TOPIC, {"cmd": "enroll", "subject": "x"})
        conn.inject(PKG[name].rec.LINK_PING_TOPIC, {"ping": 7})
        statuses = [m for m in conn.messages(PKG[name].rec.STATUS_TOPIC)]
        pongs = conn.messages(PKG[name].rec.LINK_PONG_TOPIC)
        out[name] = (statuses, [m["ping"] for m in pongs],
                     service.metrics.counter(mn.REPLICATION_ENROLL_REJECTED))
    assert out["port"] == out["jax"]
    assert out["port"][0][0]["reason"] == "read_replica" and out["port"][2] == 1
    assert out["port"][1] == [7]
    assert port_rec.LINK_PING_TOPIC == jax_rec.LINK_PING_TOPIC
    assert port_rec.LINK_PONG_TOPIC == jax_rec.LINK_PONG_TOPIC
    writer.state.close()


def test_the_serving_loop_polls_the_replica_between_batches(tmp_path):
    """Both packages' loops, threads on: rows the writer enrols after the
    start reach the reader; a poll that raises only counts."""
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll()
    for name in ("jax", "port"):
        p = PKG[name]
        pipe = p.fakes.InstantPipeline(HW)
        rep = _replica(name, root)
        rep.poll_interval_s = 0.01
        rep.poll(force=True)
        pipe.gallery = rep.gallery
        service = p.rec.RecognizerService(pipe, p.Conn(), batch_size=2, frame_shape=HW,
                                          flush_timeout=0.02, metrics=rep.metrics,
                                          replica=rep)
        service.start(warmup=False)
        try:
            n0 = writer.gallery.size
            writer.enroll()
            deadline = time.monotonic() + 10
            while rep.gallery.size < n0 + 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert rep.gallery.size == n0 + 1, name
            rep.poll = lambda force=False: (_ for _ in ()).throw(OSError("disk blip"))
            deadline = time.monotonic() + 10
            while (service.metrics.counter(mn.REPLICATION_POLL_ERRORS) < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert service.metrics.counter(mn.REPLICATION_POLL_ERRORS) >= 1, name
            assert not service.loop_crashed
        finally:
            service.stop()
    writer.state.close()


# ---------- a registry re-anchor installs the weights (ROADMAP C.15) ----------


def _marking_jax_pipeline(gallery):
    """The reference's fake pipeline answering one face whose label is the
    detector version its weights are (``installed``)."""

    class Marking(jax_fakes.InstantPipeline):
        installed = 1

        def recognize_batch_packed(self, frames):
            out = super().recognize_batch_packed(frames)
            out._arr[:, 0, 6] = self.installed
            return out

    pipe = Marking(HW, faces_per_frame=1)
    pipe.gallery = gallery
    return pipe


def _port_stack():
    gen = torch.Generator().manual_seed(0)
    det = port_detector.CNNFaceDetector(features=(16, 16), head_features=16, max_faces=4,
                                        space_to_depth=4, dtype=torch.float32, device="cpu",
                                        generator=gen)
    with torch.no_grad():
        det.net.heatmap.bias.fill_(0.0)
        det.net.size.bias.fill_(3.0)
    net = port_embedder.FaceEmbedNet(embed_dim=DIM, stem_features=8, stage_features=(8, 16),
                                     stage_blocks=(2, 1), input_size=(32, 32),
                                     dtype=torch.float32, generator=gen)
    pipe = RecognitionPipeline(det, net, _port_gallery(), face_size=(32, 32), device="cpu")
    v1 = {k: v.clone() for k, v in det.params.items()}
    v2 = {k: v + 0.3 * torch.randn(v.shape, generator=gen) for k, v in v1.items()}
    return pipe, det, v1, v2


def test_a_reader_runs_the_weights_its_registry_stamp_names(tmp_path, clock):
    """A detector swap on the writer, v1 -> v2, with the candidate staged
    at ``registry_params_path``: both readers park on the fence and
    re-anchor on the covering checkpoint. The reference's reader then
    stamps detector 2 on batches its v1 weights ran (it reloads the
    manifest and flushes its caches only); the port's installs the staged
    v2 weights at the re-anchor, so its stamp 2 names the weights that ran
    and its results equal a direct call of v2 (ROADMAP C.15)."""
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll(2)
    writer.checkpoint()
    pipe, det, v1, v2 = _port_stack()
    staged = port_registry.registry_params_path(root, "detector", 2)
    os.makedirs(os.path.dirname(staged), exist_ok=True)
    det.load_params(v2)
    det.save(staged)
    det.load_params(v1)
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64)).astype(np.float32)

    readers = {}
    for name in ("jax", "port"):
        p = PKG[name]
        rep = _replica(name, root, registry=False,
                       gallery=pipe.gallery if name == "port" else None)
        rep.poll(force=True)
        rep.registry = p.registry.ModelRegistry(root, metrics=rep.metrics, readonly=True)
        if name == "jax":
            served = _marking_jax_pipeline(rep.gallery)
        else:
            served = pipe
            rep.install_model = port_repl.pipeline_model_installer(pipe)
        conn = p.Conn()
        service = p.rec.RecognizerService(served, conn, batch_size=2, frame_shape=(64, 64),
                                          flush_timeout=0.02, similarity_threshold=-1.0,
                                          metrics=rep.metrics, readback_worker=False,
                                          bucket_sizes=(2,), replica=rep)
        service._running = True
        service.registry = rep.registry
        rep.on_registry_change = service.flush_model_caches
        readers[name] = (service, conn, rep)

    def serve(tag):
        for service, conn, _rep in readers.values():
            for j in range(2):
                conn.inject(jax_rec.FRAME_TOPIC, {"frame": frames[j],
                                                  "meta": {"tag": tag, "j": j}})
            service._serve_one(service.batcher.get_batch(block=True))
            service._drain(force=True)

    serve("v1")
    writer.registry_swap("detector", 2)
    for _service, _conn, rep in readers.values():
        rep.poll(force=True)
        assert rep.stats()["awaiting_cutover"]["role"] == "detector"
    serve("parked")
    writer.checkpoint()
    for _service, _conn, rep in readers.values():
        rep.poll(force=True)
        assert rep.registry.version("detector") == 2
    serve("reanchored")

    ref = [(m["meta"]["tag"], m["registry"]["detector"], m["faces"][0]["label"])
           for m in readers["jax"][1].messages(jax_rec.RESULT_TOPIC)]
    # the reference: the manifest's v2 stamp on the v1 weights
    assert ref[-2:] == [("reanchored", 2, 1)] * 2
    assert [r[1:] for r in ref[:4]] == [(1, 1)] * 4

    ran = {}
    for version, params in ((1, v1), (2, v2)):
        pipe.install_detector_params(params)
        direct = unpack_result(pipe.recognize_batch_packed(frames).numpy(), 1)
        ran[version] = [[[float(v) for v in direct.boxes[j, k]]
                         for k in np.flatnonzero(direct.valid[j])] for j in range(2)]
    assert ran[1] != ran[2]
    port = []
    for m in readers["port"][1].messages(jax_rec.RESULT_TOPIC):
        boxes = [[f["box"][1], f["box"][0], f["box"][3], f["box"][2]] for f in m["faces"]]
        which = [v for v in (1, 2) if ran[v][m["meta"]["j"]] == boxes]
        assert len(which) == 1
        port.append((m["meta"]["tag"], m["registry"]["detector"], which[0]))
    assert port == [("v1", 1, 1)] * 2 + [("parked", 1, 1)] * 2 + [("reanchored", 2, 2)] * 2
    assert readers["port"][2].metrics.counter(mn.REGISTRY_CACHE_FLUSHES) == 1
    writer.state.close()


def _port_reader(root, pipe):
    """A port reader service over ``pipe`` with the pipeline installer,
    synced to ``root``, threads off."""
    rep = port_repl.ReadReplica(root, pipe.gallery, [], metrics=mn.Metrics(),
                                poll_interval_s=0.0)
    rep.poll(force=True)
    rep.registry = port_registry.ModelRegistry(root, metrics=rep.metrics, readonly=True)
    rep.install_model = port_repl.pipeline_model_installer(pipe)
    conn = PortConnector()
    service = port_rec.RecognizerService(pipe, conn, batch_size=2, frame_shape=(64, 64),
                                         flush_timeout=0.02, similarity_threshold=-1.0,
                                         metrics=rep.metrics, readback_worker=False,
                                         bucket_sizes=(2,), replica=rep)
    service._running = True
    service.registry = rep.registry
    rep.on_registry_change = service.flush_model_caches
    return service, conn, rep


def _served_boxes(service, conn, frames):
    """One batch of ``frames`` through ``service``: each result's
    (detector stamp, boxes as the pipeline's corner order)."""
    n = len(conn.messages(jax_rec.RESULT_TOPIC))
    for j in range(len(frames)):
        conn.inject(jax_rec.FRAME_TOPIC, {"frame": frames[j], "meta": {"j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    service._drain(force=True)
    return [(m["registry"]["detector"],
             [[f["box"][1], f["box"][0], f["box"][3], f["box"][2]] for f in m["faces"]])
            for m in conn.messages(jax_rec.RESULT_TOPIC)[n:]]


def _direct_boxes(pipe, frames):
    direct = unpack_result(pipe.recognize_batch_packed(frames).numpy(), 1)
    return [[[float(v) for v in direct.boxes[j, k]] for k in np.flatnonzero(direct.valid[j])]
            for j in range(len(frames))]


def test_a_rollback_on_the_writer_restores_the_weights_on_its_readers(tmp_path, clock):
    """Swap v1 -> v2 through the writer's coordinator, re-anchor, roll back
    (v3, which stages no params), re-anchor: a reader that installed v2
    serves v1's weights again stamped 3, and so does a reader that polls
    only after the rollback and never ran v2. Each result equals a direct
    call of the writer's restored weights (ROADMAP C.15)."""
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll(2)
    writer.checkpoint()
    pipe, det, v1, v2 = _port_stack()
    staged = port_registry.registry_params_path(root, "detector", 2)
    os.makedirs(os.path.dirname(staged), exist_ok=True)
    det.load_params(v2)
    det.save(staged)
    det.load_params(v1)
    late_pipe, *_ = _port_stack()
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64)).astype(np.float32)
    reader = _port_reader(root, pipe)
    late = _port_reader(root, late_pipe)
    direct_pipe, *_ = _port_stack()
    want = {1: _direct_boxes(direct_pipe, frames)}
    direct_pipe.install_detector_params(v2)
    want[2] = _direct_boxes(direct_pipe, frames)
    assert want[1] != want[2]

    co = port_registry.RegistrySwapCoordinator(writer.state, writer.registry, "detector", 2,
                                               params_path=staged)
    co.cutover(force=True)
    for _ in range(2):  # the fence parks, the covering checkpoint re-anchors
        reader[2].poll(force=True)
    assert _served_boxes(reader[0], reader[1], frames) == [(2, b) for b in want[2]]

    co.auto_rollback()
    assert writer.registry.version("detector") == 3
    for _service, _conn, rep in (reader, late):
        for _ in range(3):
            rep.poll(force=True)
        assert rep.registry.version("detector") == 3 and rep.install_pending == {}
    for service, conn, _rep in (reader, late):
        assert _served_boxes(service, conn, frames) == [(3, b) for b in want[1]]
    writer.state.close()


def test_a_rollback_installs_the_params_it_stages_or_version_1s(tmp_path):
    """Swaps and rollbacks through the writer's coordinator: the rollback
    of a detector v3 swapped in from a staged v2 stages v2's params as v4,
    and the reader installs them; the rollback of a cascade swapped in
    from version 1, which no file stages, serves version 1's weights
    (``None``); a version whose manifest names a params file that is gone
    is not installed, and stays pending."""
    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll()
    writer.checkpoint()
    rep = port_repl.ReadReplica(root, _port_gallery(), [], poll_interval_s=0.0)
    rep.poll(force=True)
    rep.registry = port_registry.ModelRegistry(root, readonly=True)
    installed = []
    rep.install_model = lambda *a: installed.append(a)

    def path(role, version):
        return port_registry.registry_params_path(root, role, version)

    def swap(role, version, rollback=False, drop=False):
        os.makedirs(os.path.dirname(path(role, version)), exist_ok=True)
        with open(path(role, version), "wb") as fh:
            fh.write(f"{role} v{version}".encode())
        co = port_registry.RegistrySwapCoordinator(writer.state, writer.registry, role,
                                                   version, params_path=path(role, version))
        co.cutover(force=True)
        if rollback:
            for _ in range(3):
                rep.poll(force=True)
            co.auto_rollback()
        if drop:
            os.remove(path(role, version))
        for _ in range(3):
            rep.poll(force=True)

    swap("detector", 2)
    swap("detector", 3, rollback=True)
    swap("cascade", 2, rollback=True)
    with open(path("detector", 4), "rb") as fh:
        assert fh.read() == b"detector v2"
    assert not os.path.exists(path("cascade", 3))
    assert installed == [("detector", 2, path("detector", 2)),
                         ("detector", 3, path("detector", 3)),
                         ("detector", 4, path("detector", 4)),
                         ("cascade", 2, path("cascade", 2)), ("cascade", 3, None)]
    assert rep.install_pending == {}
    swap("detector", 5, drop=True)
    assert len(installed) == 5 and rep.install_pending == {"detector": 5}
    assert "is not staged" in rep.install_error
    writer.state.close()


def test_a_failed_install_is_retried_alone_and_reads_critical(tmp_path, clock):
    """An install that fails leaves the re-anchored gallery serving and
    is retried alone after a backoff that doubles; no poll resyncs again.
    Meanwhile the reader's health (in process and ``/health``) reads
    critical; the install's success clears it."""
    from opencv_facerecognizer_tpu_torch.runtime.expo import ExpoServer
    from opencv_facerecognizer_tpu_torch.runtime.slo import STATE_CRITICAL, STATE_OK

    root = str(tmp_path / "state")
    writer = _Writer("port", root)
    writer.enroll()
    writer.checkpoint()
    pipe = port_fakes.InstantPipeline(HW, faces_per_frame=1)
    pipe.gallery = _port_gallery()
    service, _conn, rep = _port_reader(root, pipe)
    staged = port_registry.registry_params_path(root, "cascade", 2)
    os.makedirs(os.path.dirname(staged), exist_ok=True)
    with open(staged, "wb") as fh:
        fh.write(b"unreadable params")
    calls = []

    def install(*args):
        calls.append(args)
        if len(calls) < 3:
            raise RuntimeError("bad params")

    rep.install_model = install
    health = port_repl.service_health_probe(service)
    expo = ExpoServer(service)
    writer.registry_swap("cascade", 2)
    writer.checkpoint()
    for _ in range(2):  # parked on the fence, then the re-anchor's install fails
        rep.poll(force=True)
    resyncs = rep.metrics.counter(mn.REPLICATION_RESYNCS)
    assert calls == [("cascade", 2, staged)] and rep.install_pending == {"cascade": 2}
    assert health() == STATE_CRITICAL
    assert expo.payload("/health", {})["state_code"] == STATE_CRITICAL
    for _ in range(3):
        rep.poll(force=True)  # inside the first backoff: nothing is retried
    clock.advance(port_repl.INSTALL_RETRY_S[0])
    rep.poll(force=True)
    assert len(calls) == 2 and rep.install_pending == {"cascade": 2}
    clock.advance(port_repl.INSTALL_RETRY_S[0])
    rep.poll(force=True)  # the backoff doubled
    assert len(calls) == 2
    clock.advance(port_repl.INSTALL_RETRY_S[0])
    rep.poll(force=True)
    assert len(calls) == 3 and rep.install_pending == {} and health() == STATE_OK
    assert expo.payload("/health", {})["state"] is None
    assert rep.metrics.counter(mn.REPLICATION_INSTALL_ERRORS) == 2
    assert rep.metrics.counter(mn.REPLICATION_RESYNCS) == resyncs
    writer.state.close()
