"""The registry's swaps in the port against the JAX package's: ``box_iou``
and ``DetectionParity``, ``RegistrySwapCoordinator`` through parity,
cutover, watch, refusal and rollback, the ``registry_cutover`` fence
recovered across the packages both ways, the results' registry stamps,
and the stamp race of a registry cutover (ROADMAP C.14).

Both packages run the same scripted verdicts and frames; the coordinators
drive real ``StateLifecycle`` objects over small galleries on the CPU.
"""

import json
import os
import threading
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import registry as jax_registry
from opencv_facerecognizer_tpu.runtime import rollout as jax_rollout
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils import tracing as jax_tracing
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline, unpack_result
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import registry as port_registry
from opencv_facerecognizer_tpu_torch.runtime import rollout as port_rollout
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing as port_tracing

DIM = 8
HW = (16, 16)


def _jax_gallery(capacity=64):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    return JaxGallery(capacity=capacity, dim=DIM, mesh=mesh)


def _port_gallery(capacity=64):
    return PortGallery(capacity, DIM, device="cpu")


PKG = {
    "jax": types.SimpleNamespace(registry=jax_registry, state=jax_state, faults=jax_faults,
                                 rollout=jax_rollout, rec=jax_rec, fakes=jax_fakes,
                                 Conn=JaxConnector, Metrics=JaxMetrics, gallery=_jax_gallery,
                                 tracing=jax_tracing),
    "port": types.SimpleNamespace(registry=port_registry, state=port_state, faults=port_faults,
                                  rollout=port_rollout, rec=port_rec, fakes=port_fakes,
                                  Conn=PortConnector, Metrics=mn.Metrics, gallery=_port_gallery,
                                  tracing=port_tracing),
}


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


# ---------- box_iou and DetectionParity ----------


@pytest.mark.parametrize("seed", range(4))
def test_box_iou_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a = np.sort(rng.uniform(0, 40, 4).reshape(2, 2), axis=0).T.reshape(-1)[[0, 2, 1, 3]]
        b = a + rng.normal(0, 6, 4)
        assert port_registry.box_iou(a, b) == jax_registry.box_iou(a, b)
    assert port_registry.box_iou([0, 0, 10, 10], [20, 20, 30, 30]) == 0.0
    assert port_registry.box_iou([0, 0, 10, 10], [0, 0, 10, 10]) == 1.0


def _verdicts(seed, n=40):
    """Scripted per-frame verdicts: (old boxes, new boxes) with every kind
    of agreement and disagreement."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(4, p=[0.4, 0.4, 0.1, 0.1])
        box = [float(v) for v in rng.uniform(0, 10, 2)] * 2
        box[2] += 8.0
        box[3] += 8.0
        shift = float(rng.choice([0.5, 1.0, 6.0]))  # IoU 0.89, 0.78, 0.14
        shifted = [v + shift for v in box]
        out.append({0: ([], []), 1: ([box], [shifted]), 2: ([box], []),
                    3: ([], [(np.asarray(box), 0.9, True)])}[int(kind)])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_detection_parity_matches_reference(seed):
    """Equal verdicts give equal agreement, disagreement, sample counts,
    gate verdicts and gauges, at every step of the window."""
    verdicts = _verdicts(seed)
    trace = {}
    for name in ("jax", "port"):
        p = PKG[name]
        metrics = p.Metrics()
        box_list = lambda v: v if not v or not isinstance(v[0], tuple) else [v[0][0]]  # noqa: E731
        parity = p.registry.DetectionParity(
            lambda f: box_list(verdicts[int(f[0, 0])][0]),
            lambda f: box_list(verdicts[int(f[0, 0])][1]),
            threshold=0.6, min_samples=8, window=16, metrics=metrics)
        steps = []
        for i in range(len(verdicts)):
            parity.score([np.full(HW, i, np.float32)])
            steps.append((parity.samples, parity.agreement, parity.disagreement, parity.ok(),
                          metrics.gauge(mn.REGISTRY_PARITY_AGREEMENT)))
        parity.reset()
        steps.append((parity.samples, parity.agreement, parity.disagreement, parity.ok()))
        trace[name] = steps
    assert trace["port"] == trace["jax"]
    assert any(s[3] for s in trace["port"]) and not all(s[3] for s in trace["port"][:-1])


def test_detection_parity_takes_detect_batch_triples_like_reference():
    triple = (np.array([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32),
              np.array([0.9, 0.1]), np.array([True, False]))
    for mod in (jax_registry, port_registry):
        parity = mod.DetectionParity(lambda f: triple, lambda f: [[1, 1, 11, 11]],
                                     min_samples=1)
        parity.score([np.zeros(HW)], old_boxes_list=[[np.array([0, 0, 10, 10])]])
        parity.score([np.zeros(HW)])
        assert (parity.samples, parity.agreement) == (2, 1.0)


# ---------- the swap coordinator ----------


def _swap_setup(name, tmp_path, **co_kw):
    p = PKG[name]
    root = str(tmp_path / name)
    metrics = p.Metrics()
    faults = p.faults.FaultInjector()
    state = p.state.StateLifecycle(root, metrics=metrics, fault_injector=faults)
    gallery = p.gallery()
    gallery.add(_rows(4), np.arange(4, dtype=np.int32))
    state.bind(gallery, ["a", "b", "c", "d"])
    registry = p.registry.ModelRegistry(root, metrics=metrics)
    state.attach_registry(registry)
    staged = p.registry.registry_params_path(root, "detector", 2)
    os.makedirs(os.path.dirname(staged), exist_ok=True)
    with open(staged, "wb") as f:
        f.write(b"candidate detector params")
    calls = []
    tracer = p.tracing.Tracer(sample=1.0, dump_dir=str(tmp_path / name / "flight"),
                              min_dump_interval_s=0.0)
    co = p.registry.RegistrySwapCoordinator(
        state, registry, "detector", 2, params_path=staged,
        install_fn=lambda: calls.append("install"),
        rollback_install_fn=lambda: calls.append("rollback"),
        flush_fn=lambda stamp: calls.append(("flush", stamp)), metrics=metrics,
        tracer=tracer, parity_min_samples=4, watch_min_samples=4,
        live_sample_interval_s=0.0, **co_kw)
    return types.SimpleNamespace(state=state, registry=registry, co=co, calls=calls,
                                 metrics=metrics, faults=faults, root=root, tracer=tracer)


def _wal_records(root):
    out = []
    for line in open(os.path.join(root, "enroll.wal")):
        rec = json.loads(line)
        if rec.get("kind") in ("registry_cutover", "registry_abort"):
            rec.pop("ts")
            rec.pop("params_path", None)
            out.append(rec)
    return out


def _status(co):
    status = co.status()
    status.pop("params_path")
    return status


def _agree(f):
    return [[0.0, 0.0, 8.0, 8.0]]


def _disagree(f):
    return [] if f[0, 0] % 2 else [[0.0, 0.0, 8.0, 8.0]]


def test_swap_through_parity_cutover_and_watch_matches_reference(tmp_path):
    out = {}
    for name in ("jax", "port"):
        s = _swap_setup(name, tmp_path, old_detect_fn=_agree, new_detect_fn=_agree)
        phases = [s.co.phase]
        for i in range(6):
            s.co.offer_live(np.full(HW, i, np.float32),
                            [{"box": [0.0, 0.0, 8.0, 8.0]}] if i % 3 else None)
            s.co.drain_live()
            phases.append(s.co.phase)
        seq = s.co.cutover()
        phases.append(s.co.phase)
        s.co.score_parity([np.zeros(HW)] * 4)
        phases.append(s.co.phase)
        s.state.close()
        out[name] = dict(phases=phases, seq=seq, calls=s.calls, status=_status(s.co),
                         wal=_wal_records(s.root), manifest=s.registry.stamp(),
                         counters=s.metrics.counters(),
                         phase_gauge=s.metrics.gauge(mn.REGISTRY_PHASE),
                         lifecycle=[x["phase"] for x in s.tracer.snapshot()
                                    if x["stage"] == "registry_phase"])
    assert out["port"] == out["jax"]
    assert out["port"]["phases"][-1] == "done" and out["port"]["manifest"]["detector"] == 2
    assert out["port"]["calls"][0] == "install"


def test_shut_gate_refuses_and_force_overrides_like_reference(tmp_path):
    out = {}
    for name in ("jax", "port"):
        p = PKG[name]
        s = _swap_setup(name, tmp_path, old_detect_fn=_agree, new_detect_fn=_disagree)
        s.co.score_parity([np.full(HW, i, np.float32) for i in range(6)])
        with pytest.raises(p.rollout.RolloutGateError, match="parity gate not met") as exc:
            s.co.cutover()
        blocked = s.metrics.counter(mn.REGISTRY_SWAPS_BLOCKED)
        assert s.registry.version("detector") == 1
        s.co.cutover(force=True)
        s.state.close()
        out[name] = (str(exc.value), blocked, s.registry.stamp(), s.co.phase, s.calls)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 1


def test_watch_regression_rolls_back_with_a_dump_like_reference(tmp_path):
    out = {}
    for name in ("jax", "port"):
        s = _swap_setup(name, tmp_path, old_detect_fn=_agree, new_detect_fn=_agree)
        s.co.score_parity([np.zeros(HW)] * 4)
        s.co.cutover()
        s.co.new_detect_fn = None
        s.co.parity.new_detect_fn = _disagree
        s.co.score_parity([np.full(HW, i, np.float32) for i in range(4)])
        dumps = sorted(os.listdir(os.path.join(s.root, "flight")))
        s.state.close()
        out[name] = dict(phase=s.co.phase, calls=[c if isinstance(c, str) else c[0]
                                                  for c in s.calls],
                         manifest=s.registry.stamp(), wal=_wal_records(s.root),
                         rollbacks=s.metrics.counter(mn.REGISTRY_AUTO_ROLLBACKS),
                         dumps=[d.split("-", 2)[-1] for d in dumps], status=_status(s.co))
    assert out["port"] == out["jax"]
    assert out["port"]["phase"] == "rolled_back" and out["port"]["manifest"]["detector"] == 3
    assert out["port"]["calls"] == ["install", "flush", "rollback", "flush"]


def test_gate_retrain_runs_before_the_fence_like_reference(tmp_path):
    out = {}
    for name in ("jax", "port"):
        order = []
        s = _swap_setup(name, tmp_path, gate_retrain_fn=lambda: order.append("retrain") or "g")
        s.state.wal.append_registry_cutover = (lambda real: lambda *a, **k: (
            order.append("fence"), real(*a, **k))[1])(s.state.wal.append_registry_cutover)
        s.co.cutover(force=True)
        s.state.close()
        out[name] = (order, s.metrics.counter(mn.REGISTRY_GATE_RETRAINS), _status(s.co))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["retrain", "fence"]


def test_coordinator_refuses_what_the_reference_refuses(tmp_path):
    for name in ("jax", "port"):
        s = _swap_setup(name, tmp_path)
        for role, version in (("embedder", 2), ("detector", 1), ("nope", 2)):
            with pytest.raises(ValueError):
                PKG[name].registry.RegistrySwapCoordinator(s.state, s.registry, role, version)
        s.state.close()
    assert port_registry.PHASE_CODES == jax_registry.PHASE_CODES


# ---------- the fence across the packages ----------


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("params", ["intact", "damaged"])
def test_a_crashed_fence_is_settled_by_the_other_package(tmp_path, writer, reader, params):
    """One package's swap dies after its ``registry_cutover`` fence; the
    other's recovery completes it (the staged params verify) or abandons
    it (tombstone, retired version), and the manifest says so."""
    s = _swap_setup(writer, tmp_path)
    s.state.checkpoint_now(wait=True)
    s.faults.script("cutover", "crash_after_record")
    with pytest.raises(PKG[writer].faults.InjectedCrashError):
        s.co.cutover(force=True)
    s.state.close()
    assert s.registry.version("detector") == 1
    if params == "damaged":
        with open(PKG[writer].registry.registry_params_path(s.root, "detector", 2), "wb") as f:
            f.write(b"torn")
    r = PKG[reader]
    st = r.state.StateLifecycle(s.root, metrics=r.Metrics())
    report = st.recover(r.gallery(), [])
    st.close()
    manifest = r.registry.ModelRegistry(s.root, readonly=True)
    kinds = [rec["kind"] for rec in _wal_records(s.root)]
    if params == "intact":
        assert manifest.version("detector") == 2
        assert [e["to_version"] for e in report["completed_registry_swaps"]] == [2]
        assert kinds == ["registry_cutover"]
    else:
        assert manifest.version("detector") == 1
        assert manifest.describe("detector")["retired"] == 2
        assert [e["to_version"] for e in report["abandoned_registry_swaps"]] == [2]
        assert kinds == ["registry_cutover", "registry_abort"]


def test_fence_record_layout_matches_reference(tmp_path):
    recs = {}
    for name in ("jax", "port"):
        s = _swap_setup(name, tmp_path)
        # the fence alone: a coordinator's forced checkpoint truncates the WAL
        s.state.perform_registry_cutover("detector", 2, params_path=s.co.params_path,
                                         params_sha256=s.co.params_sha256)
        s.state.close()
        with open(os.path.join(s.root, "enroll.wal")) as f:
            rec = [json.loads(line) for line in f][-1]
        recs[name] = {k: v for k, v in rec.items() if k not in ("ts", "params_path")}
        recs[name]["keys"] = sorted(rec)
    assert recs["port"] == recs["jax"]
    assert recs["port"]["registry"] == {"embedder": 1, "detector": 2, "cascade": 1}


def test_registry_stamp_and_refusals_match_reference(tmp_path):
    for name in ("jax", "port"):
        p = PKG[name]
        s = _swap_setup(name, tmp_path)
        assert s.state.registry_stamp() == {"embedder": 1, "detector": 1, "cascade": 1}
        with pytest.raises(ValueError, match="monotonic"):
            s.state.perform_registry_cutover("detector", 1)
        s.faults.script("cutover", "crash_before_record")
        with pytest.raises(p.faults.InjectedCrashError):
            s.state.perform_registry_cutover("cascade", 2)
        s.state.perform_registry_cutover("cascade", 2, install_fn=lambda: None)
        assert s.state.registry_stamp() == {"embedder": 1, "detector": 1, "cascade": 2}
        s.state.close()


# ---------- the service's stamps, flushes and live offers ----------


def _service(name, registry=None, **kw):
    p = PKG[name]
    pipeline = p.fakes.InstantPipeline(HW, faces_per_frame=1)
    conn = p.Conn()
    service = p.rec.RecognizerService(pipeline, conn, batch_size=2, frame_shape=HW,
                                      flush_timeout=0.02, similarity_threshold=0.0,
                                      metrics=p.Metrics(), readback_worker=False,
                                      bucket_sizes=(2,), **kw)
    service._running = True
    service.registry = registry
    return service, conn, pipeline


def _serve_two(service, conn, tag):
    for j in range(2):
        conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros(HW, np.float32),
                                          "meta": {"tag": tag, "j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    service._drain(force=True)


def test_results_carry_the_registry_stamp_like_the_reference(tmp_path):
    out = {}
    for name in ("jax", "port"):
        registry = PKG[name].registry.ModelRegistry(str(tmp_path / name))
        service, conn, _p = _service(name, registry)
        _serve_two(service, conn, "a")
        registry.install("cascade", 3)
        _serve_two(service, conn, "b")
        service.registry = None
        _serve_two(service, conn, "c")
        out[name] = [(m["meta"]["tag"], m.get("embedder_version"), m.get("registry"))
                     for m in conn.messages(jax_rec.RESULT_TOPIC)]
        stamps = [service._model_stamp(v) for v in (None, 4)]
        out[name + "_fields"] = [PKG[name].rec.RecognizerService._stamp_fields(s)
                                 for s in stamps + [(("embedder", 2), ("detector", 5)), 7]]
    assert out["port"] == out["jax"]
    assert out["port_fields"] == out["jax_fields"]
    assert out["port"][2][2] == {"embedder": 1, "detector": 1, "cascade": 3}


def test_flush_and_live_offers_match_reference(tmp_path):
    """``flush_model_caches`` flushes the identity cache and counts; the
    publish path offers each frame (with its faces) to a live swap."""
    from opencv_facerecognizer_tpu.runtime import tracker as jax_tracker
    from opencv_facerecognizer_tpu_torch.runtime import tracker as port_tracker

    out = {}
    for name, trk in (("jax", jax_tracker), ("port", port_tracker)):
        offers = []
        swap = types.SimpleNamespace(offer_live=lambda f, faces: offers.append(
            (float(np.asarray(f).sum()), [x["box"] for x in faces])))
        tracker = trk.IdentityTracker()
        service, conn, _p = _service(name, tracker=tracker)
        service.registry_swap = swap
        for j in range(2):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.full(HW, j, np.float32),
                                              "meta": {"stream": "s", "j": j}})
        service._serve_one(service.batcher.get_batch(block=True))
        service._drain(force=True)
        flushed = service.flush_model_caches({"detector": 2})
        swap.offer_live = lambda *_a: (_ for _ in ()).throw(RuntimeError("boom"))
        _serve_two(service, conn, "x")
        c = service.metrics.counters()
        out[name] = (offers, flushed, c.get(mn.REGISTRY_CACHE_FLUSHES),
                     c.get(mn.REGISTRY_OBSERVE_ERRORS), service.ledger())
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 2 and out["port"][3] == 2


# ---------- the stamp race of a registry cutover (ROADMAP C.14) ----------


def _marking_jax_pipeline():
    """The reference's fake pipeline answering one face whose label is the
    detector version its step ran (``installed``)."""

    class Marking(jax_fakes.InstantPipeline):
        installed = 1

        def recognize_batch_packed(self, frames):
            out = super().recognize_batch_packed(frames)
            out._arr[:, 0, 6] = self.installed
            return out

    return Marking(HW, faces_per_frame=1)


def _port_stack():
    """A real port pipeline on the CPU, small: the detector's two weight
    sets (v1, v2) give different faces."""
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
    gallery = PortGallery(64, DIM, device="cpu")
    gallery.add(_rows(8), np.arange(8, dtype=np.int32))
    pipe = RecognitionPipeline(det, net, gallery, face_size=(32, 32), device="cpu")
    v1 = {k: v.clone() for k, v in det.params.items()}
    v2 = {k: v + 0.3 * torch.randn(v.shape, generator=gen) for k, v in v1.items()}
    return pipe, v1, v2


def _registry_race(name, tmp_path, frames):
    """Serve a batch before, during and after a registry cutover whose
    ``install_fn`` pauses after the fence and the manifest: (tag, stamped
    detector version, what the step ran) per result; for the port "what
    ran" is the faces a direct call of each weight set gives."""
    p = PKG[name]
    root = str(tmp_path / name)
    state = p.state.StateLifecycle(root)
    registry = p.registry.ModelRegistry(root)
    state.attach_registry(registry)
    if name == "jax":
        pipe = _marking_jax_pipeline()

        def install():
            pipe.installed = 2
    else:
        pipe, v1, v2 = _port_stack()

        def install():
            pipe.install_detector_params(v2, version=2)
    state.bind(pipe.gallery, [])
    conn = p.Conn()
    service = p.rec.RecognizerService(pipe, conn, batch_size=2, frame_shape=(64, 64),
                                      flush_timeout=0.02, similarity_threshold=-1.0,
                                      metrics=p.Metrics(), readback_worker=False,
                                      bucket_sizes=(2,))
    service._running = True
    service.registry = registry

    def serve(tag):
        for j in range(2):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": frames[j], "meta": {"tag": tag, "j": j}})
        service._serve_one(service.batcher.get_batch(block=True))
        service._drain(force=True)

    paused, go = threading.Event(), threading.Event()

    def paused_install():
        paused.set()
        assert go.wait(30)
        install()

    serve("before")
    swap = threading.Thread(target=lambda: state.perform_registry_cutover(
        "detector", 2, install_fn=paused_install))
    swap.start()
    assert paused.wait(30)
    serve("during")  # the fence and the manifest say 2; the weights are v1's
    go.set()
    swap.join(30)
    serve("after")
    state.close()
    results = conn.messages(jax_rec.RESULT_TOPIC)
    if name == "jax":
        return [(m["meta"]["tag"], m["registry"]["detector"], m["faces"][0]["label"])
                for m in results]
    ran = {}
    for version, params in ((1, v1), (2, v2)):
        pipe.install_detector_params(params)
        direct = unpack_result(pipe.recognize_batch_packed(frames[:2]).numpy(), 1)
        ran[version] = [[[float(v) for v in direct.boxes[j, k]]
                         for k in np.flatnonzero(direct.valid[j])] for j in range(2)]
    out = []
    for m in results:
        boxes = [[f["box"][1], f["box"][0], f["box"][3], f["box"][2]] for f in m["faces"]]
        which = [v for v in (1, 2) if ran[v][m["meta"]["j"]] == boxes]
        assert len(which) == 1, "a result equal to neither weight set, or to both"
        out.append((m["meta"]["tag"], m["registry"]["detector"], which[0]))
    return out


def test_result_stamps_pair_with_the_detector_that_ran_across_a_registry_cutover(tmp_path):
    """A batch dispatched after a registry cutover's fence and manifest but
    before its ``install_fn`` published the weights: the reference stamps
    the new detector version on a batch that ran the old weights (its
    stamp is the manifest's at dispatch); the port stamps the version its
    step recorded running, so a result's stamp always names the detector
    that ran (ROADMAP C.14). Before and after, both agree."""
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64)).astype(np.float32)
    ref = _registry_race("jax", tmp_path, frames)
    port = _registry_race("port", tmp_path, frames)
    assert [r[0] for r in port] == [r[0] for r in ref] == ["before"] * 2 + ["during"] * 2 + [
        "after"] * 2
    assert all(stamp == ran for _tag, stamp, ran in port)
    assert [s for _t, s, _r in port] == [1, 1, 1, 1, 2, 2]
    # the reference's interleaving mixes: the new stamp on the old detector
    assert [(s, ran) for tag, s, ran in ref if tag == "during"] == [(2, 1), (2, 1)]
    assert [r for r in ref if r[0] != "during"] == [r for r in port if r[0] != "during"]


def test_a_rejected_frame_carries_no_stamp_in_either_package(tmp_path):
    """A stage-1 exit publishes ``{"meta", "faces": [], "exit": "cascade"}``
    only, in both packages, registry or not."""
    out = {}
    for name in ("jax", "port"):
        p = PKG[name]
        pipeline = p.fakes.InstantPipeline(HW, cascade_stub=True)
        conn = p.Conn()
        service = p.rec.RecognizerService(pipeline, conn, batch_size=2, frame_shape=HW,
                                          flush_timeout=0.02, metrics=p.Metrics(),
                                          readback_worker=False, bucket_sizes=(2,))
        service._running = True
        service.registry = p.registry.ModelRegistry(str(tmp_path / name))
        _serve_two(service, conn, "z")
        out[name] = conn.messages(jax_rec.RESULT_TOPIC)
    assert out["port"] == out["jax"]
    assert all(m == {"meta": m["meta"], "faces": [], "exit": "cascade"} for m in out["port"])
