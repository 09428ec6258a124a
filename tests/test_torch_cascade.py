"""The detection cascade of the port against the JAX package's: the
stage-1 net, the gate file both ways, the pipeline's stage-1 pass and its
installs, and the serving gate (``completed_empty``, compaction, the
whole-batch exit, fail-open, ``reject_all``, the brownout notch, the
recompile watchdog, spans).

Tolerances: the nets are compared in float32 in both packages (``dtype``
f32), within 1e-5 on logits and probabilities; in bf16 XLA and eager torch
round at other points. The services run over ``InstantPipeline(
cascade_stub=True)`` in both packages under one ``FakeClock``, without
their threads (batches popped and served inline), so ledgers, results,
spans and gauges must be equal.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import cascade as jax_cascade
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.parallel import gallery as jax_gallery
from opencv_facerecognizer_tpu.parallel import pipeline as jax_pipeline
from opencv_facerecognizer_tpu.parallel.mesh import make_mesh
from opencv_facerecognizer_tpu.runtime import batcher as jax_batcher
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import resilience as jax_res
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.utils import metric_names as jax_mn
from opencv_facerecognizer_tpu.utils import tracing as jax_tracing
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.models import cascade as port_cascade
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.parallel import gallery as port_gallery
from opencv_facerecognizer_tpu_torch.parallel import pipeline as port_pipeline
from opencv_facerecognizer_tpu_torch.runtime import batcher as port_batcher
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_res
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.fakes import FakeClock
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils import tracing as port_tracing
from opencv_facerecognizer_tpu_torch.utils.params import (
    cascade_params_from_flax, cascade_params_to_flax, detector_params_from_flax,
    embedder_params_from_flax)

ATOL = 1e-5
HW = (32, 32)
FEATURES = (4, 8)
PKG = {"jax": (jax_rec, jax_fakes, JaxConnector, JaxMetrics, jax_res, jax_faults, jax_tracing),
       "port": (port_rec, port_fakes, PortConnector, mn.Metrics, port_res, port_faults,
                port_tracing)}


def _jax_params(features=FEATURES, downsample=4, seed=1):
    """Seeded flax init, then a seeded spread, so no two tiles tie."""
    net = jax_cascade.CascadeNet(features=features, downsample=downsample, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, *HW)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [a + 0.2 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)]
    return net, jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_unflatten(tree, leaves))


def _port_net(params, features=FEATURES, downsample=4):
    net = port_cascade.CascadeNet(features=features, downsample=downsample,
                                  dtype=torch.float32)
    cascade_params_from_flax(params, net)
    return net


def _frames(n=6, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).integers(0, 256, (n, *HW)).astype(dtype)


# ---------- the stage-1 net ----------


@pytest.mark.parametrize("features, downsample", [((4, 8), 4), ((4, 8), 2), ((8,), 1),
                                                  ((4, 4, 8), 2)])
def test_cascade_net_logits_and_scores_match_jax(features, downsample):
    jnet, params = _jax_params(features, downsample)
    pnet = _port_net(params, features, downsample)
    x = _frames()
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pnet(torch.from_numpy(x)).numpy()
        scores = port_cascade.frame_scores(pnet, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(scores, np.asarray(jax_cascade.frame_scores(
        jnet, params, jnp.asarray(x))), atol=ATOL)


def test_params_cross_both_ways_unchanged():
    _jnet, params = _jax_params()
    back = cascade_params_to_flax(_port_net(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_untrained_gate_scores_face_unlikely_like_jax():
    """The head's bias starts at -2: an untrained gate's logits sit near it."""
    gate = port_cascade.FaceGate(device="cpu")
    assert float(gate.net.head.bias.detach()) == port_cascade.HEAD_BIAS_INIT == -2.0
    assert gate.threshold == jax_cascade.DEFAULT_THRESHOLD == port_cascade.DEFAULT_THRESHOLD
    assert port_cascade.TILE_CONV_STRIDE == jax_cascade.TILE_CONV_STRIDE
    assert gate.tile_px == jax_cascade.FaceGate().tile_px == 16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_targets_match_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 64, (5, 3, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(4, 20, (5, 3, 2))
    counts = rng.integers(0, 4, 5)
    assert np.array_equal(port_cascade.tile_targets(boxes, counts, (64, 48), 16),
                          jax_cascade.tile_targets(boxes, counts, (64, 48), 16))


def test_training_is_refused_naming_its_item():
    """Kept under its name from when training was refused: ``FaceGate.train`` trains (A.13; the
    parity with the JAX package is ``tests/test_torch_detector_train.py``'s),
    here a few steps on a scene with a face and one without, which pull
    their scores apart."""
    scenes = np.full((2, *HW), 80.0, np.float32)
    scenes[0, 8:24, 8:24] = 200.0
    boxes = np.zeros((2, 1, 4), np.float32)
    boxes[0, 0] = (8, 8, 24, 24)
    gate = port_cascade.FaceGate(device="cpu")
    before = gate.score_batch(scenes).numpy()
    assert gate.train(scenes, boxes, np.array([1, 0]), steps=30, batch_size=2) is gate
    after = gate.score_batch(scenes).numpy()
    assert after[0] - after[1] > before[0] - before[1]


# ---------- the gate file, both ways ----------


@pytest.fixture
def jax_gate_file(tmp_path):
    gate = jax_cascade.FaceGate(features=FEATURES, downsample=4, threshold=0.4)
    gate.net = jax_cascade.CascadeNet(features=FEATURES, downsample=4, dtype=jnp.float32)
    gate.load_params(_jax_params()[1])
    path = str(tmp_path / "gate.msgpack")
    gate.save(path)
    return gate, path


def test_port_loads_a_jax_written_gate(jax_gate_file):
    jgate, path = jax_gate_file
    gate = port_cascade.FaceGate.load(path, device="cpu", dtype=torch.float32)
    assert (gate.net.features, gate.net.downsample, gate.threshold) == (FEATURES, 4, 0.4)
    x = _frames()
    np.testing.assert_allclose(gate.score_batch(x).numpy(), np.asarray(jgate.score_batch(x)),
                               atol=ATOL)


def test_jax_loads_a_port_written_gate(jax_gate_file, tmp_path):
    jgate, path = jax_gate_file
    gate = port_cascade.FaceGate.load(path, device="cpu", dtype=torch.float32)
    out = str(tmp_path / "port.msgpack")
    gate.save(out)
    assert open(out, "rb").read() == open(path, "rb").read()  # flax's bytes
    back = jax_cascade.FaceGate.load(out)
    back.net = jax_cascade.CascadeNet(features=FEATURES, downsample=4, dtype=jnp.float32)
    x = _frames(seed=3)
    np.testing.assert_allclose(np.asarray(back.score_batch(x)), gate.score_batch(x).numpy(),
                               atol=ATOL)
    assert back.threshold == 0.4


def test_evaluate_gate_matches_jax():
    """The operating point against the detector's own verdicts, with and
    without ground-truth counts, in float32 in both packages."""
    from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_scenes

    scenes, _boxes, counts = make_synthetic_scenes(12, (64, 64), max_faces=2, seed=4)
    jdet = jax_detector.CNNFaceDetector(features=(8, 16), head_features=16, max_faces=4,
                                        space_to_depth=2)
    jdet.net = jax_detector.DetectorNet(features=(8, 16), head_features=16, space_to_depth=2,
                                        dtype=jnp.float32)
    dparams = jax.tree_util.tree_map(np.asarray, jdet.net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)))["params"])
    dparams["Conv_5"]["bias"] = np.zeros_like(dparams["Conv_5"]["bias"])
    jdet.load_params(dparams)
    pdet = port_detector.CNNFaceDetector(features=(8, 16), head_features=16, max_faces=4,
                                         space_to_depth=2, dtype=torch.float32, device="cpu")
    detector_params_from_flax(dparams, pdet.net)
    _jnet, params = _jax_params()
    jgate = jax_cascade.FaceGate(features=FEATURES)
    jgate.net = jax_cascade.CascadeNet(features=FEATURES, dtype=jnp.float32)
    jgate.load_params(params)
    pgate = port_cascade.FaceGate(features=FEATURES, dtype=torch.float32, device="cpu")
    cascade_params_from_flax(params, pgate.net)
    scores = np.asarray(jgate.score_batch(scenes))
    thr = float(np.sort(scores)[5:7].mean())  # between two scores: no tie
    for gt in (None, counts):
        want = jax_cascade.evaluate_gate(jgate, jdet, scenes, gt_counts=gt, threshold=thr,
                                         batch_size=5)
        got = port_cascade.evaluate_gate(pgate, pdet, scenes, gt_counts=gt, threshold=thr,
                                         batch_size=5)
        assert got == pytest.approx(want, nan_ok=True)


# ---------- the pipeline's stage-1 pass ----------

DET = dict(features=(16, 16), head_features=16, space_to_depth=4)
EMB = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(2, 1))
FACE = (32, 32)


@pytest.fixture(scope="module")
def stacks():
    """The JAX pipeline and the port's on the same f32 weights, each with
    the same f32 gate, over a 64-row gallery."""
    jdet_net = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    dparams = jax.tree_util.tree_map(np.asarray, jdet_net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)))["params"])
    # the untrained heatmap (bias -4) reports no face: raise it, and the size
    dparams["Conv_5"]["bias"] = np.zeros_like(dparams["Conv_5"]["bias"])
    dparams["Conv_6"]["bias"] = np.full_like(dparams["Conv_6"]["bias"], 3.0)
    jemb = jax_embedder.FaceEmbedNet(**EMB, dtype=jnp.float32)
    eparams = jax.tree_util.tree_map(np.asarray, jemb.init(
        jax.random.PRNGKey(1), jnp.zeros((1, *FACE)))["params"])
    _jnet, gparams = _jax_params()
    rows = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    labels = np.arange(64, dtype=np.int32)
    jdet = jax_detector.CNNFaceDetector(**DET, max_faces=4)
    jdet.net = jdet_net
    jdet.load_params(dparams)
    jgal = jax_gallery.ShardedGallery(256, 32, mesh=make_mesh(devices=[jax.devices()[0]]))
    jgal.add(rows, labels)
    jgate = jax_cascade.FaceGate(features=FEATURES)
    jgate.net = jax_cascade.CascadeNet(features=FEATURES, dtype=jnp.float32)
    jgate.load_params(gparams)
    jpipe = jax_pipeline.RecognitionPipeline(jdet, jemb, eparams, jgal, face_size=FACE,
                                             cascade=jgate)
    return jpipe, dparams, eparams, gparams, rows, labels


def _port_stack(dparams, eparams, gparams, rows, labels, gate=True):
    det = port_detector.CNNFaceDetector(**DET, max_faces=4, dtype=torch.float32, device="cpu")
    detector_params_from_flax(dparams, det.net)
    net = port_embedder.FaceEmbedNet(**EMB, input_size=FACE, dtype=torch.float32)
    embedder_params_from_flax(eparams, net)
    gal = port_gallery.ShardedGallery(256, 32, device="cpu")
    gal.add(rows, labels)
    pgate = None
    if gate:
        pgate = port_cascade.FaceGate(features=FEATURES, dtype=torch.float32, device="cpu")
        cascade_params_from_flax(gparams, pgate.net)
    return port_pipeline.RecognitionPipeline(det, net, gal, face_size=FACE, device="cpu",
                                             cascade=pgate)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cascade_scores_match_jax_pipeline(stacks, dtype):
    jpipe, *args = stacks
    port = _port_stack(*args)
    x = np.random.default_rng(5).integers(0, 256, (4, 64, 64)).astype(dtype)
    want = np.asarray(jpipe.cascade_scores(x))
    got = port.cascade_scores(x)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert port.last_cascade_info == {"cache_hit": False, "version": None}
    port.cascade_scores(x)
    jpipe.cascade_scores(x)
    assert port.last_cascade_info["cache_hit"] is jpipe.last_cascade_info["cache_hit"] is True


def test_prewarm_builds_both_stages_per_rung_like_jax(stacks):
    jpipe, *args = stacks
    port = _port_stack(*args)
    assert port.prewarm_batch_shapes((2, 4), (64, 64), np.uint8) == 2
    assert sorted(port._cascade_cache) == [(2, 64, 64, "uint8"), (4, 64, 64, "uint8")]
    assert sorted(k[0] for k in port._step_cache) == [2, 4]
    jpipe._cascade_cache.clear()
    jpipe.prewarm_batch_shapes((2, 4), (64, 64), np.uint8)
    assert sorted(k[0] for k in jpipe._cascade_cache) == [2, 4]
    port_nogate = _port_stack(*args, gate=False)
    port_nogate.prewarm_batch_shapes((2,), (64, 64), np.uint8)
    assert not port_nogate._cascade_cache
    with pytest.raises(RuntimeError, match="no cascade gate"):
        port_nogate.cascade_scores(np.zeros((2, 64, 64), np.uint8))


def test_install_cascade_keeps_passes_for_the_same_architecture(stacks):
    """As the reference: a gate of the served architecture keeps the cached
    passes (their graphs, on the card); another drops them. The served net
    is the pipeline's own copy: the installed gate object is untouched."""
    _jpipe, dparams, eparams, gparams, rows, labels = stacks
    port = _port_stack(dparams, eparams, gparams, rows, labels)
    x = _frames(4, seed=6).repeat(2, axis=1).repeat(2, axis=2)
    before = port.cascade_scores(x).clone()
    first_gate = port.cascade
    other = port_cascade.FaceGate(features=FEATURES, dtype=torch.float32, device="cpu",
                                  generator=torch.Generator().manual_seed(9))
    port.install_cascade(other, version=2)
    assert len(port._cascade_cache) == 1 and port.cascade is other
    np.testing.assert_allclose(port.cascade_scores(x).numpy(),
                               other.score_batch(x).numpy(), atol=ATOL)
    assert port.last_cascade_info == {"cache_hit": True, "version": 2}
    np.testing.assert_allclose(first_gate.score_batch(x).numpy(), before.numpy(), atol=ATOL)
    wider = port_cascade.FaceGate(features=(8, 8), dtype=torch.float32, device="cpu")
    port.install_cascade(wider, version=3)
    assert not port._cascade_cache
    np.testing.assert_allclose(port.cascade_scores(x).numpy(),
                               wider.score_batch(x).numpy(), atol=ATOL)
    port.install_cascade(None)
    assert port.cascade is None and not port._cascade_cache


class _Hooked(torch.Tensor):
    """A source tensor that runs ``hook`` the first time ``copy_`` reads it:
    a dispatch arriving between two of an install's parameter copies."""

    hook = None

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.Tensor.copy_ and cls.hook is not None:
            hook, cls.hook = cls.hook, None
            hook()
        return super().__torch_function__(func, types, args, kwargs or {})


def _install_meets_dispatch(install, dispatch, new_state, key):
    """Install ``new_state`` with a dispatch started on another thread
    between the copy of ``key`` and the copies after it; returns the
    dispatch's output."""
    box = {}
    worker = threading.Thread(target=lambda: box.update(out=dispatch()), daemon=True)

    def hook():
        worker.start()
        worker.join(timeout=1.0)  # time to run through, were it not held

    state = dict(new_state)
    state[key] = state[key].as_subclass(_Hooked)
    _Hooked.hook = hook
    try:
        install(state)
    finally:
        _Hooked.hook = None
    worker.join(timeout=60)
    assert not worker.is_alive() and "out" in box
    return box["out"]


def test_a_dispatch_during_a_detector_install_runs_all_old_or_all_new(stacks):
    """A batch dispatched while ``install_detector_params`` copies the
    weights, after its first copy: it waits for the install, so its output
    equals the all-new step's (never a mix of old and new layers)."""
    _jpipe, dparams, eparams, gparams, rows, labels = stacks
    port = _port_stack(dparams, eparams, gparams, rows, labels)
    x = np.random.default_rng(8).integers(0, 256, (2, 64, 64)).astype(np.uint8)
    old = port.recognize_batch_packed(x).clone()
    old_state = {k: v.clone() for k, v in port.detector.params.items()}
    new_state = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
                 for k, v in old_state.items()}
    key = next(iter(new_state))
    got = _install_meets_dispatch(lambda s: port.install_detector_params(s, version=2),
                                  lambda: port.recognize_batch_packed(x).clone(), new_state, key)
    new = port.recognize_batch_packed(x).clone()
    assert not torch.equal(old, new)
    assert torch.equal(got, new)
    assert port.last_model_versions == {"detector": 2}
    # a half-installed detector (the first tensor new, the rest old) differs
    port.install_detector_params({**old_state, key: new_state[key]})
    assert not torch.equal(port.recognize_batch_packed(x), new)


def test_a_stage1_pass_during_a_cascade_install_runs_all_old_or_all_new(stacks):
    _jpipe, dparams, eparams, gparams, rows, labels = stacks
    port = _port_stack(dparams, eparams, gparams, rows, labels)
    x = np.random.default_rng(9).integers(0, 256, (4, 64, 64)).astype(np.uint8)
    old = port.cascade_scores(x).clone()
    new_gate = port_cascade.FaceGate(features=FEATURES, dtype=torch.float32, device="cpu",
                                     generator=torch.Generator().manual_seed(4))
    new = new_gate.score_batch(x)
    assert not torch.allclose(old, new)
    state = new_gate.net.state_dict()
    key = next(iter(state))

    def install(s):
        holder = port_cascade.FaceGate(features=FEATURES, dtype=torch.float32, device="cpu")
        holder.net.load_state_dict({k: v.as_subclass(torch.Tensor) for k, v in s.items()})
        holder.net.state_dict = lambda: s  # the install reads the hooked tensors
        port.install_cascade(holder, version=5)

    got = _install_meets_dispatch(install, lambda: port.cascade_scores(x).clone(), state, key)
    torch.testing.assert_close(got, new, atol=ATOL, rtol=0)
    assert port.last_cascade_info["version"] == 5


# ---------- the serving gate against the reference's ----------


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jax_batcher, jax_fakes, jax_rec, jax_tracing, port_batcher, port_fakes,
                port_rec, port_tracing):
        monkeypatch.setattr(mod, "time", c)
    return c


def _faced(seed):
    frame = np.random.default_rng(seed).integers(20, 90, size=HW).astype(np.float32)
    frame[8:20, 8:20] = 200.0
    return frame


def _facefree(seed):
    return np.random.default_rng(seed).integers(20, 90, size=HW).astype(np.float32)


def _service(name, clock, faults=None, tracer=True, **kw):
    rec, fakes, conn_cls, metrics_cls, res, _faults, tracing = PKG[name]
    pipeline = fakes.InstantPipeline(HW, cascade_stub=True, faces_per_frame=1)
    if name == "jax" and faults is not None:
        pipeline.fault_injector = faults  # the reference's start() installs it here
    conn = conn_cls()
    service = rec.RecognizerService(
        pipeline, conn, batch_size=8, frame_shape=HW, flush_timeout=0.02, inflight_depth=2,
        similarity_threshold=0.0, metrics=metrics_cls(), readback_worker=False,
        bucket_sizes=(2, 4, 8), fault_injector=faults,
        tracer=tracing.Tracer(sample=1.0) if tracer else None,
        resilience=res.ResiliencePolicy(readback_deadline_s=2.0, dispatch_retries=0,
                                        degraded_after=99), **kw)
    pipeline.prewarm_batch_shapes(service._bucket_ladder, HW, service.batcher.dtype)
    service._warmed = True
    service._running = True
    return service, conn, pipeline


def _serve_all(service, clock):
    clock.advance(0.03)
    while True:
        batch = service.batcher.get_batch(block=False)
        if batch is None:
            return
        service._serve_one(batch)
        service._drain(force=True)


_KEYS = ("trace", "span", "stage", "verdict", "outcome", "where", "batch", "bucket", "frames",
         "exit", "rejected", "threshold", "cache_hit", "t0", "dur")


def _comparable(spans):
    return [{k: s[k] for k in _KEYS if k in s} for s in spans]


#: name -> (frame kinds of the waves, extra service kwargs, fault script)
GATE_CASES = {
    "mixed_compacts_to_a_smaller_rung": ([["f", "e", "e", "f", "e", "e", "e", "e"]], {}, None),
    "zero_survivors_exit_the_batch": ([["e"] * 8, ["e"] * 3], {}, None),
    "all_survive": ([["f"] * 8], {}, None),
    "reject_all_fault": ([["f", "e"] * 4, ["f"] * 5], {}, ("cascade", "reject_all")),
    "no_cascade_flag": ([["f", "e"] * 4], {"cascade": False}, None),
    "threshold_above_every_score": ([["f", "e"] * 4], {"cascade_threshold": 1.5}, None),
}


def _run_gate_case(name, clock, case):
    clock.reset()
    waves, kw, script = GATE_CASES[case]
    faults = None
    if script is not None:
        faults = PKG[name][5].FaultInjector(seed=0, rates={script[0]: {script[1]: 1.0}})
    service, conn, pipeline = _service(name, clock, faults=faults, **kw)
    seq = 0
    for wave in waves:
        for kind in wave:
            clock.advance(0.001)
            frame = _faced(seq) if kind == "f" else _facefree(seq)
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": frame, "meta": {"seq": seq}})
            seq += 1
        _serve_all(service, clock)
    return service, conn, pipeline


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_cascade_gate_matches_reference(clock, case):
    out = {}
    for name in ("jax", "port"):
        service, conn, pipeline = _run_gate_case(name, clock, case)
        out[name] = dict(
            ledger=service.ledger(), results=conn.messages(jax_rec.RESULT_TOPIC),
            counters=service.metrics.counters(),
            gauges={k: repr(service.metrics.gauge(k)) for k in (  # repr: nan when unset
                mn.CASCADE_REJECT_RATE, mn.CASCADE_PASS_RATE, mn.CASCADE_THRESHOLD)},
            batches=pipeline.batch_sizes_seen, calls=pipeline.cascade_calls,
            spans=_comparable(service.tracer.snapshot()),
            acct=PKG[name][6].account_spans(service.tracer.snapshot()))
    assert out["port"] == out["jax"]
    led = out["port"]["ledger"]
    assert led["in_system"] == 0 and led["admitted"] == led["completed"] + led["completed_empty"]
    assert out["port"]["acct"]["completed_empty"] == led["completed_empty"]
    for m in out["port"]["results"]:
        if m.get("exit") == "cascade":
            assert m["faces"] == []
    if case == "mixed_compacts_to_a_smaller_rung":
        assert out["port"]["batches"] == [2]
        assert {m["meta"]["seq"] for m in out["port"]["results"] if m["faces"]} == {0, 3}
    if case in ("zero_survivors_exit_the_batch", "reject_all_fault"):
        assert out["port"]["batches"] == [] and led["completed_empty"] == led["admitted"]
        assert out["port"]["counters"][mn.CASCADE_BATCH_EXITS] == 2


def test_a_failing_stage1_fails_open_like_the_reference(clock):
    out = {}
    for name in ("jax", "port"):
        clock.reset()
        service, conn, pipeline = _service(name, clock)

        def broken(frames):
            raise RuntimeError("stage 1 blew up")

        pipeline.cascade_scores = broken
        for i in range(8):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _facefree(i), "meta": {"seq": i}})
        _serve_all(service, clock)
        out[name] = (service.ledger(), service.metrics.counters(),
                     conn.messages(jax_rec.RESULT_TOPIC), pipeline.batch_sizes_seen)
    assert out["port"] == out["jax"]
    assert out["port"][1][mn.CASCADE_ERRORS] == 1 and out["port"][0]["completed"] == 8


def test_brownout_notch_matches_reference(clock):
    """From brownout level 1 the threshold rises one notch (at most 0.99),
    in both packages alike; the gauge shows the effective value."""
    got = {}
    for name in ("jax", "port"):
        clock.reset()
        policy = PKG[name][4].BrownoutPolicy(queue_wait_s=0.05, dwell_s=0.0, max_level=2)
        service, conn, _p = _service(name, clock, brownout=policy, cascade_threshold=0.4,
                                     cascade_brownout_notch=0.2)
        levels = []
        for level in (0, 1, 2):
            service._brownout_level = level
            levels.append(service._effective_cascade_threshold())
        service._brownout_level = 1
        for i in range(8):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _faced(i), "meta": {"seq": i}})
        _serve_all(service, clock)
        service.cascade_threshold = 0.95
        levels.append(service._effective_cascade_threshold())
        service.cascade_brownout_notch = 0.0
        levels.append(service._effective_cascade_threshold())
        got[name] = (levels, service.metrics.gauge(mn.CASCADE_THRESHOLD))
    assert got["port"] == got["jax"]
    assert got["port"][0][:2] == [0.4, pytest.approx(0.6)] and got["port"][0][3] == 0.99


def test_stage1_cache_miss_after_warmup_trips_the_watchdog_like_the_reference(clock):
    counts = {}
    for name in ("jax", "port"):
        clock.reset()
        service, conn, pipeline = _service(name, clock)
        pipeline.compiled_cascade_sigs.clear()
        for i in range(8):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _facefree(i), "meta": {"seq": i}})
        _serve_all(service, clock)
        counts[name] = (service.metrics.counter(mn.RECOMPILES_POST_WARMUP),
                        [s.get("mode") for s in service.tracer.snapshot()
                         if s["stage"] == "recompile"])
    assert counts["port"] == counts["jax"] == (1.0, ["cascade"])


def test_stats_carry_the_cascade_block_like_the_reference(clock):
    got = {}
    for name in ("jax", "port"):
        clock.reset()
        service, conn, _p = _service(name, clock, cascade_threshold=0.5)
        for i in range(4):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": _faced(i) if i % 2 else _facefree(i),
                                              "meta": {"seq": i}})
        _serve_all(service, clock)
        conn.inject(jax_rec.CONTROL_TOPIC, {"cmd": "stats"})
        stats = [m for m in conn.messages(jax_rec.STATUS_TOPIC) if m["status"] == "stats"]
        got[name] = stats[-1]["cascade"]
    assert got["port"] == got["jax"] == {"threshold": 0.5, "effective_threshold": 0.5,
                                         "scored": 4, "rejected": 2}


def test_a_rejected_frame_is_a_tracker_miss_like_the_reference(clock):
    """A cascade exit on a tracked stream ages its tracks (``note_miss``)."""
    from opencv_facerecognizer_tpu.runtime import tracker as jax_tracker
    from opencv_facerecognizer_tpu_torch.runtime import tracker as port_tracker

    got = {}
    for name, trk in (("jax", jax_tracker), ("port", port_tracker)):
        clock.reset()
        tracker = trk.IdentityTracker(trk.TrackerConfig(miss_ttl=2))
        service, conn, _p = _service(name, clock, tracker=tracker)
        for i, kind in enumerate("fffeeeef"):
            conn.inject(jax_rec.FRAME_TOPIC, {
                "frame": _faced(0) if kind == "f" else _facefree(i),
                "meta": {"seq": i, "stream": "cam"}})
            _serve_all(service, clock)
        got[name] = (service.ledger(), tracker.stats(),
                     [m.get("exit") for m in conn.messages(jax_rec.RESULT_TOPIC)])
    assert got["port"] == got["jax"]
    assert got["port"][0]["completed_empty"] == 4


def test_fault_boundary_matches_reference():
    assert port_faults.BOUNDARIES["cascade"] == jax_faults.BOUNDARIES["cascade"]
    keep = np.array([True, False, True])
    for mod in (jax_faults, port_faults):
        inj = mod.FaultInjector()
        assert inj.on_cascade(keep) is keep
        inj.script("cascade", "reject_all")
        assert not inj.on_cascade(keep).any() and inj.injected["cascade:reject_all"] == 1


def test_metric_names_and_ledger_tables_match_reference():
    for name in ("FRAMES_COMPLETED_EMPTY", "CASCADE_FRAMES_SCORED", "CASCADE_BATCH_EXITS",
                 "CASCADE_ERRORS", "CASCADE_SCORE", "CASCADE_REJECT_RATE", "CASCADE_PASS_RATE",
                 "CASCADE_THRESHOLD", "REGISTRY_PHASE", "REGISTRY_PARITY_AGREEMENT",
                 "REGISTRY_PARITY_SAMPLES", "REGISTRY_SWAPS", "REGISTRY_SWAPS_BLOCKED",
                 "REGISTRY_AUTO_ROLLBACKS", "REGISTRY_GATE_RETRAINS", "REGISTRY_CACHE_FLUSHES",
                 "REGISTRY_OBSERVE_ERRORS", "WAL_REGISTRY_RECORDS", "WAL_REGISTRY_ABORTS"):
        assert getattr(mn, name) == getattr(jax_mn, name), name
    assert mn.LEDGER_COMPLETION_COUNTERS == jax_mn.LEDGER_COMPLETION_COUNTERS
    assert mn.LEDGER_DROP_COUNTERS == jax_mn.LEDGER_DROP_COUNTERS


@pytest.mark.parametrize("density, jpeg", [(0.3, False), (0.0, False), (1.0, False),
                                           (0.5, True)])
def test_synthetic_frame_stream_matches_reference(density, jpeg):
    want = jax_fakes.synthetic_frame_stream(12, (48, 40), face_density=density, seed=3,
                                            jpeg=jpeg)
    got = port_fakes.synthetic_frame_stream(12, (48, 40), face_density=density, seed=3,
                                            jpeg=jpeg)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g[-1] == w[-1] and np.array_equal(g[-2], w[-2])
        if jpeg:
            assert g[0] == w[0]
    assert sum(1 for g in got if g[-1]) == round(12 * density)


def test_cascade_stub_matches_reference():
    frames = np.stack([_faced(0), _facefree(1)]).astype(np.uint8)
    ref = jax_fakes.InstantPipeline(HW, cascade_stub=True)
    port = port_fakes.InstantPipeline(HW, cascade_stub=True)
    assert np.array_equal(port.cascade_scores(frames), np.asarray(ref.cascade_scores(frames)))
    assert port.last_cascade_info == ref.last_cascade_info == {"cache_hit": False}
    assert port_fakes.InstantPipeline(HW).cascade is None
