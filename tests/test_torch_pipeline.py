"""The slice as a whole: the PyTorch port's serving step and service
against the JAX package's, on the same frames and the same flax params.

The JAX ``RecognitionPipeline`` runs on a one-device CPU mesh with
``use_pallas=True`` and, where the case says so, ``fused_embedder=True``,
so both Pallas kernels run in interpret mode; the port runs on
``device="cpu"``, where both kernel wrappers take their plain versions.

Both sides are built in f32 (``dtype=float32``): under ``jax.jit`` XLA
fuses bf16 ops and moves their rounding points away from flax's eager
ones (measured on this config: detector logits differ by 1.3e-2 between
jit and eager flax), so whole-pipeline parity in bf16 would compare
XLA's fusion choices, not the port. The bf16 modules are held to eager
flax in test_torch_detector.py / test_torch_embedder.py.

Tolerances: the valid mask and the labels of valid faces are held
exactly; boxes to ``BOX_ATOL`` pixels; sims to ``SIM_ATOL`` (the fused
schedule rounds its operands to bf16 on both sides, in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.parallel import gallery as jax_gallery
from opencv_facerecognizer_tpu.parallel import pipeline as jax_pipeline
from opencv_facerecognizer_tpu.parallel import quantizer as jax_quantizer
from opencv_facerecognizer_tpu.parallel.mesh import make_mesh
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.ops.ivf_match import ivf_match_topk
from opencv_facerecognizer_tpu_torch.parallel import gallery as port_gallery
from opencv_facerecognizer_tpu_torch.parallel import pipeline as port_pipeline
from opencv_facerecognizer_tpu_torch.parallel import quantizer as port_quantizer
from opencv_facerecognizer_tpu_torch.runtime.connector import (
    FakeConnector, decode_frame, encode_frame)
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    FRAME_TOPIC, RESULT_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.utils.params import (
    detector_params_from_flax, embedder_params_from_flax)

BOX_ATOL = 1e-3
SIM_ATOL = 2e-3
DET = dict(features=(16, 16), head_features=16, space_to_depth=4)
EMB = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(2, 1))
FACE = (32, 32)
MAX_FACES = 4
CAPACITY = 256


@pytest.fixture(scope="module")
def params():
    """Flax detector/embedder params (heatmap bias raised from -4 so the
    untrained detector yields faces), frames, and gallery rows in which
    the faces' own embeddings are planted among random rows."""
    jdet_net = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    dparams = jax.tree_util.tree_map(np.asarray, jax.jit(jdet_net.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64)))["params"])
    dparams["Conv_5"]["bias"] = np.zeros_like(dparams["Conv_5"]["bias"])
    jemb = jax_embedder.FaceEmbedNet(**EMB, dtype=jnp.float32)
    eparams = jax.tree_util.tree_map(np.asarray, jax.jit(jemb.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, *FACE)))["params"])
    rng = np.random.default_rng(0)
    frames = (rng.random((5, 64, 64)) * 255).astype(np.uint8)
    rows = rng.normal(size=(200, 32)).astype(np.float32)
    labels = np.arange(200, dtype=np.int32) * 3
    port = _port_pipeline(dparams, eparams, rows[:1], labels[:1], fused=False)
    _b, _s, valid, emb = port.embed_frames(frames)
    planted = emb.numpy()[valid.reshape(-1).numpy()]
    assert 4 <= len(planted) <= 20, len(planted)
    rows[10:10 + len(planted)] = planted
    return dparams, eparams, frames, rows, labels


def _port_pipeline(dparams, eparams, rows, labels, fused):
    det = port_detector.CNNFaceDetector(**DET, max_faces=MAX_FACES, dtype=torch.float32,
                                        device="cpu")
    detector_params_from_flax(dparams, det.net)
    net = port_embedder.FaceEmbedNet(**EMB, dtype=torch.float32, input_size=FACE)
    embedder_params_from_flax(eparams, net)
    gal = port_gallery.ShardedGallery(CAPACITY, 32, use_kernel=True,
                                      store_dtype=torch.bfloat16, device="cpu")
    gal.add(rows, labels)
    return port_pipeline.RecognitionPipeline(det, net, gal, face_size=FACE,
                                             fused_embedder=fused, device="cpu")


def _jax_pipeline(dparams, eparams, rows, labels, fused):
    det = jax_detector.CNNFaceDetector(**DET, max_faces=MAX_FACES)
    det.net = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    det.load_params(dparams)
    net = jax_embedder.FaceEmbedNet(**EMB, dtype=jnp.float32)
    gal = jax_gallery.ShardedGallery(CAPACITY, 32, mesh=make_mesh(devices=[jax.devices()[0]]),
                                     use_pallas=True, store_dtype=jnp.bfloat16)
    gal.add(rows, labels)
    return jax_pipeline.RecognitionPipeline(det, net, eparams, gal, face_size=FACE,
                                            fused_embedder=fused)


def _assert_same(got, want):
    g = port_pipeline.unpack_result(got, 1)
    w = jax_pipeline.unpack_result(want, 1)
    assert got.shape == want.shape == (5, MAX_FACES, 8)
    np.testing.assert_array_equal(g.valid, w.valid)
    assert w.valid.sum() >= 4
    np.testing.assert_array_equal(g.labels[g.valid], w.labels[w.valid])
    np.testing.assert_allclose(g.boxes, w.boxes, atol=BOX_ATOL)
    np.testing.assert_allclose(g.det_scores[g.valid], w.det_scores[w.valid], atol=1e-5)
    np.testing.assert_allclose(g.similarities, w.similarities, atol=SIM_ATOL)
    # planted faces find themselves
    assert (g.similarities[g.valid] > 0.99).all()


@pytest.mark.parametrize("fused", [True, False])
def test_packed_step_matches_jax(params, fused):
    dparams, eparams, frames, rows, labels = params
    want = np.asarray(_jax_pipeline(dparams, eparams, rows, labels, fused)
                      .recognize_batch_packed(frames))
    port = _port_pipeline(dparams, eparams, rows, labels, fused)
    got = port.recognize_batch_packed(frames)
    assert got.dtype == torch.float32
    _assert_same(got.numpy(), want)
    # the unpacked step carries the same numbers
    res = port.recognize_batch(frames)
    np.testing.assert_array_equal(port_pipeline.pack_result(res).numpy(), got.numpy())


def test_packed_step_with_ivf_matches_jax(params):
    """The step through the two-stage IVF match: both galleries hold the
    same quantizer state (the JAX package's, carried by its sidecar
    payload), half the cells probed per face; the port's step takes the
    IVF path once per batch."""
    dparams, eparams, frames, rows, labels = params
    jax_pipe = _jax_pipeline(dparams, eparams, rows, labels, fused=False)
    jq = jax_quantizer.CoarseQuantizer(nlist=8, nprobe=4, seed=1, kmeans_iters=4,
                                       train_sample=256)
    jax_pipe.gallery.attach_quantizer(jq, mode="ivf")
    assert jq.rebuild_now()
    want = np.asarray(jax_pipe.recognize_batch_packed(frames))
    port = _port_pipeline(dparams, eparams, rows, labels, fused=False)
    pq = port_quantizer.CoarseQuantizer(nlist=8, nprobe=4, seed=1)
    port.gallery.attach_quantizer(pq, mode="ivf")
    payload = jax_pipe.gallery.snapshot_quantizer()
    assert pq.install_from_arrays(payload["centroids"], payload["assign"])
    before = ivf_match_topk.calls
    got = port.recognize_batch_packed(frames)
    assert ivf_match_topk.calls == before + 1
    _assert_same(got.numpy(), want)


def test_install_detector_params_takes_effect(params):
    dparams, eparams, frames, rows, labels = params
    port = _port_pipeline(dparams, eparams, rows, labels, fused=False)
    assert port.recognize_batch(frames).valid.any()
    new = {k: v.clone() for k, v in port.detector.params.items()}
    new["heatmap.bias"].fill_(-20.0)  # every score ~0: no face survives 0.3
    port.install_detector_params(new)
    assert torch.equal(port.detector.net.heatmap.bias, new["heatmap.bias"])
    assert not port.recognize_batch(frames).valid.any()


def test_pack_layout_matches_reference():
    rng = np.random.default_rng(9)
    parts = dict(boxes=rng.random((2, 3, 4)).astype(np.float32),
                 det_scores=rng.random((2, 3)).astype(np.float32),
                 valid=rng.random((2, 3)) > 0.5,
                 labels=rng.integers(-1, 99, (2, 3, 2)).astype(np.int32),
                 similarities=rng.random((2, 3, 2)).astype(np.float32))
    want = np.asarray(jax_pipeline.pack_result(jax_pipeline.RecognitionResult(
        **{k: jnp.asarray(v) for k, v in parts.items()})))
    got = port_pipeline.pack_result(port_pipeline.RecognitionResult(
        **{k: torch.tensor(v) for k, v in parts.items()})).numpy()
    np.testing.assert_array_equal(got, want)
    back = port_pipeline.unpack_result(got, 2)
    np.testing.assert_array_equal(back.labels, parts["labels"])
    np.testing.assert_array_equal(back.valid, parts["valid"])


def _expected_faces(packed, i, threshold=0.3):
    r = jax_pipeline.unpack_result(packed, 1)
    faces = []
    for j in range(r.boxes.shape[1]):
        if r.valid[i, j]:
            sim, label = float(r.similarities[i, j, 0]), int(r.labels[i, j, 0])
            known = sim >= threshold and label >= 0
            y0, x0, y1, x1 = r.boxes[i, j]
            faces.append(dict(box=[x0, y0, x1, y1], label=label if known else -1,
                              name=str(label) if known else "unknown"))
    return faces


def test_service_answers_every_frame_like_jax(params):
    """N frames through FakeConnector -> N results whose faces are the JAX
    pipeline's, in the reference's result schema."""
    dparams, eparams, frames, rows, labels = params
    want = np.asarray(_jax_pipeline(dparams, eparams, rows, labels, True)
                      .recognize_batch_packed(frames))
    conn = FakeConnector()
    service = RecognizerService(
        _port_pipeline(dparams, eparams, rows, labels, True), conn, batch_size=4,
        frame_shape=(64, 64), transfer_dtype=np.uint8, bucket_sizes=(2,),
        flush_timeout=0.02)
    service.start(warmup=True)
    try:
        for i, frame in enumerate(frames):
            conn.inject(FRAME_TOPIC, {**encode_frame(frame), "meta": {"i": i}})
        conn.inject(FRAME_TOPIC, {"meta": "broken"})  # malformed: no payload
        assert service.drain(timeout=60.0)
    finally:
        service.stop()
    results = conn.messages(RESULT_TOPIC)
    assert len(results) == len(frames)
    assert sorted(r["meta"]["i"] for r in results) == list(range(len(frames)))
    for r in results:
        exp = _expected_faces(want, r["meta"]["i"])
        assert len(r["faces"]) == len(exp)
        for face, e in zip(r["faces"], exp):
            assert set(face) == {"box", "detection_score", "label", "name", "similarity"}
            np.testing.assert_allclose(face["box"], e["box"], atol=BOX_ATOL)
            assert (face["label"], face["name"]) == (e["label"], e["name"])
    ledger = service.ledger()
    assert ledger == {"admitted": 6.0, "completed": 5.0, "dropped": 1.0, "in_system": 0.0}


class _StubPipeline:
    """Answers every frame with one empty packed row, instantly (CPU)."""

    top_k = 1
    face_size = FACE

    def recognize_batch_packed(self, frames):
        return torch.zeros((len(frames), MAX_FACES, 8))

    def prewarm_batch_shapes(self, sizes, frame_shape, dtype):
        return len(sizes)


def test_service_ledger_under_concurrent_producers():
    """Eight producer threads inject at once while the loop and the readback
    worker run, with a tiny switch interval: every frame is published
    exactly once and the ledger balances (a lost update would break it)."""
    import sys
    import threading

    conn = FakeConnector()
    service = RecognizerService(_StubPipeline(), conn, batch_size=4, frame_shape=(8, 8),
                                flush_timeout=0.005, max_pending=10_000,
                                bucket_sizes=(2,), inflight_depth=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        service.start()

        def produce(t):
            for i in range(50):
                conn.inject(FRAME_TOPIC, {"frame": np.full((8, 8), i, np.uint8),
                                          "meta": (t, i)})

        threads = [threading.Thread(target=produce, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        assert service.drain(timeout=30)
    finally:
        service.stop()
        sys.setswitchinterval(old)
    metas = [r["meta"] for r in conn.messages(RESULT_TOPIC)]
    assert sorted(metas) == sorted((t, i) for t in range(8) for i in range(50))
    assert service.ledger() == {"admitted": 400.0, "completed": 400.0,
                                "dropped": 0.0, "in_system": 0.0}


def test_frame_wire_roundtrip():
    frame = (np.arange(12, dtype=np.uint8) * 7).reshape(3, 4)
    np.testing.assert_array_equal(decode_frame(encode_frame(frame)), frame)


def test_batcher_flush_overflow_and_recycle():
    from opencv_facerecognizer_tpu_torch.runtime.batcher import FrameBatcher
    from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    b = FrameBatcher(3, (2, 2), flush_timeout=0.01, max_pending=4, dtype=np.uint8,
                     metrics=m)
    assert not b.put(np.zeros((3, 3)))  # malformed
    for i in range(5):
        assert b.put(np.full((2, 2), i + 0.7, np.float32), meta=i)
    assert m.counter("batcher_dropped_overflow") == 1  # oldest dropped
    full = b.get_batch()
    assert full.count == 3 and full.metas == [1, 2, 3]
    assert full.frames.dtype == np.uint8 and full.frames[0, 0, 0] == 1
    b.recycle(full.frames)
    part = b.get_batch()  # flushes on the timeout with one frame
    assert part.count == 1 and part.frames is full.frames
    assert (part.frames[1:] == 0).all()
    b.close()
    assert b.get_batch() is None and not b.put(np.zeros((2, 2)))
    assert m.counter("batcher_dropped_malformed") == 1
