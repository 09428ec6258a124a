"""The port's pipeline parallelism (``parallel/pp.py``) against the JAX
package's ``TwoStagePipeline`` and fused ``RecognitionPipeline`` on its 8
virtual CPU devices, and against the port's own single-device pipeline:
the port's stage meshes are CPU slots (``split_mesh`` of a (4, 2) or
(2, 4) mesh of 8), so stage A per dp row, the hop, stage B and the
sharded match all run here.

Both packages build the nets in f32 from the same flax params (the
detector's heatmap bias raised from -4 so the untrained detector finds
faces; ``test_torch_pipeline.py`` says why parity is held in f32).
Tolerances: against the port's single-device pipeline, the reference
test's own (boxes within 1e-4, sims within 2e-2, labels and valid flags
equal); across the packages, ``test_torch_pipeline.py``'s (boxes within
1e-3 px, sims within 2e-3, labels and valid flags equal)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import make_mesh as jax_make_mesh
from opencv_facerecognizer_tpu.parallel import pipeline as jax_pipeline
from opencv_facerecognizer_tpu.parallel import pp as jax_pp
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_scenes
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.parallel import (
    ShardedGallery, TwoStagePipeline, make_mesh, split_mesh)
from opencv_facerecognizer_tpu_torch.parallel.mesh import Mesh
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
from opencv_facerecognizer_tpu_torch.utils.params import (
    detector_params_from_flax, embedder_params_from_flax)

PP_BOX_ATOL = 1e-4
PP_SIM_ATOL = 2e-2
X_BOX_ATOL = 1e-3
X_SIM_ATOL = 2e-3
DET = dict(features=(8, 16), head_features=16, space_to_depth=2)
EMB = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(1, 1))
FACE = (48, 48)
MAX_FACES = 4
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def stack():
    jdet = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    dparams = jax.tree_util.tree_map(np.asarray, jax.jit(jdet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 96, 96)))["params"])
    nb = 2 * len(DET["features"])
    dparams[f"Conv_{nb + 1}"]["bias"] = np.zeros_like(dparams[f"Conv_{nb + 1}"]["bias"])
    dparams[f"Conv_{nb + 2}"]["bias"] = np.full_like(dparams[f"Conv_{nb + 2}"]["bias"], 3.0)
    jemb = jax_embedder.FaceEmbedNet(**EMB, dtype=jnp.float32)
    eparams = jax.tree_util.tree_map(np.asarray, jax.jit(jemb.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, *FACE)))["params"])
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(64, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    labels = rng.integers(0, 8, size=64).astype(np.int32)
    scenes = make_synthetic_scenes(32, (96, 96), max_faces=2, seed=3)[0].astype(np.uint8)
    return dparams, eparams, emb, labels, scenes


def _port_nets(dparams, eparams):
    det = port_detector.CNNFaceDetector(**DET, max_faces=MAX_FACES, dtype=torch.float32,
                                        device="cpu")
    detector_params_from_flax(dparams, det.net)
    net = port_embedder.FaceEmbedNet(**EMB, dtype=torch.float32, input_size=FACE)
    embedder_params_from_flax(eparams, net)
    return det, net


def _jax_nets(dparams):
    det = jax_detector.CNNFaceDetector(**DET, max_faces=MAX_FACES)
    det.net = jax_detector.DetectorNet(**DET, dtype=jnp.float32)
    det.load_params(dparams)
    return det, jax_embedder.FaceEmbedNet(**EMB, dtype=jnp.float32)


def _port_pp(stack, dp=4, tp=2, top_k=1, capacity=64, rows=None):
    dparams, eparams, emb, labels, _ = stack
    det, net = _port_nets(dparams, eparams)
    mesh_a, mesh_b = split_mesh(make_mesh(dp=dp, tp=tp, devices=CPU8))
    gal = ShardedGallery(capacity, 32, mesh=mesh_b)
    n = len(emb) if rows is None else rows
    gal.add(emb[:n], labels[:n])
    return TwoStagePipeline(det, net, None, gal, mesh_a, face_size=FACE, top_k=top_k)


def _np(result):
    return {f: np.asarray(getattr(result, f)) for f in result._fields}


def _assert_close(got, want, box_atol, sim_atol):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=box_atol)
    v = want["valid"]
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["similarities"][v], want["similarities"][v],
                               atol=sim_atol)


def test_split_mesh_halves_dp():
    a, b = split_mesh(make_mesh(dp=4, tp=2, devices=CPU8))
    assert a.shape == {"dp": 2, "tp": 2} and b.shape == {"dp": 2, "tp": 2}
    assert not {s.id for s in a.devices.flat} & {s.id for s in b.devices.flat}
    for bad in (make_mesh(dp=1, tp=8, devices=CPU8), make_mesh(dp=3, tp=2, devices=["cpu"] * 6)):
        with pytest.raises(ValueError, match="even dp >= 2"):
            split_mesh(bad)
    with pytest.raises(ValueError) as want:
        jax_pp.split_mesh(jax_make_mesh(dp=1, tp=8))
    with pytest.raises(ValueError) as got:
        split_mesh(make_mesh(dp=1, tp=8, devices=CPU8))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_pp_matches_fused_pipeline(stack, dp, tp):
    """The port's pp against its own single-device pipeline (the reference
    test's tolerances) and against the reference's fused pipeline on its
    (dp, tp) mesh and its pp (the cross-package tolerances)."""
    dparams, eparams, emb, labels, scenes = stack
    frames = scenes[:8]
    det, net = _port_nets(dparams, eparams)
    single = ShardedGallery(64, 32, device="cpu")
    single.add(emb, labels)
    fused = RecognitionPipeline(det, net, single, face_size=FACE, top_k=2, device="cpu")
    out = _port_pp(stack, dp, tp, top_k=2).recognize_batch(frames)
    _assert_close(out, fused.recognize_batch(frames), PP_BOX_ATOL, PP_SIM_ATOL)
    jdet, jnet = _jax_nets(dparams)
    jmesh = jax_make_mesh(dp=dp, tp=tp)
    jgal = JaxGallery(capacity=64, dim=32, mesh=jmesh)
    jgal.add(emb, labels)
    jfused = jax_pipeline.RecognitionPipeline(jdet, jnet, eparams, jgal, face_size=FACE,
                                              top_k=2)
    _assert_close(out, jfused.recognize_batch(frames), X_BOX_ATOL, X_SIM_ATOL)
    ja, jb = jax_pp.split_mesh(jmesh)
    jgal_b = JaxGallery(capacity=64, dim=32, mesh=jb)
    jgal_b.add(emb, labels)
    jpp = jax_pp.TwoStagePipeline(jdet, jnet, eparams, jgal_b, ja, face_size=FACE, top_k=2)
    _assert_close(out, jpp.recognize_batch(frames), X_BOX_ATOL, X_SIM_ATOL)


def test_pp_packed_matches_the_reference_pp(stack):
    """``recognize_batch_packed``: the reference's byte layout, one array
    on mesh_b's first slot, equal to the reference's packed pp output."""
    dparams, eparams, emb, labels, scenes = stack
    pp = _port_pp(stack, 2, 4)
    got = pp.recognize_batch_packed(scenes[:8]).numpy()
    assert pp.device == pp.mesh_b.first.device == torch.device("cpu")
    jdet, jnet = _jax_nets(dparams)
    ja, jb = jax_pp.split_mesh(jax_make_mesh(dp=2, tp=4))
    jgal = JaxGallery(capacity=64, dim=32, mesh=jb)
    jgal.add(emb, labels)
    want = np.asarray(jax_pp.TwoStagePipeline(jdet, jnet, eparams, jgal, ja, face_size=FACE)
                      .recognize_batch_packed(scenes[:8]))
    assert got.shape == want.shape == (8, MAX_FACES, 8)
    g = jax_pipeline.unpack_result(got, 1)
    w = jax_pipeline.unpack_result(want, 1)
    _assert_close(g, w, X_BOX_ATOL, X_SIM_ATOL)


def test_pp_stream_order_and_completeness(stack):
    pp = _port_pp(stack, 2, 4)
    scenes = stack[4]
    batches = [scenes[i:i + 4] for i in range(0, 24, 4)]
    outs = list(pp.recognize_stream(iter(batches)))
    assert len(outs) == len(batches)
    for i, out in enumerate(outs):
        solo = pp.recognize_batch(batches[i])
        np.testing.assert_array_equal(out.labels.numpy(), solo.labels.numpy())
        np.testing.assert_array_equal(out.valid.numpy(), solo.valid.numpy())


def test_pp_stream_dispatches_next_stage_a_before_yield(stack):
    """Depth 2: stage A of batch i+1 is queued before batch i reaches the
    consumer, and stage B of batch i before stage A of batch i+2."""
    pp = _port_pp(stack, 2, 4)
    events, counts = [], {"a": 0, "b": 0}
    orig_a, orig_b = pp._submit_a, pp._submit_b

    def wrapped_a(frames):
        events.append(("A", counts["a"]))
        counts["a"] += 1
        return orig_a(frames)

    def wrapped_b(hopped):
        events.append(("B", counts["b"]))
        counts["b"] += 1
        return orig_b(hopped)

    pp._submit_a, pp._submit_b = wrapped_a, wrapped_b
    batches = [stack[4][i:i + 4] for i in range(0, 16, 4)]
    for i, _out in enumerate(pp.recognize_stream(iter(batches))):
        events.append(("got", i))
    assert counts["a"] == counts["b"] == 4
    for i in range(len(batches) - 1):
        assert events.index(("A", i + 1)) < events.index(("got", i)), events
        assert events.index(("A", i + 1)) < events.index(("B", i + 1)), events
    for i in range(len(batches) - 2):
        assert events.index(("B", i)) < events.index(("A", i + 2)), events


def test_pp_sees_live_enrolment_through_a_grow(stack):
    """Every batch reads the live snapshot: an enrolment (past capacity:
    a grow) lands on the next batch, and the grow ran the pipeline's
    prewarm hook for the new tier."""
    _dparams, _eparams, emb, labels, scenes = stack
    pp = _port_pp(stack, 2, 4, rows=32)
    gal = pp.gallery
    assert pp.prewarm_capacity in gal.prewarm_hooks and pp.evict_below in gal.evict_hooks
    frames = scenes[:4]
    out0 = pp.recognize_batch(frames)
    assert pp.last_snapshot is gal.data
    extra = np.tile(emb, (2, 1))
    gal.add(extra, np.full(len(extra), 7, np.int32))  # 32 + 128 rows: a grow
    assert gal.capacity > 64
    out1 = pp.recognize_batch(frames)
    assert out1.labels.shape == out0.labels.shape
    assert pp.last_snapshot.capacity == gal.capacity
    # the planted rows (copies of every gallery row, label 7) now win ties
    # only where they are first; the old rows stay matchable
    lab, _, _ = gal.match(emb[:8], k=1)
    assert (lab.numpy()[:, 0] == labels[:8]).mean() >= 0.9


def test_pp_prewarm_and_evict_follow_an_async_grow(stack):
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    mesh_a, mesh_b = split_mesh(make_mesh(dp=2, tp=4, devices=CPU8))
    gal = ShardedGallery(16, 32, mesh=mesh_b, async_grow=True)
    gal.add(emb[:16], labels[:16])
    pp = TwoStagePipeline(det, net, None, gal, mesh_a, face_size=FACE)
    pp.recognize_batch(scenes[:4])  # a crop shape served
    gal.add(emb[16:40], labels[16:40])  # overflow: the worker grows 16 -> 64
    assert gal.wait_ready(timeout=60) and gal.capacity == 64
    assert 64 in pp.warmed_capacities
    gal.add(emb[40:], labels[40:])
    gal.add(np.tile(emb[:8], (8, 1)), np.full(64, 7, np.int32))  # 64 -> 128
    assert gal.wait_ready(timeout=60) and gal.capacity == 128
    # the replaced tier survives for readers holding its snapshot
    assert pp.warmed_capacities == {64, 128}
    gal.add(np.tile(emb, (2, 1)), np.full(128, 7, np.int32))  # 128 -> 256
    assert gal.wait_ready(timeout=60) and gal.capacity == 256
    assert pp.warmed_capacities == {128, 256}  # 64 evicted


def test_pp_rejects_overlapping_meshes(stack):
    dparams, eparams, emb, labels, _ = stack
    det, net = _port_nets(dparams, eparams)
    mesh = make_mesh(dp=2, tp=4, devices=CPU8)
    gal = ShardedGallery(64, 32, mesh=mesh)
    gal.add(emb, labels)
    mesh_a, _ = split_mesh(mesh)
    with pytest.raises(ValueError, match="share devices"):
        TwoStagePipeline(det, net, None, gal, mesh_a, face_size=FACE)


def test_pp_embed_params_load_into_its_own_copy(stack):
    """``embed_params`` (a state dict) serve stage B; the caller's net is
    not touched."""
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    other = port_embedder.FaceEmbedNet(**EMB, dtype=torch.float32, input_size=FACE,
                                       generator=torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in other.state_dict().items()}
    mesh_a, mesh_b = split_mesh(make_mesh(dp=2, tp=4, devices=CPU8))
    gal = ShardedGallery(64, 32, mesh=mesh_b)
    gal.add(emb, labels)
    pp = TwoStagePipeline(det, other, net.state_dict(), gal, mesh_a, face_size=FACE)
    want = _port_pp(stack, 2, 4).recognize_batch(scenes[:4])
    got = pp.recognize_batch(scenes[:4])
    np.testing.assert_array_equal(got.similarities.numpy(), want.similarities.numpy())
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in before.items())


def test_pp_drop_in_for_recognizer_service(stack):
    """A ``TwoStagePipeline`` serves frames through ``RecognizerService``
    (warmup runs each rung once, no ``prewarm_batch_shapes``), equal to
    the direct call, and an enrolment lands live and is named."""
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC, RecognizerService)

    scenes = stack[4]
    pp = _port_pp(stack, 2, 4)
    assert not hasattr(pp, "prewarm_batch_shapes")
    connector = FakeConnector()
    service = RecognizerService(pp, connector, batch_size=4, frame_shape=(96, 96),
                                flush_timeout=0.02, similarity_threshold=0.0,
                                subject_names=[f"p{i}" for i in range(8)])
    service.start()
    try:
        for i, scene in enumerate(scenes[:8]):
            connector.inject(FRAME_TOPIC, {**encode_frame(scene), "meta": {"frame_id": i}})
        assert service.drain(timeout=60)
        results = connector.messages(RESULT_TOPIC)
        assert sorted(r["meta"]["frame_id"] for r in results) == list(range(8))
        assert any(r["faces"] for r in results)
        direct = pp.recognize_batch(scenes[:4])
        first = sorted((r for r in results if r["meta"]["frame_id"] < 4),
                       key=lambda r: r["meta"]["frame_id"])
        for i, r in enumerate(first):
            want = direct.labels.numpy()[i, direct.valid.numpy()[i], 0]
            assert [f["label"] for f in r["faces"]] == list(want)
        # enrol a subject from one scene, then that scene names it
        scene = next(s for s in scenes[8:] if pp.recognize_batch(
            np.stack([s] * 4)).valid.numpy()[0].any())
        connector.inject(CONTROL_TOPIC, {"cmd": "enroll", "subject": "newbie", "count": 2})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
                m.get("status") == "enrolled" for m in connector.messages(STATUS_TOPIC)):
            connector.inject(FRAME_TOPIC, {**encode_frame(scene), "meta": {"frame_id": -1}})
            time.sleep(0.05)
        assert any(m.get("status") == "enrolled" for m in connector.messages(STATUS_TOPIC))
        assert service.drain(timeout=60)
        n = len(connector.messages(RESULT_TOPIC))
        for _ in range(4):
            connector.inject(FRAME_TOPIC, {**encode_frame(scene), "meta": {"frame_id": -2}})
        assert service.drain(timeout=60)
        after = connector.messages(RESULT_TOPIC)[n:]
        assert any(f["name"] == "newbie" for r in after for f in r["faces"])
    finally:
        service.stop()


def test_pp_refuses_stage_meshes_of_other_dp_and_batches_dp_does_not_divide(stack):
    """A dp row of stage A hands its frames to the same row of stage B, so
    the meshes need one dp; a batch dp does not divide is refused, as the
    reference's sharded stage A refuses it."""
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    slots = make_mesh(dp=3, tp=2, devices=["cpu"] * 6).devices
    gal = ShardedGallery(64, 32, mesh=Mesh(slots[:2]))  # dp 2, slots 0-3
    gal.add(emb, labels)
    with pytest.raises(ValueError, match="one dp"):
        TwoStagePipeline(det, net, None, gal, Mesh(slots[2:]), face_size=FACE)  # dp 1
    pp = _port_pp(stack, 4, 2)  # (2, 2) halves
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        pp.recognize_batch(scenes[:3])
