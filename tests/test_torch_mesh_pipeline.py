"""The port's fused serving step over a (dp, tp) mesh (``parallel/pipeline.py``
over ``gallery.mesh``) against the JAX package's ``RecognitionPipeline`` on
its 8 virtual CPU devices, and against the port's own single-device step:
the port's meshes are ``["cpu"] * 8`` slots, so each dp row's detect ->
align -> embed, the gather on the first slot and the sharded match all run
here. Also the dispatch ladder's dp filter (ROADMAP C.24); the CLI's
``--parallel fused`` over a mesh is in ``test_torch_recognize_app.py``.

The stack is ``test_torch_pp.py``'s (f32 nets from one set of flax params,
the detector's heatmap bias raised so the untrained detector finds faces).
Tolerances: across the packages ``test_torch_pipeline.py``'s (boxes within
1e-3 px, sims within 2e-3, labels and valid flags equal); against the
port's single-device step on each dp row's frames, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import make_mesh as jax_make_mesh
from opencv_facerecognizer_tpu.parallel import pipeline as jax_pipeline
from opencv_facerecognizer_tpu.parallel import pp as jax_pp
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.runtime.recognizer import RecognizerService as JaxService
from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery, make_mesh, split_mesh
from opencv_facerecognizer_tpu_torch.parallel.mesh import _replicas
from opencv_facerecognizer_tpu_torch.parallel.pipeline import (
    RecognitionPipeline, _LevelStep)
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    FRAME_TOPIC, RESULT_TOPIC, RecognizerService, bucket_ladder)
from test_torch_pp import (  # noqa: F401 - fixtures and helpers of the pp twin
    CPU8, FACE, MAX_FACES, X_BOX_ATOL, X_SIM_ATOL, _assert_close, _jax_nets, _port_nets,
    _port_pp, stack)


def _mesh_pipeline(stack, dp, tp, top_k=1, capacity=64, rows=None, **kw):
    dparams, eparams, emb, labels, _ = stack
    det, net = _port_nets(dparams, eparams)
    gal = ShardedGallery(capacity, 32, mesh=make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp)),
                         **kw)
    n = len(emb) if rows is None else rows
    gal.add(emb[:n], labels[:n])
    return RecognitionPipeline(det, net, gal, face_size=FACE, top_k=top_k, device="cpu")


def _single_pipeline(stack, top_k=1):
    dparams, eparams, emb, labels, _ = stack
    det, net = _port_nets(dparams, eparams)
    gal = ShardedGallery(64, 32, device="cpu")
    gal.add(emb, labels)
    return RecognitionPipeline(det, net, gal, face_size=FACE, top_k=top_k, device="cpu")


def _by_row(single, frames, dp):
    """The single-device packed step run on each dp row's frames, in order."""
    per = len(frames) // dp
    return torch.cat([single.recognize_batch_packed(frames[r * per:(r + 1) * per])
                      for r in range(dp)])


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8)])
def test_fused_pipeline_runs_sharded(stack, dp, tp):
    """Twin of ``tests/test_pipeline.py``'s test: the port over 8 CPU slots
    against the JAX ``RecognitionPipeline`` on its 8 devices at the same
    (dp, tp), on the same parameters, with the reference test's checks."""
    dparams, eparams, emb, labels, scenes = stack
    frames = scenes[:8]
    pipe = _mesh_pipeline(stack, dp, tp, top_k=2)
    assert pipe.gallery.mesh.shape == {"dp": dp, "tp": tp}
    result = pipe.recognize_batch(frames)
    assert result.boxes.shape == (8, MAX_FACES, 4)
    assert result.valid.shape == (8, MAX_FACES)
    assert result.labels.shape == result.similarities.shape == (8, MAX_FACES, 2)
    valid = result.valid.numpy()
    assert set(np.unique(result.labels.numpy()[..., 0][valid]).tolist()) <= set(labels.tolist())
    assert np.all(result.similarities.numpy()[valid] <= 1.0 + 1e-3)
    jdet, jnet = _jax_nets(dparams)
    jgal = JaxGallery(capacity=64, dim=32, mesh=jax_make_mesh(dp=dp, tp=tp))
    jgal.add(emb, labels)
    jpipe = jax_pipeline.RecognitionPipeline(jdet, jnet, eparams, jgal, face_size=FACE,
                                             top_k=2)
    _assert_close(result, jpipe.recognize_batch(frames), X_BOX_ATOL, X_SIM_ATOL)
    got = pipe.recognize_batch_packed(frames).numpy()
    want = np.asarray(jpipe.recognize_batch_packed(frames))
    assert got.shape == want.shape == (8, MAX_FACES, 6 + 2 * 2)
    _assert_close(jax_pipeline.unpack_result(got, 2), jax_pipeline.unpack_result(want, 2),
                  X_BOX_ATOL, X_SIM_ATOL)


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8), (4, 2), (8, 1)])
def test_mesh_step_equals_the_single_device_step_per_dp_row(stack, dp, tp):
    """Bit for bit: each dp row runs the single-device step's functions on
    its frames, and the sharded match equals the whole-gallery top-k."""
    frames = stack[4][:8]
    pipe = _mesh_pipeline(stack, dp, tp, top_k=2)
    got = pipe.recognize_batch_packed(frames)
    want = _by_row(_single_pipeline(stack, top_k=2), frames, dp)
    assert torch.equal(got, want)
    assert len(pipe._det_nets) == len(pipe._emb_nets) == dp
    assert pipe._det_nets[0] is pipe.detector.net and pipe._emb_nets[0] is pipe.embed_net
    assert pipe.last_snapshot is pipe.gallery.data


def test_a_mesh_of_one_slot_is_the_single_device_step(stack):
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    gal = ShardedGallery(64, 32, mesh=make_mesh(dp=1, tp=1, devices=["cpu"]))
    gal.add(emb, labels)
    pipe = RecognitionPipeline(det, net, gal, face_size=FACE, device="cpu")
    assert pipe._rows == [] and pipe._det_nets == [det.net]
    assert torch.equal(pipe.recognize_batch_packed(scenes[:5]),
                       _single_pipeline(stack).recognize_batch_packed(scenes[:5]))


class _ReplayGraph:
    """A CPU stand-in for a captured graph: a replay runs the function
    again and copies its outputs into the captured ones."""

    def __init__(self, run, out):
        self.run, self.out = run, out

    def replay(self):
        for old, new in zip(self.out, self.run()):
            for o, n in zip(old, new):
                o.copy_(n)


@pytest.mark.parametrize("dp,tp", [(2, 4), (1, 8), (4, 2)])
def test_level_step_equals_the_mesh_step(stack, dp, tp, monkeypatch):
    """The several-card step's levels and hops (``_capture_levels``), with a
    replay that reruns each level, give the eager mesh step's bits, on new
    frames and after an enrolment (its static valid and labels refilled)."""
    dparams, eparams, emb, labels, scenes = stack
    pipe = _mesh_pipeline(stack, dp, tp, top_k=2, rows=48)

    def fake_capture(run, pool=None, device=None):
        out = run()
        return _ReplayGraph(run, out), out, {}

    monkeypatch.setattr(pipe, "_capture_graph", fake_capture)
    frames = torch.from_numpy(scenes[:8])
    data = pipe.gallery.data
    key = pipe._step_key(frames, data)
    step = pipe._capture_levels(key, data)
    assert isinstance(step, _LevelStep) and len(step.levels) == 4
    assert pipe.captures == 1 and key in pipe.capture_ms
    out = step(frames, data, None)
    assert not out.requires_grad  # the service reads it back with ``numpy()``
    assert torch.equal(out, pipe.recognize_batch_packed(frames))
    pipe.gallery.add(emb[48:], labels[48:])  # in place: the same rows by address
    data = pipe.gallery.data
    assert pipe._binding(data, None) == step.binding
    other = torch.from_numpy(scenes[8:16])
    assert torch.equal(step(other, data, None), pipe.recognize_batch_packed(other))


def test_a_capture_with_no_cached_step_takes_fresh_pools(stack, monkeypatch):
    """A step capture made while no cached step holds a graph (after
    ``evict_below`` of every tier, or a cleared cache) takes fresh pools on
    every card, since capturing into a pool whose graphs were all freed
    trips the caching allocator; one made beside a cached step keeps the
    pool that step's graphs use."""
    scenes = stack[4]
    pipe = _mesh_pipeline(stack, 2, 2, rows=48)
    handles = iter(range(1, 100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (next(handles), 0))
    pools = []

    def fake_capture(run, pool=None, device=None):
        pools.append(pool)
        out = run()
        return _ReplayGraph(run, out), out, {}

    monkeypatch.setattr(pipe, "_capture_graph", fake_capture)
    monkeypatch.setattr(pipe, "cuda_graphs", True)  # pools exist only with graphs

    def capture(n):
        frames = torch.from_numpy(scenes[:n])
        data = pipe.gallery.data
        key = pipe._step_key(frames, data)
        pipe._step_cache[key] = pipe._capture_levels(key, data)

    capture(8)
    assert pipe._pool == (1, 0) and pools == [(1, 0)] * 4
    capture(4)
    assert pipe._pool == (1, 0) and pools[4:] == [(1, 0)] * 4
    pipe.evict_below(pipe.gallery.capacity + 1)
    assert not pipe._step_cache
    pipe._pools = {"cuda:1": (9, 0)}  # another card's pool, freed with the steps
    capture(8)
    assert pipe._pool == (2, 0) and pools[8:] == [(2, 0)] * 4 and pipe._pools == {}
    pipe._step_cache.clear()
    capture(4)
    assert pipe._pool == (3, 0) and pools[12:] == [(3, 0)] * 4


def test_refusals_carry_the_reference_messages(stack):
    """``fused_embedder`` on a mesh of more than one device, and a batch
    the dp axis does not divide, are refused with a ``ValueError`` as the
    reference refuses them."""
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    gal = ShardedGallery(64, 32, mesh=make_mesh(dp=2, tp=4, devices=CPU8))
    with pytest.raises(ValueError) as got:
        RecognitionPipeline(det, net, gal, face_size=FACE, fused_embedder=True, device="cpu")
    jdet, jnet = _jax_nets(dparams)
    jgal = JaxGallery(capacity=64, dim=32, mesh=jax_make_mesh(dp=2, tp=4))
    with pytest.raises(ValueError) as want:
        jax_pipeline.RecognitionPipeline(jdet, jnet, eparams, jgal, face_size=FACE,
                                         fused_embedder=True)
    assert str(got.value) == str(want.value)
    assert "requires a single-device mesh (got 8 devices)" in str(got.value)
    jgal.add(emb, labels)
    with pytest.raises(ValueError, match="divisible by 2"):
        jax_pipeline.RecognitionPipeline(jdet, jnet, eparams, jgal,
                                         face_size=FACE).recognize_batch(scenes[:3])
    pipe = _mesh_pipeline(stack, 2, 4)
    for call in (pipe.recognize_batch_packed, pipe.recognize_batch):
        with pytest.raises(ValueError, match="frame batch 3 not divisible by dp=2"):
            call(scenes[:3])
    assert pipe._step_cache == {}


def test_install_reaches_every_dp_row(stack):
    """An install on a (2, 2) mesh loads the new weights into every row's
    copy of the detector; the step then equals a pipeline built on them."""
    dparams, eparams, emb, labels, scenes = stack
    pipe = _mesh_pipeline(stack, 2, 2)
    frames = scenes[:8]
    before = pipe.recognize_batch_packed(frames).clone()
    rng = np.random.default_rng(5)
    new = {k: v + torch.from_numpy(rng.normal(scale=0.05, size=v.shape).astype(np.float32))
           if v.is_floating_point() else v for k, v in pipe.detector.params.items()}
    pipe.install_detector_params(new, version=2)
    for net in pipe._det_nets:
        for k, v in net.state_dict().items():
            assert torch.equal(v, new[k]), k
    got = pipe.recognize_batch_packed(frames)
    assert pipe.last_model_versions == {"detector": 2}
    det, net = _port_nets(dparams, eparams)
    det.load_params(new)
    gal = ShardedGallery(64, 32, mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    gal.add(emb, labels)
    fresh = RecognitionPipeline(det, net, gal, face_size=FACE, device="cpu")
    assert torch.equal(got, fresh.recognize_batch_packed(frames))
    assert not torch.equal(got, before)


def test_replicas_live_in_mesh_and_serve_both_pipelines():
    from opencv_facerecognizer_tpu_torch.parallel import pp

    assert pp._replicas is _replicas
    net = torch.nn.Linear(2, 2)
    slots = make_mesh(dp=3, tp=1, devices=["cpu"] * 3).devices[:, 0]
    copies = _replicas(net, slots)
    assert copies[0] is net and len({id(c) for c in copies}) == 3
    assert all(torch.equal(c.weight, net.weight) for c in copies)


def test_a_grow_across_a_tier_on_a_mesh_gallery(stack):
    """An enrolment past capacity grows the mesh gallery (sync and async);
    the next step reads the new tier, equal to the single-device step on
    each dp row over the same rows, and the async grow warmed the step."""
    dparams, eparams, emb, labels, scenes = stack
    frames = scenes[:8]
    extra = np.tile(emb[:40], (2, 1))
    extra_labels = np.full(len(extra), 7, np.int32)
    for async_grow in (False, True):
        pipe = _mesh_pipeline(stack, 2, 4, capacity=64, async_grow=async_grow)
        pipe.recognize_batch_packed(frames)
        pipe.gallery.add(extra, extra_labels)
        if async_grow:
            assert pipe.gallery.wait_ready(timeout=60)
            assert not pipe.gallery.last_grow_info.get("prewarm_errors")
            assert any(k[4] == 256 for k in pipe._step_cache)
        assert pipe.gallery.capacity == 256
        got = pipe.recognize_batch_packed(frames)
        assert pipe.last_snapshot.capacity == 256
        det, net = _port_nets(dparams, eparams)
        single = ShardedGallery(256, 32, device="cpu")
        single.add(emb, labels)
        single.add(extra, extra_labels)
        ref = RecognitionPipeline(det, net, single, face_size=FACE, device="cpu")
        assert torch.equal(got, _by_row(ref, frames, 2))


def test_service_answers_every_frame_through_the_mesh(stack):
    pipe = _mesh_pipeline(stack, 2, 4)
    conn = FakeConnector()
    service = RecognizerService(pipe, conn, batch_size=8, frame_shape=(96, 96),
                                flush_timeout=0.02, similarity_threshold=0.0,
                                bucket_sizes=(1, 2, 3, 4))
    assert service._bucket_ladder == [2, 4, 8]
    service.start()
    try:
        for i, scene in enumerate(stack[4][:13]):
            conn.inject(FRAME_TOPIC, {**encode_frame(scene), "meta": {"i": i}})
        assert service.drain(timeout=60)
    finally:
        service.stop()
    results = conn.messages(RESULT_TOPIC)
    assert sorted(r["meta"]["i"] for r in results) == list(range(13))
    assert any(r["faces"] for r in results)


# ---- ROADMAP C.24: the dispatch ladder's dp filter ----


class _MeshOnly:
    """A pipeline surface for the ladder: a gallery mesh and, for pp, a
    stage-A mesh."""

    def __init__(self, gallery_mesh, mesh_a=None):
        self.gallery = type("G", (), {"mesh": gallery_mesh})()
        if mesh_a is not None:
            self.mesh_a = mesh_a


LADDERS = [((1, 8, 32), 32), ((1, 2, 3, 4, 6, 8), 8), ((1, 4), 4), ((), 16),
           ((4, 2, 4, 12, 99), 16)]


@pytest.mark.parametrize("layout", ["pp 4x1", "pp 4x2", "fused 2x4", "fused 4x2", "fused 1x8"])
@pytest.mark.parametrize("sizes,batch", LADDERS)
def test_bucket_ladder_matches_the_reference(layout, sizes, batch):
    kind, shape = layout.split()
    dp, tp = (int(x) for x in shape.split("x"))
    n = dp * tp
    port = make_mesh(dp=dp, tp=tp, devices=["cpu"] * n)
    ref = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:n])
    if kind == "pp":
        port_pipe, ref_pipe = _MeshOnly(*split_mesh(port)[::-1]), _MeshOnly(
            *jax_pp.split_mesh(ref)[::-1])
    else:
        port_pipe, ref_pipe = _MeshOnly(port), _MeshOnly(ref)
    want = JaxService._build_bucket_ladder(type("S", (), {"pipeline": ref_pipe})(), sizes,
                                           batch)
    assert bucket_ladder(sizes, batch, port_pipe) == want
    assert all(b % (dp // 2 if kind == "pp" else dp) == 0 for b in want[:-1])


def test_a_lone_frame_on_a_dp2_pp_mesh_is_answered_like_the_reference(stack):
    """``bucket_sizes=(1, 4)`` over a pp mesh of dp 2: rung 1 is filtered
    out, so a lone frame is dispatched at rung 4 (padded) and answered, as
    the reference's service answers it, instead of failing at the split."""
    dparams, eparams, emb, labels, scenes = stack
    pp = _port_pp(stack, 4, 2)  # (2, 2) stage meshes
    conn = FakeConnector()
    service = RecognizerService(pp, conn, batch_size=8, frame_shape=(96, 96),
                                flush_timeout=0.02, similarity_threshold=0.0,
                                bucket_sizes=(1, 4))
    assert service._bucket_ladder == [4, 8]
    service.start()
    try:
        conn.inject(FRAME_TOPIC, {**encode_frame(scenes[0]), "meta": {"i": 0}})
        assert service.drain(timeout=60)
    finally:
        service.stop()
    (got,) = conn.messages(RESULT_TOPIC)
    jdet, jnet = _jax_nets(dparams)
    ja, jb = jax_pp.split_mesh(jax_make_mesh(dp=4, tp=2))
    jgal = JaxGallery(capacity=64, dim=32, mesh=jb)
    jgal.add(emb, labels)
    jconn = JaxConnector()
    jservice = JaxService(jax_pp.TwoStagePipeline(jdet, jnet, eparams, jgal, ja,
                                                  face_size=FACE),
                          jconn, batch_size=8, frame_shape=(96, 96), flush_timeout=0.02,
                          similarity_threshold=0.0, bucket_sizes=(1, 4))
    assert jservice._bucket_ladder == [4, 8]
    jservice.start()
    try:
        jconn.inject(FRAME_TOPIC, {**encode_frame(scenes[0]), "meta": {"i": 0}})
        assert jservice.drain(timeout=120)
    finally:
        jservice.stop()
    (want,) = jconn.messages(RESULT_TOPIC)
    assert got["meta"]["i"] == want["meta"]["i"] == 0
    assert len(got["faces"]) == len(want["faces"]) >= 1
    for g, w in zip(got["faces"], want["faces"]):
        assert g["label"] == w["label"]
        np.testing.assert_allclose(g["box"], w["box"], atol=X_BOX_ATOL)
        assert abs(g["similarity"] - w["similarity"]) <= X_SIM_ATOL
