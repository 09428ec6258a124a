"""The IVF large-gallery path of the PyTorch port against the JAX package:
the quantizer's packing and sidecar format, the two-stage match, the
assignment and k-means, the gallery's matcher selection, and the
quantizer's lifecycle, on the same numpy inputs on the CPU.

The JAX side runs on a one-device CPU mesh, its stage-2 Pallas kernel in
interpret mode; the port runs on ``device="cpu"``, where stage 2 is the
streaming match's plain version.

Tolerances: the int8 lists and the sidecar bytes are held bit for bit.
Two-stage sims are f32 sums of the same bf16 products in another order
(``SIM_ATOL``); indices are held exactly. Assignment and k-means are f32
products in another order: a row whose two best cells score within
``ASSIGN_TIE`` of each other may take either; centroids agree within
``CENTROID_ATOL``. The port's k-means init differs from the reference's
by design (numpy, not ``jax.random``), so k-means is held to the
reference given the reference's init.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.ops import ivf_match as jax_ivf
from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import quantizer as jax_quant
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu_torch.ops import ivf_match as port_ivf
from opencv_facerecognizer_tpu_torch.parallel import quantizer as port_quant
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.params import ivf_data_from_numpy

SIM_ATOL = 1e-5
ASSIGN_TIE = 1e-6
CENTROID_ATOL = 1e-5
ROWS, DIM, NLIST = 2048, 32, 32
IVF_FIELDS = ("centroids", "cell_rows", "cell_q8", "cell_scale", "spill_rows",
              "spill_q8", "spill_scale")


def _unit(x):
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))


def _jax_gallery(emb, nlist=NLIST, nprobe=8, seed=0, build=True):
    g = JaxGallery(capacity=len(emb), dim=emb.shape[1], mesh=_mesh1())
    g.add(emb, np.arange(len(emb), dtype=np.int32))
    q = jax_quant.CoarseQuantizer(nlist=nlist, nprobe=nprobe, seed=seed, kmeans_iters=5,
                                  train_sample=4096)
    g.attach_quantizer(q, mode="ivf")
    if build:
        assert q.rebuild_now()
    return g, q


def _port_gallery(emb, nlist=NLIST, nprobe=8, seed=0, build=True, metrics=None,
                  mode="ivf", capacity=None):
    g = ShardedGallery(capacity or len(emb), emb.shape[1], device="cpu")
    g.add(emb, np.arange(len(emb), dtype=np.int32))
    q = port_quant.CoarseQuantizer(nlist=nlist, nprobe=nprobe, seed=seed, kmeans_iters=5,
                                   train_sample=4096, metrics=metrics)
    # Attach after the bulk add, so no background build races the tests'
    # own rebuild_now().
    g.attach_quantizer(q, mode=mode)
    if build:
        assert q.rebuild_now()
    return g, q


@pytest.fixture(scope="module")
def built():
    """A JAX gallery with a built quantizer, and a port gallery of the same
    rows holding the same quantizer state (from the JAX sidecar)."""
    rng = np.random.default_rng(0)
    emb = _unit(rng.normal(size=(ROWS, DIM)))
    jg, jq = _jax_gallery(emb)
    pg, pq = _port_gallery(emb, build=False)
    _h, cent, assign = port_quant.decode_sidecar(
        jax_quant.encode_sidecar(jg.snapshot_quantizer(), wal_seq=3))
    assert pq.install_from_arrays(cent, assign)
    return emb, jg, jq, pg, pq


# ---- host-pure parts: bit for bit ----

def test_quantize_and_pack_bit_equal():
    rng = np.random.default_rng(1)
    rows = _unit(rng.normal(size=(600, 24)))
    rows[5] = 0.0  # the scale floor
    ids = np.sort(rng.choice(1000, 600, replace=False)).astype(np.int32)
    cells = rng.integers(0, 8, 600).astype(np.int32)
    cells[:150] = 3  # one cell past max_cell: rows spill
    got_q, got_s = port_quant.quantize_rows(rows)
    want_q, want_s = jax_quant.quantize_rows(rows)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    got = port_quant.pack_inverted_lists(ids, cells, got_q, got_s, 8, spill_floor=300)
    want = jax_quant.pack_inverted_lists(ids, cells, want_q, want_s, 8, spill_floor=300)
    assert got[7] == want[7] > 0  # overflow into the spill
    for a, b in zip(got[:7], want[:7]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecar_crosses_packages(writer):
    rng = np.random.default_rng(2)
    payload = {"centroids": _unit(rng.normal(size=(16, 8))),
               "assign": rng.integers(-1, 16, 100).astype(np.int32),
               "nlist": 16, "seed": 4, "trained_size": 99, "version": 3,
               "embedder_version": 2}
    enc, dec = ((jax_quant.encode_sidecar, port_quant.decode_sidecar) if writer == "jax"
                else (port_quant.encode_sidecar, jax_quant.decode_sidecar))
    blob = enc(payload, wal_seq=17)
    header, cent, assign = dec(blob)
    assert header["wal_seq"] == 17 and header["embedder_version"] == 2
    np.testing.assert_array_equal(cent, payload["centroids"])
    np.testing.assert_array_equal(assign, payload["assign"])
    assert port_quant.SIDECAR_MAGIC == jax_quant.SIDECAR_MAGIC
    for bad in (blob[:len(blob) // 2], b"garbage" + blob):
        with pytest.raises(port_quant.SidecarError):
            port_quant.decode_sidecar(bad)


def test_install_from_jax_sidecar_equals_jax_lists(built):
    _emb, _jg, jq, pg, pq = built
    for field in IVF_FIELDS:
        np.testing.assert_array_equal(getattr(pq.data, field).numpy(),
                                      np.asarray(getattr(jq.data, field)), err_msg=field)
    assert pq.data.shape_signature() == jq.data.shape_signature()
    assert pq.stats() == jq.stats()
    assert pq.data.gallery_epoch == pg.data.epoch


def test_ivf_data_from_numpy_round_trip(built):
    _emb, _jg, jq, _pg, _pq = built
    ivf = ivf_data_from_numpy(tuple(np.asarray(a) for a in jq.data[:7]) + (5,), device="cpu")
    assert ivf.gallery_epoch == 5
    for field, dtype in zip(IVF_FIELDS, (torch.float32, torch.int32, torch.int8, torch.float32,
                                         torch.int32, torch.int8, torch.float32)):
        assert getattr(ivf, field).dtype == dtype
        np.testing.assert_array_equal(getattr(ivf, field).numpy(),
                                      np.asarray(getattr(jq.data, field)))


# ---- the two-stage match ----

@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("nq,nprobe", [(4, 4), (16, 8)])
def test_ivf_match_topk_matches_jax(built, k, nq, nprobe):
    """The same IVFDeviceData and queries: equal indices, sims within
    SIM_ATOL; a part of the cells probed (4 x 4 < 32) and all of them;
    invalid rows never surface."""
    emb, _jg, jq, _pg, _pq = built
    rng = np.random.default_rng(10 + nq)
    q = _unit(emb[rng.choice(ROWS, nq)] + 0.05 * rng.normal(size=(nq, DIM)))
    valid = rng.random(ROWS) > 0.1
    ivf = ivf_data_from_numpy(tuple(np.asarray(a) for a in jq.data[:7]), device="cpu")
    wv, wi = (np.asarray(a) for a in jax_ivf.ivf_match_topk(
        jnp.asarray(q), jnp.asarray(valid), jq.data, k=k, nprobe=nprobe, interpret=True))
    gv, gi = port_ivf.ivf_match_topk(torch.tensor(q), torch.tensor(valid), ivf, k=k,
                                     nprobe=nprobe)
    assert gi.dtype == torch.int32 and gv.shape == (nq, k)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, atol=SIM_ATOL, rtol=0)
    assert valid[gi.numpy()[gi.numpy() >= 0]].all()
    if nprobe == 4:  # a part of the cells: the union has pads
        sel = port_ivf.shortlist_cells(torch.tensor(q), ivf.centroids, nprobe)
        assert sel.shape == (16,) and bool((sel[1:] >= sel[:-1]).all())


def test_ivf_match_sentinels_and_out_of_range_rows(built):
    """Fewer valid rows than k: -1e30 / -1 in the empty slots, as the
    reference; list ids past a smaller snapshot's capacity are masked."""
    emb, _jg, jq, _pg, _pq = built
    valid = np.zeros(ROWS, bool)
    valid[:3] = True
    ivf = ivf_data_from_numpy(tuple(np.asarray(a) for a in jq.data[:7]), device="cpu")
    q = emb[:8]
    wv, wi = (np.asarray(a) for a in jax_ivf.ivf_match_topk(
        jnp.asarray(q), jnp.asarray(valid), jq.data, k=5, nprobe=NLIST, interpret=True))
    gv, gi = port_ivf.ivf_match_topk(torch.tensor(q), torch.tensor(valid), ivf, k=5,
                                     nprobe=NLIST)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gv.numpy(), wv, atol=SIM_ATOL, rtol=0)
    assert (gi[:, 3:] == -1).all() and (gv[:, 3:] == -1e30).all()
    # a gallery snapshot of 1000 rows against lists that name rows up to 2047
    small = torch.ones(1000, dtype=torch.bool)
    _v, idx = port_ivf.ivf_match_topk(torch.tensor(emb[1500:1508]), small, ivf, k=3,
                                      nprobe=NLIST)
    assert int(idx.max()) < 1000


def test_ivf_tie_break_prefers_lowest_gallery_index():
    """Duplicate rows at other list positions resolve to the lowest gallery
    index, as the exact scan does, in both packages (the port on the JAX
    package's centroids)."""
    rng = np.random.default_rng(3)
    base = _unit(rng.normal(size=(8, 16)))
    emb = np.tile(base, (16, 1))  # 128 rows, each base row 16 times
    jg, jq = _jax_gallery(emb, nlist=8, nprobe=8, seed=1)
    pg, pq = _port_gallery(emb, nlist=8, nprobe=8, seed=1, build=False)
    payload = jg.snapshot_quantizer()
    assert pq.install_from_arrays(payload["centroids"], payload["assign"])
    oracle = np.argsort(-(base @ emb.T), axis=1, kind="stable")[:, :4]
    _l, _s, ji = (np.asarray(v) for v in jg.match(base, k=4))
    _l, _s, pi = pg.match(base, k=4)
    np.testing.assert_array_equal(ji, oracle)
    np.testing.assert_array_equal(pi.numpy(), oracle)


def test_gallery_match_after_install_equals_jax(built):
    emb, jg, _jq, pg, _pq = built
    rng = np.random.default_rng(4)
    q = _unit(emb[:16] + 0.05 * rng.normal(size=(16, DIM)))
    assert jg._ivf_enabled() and pg._ivf_enabled()
    before = port_ivf.ivf_match_topk.calls
    jl, jv, ji = (np.asarray(v) for v in jg.match(q, k=3))
    pl, pv, pi = (v.numpy() for v in pg.match(q, k=3))
    assert port_ivf.ivf_match_topk.calls == before + 1
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(pv, jv, atol=SIM_ATOL, rtol=0)


def test_port_trained_sidecar_loads_in_jax():
    """The reverse direction: centroids the port trained, carried by a
    sidecar, give the JAX gallery the port's lists and answers."""
    rng = np.random.default_rng(5)
    emb = _unit(rng.normal(size=(1024, 16)))
    pg, pq = _port_gallery(emb, nlist=16, seed=2)
    jg, jq = _jax_gallery(emb, nlist=16, seed=2, build=False)
    _h, cent, assign = jax_quant.decode_sidecar(
        port_quant.encode_sidecar(pg.snapshot_quantizer(), wal_seq=1))
    assert jq.install_from_arrays(cent, assign)
    for field in IVF_FIELDS:
        np.testing.assert_array_equal(getattr(pq.data, field).numpy(),
                                      np.asarray(getattr(jq.data, field)), err_msg=field)
    q = _unit(emb[:8] + 0.05 * rng.normal(size=(8, 16)))
    _l, jv, ji = (np.asarray(v) for v in jg.match(q, k=2))
    _l, pv, pi = pg.match(q, k=2)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pv.numpy(), jv, atol=SIM_ATOL, rtol=0)


# ---- assignment and k-means ----

def test_assign_rows_matches_reference(built):
    """Ragged chunks past ASSIGN_CHUNK, in the same pad tiers: the same
    cells, except where two cells tie within f32 noise."""
    _emb, _jg, jq, _pg, pq = built
    rng = np.random.default_rng(6)
    rows = _unit(rng.normal(size=(port_quant.ASSIGN_CHUNK + 37, DIM)))
    cent = jq._h_centroids
    got = pq.assign_rows(rows, cent)
    want = jq.assign_rows(rows, cent)
    assert got.dtype == np.int32 and got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    s = rows[diff].astype(np.float64) @ cent.T.astype(np.float64)
    gaps = np.abs(s[np.arange(len(diff)), got[diff]] - s[np.arange(len(diff)), want[diff]])
    assert (gaps <= ASSIGN_TIE).all(), (diff, gaps)
    assert len(diff) <= 2
    assert port_quant.ASSIGN_CHUNK == jax_quant.ASSIGN_CHUNK
    for n in (1, 8, 9, 1000, 8192, 9000):
        assert pq._pad_tier(n) == jq._pad_tier(n)


def test_kmeans_matches_reference_given_its_init():
    rng = np.random.default_rng(7)
    rows = _unit(rng.normal(size=(ROWS, DIM)))
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3), ROWS))
    init = rows[perm[np.arange(NLIST) % ROWS]]
    want = jax_quant._kmeans(rows, NLIST, 5, 3)
    got = port_quant._kmeans(rows, NLIST, 5, 3, device="cpu", init=init)
    assert got.dtype == np.float32 and got.shape == (NLIST, DIM)
    np.testing.assert_allclose(got, want, atol=CENTROID_ATOL, rtol=0)
    # the port's own init (numpy): deterministic, unit-norm centroids
    a = port_quant._kmeans(rows, NLIST, 5, 3, device="cpu")
    b = port_quant._kmeans(rows, NLIST, 5, 3, device="cpu")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)


def test_default_nlist_and_comparators_match_reference():
    for rows in (1, 1000, 262_144, 1 << 20, 1 << 22, 10_000_000):
        assert (port_quant.CoarseQuantizer.default_nlist(rows)
                == jax_quant.CoarseQuantizer.default_nlist(rows))
    assert port_quant.CoarseQuantizer.default_nlist(1 << 20) == 4096
    va, vb = np.asarray([0.9, 0.8, 0.7]), np.asarray([0.9, 0.5, 0.7])
    ia, ib = np.asarray([1, 2, 3]), np.asarray([5, 9, 3])
    np.testing.assert_array_equal(port_ivf.tie_aware_mismatch(va, ia, vb, ib),
                                  jax_ivf.tie_aware_mismatch(va, ia, vb, ib))
    assert (port_ivf.tie_aware_agreement(va, ia, vb, ib)
            == jax_ivf.tie_aware_agreement(va, ia, vb, ib))
    assert ShardedGallery.IVF_MIN_CAPACITY == JaxGallery.IVF_MIN_CAPACITY


# ---- lifecycle (the port alone, mirroring tests/test_ivf.py) ----

def test_incremental_add_immediately_matchable():
    rng = np.random.default_rng(8)
    g, q = _port_gallery(_unit(rng.normal(size=(1024, 16))), nlist=16)
    new = _unit(rng.normal(size=(6, 16)))
    start = g.size
    g.add(new, np.arange(start, start + 6, dtype=np.int32))
    assert q.ready and q._assigned_rows == start + 6
    _l, _s, idx = g.match(new, k=1)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(start, start + 6))


def test_incremental_add_exceeding_assign_chunk_is_chunked():
    rng = np.random.default_rng(1)
    g, q = _port_gallery(_unit(rng.normal(size=(16384, 16))), nlist=8, seed=1)
    n = port_quant.ASSIGN_CHUNK + 64
    new = _unit(rng.normal(size=(n, 16)))
    start = g.size
    g.add(new, np.arange(start, start + n, dtype=np.int32))
    assert q.ready and q._assigned_rows == start + n
    _l, _s, idx = g.match(np.concatenate([new[:1], new[-1:]]), k=1)
    assert idx[:, 0].tolist() == [start, start + n - 1]


def test_reader_holding_an_older_snapshot_is_undisturbed():
    """Inserts copy the lists: a reader's older (GalleryData, IVFDeviceData)
    pair neither changes nor answers differently after an add."""
    rng = np.random.default_rng(9)
    g, q = _port_gallery(_unit(rng.normal(size=(512, 16))), nlist=8, capacity=1024)
    old_data, old_ivf = g.data, g._ivf_data(g.data)
    frozen = [t.clone() for t in old_ivf[:7]]
    probe = torch.tensor(_unit(rng.normal(size=(4, 16))))
    before = port_ivf.ivf_match_topk(probe, old_data.valid, old_ivf, k=3)
    g.add(probe.numpy(), np.arange(4, dtype=np.int32))  # the probes become rows 512..515
    assert g.capacity == 1024 and q.data is not old_ivf
    for a, b in zip(old_ivf[:7], frozen):
        assert torch.equal(a, b)
    after = port_ivf.ivf_match_topk(probe, old_data.valid, old_ivf, k=3)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    _l, _s, idx = g.match(probe, k=1)
    assert idx[:, 0].tolist() == [512, 513, 514, 515]


def test_auto_mode_threshold_selects_path():
    rng = np.random.default_rng(0)
    g, q = _port_gallery(_unit(rng.normal(size=(ROWS, DIM))), mode="auto")
    assert g.capacity < g.IVF_MIN_CAPACITY
    assert q.ready and not g._ivf_enabled() and g._ivf_data(g.data) is None
    g.IVF_MIN_CAPACITY = g.capacity
    assert g._ivf_enabled() and g._ivf_data(g.data) is not None
    assert g.match_fn(1, use_ivf=True).__code__.co_argcount == 5
    assert g.match_fn(1, use_ivf=False).__code__.co_argcount == 4
    g.match_mode = "exact"
    assert not g._ivf_enabled()
    with pytest.raises(ValueError):
        g.attach_quantizer(q, mode="sometimes")


def test_reset_invalidates_and_fences_the_epoch():
    rng = np.random.default_rng(2)
    metrics = mn.Metrics()
    g, q = _port_gallery(_unit(rng.normal(size=(256, 16))), nlist=8, metrics=metrics)
    summary = metrics.summary()
    assert summary[mn.IVF_BUILDS] == 1 and summary[mn.IVF_SPILL_ROWS] == q.spill_count
    old = g.data
    g.reset()
    assert not q.ready and metrics.counter(mn.IVF_INVALIDATIONS) == 1
    assert g.data.epoch == old.epoch + 1
    emb = _unit(rng.normal(size=(256, 16)))
    g.add(emb, np.arange(256, dtype=np.int32))  # a build starts in the background
    assert q.rebuild_now(skip_if_ready=True)
    assert q.data.gallery_epoch == g.data.epoch
    assert g._ivf_data(old) is None and g._ivf_data(g.data) is not None
    _l, _s, idx = g.match(emb[:8], k=1)
    assert idx[:, 0].tolist() == list(range(8))


def test_spill_overflow_invalidates_never_drops():
    metrics = mn.Metrics()
    rng = np.random.default_rng(3)
    g, q = _port_gallery(_unit(rng.normal(size=(256, 16))), nlist=8, metrics=metrics,
                         capacity=512)
    q._spill_count = q.data.spill_cap  # spill exhausted ...
    full = int(np.argmax(q._h_counts))
    q._h_counts[full] = q.data.max_cell  # ... and the row's cell full
    row = _unit(q._h_centroids[full][None, :])
    start = g.size
    g.add(row, np.asarray([start], np.int32))
    assert metrics.counter(mn.IVF_INVALIDATIONS) == 1
    _l, _s, idx = g.match(np.tile(row, (8, 1)), k=1)
    assert idx[0, 0] == start  # the row is found, exact or rebuilt


def test_failed_retrain_leaves_serving_intact(monkeypatch):
    metrics = mn.Metrics()
    rng = np.random.default_rng(4)
    emb = _unit(rng.normal(size=(512, 16)))
    g, q = _port_gallery(emb, nlist=8, metrics=metrics)
    v_before = q.version
    monkeypatch.setattr(port_quant, "_kmeans",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("injected")))
    assert q.rebuild_now() is False
    assert metrics.counter(mn.IVF_BUILD_FAILURES) == 1
    assert q.ready and q.version == v_before and not q._train_lock.locked()
    _l, _s, idx = g.match(emb[:8], k=1)
    assert idx[:, 0].tolist() == list(range(8))
    monkeypatch.undo()
    assert q.rebuild_now() and q.version == v_before + 1


def test_failed_retrain_before_first_build_serves_exact(monkeypatch):
    rng = np.random.default_rng(5)
    emb = _unit(rng.normal(size=(256, 16)))
    g, q = _port_gallery(emb, nlist=8, build=False)
    monkeypatch.setattr(port_quant, "_kmeans",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    before = port_ivf.ivf_match_topk.calls
    assert q.rebuild_now() is False and not q.ready
    _l, _s, idx = g.match(emb[:8], k=1)
    assert idx[:, 0].tolist() == list(range(8))
    assert port_ivf.ivf_match_topk.calls == before  # the exact path served


def test_fenced_rebuild_refires_async(monkeypatch):
    """A reset landing mid-build drops that build and fires one fresh
    build against the new epoch."""
    rng = np.random.default_rng(6)
    g, q = _port_gallery(_unit(rng.normal(size=(256, 16))), nlist=8, build=False)
    real = port_quant._kmeans
    fenced = []

    def fence_once(*a, **k):
        out = real(*a, **k)
        if not fenced:
            fenced.append(True)
            g.run_locked(lambda: setattr(g, "_epoch", g._epoch + 1))
        return out

    monkeypatch.setattr(port_quant, "_kmeans", fence_once)
    assert q.rebuild_now() is False
    deadline = time.monotonic() + 30
    while not q.ready and time.monotonic() < deadline:
        time.sleep(0.02)
    assert q.ready and q.data.gallery_epoch == g._epoch


def test_single_flight_retrain_guard():
    rng = np.random.default_rng(7)
    g, q = _port_gallery(_unit(rng.normal(size=(256, 16))), nlist=8, metrics=mn.Metrics())
    assert q._train_lock.acquire(blocking=False)
    try:
        assert q.rebuild_now(wait=False) is False
        assert q.maybe_rebuild_async() is False
        assert q.metrics.counter(mn.IVF_RETRAINS_SKIPPED_INFLIGHT) == 2
    finally:
        q._train_lock.release()


def test_rebuild_is_bit_identical():
    """Same rows and seed: the same centroids, assignment and lists."""
    rng = np.random.default_rng(9)
    emb = _unit(rng.normal(size=(1024, 16)))
    _g1, q1 = _port_gallery(emb, nlist=16, seed=9)
    _g2, q2 = _port_gallery(emb, nlist=16, seed=9)
    np.testing.assert_array_equal(q1._h_centroids, q2._h_centroids)
    np.testing.assert_array_equal(q1._h_assign, q2._h_assign)
    for field in IVF_FIELDS:
        assert torch.equal(getattr(q1.data, field), getattr(q2.data, field)), field
    assert set(q1.last_build_s) == {"kmeans", "assign", "pack", "upload"}


def test_concurrent_adds_and_matches_keep_every_row():
    """Enrolment threads add while a reader matches: every row is found
    through the two-stage path at the end (a lost insert would miss)."""
    rng = np.random.default_rng(11)
    g, q = _port_gallery(_unit(rng.normal(size=(512, 16))), nlist=8, capacity=2048)
    batches = [_unit(rng.normal(size=(8, 16))) for _ in range(24)]
    stop = threading.Event()

    def read():
        while not stop.is_set():
            g.match(batches[0], k=1)

    reader = threading.Thread(target=read)
    reader.start()
    try:
        writers = [threading.Thread(target=lambda b=b: g.add(b, np.zeros(8, np.int32)))
                   for b in batches]
        for w in writers:
            w.start()
        for w in writers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in writers)
    finally:
        stop.set()
        reader.join(timeout=30)
    assert not reader.is_alive() and q.ready and g.size == 512 + 24 * 8
    _l, sims, idx = g.match(np.concatenate(batches), k=1)
    assert (sims[:, 0] > 0.99).all() and len(set(idx[:, 0].tolist())) == 24 * 8


def test_ivf_smoke_recall_gate_on_cpu():
    """The reference's ``bench.py --ivf-smoke`` configuration through the
    port: tie-aware recall of the two-stage top-1 >= 0.99."""
    import chip_smoke

    out = chip_smoke.ivf_recall_gate("cpu")
    assert out["recall"] >= 0.99 and out["incremental_rows_found"], out
    assert out["two_stage_calls"] == 2 and out["stats"]["ready"]
