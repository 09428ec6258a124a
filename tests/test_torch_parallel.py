"""The port's device mesh and sharded gallery (``parallel/mesh.py``, the
mesh branch of ``parallel/gallery.py``) against the JAX package's on its
8 virtual CPU devices: the port's meshes are 8 CPU slots, so every
sharded path (per-shard top-k, the merge, dp query splits, the grow
machinery over a tp-aligned capacity) runs here. The reference's pod
matcher runs its Pallas kernel in interpret mode.

Tolerances: both sides round the operands to bf16 and accumulate in f32,
in other orders and blockings, so sims agree to ``SIM_ATOL``; labels and
indices are held exactly (the galleries below have no near-ties). Against
numpy brute force in f32 the sims carry the bf16 rounding (2e-2, the
reference test's own bound)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import gallery as jax_gallery
from opencv_facerecognizer_tpu.parallel import make_mesh as jax_make_mesh
from opencv_facerecognizer_tpu.parallel import mesh as jax_mesh
from opencv_facerecognizer_tpu_torch.parallel import ShardedGallery, make_mesh
from opencv_facerecognizer_tpu_torch.parallel import gallery as port_gallery
from opencv_facerecognizer_tpu_torch.parallel import mesh as port_mesh

SIM_ATOL = 1e-5
BRUTE_ATOL = 2e-2
CPU8 = ["cpu"] * 8
RNG = np.random.default_rng(17)


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _mesh(dp=None, tp=None):
    return make_mesh(dp=dp, tp=tp, devices=CPU8)


def _np(out):
    return tuple(np.asarray(v) for v in out)


def _same(got, want, atol=SIM_ATOL):
    """(labels, sims, idx) of the port and of the reference agree."""
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=atol)
    np.testing.assert_array_equal(got[2], want[2])


def _brute_force_topk(queries, gallery, labels, k):
    sims = _unit(queries) @ _unit(gallery).T
    idx = np.argsort(-sims, axis=1)[:, :k]
    return labels[idx], np.take_along_axis(sims, idx, axis=1)


# ---------- the mesh ----------

@pytest.mark.parametrize("kwargs", [{}, {"dp": 2}, {"tp": 2}, {"dp": 8, "tp": 1},
                                    {"dp": 2, "tp": 4}])
def test_make_mesh_factorizations_match_the_reference(kwargs):
    got = make_mesh(devices=CPU8, **kwargs)
    assert got.shape == jax_make_mesh(**kwargs).shape
    assert got.size == 8 and got.axis_names == ("dp", "tp")
    # slots are told apart by their position in the device list
    assert [s.id for s in got.devices.flat] == list(range(8))
    assert all(s.device == torch.device("cpu") and s.stream is None
               for s in got.devices.flat)


@pytest.mark.parametrize("kwargs", [{"dp": 3}, {"tp": 3}, {"dp": 2, "tp": 2}])
def test_make_mesh_errors_match_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(**kwargs)
    with pytest.raises(ValueError) as got:
        make_mesh(devices=CPU8, **kwargs)
    assert str(got.value) == str(want.value)


def test_make_mesh_defaults_to_the_cards_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    # the CPU is named explicitly, never a fallback
    assert make_mesh(devices=["cpu"]).shape == {"dp": 1, "tp": 1}


# ---------- the sharded match ----------

@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4), (8, 1)])
def test_sharded_match_equals_bruteforce_and_the_reference(dp, tp):
    rng = np.random.default_rng(dp * 10 + tp)
    gal_emb = rng.normal(size=(64, 16)).astype(np.float32)
    gal_labels = rng.integers(0, 10, size=64).astype(np.int32)
    queries = _unit(rng.normal(size=(8, 16)).astype(np.float32))
    g = ShardedGallery(64, 16, mesh=_mesh(dp, tp))
    g.add(gal_emb, gal_labels)
    ref = JaxGallery(capacity=64, dim=16, mesh=jax_make_mesh(dp=dp, tp=tp))
    ref.add(gal_emb, gal_labels)
    for k in (1, 3):
        labels, sims, _idx = _np(g.match(queries, k=k))
        want_labels, want_sims = _brute_force_topk(queries, gal_emb, gal_labels, k)
        np.testing.assert_allclose(sims, want_sims, atol=BRUTE_ATOL)
        clear = (want_sims[:, :1] - want_sims[:, -1:]) > 0.05 if k > 1 else np.ones((8, 1),
                                                                                      bool)
        np.testing.assert_array_equal(labels[:, 0][clear[:, 0]],
                                      want_labels[:, 0][clear[:, 0]])
        _same(g.match(queries, k=k), ref.match(queries, k=k))


def _pod_case(cap=128, n_valid=100, dim=16, seed=23):
    rng = np.random.default_rng(seed)
    emb = _unit(rng.normal(size=(cap, dim)).astype(np.float32))
    valid = np.ones(cap, bool)
    valid[n_valid:] = False
    labels = rng.integers(0, 20, size=cap).astype(np.int32)
    q = _unit(rng.normal(size=(8, dim)).astype(np.float32))
    return q, emb, valid, labels


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("k", [1, 3, 20])
def test_matchers_equal_the_reference_matchers(dp, tp, k):
    """``match_global`` against the reference's GSPMD matcher and
    ``match_pod`` against ``match_pod_pallas`` (interpret mode), on the
    reference test's case and at k above a shard's rows (tp 8: 16)."""
    q, emb, valid, labels = _pod_case()
    jmesh = jax_make_mesh(dp=dp, tp=tp)
    jargs = tuple(jnp.asarray(x) for x in (q, emb, valid, labels))
    targs = tuple(torch.as_tensor(x) for x in (q, emb, valid, labels))
    mesh = _mesh(dp, tp)
    with jmesh:
        pod_ref = jax_gallery.match_pod_pallas(*jargs, k=k, mesh=jmesh, interpret=True)
    _same(port_gallery.match_pod(*targs, k=k, mesh=mesh), pod_ref)
    _same(port_gallery.match_global(*targs, k=k, mesh=mesh),
          jax_gallery.match_global(*jargs, k=k, mesh=jmesh))


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
def test_pod_matcher_matches_global(dp, tp):
    """C.18: the two matchers a mesh gallery picks between compute the
    same function where no row is short of k (the reference's
    ``test_pod_pallas_matcher_matches_gspmd``)."""
    q, emb, valid, labels = _pod_case()
    args = tuple(torch.as_tensor(x) for x in (q, emb, valid, labels))
    _same(port_gallery.match_pod(*args, k=3, mesh=_mesh(dp, tp)),
          port_gallery.match_global(*args, k=3, mesh=_mesh(dp, tp)), atol=0.0)


def test_pod_matcher_sparse_shards():
    """Fewer valid rows than k on most shards: the sentinels stay -1 and
    never alias a neighbour shard's rows (the reference's case)."""
    rng = np.random.default_rng(5)
    cap = 64
    emb = np.zeros((cap, 8), np.float32)
    valid = np.zeros(cap, bool)
    labels = np.full(cap, -1, np.int32)
    emb[0] = _unit(rng.normal(size=8).astype(np.float32))
    valid[0] = True
    labels[0] = 7
    q = np.tile(emb[0], (8, 1))
    lab, sims, idx = _np(port_gallery.match_pod(
        *(torch.as_tensor(x) for x in (q, emb, valid, labels)), k=3, mesh=_mesh(1, 8)))
    assert (idx[:, 0] == 0).all() and (lab[:, 0] == 7).all()
    assert (idx[:, 1:] == -1).all(), idx
    assert (sims[:, 1:] < -1e29).all()
    jmesh = jax_make_mesh(dp=1, tp=8)
    with jmesh:
        want = jax_gallery.match_pod_pallas(*(jnp.asarray(x) for x in (q, emb, valid, labels)),
                                            k=3, mesh=jmesh, interpret=True)
    _same((lab, sims, idx), want)


def test_sentinel_slots_carry_pad_label():
    """Sentinel -1 indices surface the pad label even where rows 0 and
    capacity-1 hold real subjects (the rows a clamp or a wrap would alias),
    through ``match_pod`` and through a mesh gallery's own match."""
    rng = np.random.default_rng(5)
    cap = 64
    emb = np.zeros((cap, 8), np.float32)
    valid = np.zeros(cap, bool)
    labels = np.full(cap, -1, np.int32)
    for row, lab in ((0, 3), (cap - 1, 9)):
        emb[row] = _unit(rng.normal(size=8).astype(np.float32))
        valid[row] = True
        labels[row] = lab
    q = np.tile(emb[0], (8, 1))
    lab, _sims, idx = _np(port_gallery.match_pod(
        *(torch.as_tensor(x) for x in (q, emb, valid, labels)), k=4, mesh=_mesh(1, 8)))
    sentinel = idx == -1
    assert sentinel.any()
    assert (lab[sentinel] == -1).all(), lab
    assert set(lab[~sentinel].ravel()) <= {3, 9}
    g = ShardedGallery(cap, 8, mesh=_mesh(2, 4), use_kernel=True, labels_pad=-5)
    g.add(emb[valid], labels[valid])
    lab, _sims, idx = _np(g.match(q, k=4))
    assert (idx == -1).any() and (lab[idx == -1] == -5).all()


def test_gallery_partial_fill_and_masking():
    g = ShardedGallery(30, 8, mesh=_mesh(tp=8))  # rounds up to 32
    assert g.capacity == 32 == JaxGallery(30, 8, mesh=jax_make_mesh(tp=8)).capacity
    emb = RNG.normal(size=(5, 8)).astype(np.float32)
    labels = np.arange(5, dtype=np.int32)
    g.add(emb, labels)
    got_labels, _sims, idx = _np(g.match(_unit(emb), k=1))
    np.testing.assert_array_equal(got_labels[:, 0], labels)
    assert np.all(idx < 5)


def test_gallery_overflow_auto_grows_tp_aligned():
    g = ShardedGallery(8, 4, mesh=_mesh(tp=8))
    g.add(RNG.normal(size=(8, 4)).astype(np.float32), np.arange(8, dtype=np.int32))
    g.add(RNG.normal(size=(1, 4)).astype(np.float32), np.array([9], dtype=np.int32))
    assert (g.grow_count, g.size, g.capacity) == (1, 9, 16)
    # a tier that does not divide by tp rounds up, as the reference's
    g3 = ShardedGallery(6, 4, mesh=make_mesh(tp=4, devices=["cpu"] * 4))
    r3 = JaxGallery(6, 4, mesh=jax_make_mesh(tp=4, devices=jax.devices()[:4]))
    rows = RNG.normal(size=(11, 4)).astype(np.float32)
    for gal in (g3, r3):
        gal.add(rows, np.arange(11, dtype=np.int32))
    assert g3.capacity == r3.capacity == 16


def test_gallery_incremental_enrolment_writes_every_replica():
    """Within a tier an add writes the rows in place: each shard on the
    first slot's device is a view of the whole array, so every replica
    (dp rows) of the owning shard sees them; the labels follow."""
    g = ShardedGallery(16, 8, mesh=_mesh(dp=2, tp=4))
    ref = JaxGallery(16, 8, mesh=jax_make_mesh(dp=2, tp=4))
    e1 = RNG.normal(size=(4, 8)).astype(np.float32)
    e2 = RNG.normal(size=(4, 8)).astype(np.float32)
    emb_before = g.data.embeddings
    for gal in (g, ref):
        gal.add(e1, np.zeros(4, dtype=np.int32))
        gal.add(e2, np.ones(4, dtype=np.int32))
    assert g.size == 8 and g.data.embeddings is emb_before  # in place
    labels, _, _ = _np(g.match(_unit(e2)[:2], k=1))
    np.testing.assert_array_equal(labels[:, 0], [1, 1])
    shards = g.data.shards
    for r in range(2):
        for t in range(4):
            np.testing.assert_array_equal(shards.emb[r][t].float().numpy(),
                                          g.data.embeddings[4 * t:4 * t + 4].numpy())
            np.testing.assert_array_equal(shards.valid[r][t].numpy(),
                                          np.asarray(ref.valid)[4 * t:4 * t + 4])
        np.testing.assert_array_equal(shards.labels[r].numpy(), np.asarray(ref.labels))
    _same(g.match(_unit(e1), k=2), ref.match(_unit(e1), k=2))


def test_double_buffered_swap():
    live = ShardedGallery(8, 4, mesh=_mesh(tp=8))
    live.add(_unit(RNG.normal(size=(4, 4)).astype(np.float32)), np.zeros(4, np.int32))
    staged = ShardedGallery(8, 4, mesh=_mesh(tp=8))
    new_emb = _unit(RNG.normal(size=(6, 4)).astype(np.float32))
    staged.add(new_emb, np.full(6, 7, np.int32))
    live.swap_from(staged)
    assert live.size == 6
    labels, _, _ = _np(live.match(new_emb[:1].repeat(8, 0), k=1))
    assert (labels[:, 0] == 7).all()
    # a donor on another layout is placed again on this gallery's mesh
    other = ShardedGallery(8, 4, mesh=_mesh(dp=2, tp=4))
    other.add(new_emb, np.full(6, 5, np.int32))
    live.swap_from(other)
    assert live.data.shards.chunk == 1 and len(live.data.shards.emb[0]) == 8
    labels, _, _ = _np(live.match(new_emb[:1].repeat(8, 0), k=1))
    assert (labels[:, 0] == 5).all()


def test_query_count_must_divide_dp():
    g = ShardedGallery(8, 4, mesh=_mesh(dp=4, tp=2))
    g.add(RNG.normal(size=(4, 4)).astype(np.float32), np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError, match="divisible"):
        g.match(np.zeros((3, 4), dtype=np.float32), k=1)
    with pytest.raises(ValueError, match="divisible"):
        port_gallery.match_pod(torch.zeros(3, 4), g.data.embeddings, g.data.valid,
                               g.data.labels, k=1, mesh=g.mesh)


def test_snapshot_roundtrip_and_load_snapshot_on_a_mesh():
    """``snapshot`` / ``load_snapshot`` (the restore path) on a mesh, into
    a bf16 gallery of another layout, equal to the reference's match."""
    trainer = ShardedGallery(16, 8, mesh=_mesh(tp=4 * 2))
    emb = _unit(RNG.normal(size=(6, 8)).astype(np.float32))
    trainer.add(emb, np.arange(6, dtype=np.int32))
    snap = trainer.snapshot()
    serving = ShardedGallery(16, 8, mesh=_mesh(dp=2, tp=4), store_dtype=torch.bfloat16)
    serving.load_snapshot(*snap)
    ref = JaxGallery(16, 8, mesh=jax_make_mesh(dp=2, tp=4), store_dtype=jnp.bfloat16)
    ref.load_snapshot(*snap)
    assert serving.size == 6 and serving.data.embeddings.dtype == torch.bfloat16
    assert serving.data.shards.emb[1][3].dtype == torch.bfloat16
    q = np.concatenate([emb, emb[:2]])
    _same(serving.match(q, k=2), ref.match(q, k=2))


# ---------- the grow machinery on a mesh ----------

def test_gallery_async_grow_tp4_lands_rows_off_the_adding_thread():
    g = ShardedGallery(16, 8, mesh=_mesh(dp=2, tp=4), async_grow=True)
    warmed, threads = [], []

    def hook(capacity, data):
        warmed.append(capacity)
        threads.append(threading.current_thread().name)
        # the warm snapshot is placed on the mesh like a served one
        assert data.capacity == capacity and data.shards.chunk == capacity // 4

    g.prewarm_hooks.append(hook)
    e = RNG.normal(size=(16, 8)).astype(np.float32)
    g.add(e, np.arange(16, dtype=np.int32))
    assert g.size == 16 and g.pending_rows == 0
    e2 = RNG.normal(size=(8, 8)).astype(np.float32)
    g.add(e2, np.arange(16, 24, dtype=np.int32))  # overflows -> staged
    assert g.wait_ready(timeout=30)
    assert (g.pending_rows, g.size, g.capacity, g.grow_count) == (0, 24, 32, 1)
    assert warmed == [32] and threads[0] != threading.main_thread().name
    labels, _, _ = _np(g.match(_unit(e2), k=1))
    np.testing.assert_array_equal(labels[:, 0], np.arange(16, 24))
    assert g.data.shards.chunk == 8


def test_gallery_async_grow_tp2_absorbs_adds_and_matches_the_reference():
    g = ShardedGallery(8, 4, mesh=_mesh(dp=4, tp=2), async_grow=True)
    ref = JaxGallery(8, 4, mesh=jax_make_mesh(dp=4, tp=2), async_grow=True)
    slow = threading.Event()
    g.prewarm_hooks.append(lambda capacity, data: slow.wait(5))
    ref.prewarm_hooks.append(lambda capacity: slow.wait(5))
    batches = [(RNG.normal(size=(n, 4)).astype(np.float32), np.arange(lo, lo + n,
                                                                     dtype=np.int32))
               for lo, n in ((0, 8), (8, 4), (12, 4))]
    for gal in (g, ref):
        for rows, labels in batches:
            gal.add(rows, labels)
    assert g.pending_rows == ref.pending_rows == 8
    slow.set()
    assert g.wait_ready(timeout=30) and ref.wait_ready(timeout=30)
    assert g.size == ref.size == 16 and g.capacity == ref.capacity
    np.testing.assert_array_equal(np.asarray(g.labels)[:16], np.arange(16))
    q = _unit(np.concatenate([b[0] for b in batches]))
    _same(g.match(q, k=3), ref.match(q, k=3))


def test_gallery_reset_cancels_inflight_grow_on_a_mesh():
    g = ShardedGallery(8, 4, mesh=_mesh(dp=4, tp=2), async_grow=True)
    hold = threading.Event()
    g.prewarm_hooks.append(lambda capacity, data: hold.wait(5))
    g.add(RNG.normal(size=(8, 4)).astype(np.float32), np.arange(8, dtype=np.int32))
    g.add(RNG.normal(size=(4, 4)).astype(np.float32), np.arange(8, 12, dtype=np.int32))
    g.reset()
    hold.set()
    assert g.wait_ready(timeout=30)
    assert g.size == 0 and g.pending_rows == 0
    assert not np.asarray(g.data.shards.valid[3][1]).any()


def test_gallery_evict_hooks_run_after_a_mesh_grow():
    g = ShardedGallery(8, 4, mesh=_mesh(dp=2, tp=4))
    evicted = []
    g.evict_hooks.append(evicted.append)
    g.add(RNG.normal(size=(12, 4)).astype(np.float32), np.arange(12, dtype=np.int32))
    assert g.capacity == 16 and evicted == [8]


# ---------- C.18: the matcher a mesh gallery picks ----------

def test_mesh_gallery_picks_the_pod_matcher_on_cards_from_kernel_capacity():
    """C.18 (an accepted divergence): on a mesh whose slots are all cards
    and whose shards hold at least ``KERNEL_MIN_CAPACITY`` rows the port
    serves ``match_pod`` (kernel A per shard), where the reference keeps
    its GSPMD ``match_global`` on every mesh of more than one device. CPU
    slots (and smaller shards) take ``match_global``; ``use_kernel``
    forces either."""
    g = ShardedGallery(64, 8, mesh=_mesh(dp=2, tp=4))
    assert not g.kernel_enabled() and g.match_fn(1).__name__ == "sharded"
    ref = JaxGallery(1 << 20, 8, mesh=jax_make_mesh(dp=2, tp=4))
    assert not ref._pallas_enabled()  # the reference: never on a mesh
    # the same gallery's selection with slots that name cards (no card is
    # touched: the selection reads the mesh only)
    slots = np.empty(8, dtype=object)
    for i in range(8):
        slots[i] = port_mesh.Slot(i, torch.device("cuda", 0), None)
    g.mesh = port_mesh.Mesh(slots.reshape(2, 4))
    kmc = ShardedGallery.KERNEL_MIN_CAPACITY
    assert g.kernel_enabled(4 * kmc) and g.match_fn(1, 4 * kmc).__name__ == "pod"
    assert not g.kernel_enabled(4 * kmc - 4)
    assert g.match_fn(1, 4 * kmc - 4).__name__ == "sharded"
    forced = ShardedGallery(64, 8, mesh=_mesh(dp=2, tp=4), use_kernel=True)
    assert forced.match_fn(1).__name__ == "pod"
    # IVF stays single-device, as the reference's
    assert not forced._ivf_wanted()


# ---------- C.17: the gallery's whole-array members ----------

@pytest.mark.parametrize("layout", [None, (2, 4)])
def test_embeddings_labels_valid_equal_the_reference(layout):
    """C.17: ``embeddings``, ``labels`` and ``valid`` read one attribute
    of the snapshot: the whole arrays (on a mesh, on its first slot), as
    the reference's sharded arrays read whole."""
    emb = RNG.normal(size=(10, 8)).astype(np.float32)
    labels = np.arange(10, dtype=np.int32) * 3
    if layout is None:
        g = ShardedGallery(16, 8, device="cpu")
        ref = JaxGallery(16, 8, mesh=jax_make_mesh(devices=jax.devices()[:1]))
    else:
        g = ShardedGallery(16, 8, mesh=_mesh(*layout))
        ref = JaxGallery(16, 8, mesh=jax_make_mesh(*layout))
    for gal in (g, ref):
        gal.add(emb, labels)
    assert g.embeddings is g.data.embeddings and g.valid is g.data.valid
    assert g.labels.device == g.mesh.first.device
    np.testing.assert_allclose(g.embeddings.numpy(), np.asarray(ref.embeddings), atol=1e-7)
    np.testing.assert_array_equal(g.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(ref.valid))


# ---------- multi-host bootstrap ----------

def test_initialize_multihost_single_process_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert port_mesh.initialize_multihost() is False
    assert jax_mesh.initialize_multihost() is False
    assert make_mesh(devices=CPU8).size == 8


def test_initialize_multihost_env_and_args_like_the_reference(monkeypatch):
    """The reference's contract, with ``torch.distributed.init_process_group``
    monkeypatched as the reference's test patches ``jax.distributed``."""
    calls, ref_calls = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: ref_calls.append(kw))
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert port_mesh.initialize_multihost() is jax_mesh.initialize_multihost() is True
    assert ref_calls[-1] == {"coordinator_address": "10.0.0.1:1234", "num_processes": 4,
                             "process_id": 2}
    assert calls[-1] == {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                         "world_size": 4, "rank": 2}
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var)
    assert port_mesh.initialize_multihost(num_processes=8, process_id=3) is True
    assert calls[-1] == {"backend": "gloo", "init_method": None, "world_size": 8, "rank": 3}
    # on a card the backend is nccl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_mesh.initialize_multihost("h:1", 2, 0) is True
    assert calls[-1]["backend"] == "nccl"
    # already initialized: no second call
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    n = len(calls)
    assert port_mesh.initialize_multihost() is True
    assert len(calls) == n
