"""The port's mesh across processes (``parallel/mesh.py`` after
``initialize_multihost``) on the CPU: two worker processes, started once
for the module with the ``spawn`` method, join a ``gloo`` group through
the port's own ``initialize_multihost("127.0.0.1:<port>", 2, rank)`` and
bring two CPU slots each, so every mesh has four slots, two a process
(``tests/torch_multiprocess_worker.py`` runs every case and saves its
tensors). The parent kills both workers and fails after
``DEADLINE_S``, or as soon as one exits with an error (``Workers``).

What the reference promises (``opencv_facerecognizer_tpu/parallel/mesh.py``:
after ``initialize_multihost`` the same graphs run on the global mesh) is
held two ways: every rank's result equals, bit for bit, the port's
single-process mesh of the same layout on ``["cpu"] * 4``; and it agrees
with the JAX package's function on four of its 8 virtual CPU devices
within ``test_torch_mesh_pipeline.py``'s tolerances (boxes within 1e-3 px,
sims within 2e-3, labels, indices and flags equal). The reference's pod
matcher runs its Pallas kernel in interpret mode. The sharded ArcFace
step (g) is held to the single-process mesh only here;
``test_torch_sharded_train.py`` holds that to the JAX package."""

import functools
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiprocess_worker as worker
from torch_multiprocess_worker import DEADLINE_S, Workers
from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import gallery as jax_gallery
from opencv_facerecognizer_tpu.parallel import make_mesh as jax_make_mesh
from opencv_facerecognizer_tpu.parallel import pipeline as jax_pipeline
from opencv_facerecognizer_tpu.parallel import pp as jax_pp
from opencv_facerecognizer_tpu_torch.parallel import (
    ShardedGallery, TwoStagePipeline, make_mesh, split_mesh)
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
from test_torch_pp import (  # noqa: F401 - fixtures and helpers of the pp twin
    DET, EMB, FACE, MAX_FACES, X_BOX_ATOL, X_SIM_ATOL, _assert_close, _jax_nets, _port_nets,
    stack)

CPU4 = ["cpu"] * 4
CAPACITY, DIM, GROW_CAPACITY = 64, 16, 32


def _gallery_data():
    rng = np.random.default_rng(29)
    dense = rng.normal(size=(40, DIM)).astype(np.float32)
    sparse = dense[:3]  # three valid rows, all in shard 0: fewer than k=5
    labels = rng.integers(0, 20, size=40).astype(np.int32)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    q[:4] = dense[[1, 5, 21, 2]]  # queries that find their rows
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return {"gallery/dense": (dense, labels), "gallery/sparse": (sparse, labels[:3]),
            "queries": q, "capacity": CAPACITY, "dim": DIM, "grow_capacity": GROW_CAPACITY}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The workers run torch on one thread; CPU convolutions may block
    their sums otherwise on more, so the references here do too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(stack, tmp_path_factory):
    root = tmp_path_factory.mktemp("multiprocess")
    with open(root / "stack.pkl", "wb") as f:
        pickle.dump(dict(stack=stack, DET=DET, EMB=EMB, FACE=FACE, MAX_FACES=MAX_FACES,
                         gallery=_gallery_data()), f)
    workers = Workers(root, worker.run, "all")
    yield workers
    workers.kill()


def _both(runs, key):
    return [out[key] for out in runs.wait()]


def _equal(got, want) -> None:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(w)), (g, w)


# ---------- (b) the sharded match ----------

def _port_gallery(mesh, fill, kind, data):
    g = ShardedGallery(CAPACITY, DIM, mesh=mesh, use_kernel=kind == "pod")
    g.add(*data[f"gallery/{fill}"])
    return g


POD_K = 5


@functools.lru_cache(maxsize=None)
def _jax_pod(dp, tp):
    """``match_pod_pallas`` (interpret mode) at k = ``POD_K``, jitted once
    per layout: the dense and the sparse gallery share its compile, and
    k = 1 is its first column (a stable top-k's first pick)."""
    jmesh = jax_make_mesh(dp, tp, devices=jax.devices()[:4])
    return jmesh, jax.jit(functools.partial(jax_gallery.match_pod_pallas, k=POD_K, mesh=jmesh,
                                            interpret=True, labels_pad=-1))


def _jax_match(fill, kind, k, dp, tp, data):
    jmesh, pod = _jax_pod(dp, tp)
    ref = JaxGallery(capacity=CAPACITY, dim=DIM, mesh=jmesh)
    ref.add(*data[f"gallery/{fill}"])
    if kind == "global":
        return ref.match(data["queries"], k=k)
    with jmesh:
        return tuple(x[:, :k] for x in pod(jnp.asarray(data["queries"]), ref.embeddings,
                                           ref.valid, ref.labels))


@pytest.mark.parametrize("k", [1, POD_K])
@pytest.mark.parametrize("fill", ["dense", "sparse"])
@pytest.mark.parametrize("kind", ["pod", "global"])
@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_gallery_match_across_processes(runs, dp, tp, kind, fill, k):
    """``gallery.match`` through ``match_pod`` (plain per shard on the CPU)
    and ``match_global``: every rank returns the single-process mesh's
    triple bit for bit (the sparse gallery's ``-1`` sentinels and pad
    labels included), and the reference's within the tolerances; each
    rank holds shard tensors only on its own slots, and no whole
    embeddings array."""
    data = _gallery_data()
    want = _port_gallery(make_mesh(dp, tp, devices=CPU4), fill, kind, data).match(
        data["queries"], k=k)
    ref = tuple(np.asarray(x) for x in _jax_match(fill, kind, k, dp, tp, data))
    for got in _both(runs, f"match/{dp}x{tp}/{kind}/{fill}/{k}"):
        _equal(got, want)
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        np.testing.assert_allclose(got[1].numpy(), ref[1], atol=X_SIM_ATOL)
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
    if fill == "sparse" and k == 5 and kind == "pod":
        assert (want[2] == -1).any() and (want[0][want[2] == -1] == -1).all()
    for rank, held in enumerate(_both(runs, f"held/{dp}x{tp}/{kind}/{fill}")):
        assert held == [[(r * tp + t) // 2 == rank for t in range(tp)] for r in range(dp)]
    assert _both(runs, f"meta/{dp}x{tp}/{kind}/{fill}") == ["meta", "meta"]


# ---------- (c) the serving step, (d) pp ----------

def _packed_close(got, want) -> None:
    _assert_close(jax_pipeline.unpack_result(got.numpy(), 2),
                  jax_pipeline.unpack_result(np.asarray(want), 2), X_BOX_ATOL, X_SIM_ATOL)


_JAX_PACKED = {}


def _jax_packed(stack, dp, tp):
    """The JAX package's packed step on the first batch, once per layout."""
    if (dp, tp) not in _JAX_PACKED:
        dparams, eparams, emb, labels, scenes = stack
        jdet, jnet = _jax_nets(dparams)
        jgal = JaxGallery(capacity=64, dim=32,
                          mesh=jax_make_mesh(dp, tp, devices=jax.devices()[:4]))
        jgal.add(emb, labels)
        jpipe = jax_pipeline.RecognitionPipeline(jdet, jnet, eparams, jgal, face_size=FACE,
                                                 top_k=2)
        _JAX_PACKED[dp, tp] = jpipe.recognize_batch_packed(scenes[:8])
    return _JAX_PACKED[dp, tp]


@pytest.mark.parametrize("form", ["eager", "levels"])
@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_recognize_batch_packed_across_processes(runs, stack, dp, tp, form):
    """Each process detects, aligns and embeds only its rows' frames;
    candidates cross processes by the row group's all-gather (tp rows)
    and the packed rows by the dp result gather: every rank returns the
    single-process mesh step bit for bit, in the eager form and in the
    level form (``_capture_levels`` with a replay that reruns each level,
    its collectives run between levels), on two batches; and the JAX
    package's ``RecognitionPipeline`` on four devices within the
    tolerances."""
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    gal = ShardedGallery(64, 32, mesh=make_mesh(dp, tp, devices=CPU4))
    gal.add(emb, labels)
    single = RecognitionPipeline(det, net, gal, face_size=FACE, top_k=2, device="cpu")
    want = [single.recognize_batch_packed(scenes[:8]).clone(),
            single.recognize_batch_packed(scenes[8:16]).clone()]
    ref = _jax_packed(stack, dp, tp)
    again = "levels_again" if form == "levels" else "eager_again"
    for out in runs.wait():
        _equal(out[f"pipe/{dp}x{tp}/{form}"], want[0])
        _equal(out[f"pipe/{dp}x{tp}/{again}"], want[1])
        _packed_close(out[f"pipe/{dp}x{tp}/{form}"], ref)


def test_two_stage_pipeline_across_processes(runs, stack):
    """``split_mesh`` of a (2, 2) mesh puts stage A on rank 0 and stage B
    (the gallery) on rank 1: the hop goes point to point and the packed
    batch comes back to both ranks, equal bit for bit to the
    single-process pp on ``["cpu"] * 4`` and within the tolerances of the
    reference's ``TwoStagePipeline``; a stream keeps order; rank 0's
    results land on its own slot."""
    dparams, eparams, emb, labels, scenes = stack
    det, net = _port_nets(dparams, eparams)
    mesh_a, mesh_b = split_mesh(make_mesh(2, 2, devices=CPU4))
    gal = ShardedGallery(64, 32, mesh=mesh_b)
    gal.add(emb, labels)
    single = TwoStagePipeline(det, net, None, gal, mesh_a, face_size=FACE, top_k=2)
    want = single.recognize_batch_packed(scenes[:8])
    stream = [single.recognize_batch(b).labels for b in (scenes[:8], scenes[8:16], scenes[:8])]
    jdet, jnet = _jax_nets(dparams)
    ja, jb = jax_pp.split_mesh(jax_make_mesh(2, 2, devices=jax.devices()[:4]))
    jgal = JaxGallery(capacity=64, dim=32, mesh=jb)
    jgal.add(emb, labels)
    jpp = jax_pp.TwoStagePipeline(jdet, jnet, eparams, jgal, ja, face_size=FACE, top_k=2)
    ref = jpp.recognize_batch_packed(scenes[:8])
    outs = runs.wait()
    for out in outs:
        _equal(out["pp/2x2"], want)
        _equal(out["pp/2x2/stream"], stream)
        _packed_close(out["pp/2x2"], ref)
        assert out["pp/device"] == "cpu"
    stats = outs[1]["stats"]
    assert stats["calls"]["hop"] == 4 and stats["calls"]["results"] == 4


# ---------- (a) the mesh ----------

@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2), (4, 1)])
def test_make_mesh_spans_every_process_rank_major(runs, dp, tp):
    """Four slots, two a rank, rank-major; each slot carries its rank and
    the layout is the same on both ranks; each rank holds its own slots
    and its first slot of each row it holds."""
    got = _both(runs, f"mesh/{dp}x{tp}")
    assert got[0]["layout"] == got[1]["layout"]
    for rank, m in enumerate(got):
        assert m["ids"] == [0, 1, 2, 3] and m["ranks"] == [0, 0, 1, 1]
        assert m["devices"] == ["cpu"] * 4
        assert m["local"] == [2 * rank, 2 * rank + 1] and m["home"] == 2 * rank
        rows = [[i for i in range(r * tp, (r + 1) * tp) if i // 2 == rank] for r in range(dp)]
        assert m["rows"] == [r[0] if r else None for r in rows]
    assert make_mesh(dp, tp, devices=CPU4).shape == jax_make_mesh(
        dp, tp, devices=jax.devices()[:4]).shape


def test_unequal_device_counts_are_refused(runs):
    got = _both(runs, "mesh/unequal")
    assert got[0] == got[1] == ("make_mesh: every process must bring the same device count, "
                                "got [1, 2] by rank")


def test_a_slot_of_the_other_process_is_refused(runs):
    """``on_slot`` runs nothing on another process's slot: a slot is local
    by its rank, never by its device (every slot here is ``cpu``)."""
    assert _both(runs, "mesh/on_other_slot") == [
        "on_slot: slot 2 belongs to process 1, not to this one (0)",
        "on_slot: slot 0 belongs to process 0, not to this one (1)"]


# ---------- (e) a synchronous grow, (f) C.30 ----------

@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2)])
def test_synchronous_grow_across_processes(runs, dp, tp):
    """An add past the tier grows it on every process at once: the host
    snapshots are equal on both ranks and to the single-process
    gallery's, and the match after the grow is the single-process one."""
    data = _gallery_data()
    g = ShardedGallery(GROW_CAPACITY, DIM, mesh=make_mesh(dp, tp, devices=CPU4))
    emb, lab = data["gallery/dense"]
    g.add(emb[:20], lab[:20])
    g.add(emb[20:], lab[20:])
    want = g.snapshot()
    for got in _both(runs, f"grow/{dp}x{tp}"):
        assert (got["before"], got["after"], got["grows"]) == (GROW_CAPACITY, 64, 1)
        for a, b in zip(got["snapshot"], want):
            np.testing.assert_array_equal(a, b)
        _equal(got["match"], g.match(data["queries"], k=5))


def test_async_grow_is_refused_across_processes(runs):
    """ROADMAP C.30: an asynchronous grow publishes at its own moment on
    each process, so a mesh across processes refuses it."""
    got = _both(runs, "async_grow")
    assert got[0] == got[1] and "ROADMAP C.30" in got[0] and "async_grow=True" in got[0]


# ---------- (g) the sharded ArcFace step ----------

@pytest.mark.parametrize("dp,tp", worker.TRAIN_LAYOUTS)
def test_sharded_arcface_step_across_processes(runs, dp, tp):
    """``parallel.train.ShardedArcFaceStep`` over two processes of two
    slots: at (2, 2) each dp row is one process's and the gradient sums
    over dp cross the processes (the column groups), at (1, 4) the
    softmax's statistics and the embeddings' gradient cross them (the row
    group). Each rank's losses, replicas, gradients, shards and gathered
    head equal the single-process mesh's bit for bit: each process sums
    its own two slots and the all-reduce adds the two halves, the tree
    the single process sums in."""
    want = worker.train_run((dp, tp), CPU4)
    crossing = ({"net_grad", "head_grad"} if dp == 2
                else {"ce_max", "ce_sum", "emb_grad"})
    for rank, got in enumerate(_both(runs, f"train/{dp}x{tp}")):
        _equal(got["losses"], want["losses"])
        assert sorted(got["slots"]) == [2 * rank, 2 * rank + 1]
        for i, mine in got["slots"].items():
            theirs = want["slots"][i]
            _equal(mine["params"] + mine["grads"], theirs["params"] + theirs["grads"])
            _equal([mine["shard"], mine["shard_grad"]], [theirs["shard"], theirs["shard_grad"]])
        _equal(got["head"], want["head"])
        calls = got["stats"]["calls"]
        assert set(calls) == crossing | {"head"}, calls
        per_step = 2 if dp == 2 else 1  # one a dp column, or one a row
        assert all(calls[name] == per_step * worker.TRAIN_STEPS for name in crossing), calls


# ---------- no process waits forever ----------

def test_a_rank_that_dies_fails_the_run_without_a_hang(tmp_path):
    """Rank 1 raises after joining; rank 0 waits in ``make_mesh``'s
    exchange. The parent sees rank 1's exit code, kills rank 0 and fails,
    long before the deadline."""
    t0 = time.monotonic()
    workers = Workers(tmp_path, worker.run, "die")
    with pytest.raises(RuntimeError, match="rank 1 fails before its first collective"):
        workers.wait()
    assert time.monotonic() - t0 < DEADLINE_S / 2
    assert not any(p.is_alive() for p in workers.procs)


def test_candidates_gather_keeps_shard_order_when_shares_differ():
    """A dp row whose processes hold unequal shares of its shards (three
    processes of four slots at (2, 6): row 0 is four shards of rank 0 and
    two of rank 1) pads the smaller share to the widest for the
    all-gather and drops the padding after it: every process merges the
    row's six shards' candidates in shard order. Run in one process with
    a stand-in group that hands each member every contribution."""
    from opencv_facerecognizer_tpu_torch.parallel.gallery import _gather_candidates
    from opencv_facerecognizer_tpu_torch.parallel.mesh import Mesh, Slot

    rng = np.random.default_rng(3)
    lk, q = 2, 5
    shards = [(torch.from_numpy(rng.normal(size=(q, lk)).astype(np.float32)),
               torch.from_numpy(rng.integers(-1, 100, (q, lk)).astype(np.int32)))
              for _ in range(6)]
    sent = {}

    class Group:
        def __init__(self, rank):
            self.rank, self.row_groups = rank, {(0, 1): None}

        def all_gather(self, t, group, name):
            sent[self.rank] = t
            return torch.stack([sent.get(0, t), sent.get(1, t)])

    def mesh_of(rank):
        slots = np.empty(12, dtype=object)
        for i in range(12):
            slots[i] = Slot(i, torch.device("cpu"), None, i // 4)
        return Mesh(slots.reshape(2, 6), Group(rank))

    mine = {0: shards[:4], 1: shards[4:]}
    _gather_candidates(mesh_of(1), 0, mine[1], lk)  # rank 1's share goes first
    got = _gather_candidates(mesh_of(0), 0, mine[0], lk)
    assert sent[0].shape == sent[1].shape == (q, 2 * 4 * lk)
    for want, have in zip((torch.cat([v for v, _ in shards], 1),
                           torch.cat([i for _, i in shards], 1)),
                          (torch.cat([v for v, _ in got], 1), torch.cat([i for _, i in got], 1))):
        assert torch.equal(have, want)
