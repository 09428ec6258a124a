"""The port's embedder rollout (``runtime.rollout`` and the cutover of
``runtime.state_store``) against the JAX package's.

Every case of the reference's ``tests/test_rollout.py`` that needs no
read replica, router, offline verifier or fine-tune runs on both packages,
and the outcomes are compared: the stage files' records, the galleries'
host mirrors, names, recovery reports, counters, parity agreement and the
rollback. Cross-package cases: a stage written by either package is read
(and resumed) by the other, and a dir left by a crash after the cutover's
fence in either package recovers in the other to the gallery of the
writer's own recovery. One more case drives cutovers against a stream of
dispatches (ROADMAP C.12): the reference can stamp a batch matched on the
old rows with the new version; the port stamps from the snapshot it
matched. Tolerance: exact (bytes, labels, records), except the re-embedded
rows against the plain rotation (1e-5, float rounding of two matmul
orders).
"""

import json
import os
import shutil
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import EmbeddingDimMismatchError as JaxDimError
from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import fakes as jax_fakes
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import recognizer as jax_rec
from opencv_facerecognizer_tpu.runtime import rollout as jax_rollout
from opencv_facerecognizer_tpu.runtime import slo as jax_slo
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.runtime.connector import FakeConnector as JaxConnector
from opencv_facerecognizer_tpu.runtime.connector import encode_frame as jax_encode_frame
from opencv_facerecognizer_tpu.utils import metric_names as jax_names
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.parallel.gallery import EmbeddingDimMismatchError
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.runtime import fakes as port_fakes
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_rec
from opencv_facerecognizer_tpu_torch.runtime import rollout as port_rollout
from opencv_facerecognizer_tpu_torch.runtime import slo as port_slo
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector as PortConnector
from opencv_facerecognizer_tpu_torch.runtime.connector import encode_frame as port_encode_frame
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

DIM = 8
PACKAGES = ("jax", "port")


def _jax_gallery(capacity=64, dim=DIM, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    return JaxGallery(capacity=capacity, dim=dim, mesh=mesh, **kw)


def _port_gallery(capacity=64, dim=DIM, **kw):
    return PortGallery(capacity, dim, device="cpu", **kw)


PKG = {
    "jax": types.SimpleNamespace(rollout=jax_rollout, state=jax_state, faults=jax_faults,
                                 gallery=_jax_gallery, Metrics=JaxMetrics, rec=jax_rec,
                                 fakes=jax_fakes, Conn=JaxConnector, encode=jax_encode_frame,
                                 slo=jax_slo, DimError=JaxDimError),
    "port": types.SimpleNamespace(rollout=port_rollout, state=port_state, faults=port_faults,
                                  gallery=_port_gallery, Metrics=mn.Metrics, rec=port_rec,
                                  fakes=port_fakes, Conn=PortConnector, encode=port_encode_frame,
                                  slo=port_slo, DimError=EmbeddingDimMismatchError),
}
BOTH = pytest.mark.parametrize("pkg", PACKAGES)


@pytest.fixture(scope="module")
def rotation():
    rng = np.random.default_rng(42)
    q, _ = np.linalg.qr(rng.normal(size=(DIM, DIM)))
    return q.astype(np.float32)


def _writer(pkg, root, **kw):
    p = PKG[pkg]
    gallery = p.gallery()
    names = []
    state = p.state.StateLifecycle(str(root), metrics=kw.pop("metrics", p.Metrics()),
                                   checkpoint_wal_rows=1 << 30, checkpoint_every_s=1e9, **kw)
    state.bind(gallery, names)
    return state, gallery, names


def _enroll(state, gallery, names, rng, i, n=1):
    emb = rng.normal(size=(n, DIM)).astype(np.float32)
    labels = np.full(n, i, np.int32)
    names.append(f"s{i}")
    state.append_enrollment(emb, labels, subject=f"s{i}", label=i,
                            apply_fn=lambda e=emb, l=labels: gallery.add(e, l))
    return emb


def _norm(rows):
    return rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True), 1e-12)


def _expected_new(embs, rotation):
    return _norm(_norm(np.concatenate(embs)) @ rotation)


def _coordinator(pkg, state, gallery, rotation, to_version=2, **kw):
    kw.setdefault("chunk_rows", 3)
    kw.setdefault("metrics", PKG[pkg].Metrics())
    return PKG[pkg].rollout.RolloutCoordinator(state, gallery, lambda rows: rows @ rotation,
                                               to_version, **kw)


def _mirrors(gallery):
    emb, lab, val, size = gallery.snapshot()
    return [np.asarray(emb), np.asarray(lab), np.asarray(val), int(size),
            int(gallery.capacity), int(gallery.embedder_version)]


def _assert_mirrors_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _stage_records(path):
    """The stage file's whole records (a sealed torn remnant skipped, as the
    reader skips it) without their wall-clock stamps."""
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            rec.pop("ts", None)
            out.append(rec)
    return out


# ---------- staged re-embed: durability and resume ----------


def _torn_stage(pkg, root):
    p = PKG[pkg]
    injector = p.faults.FaultInjector(seed=0)
    stage = p.rollout.ReEmbedStage(str(root), 2, dim=DIM, metrics=p.Metrics(),
                                   fault_injector=injector)
    rng = np.random.default_rng(0)
    stage.stage_chunk(0, rng.normal(size=(3, DIM)).astype(np.float32),
                      np.arange(3, dtype=np.int32))
    stage.stage_chunk(3, rng.normal(size=(2, DIM)).astype(np.float32),
                      np.arange(2, dtype=np.int32))
    out = [stage.watermark]
    injector.script("stage", "torn")
    with pytest.raises(p.faults.InjectedCrashError):
        stage.stage_chunk(5, rng.normal(size=(2, DIM)).astype(np.float32),
                          np.arange(2, dtype=np.int32))
    metrics = p.Metrics()
    resumed = p.rollout.ReEmbedStage(str(root), 2, dim=DIM, metrics=metrics)
    emb, labels = resumed.arrays()
    out += [resumed.resumed, resumed.watermark, emb, labels]
    resumed.stage_chunk(5, np.ones((1, DIM), np.float32), np.zeros(1, np.int32))
    out += [resumed.watermark, metrics.counters(), _stage_records(resumed.path)]
    return out


def test_stage_resume_after_torn_append(tmp_path):
    got = {pkg: _torn_stage(pkg, tmp_path / pkg) for pkg in PACKAGES}
    port, ref = got["port"], got["jax"]
    assert port[:3] == ref[:3] == [5, True, 5]
    np.testing.assert_array_equal(port[3], ref[3])
    np.testing.assert_array_equal(port[4], ref[4])
    assert port[5:] == ref[5:]
    assert port[5] == 6 and port[6][mn.ROLLOUT_STAGE_RESUMES] == 1


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_stage_written_by_one_package_is_read_by_the_other(tmp_path, writer, reader):
    """A stage (header, chunks, a torn tail) written by ``writer`` loads in
    ``reader`` (``load_stage``) to the same arrays, and ``reader`` resumes
    it at the same watermark and appends the same record."""
    w, r = PKG[writer], PKG[reader]
    rng = np.random.default_rng(5)
    injector = w.faults.FaultInjector()
    stage = w.rollout.ReEmbedStage(str(tmp_path), 3, dim=DIM, from_version=2,
                                   fault_injector=injector)
    chunks = [rng.normal(size=(n, DIM)).astype(np.float32) for n in (4, 4, 2)]
    start = 0
    for rows in chunks:
        stage.stage_chunk(start, rows, np.arange(start, start + len(rows), dtype=np.int32))
        start += len(rows)
    injector.script("stage", "torn")
    with pytest.raises(w.faults.InjectedCrashError):
        stage.stage_chunk(start, chunks[0], np.zeros(4, np.int32))
    emb_r, lab_r = r.rollout.load_stage(str(tmp_path), 3, expect_rows=10, expect_dim=DIM)
    emb_w, lab_w = w.rollout.load_stage(str(tmp_path), 3, expect_rows=10, expect_dim=DIM)
    np.testing.assert_array_equal(emb_r, np.concatenate(chunks))
    np.testing.assert_array_equal(emb_r, emb_w)
    np.testing.assert_array_equal(lab_r, lab_w)
    resumed = r.rollout.ReEmbedStage(str(tmp_path), 3, dim=DIM, from_version=2)
    assert resumed.resumed and resumed.watermark == 10
    resumed.stage_chunk(10, chunks[2], np.array([7, 8], np.int32))
    records = _stage_records(resumed.path)
    assert records[0] == {"kind": "stage_begin", "to_version": 3, "from_version": 2, "dim": DIM}
    assert [rec["start"] for rec in records[1:]] == [0, 4, 8, 10]
    assert w.rollout.load_stage(str(tmp_path), 3)[0].shape == (12, DIM)


def _load_stage_gaps(pkg, root):
    p = PKG[pkg]
    stage = p.rollout.ReEmbedStage(str(root), 2, dim=DIM)
    stage.stage_chunk(0, np.ones((2, DIM), np.float32), np.zeros(2, np.int32))
    with pytest.raises(p.rollout.RolloutStateError):
        p.rollout.load_stage(str(root), 2, expect_rows=5, expect_dim=DIM)
    with pytest.raises(p.rollout.RolloutStateError):
        p.rollout.load_stage(str(root), 2, expect_rows=2, expect_dim=DIM + 1)
    emb, labels = p.rollout.load_stage(str(root), 2, expect_rows=2, expect_dim=DIM)
    with pytest.raises(p.rollout.RolloutStateError):
        p.rollout.load_stage(str(root / "nowhere"), 2, expect_rows=1, expect_dim=DIM)
    return emb, labels, p.rollout.stage_path("d", 7)


def test_load_stage_fails_closed_on_gaps(tmp_path):
    got = {pkg: _load_stage_gaps(pkg, tmp_path / pkg) for pkg in PACKAGES}
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])
    assert got["port"][2] == got["jax"][2] == os.path.join("d", "rollout", "stage-v7.jsonl")


@pytest.mark.parametrize("chunks", [[(0, 3), (3, 2)], [(0, 3), (2, 4), (6, 1)], [(0, 2), (5, 2)]])
def test_stage_parts_tile_the_watermark_without_a_copy(tmp_path, chunks):
    """The port's ``parts`` (what parity scores against) are views of the
    staged chunks that tile ``[0, watermark)`` once, equal bit for bit to
    the reference's assembled ``arrays()``: after a re-staged overlap and
    before a gap too. Re-staged rows repeat their source bytes, as a
    deterministic re-embed gives them."""
    src = np.random.default_rng(3).normal(size=(8, DIM)).astype(np.float32)
    stages = {pkg: PKG[pkg].rollout.ReEmbedStage(str(tmp_path / pkg), 2, dim=DIM)
              for pkg in PACKAGES}
    for stage in stages.values():
        for start, n in chunks:
            stage.stage_chunk(start, src[start:start + n],
                              np.arange(start, start + n, dtype=np.int32))
    emb, lab = stages["jax"].arrays()
    parts = stages["port"].parts()
    assert stages["port"].watermark == stages["jax"].watermark == emb.shape[0]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), emb)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), lab)
    chunk_bufs = [c[0] for c in stages["port"]._chunks.values()]
    assert all(any(np.shares_memory(p[0], c) for c in chunk_bufs) for p in parts)


@pytest.mark.parametrize("splits", [[], [1], [4, 9], [2, 3, 11]])
def test_parity_top1_over_parts_equals_the_reference_over_the_whole(splits):
    """``_top1`` over row-ordered pieces picks the reference's label over
    the assembled gallery, its lowest-index tie-break across a piece
    boundary included (rows 3 and 10 are equal)."""
    rng = np.random.default_rng(5)
    rows = _norm(rng.normal(size=(12, DIM)).astype(np.float32))
    rows[10] = rows[3]
    labels = np.arange(12, dtype=np.int32) * 7
    queries = np.concatenate([rows[[3, 0, 11]], _norm(rng.normal(size=(5, DIM)))]).astype(
        np.float32)
    edges = [0, *splits, 12]
    parts = [(rows[a:b], labels[a:b]) for a, b in zip(edges, edges[1:])]
    want = jax_rollout.DualScoreParity._top1(queries, rows, labels)
    np.testing.assert_array_equal(port_rollout.DualScoreParity._top1(queries, parts), want)
    assert want[0] == 21
    np.testing.assert_array_equal(
        port_rollout.DualScoreParity._top1(queries, [(rows[:0], labels[:0])]),
        jax_rollout.DualScoreParity._top1(queries, rows[:0], labels[:0]))


def test_snapshot_rows_are_read_only_views_of_the_mirror():
    """The stage and parity read the port gallery's rows as views, taken
    under the write lock: equal to ``snapshot()``'s slice, not copied, and
    unchanged by a later append."""
    gallery = _port_gallery(capacity=16)
    rng = np.random.default_rng(8)
    gallery.add(rng.normal(size=(5, DIM)).astype(np.float32), np.arange(5, dtype=np.int32))
    emb, lab, size = gallery.snapshot_rows(2, 4)
    full_emb, full_lab, _val, full_size = gallery.snapshot()
    assert size == full_size == 5 and emb.shape == (2, DIM)
    np.testing.assert_array_equal(emb, full_emb[2:4])
    np.testing.assert_array_equal(lab, full_lab[2:4])
    assert np.shares_memory(emb, gallery._host_emb) and not emb.flags.writeable
    all_emb, all_lab, _ = gallery.snapshot_rows(0, None)
    before = all_emb.copy()
    gallery.add(rng.normal(size=(3, DIM)).astype(np.float32), np.arange(3, dtype=np.int32))
    np.testing.assert_array_equal(all_emb, before)
    assert all_emb.shape[0] == 5 and gallery.snapshot_rows(7, 20)[0].shape[0] == 1
    assert gallery.snapshot_rows(9, 12)[0].shape[0] == 0


# ---------- version fencing ----------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_swap_from_dim_mismatch_fails_closed(pkg):
    p = PKG[pkg]
    serving = p.gallery(capacity=16)
    donor = p.gallery(capacity=16, dim=DIM * 2)
    with pytest.raises(p.DimError, match="staged re-embed"):
        serving.swap_from(donor)
    with pytest.raises(ValueError):
        serving.swap_from(donor)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_swap_from_adopts_donor_version(pkg):
    p = PKG[pkg]
    serving = p.gallery(capacity=16)
    donor = p.gallery(capacity=16, embedder_version=3)
    donor.add(np.ones((2, DIM), np.float32), np.zeros(2, np.int32))
    serving.swap_from(donor)
    assert serving.embedder_version == 3
    if pkg == "port":
        assert serving.data.embedder_version == 3  # published with the rows (C.12)


def _version_fence(pkg, root):
    p = PKG[pkg]
    metrics = p.Metrics()
    state, gallery, _names = _writer(pkg, root, metrics=metrics)
    seq_before = state.wal_seq
    with pytest.raises(p.state.EmbedderVersionMismatchError):
        state.append_enrollment(np.ones((1, DIM), np.float32), np.zeros(1, np.int32),
                                embedder_version=9)
    out = [state.wal_seq == seq_before, metrics.counter(mn.ROLLOUT_VERSION_MISMATCHES),
           list(state.wal.enrollments())]
    state.append_enrollment(np.ones((1, DIM), np.float32), np.zeros(1, np.int32),
                            embedder_version=1,
                            apply_fn=lambda: gallery.add(np.ones((1, DIM), np.float32),
                                                         np.zeros(1, np.int32)))
    out.append([r["embedder_version"] for r in state.wal.enrollments()])
    state.close()
    return out


def test_append_enrollment_version_fence(tmp_path):
    got = {pkg: _version_fence(pkg, tmp_path / pkg) for pkg in PACKAGES}
    assert got["port"] == got["jax"] == [True, 1, [], [1]]


# ---------- cutover: the swap and recovery's completion ----------


def _cutover_and_recover(pkg, root, rotation):
    p = PKG[pkg]
    rng = np.random.default_rng(1)
    state, gallery, names = _writer(pkg, root)
    embs = [_enroll(state, gallery, names, rng, i, n=2) for i in range(4)]
    co = _coordinator(pkg, state, gallery, rotation)
    co.run_stage()
    assert co.caught_up
    seq = co.cutover(force=True)
    out = [gallery.embedder_version, _mirrors(gallery),
           os.path.exists(p.rollout.stage_path(str(root), 2)), seq == state.wal_seq,
           co.status()]
    got = gallery.snapshot()
    np.testing.assert_allclose(got[0][:got[3]], _expected_new(embs, rotation), atol=1e-5)
    g2, names2 = p.gallery(), []
    report = p.state.StateLifecycle(str(root), metrics=p.Metrics()).recover(g2, names2)
    out += [report["embedder_version"], report.get("completed_cutover"), _mirrors(g2),
            names2 == names]
    state.close()
    return out


def test_cutover_swaps_and_checkpoint_carries_version(tmp_path, rotation):
    got = {pkg: _cutover_and_recover(pkg, tmp_path / pkg, rotation) for pkg in PACKAGES}
    port, ref = got["port"], got["jax"]
    assert port[0] == ref[0] == 2
    _assert_mirrors_equal(port[1], ref[1])
    assert port[2:5] == ref[2:5] and port[2] is False and port[3] is True
    assert port[4]["phase"] == "done"
    assert port[5:7] == ref[5:7] == [2, None]
    _assert_mirrors_equal(port[7], ref[7])
    _assert_mirrors_equal(port[7], port[1])
    assert port[8] and ref[8]


def _crash_after_fence(pkg, root, rotation):
    """Enrol, checkpoint, enrol a WAL-only row, stage, then die after the
    cutover's fence record; returns the enrolled rows and names."""
    p = PKG[pkg]
    rng = np.random.default_rng(2)
    injector = p.faults.FaultInjector(seed=2)
    state, gallery, names = _writer(pkg, root, fault_injector=injector)
    embs = [_enroll(state, gallery, names, rng, i) for i in range(3)]
    assert state.checkpoint_now(wait=True)
    embs.append(_enroll(state, gallery, names, rng, 3))
    co = _coordinator(pkg, state, gallery, rotation, fault_injector=injector)
    co.run_stage()
    injector.script("cutover", "crash_after_record")
    with pytest.raises(p.faults.InjectedCrashError):
        co.cutover(force=True)
    assert gallery.embedder_version == 1  # the dying process never swapped
    state.close()
    return embs, names


def _recover(pkg, root):
    p = PKG[pkg]
    metrics = p.Metrics()
    gallery, names = p.gallery(), []
    report = p.state.StateLifecycle(str(root), metrics=metrics).recover(gallery, names)
    return report, _mirrors(gallery), names, metrics.counter(
        mn.ROLLOUT_CUTOVERS_COMPLETED_RECOVERY)


def test_crash_after_fence_record_recovery_completes(tmp_path, rotation):
    got = {}
    for pkg in PACKAGES:
        embs, names = _crash_after_fence(pkg, tmp_path / pkg, rotation)
        report, mirrors, names2, completed = _recover(pkg, tmp_path / pkg)
        assert report["completed_cutover"]["to_version"] == 2
        assert report["embedder_version"] == 2 and completed == 1 and names2 == names
        np.testing.assert_allclose(mirrors[0][:mirrors[3]], _expected_new(embs, rotation),
                                   atol=1e-5)
        got[pkg] = (report, mirrors)
    for key in ("completed_cutover", "embedder_version", "replayed_records", "skipped_records",
                "gallery_size"):
        assert got["port"][0][key] == got["jax"][0][key], key
    _assert_mirrors_equal(got["port"][1], got["jax"][1])


@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_crash_after_fence_recovers_across_packages(tmp_path, rotation, writer, reader):
    """A dir left by ``writer``'s crash after the fence record: ``reader``'s
    recovery completes the cutover to the gallery, names and report of
    ``writer``'s own recovery, bit for bit."""
    root = tmp_path / "dir"
    _crash_after_fence(writer, root, rotation)
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    own = _recover(writer, root)
    other = _recover(reader, copy)
    _assert_mirrors_equal(other[1], own[1])
    assert other[2] == own[2] and other[3] == own[3] == 1
    for key in ("completed_cutover", "embedder_version", "replayed_records", "skipped_records",
                "version_skipped_records", "gallery_size"):
        assert other[0][key] == own[0][key], key


def _crash_before_fence(pkg, root, rotation):
    p = PKG[pkg]
    rng = np.random.default_rng(3)
    injector = p.faults.FaultInjector(seed=3)
    state, gallery, names = _writer(pkg, root, fault_injector=injector)
    embs = [_enroll(state, gallery, names, rng, i) for i in range(3)]
    co = _coordinator(pkg, state, gallery, rotation, fault_injector=injector)
    co.run_stage()
    injector.script("cutover", "crash_before_record")
    with pytest.raises(p.faults.InjectedCrashError):
        co.cutover(force=True)
    state.close()
    report, mirrors, _names, _c = _recover(pkg, root)
    np.testing.assert_allclose(mirrors[0][:mirrors[3]], _norm(np.concatenate(embs)), atol=1e-6)
    return report["embedder_version"], report.get("completed_cutover"), mirrors


def test_crash_before_fence_record_stays_old_version(tmp_path, rotation):
    got = {pkg: _crash_before_fence(pkg, tmp_path / pkg, rotation) for pkg in PACKAGES}
    assert got["port"][:2] == got["jax"][:2] == (1, None)
    _assert_mirrors_equal(got["port"][2], got["jax"][2])


@BOTH
def test_recovery_fails_closed_on_damaged_stage(tmp_path, rotation, pkg):
    p = PKG[pkg]
    rng = np.random.default_rng(4)
    injector = p.faults.FaultInjector(seed=4)
    state, gallery, names = _writer(pkg, tmp_path, fault_injector=injector)
    for i in range(3):
        _enroll(state, gallery, names, rng, i)
    co = _coordinator(pkg, state, gallery, rotation, fault_injector=injector)
    co.run_stage()
    injector.script("cutover", "crash_after_record")
    with pytest.raises(p.faults.InjectedCrashError):
        co.cutover(force=True)
    os.remove(p.rollout.stage_path(str(tmp_path), 2))
    with pytest.raises(p.rollout.RolloutStateError):
        p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(p.gallery(), [])
    state.close()


# ---------- the parity gate ----------


def _crop_for(row):
    return _norm(row[None])[0].reshape(2, 4)


def _old_embed(crops):
    return np.asarray(crops, np.float32).reshape(len(crops), -1)[:, :DIM]


def _parity_gate(pkg, root, rotation):
    p = PKG[pkg]
    rng = np.random.default_rng(5)
    state, gallery, names = _writer(pkg, root)
    embs = [_enroll(state, gallery, names, rng, i, n=2) for i in range(4)]

    def broken_embed(crops):
        return np.random.default_rng(99).normal(size=(len(crops), DIM)).astype(np.float32)

    metrics = p.Metrics()
    co = p.rollout.RolloutCoordinator(state, gallery, lambda r: r @ rotation, 2,
                                      old_embed_fn=_old_embed, new_embed_fn=broken_embed,
                                      parity_min_samples=4, parity_threshold=0.9,
                                      chunk_rows=8, metrics=metrics)
    co.run_stage()
    out = [co.score_parity([_crop_for(e[0]) for e in embs]), co.parity_ok(),
           co.parity.agreement, co.parity.disagreement, co.status()]
    with pytest.raises(p.rollout.RolloutGateError, match="parity gate"):
        co.cutover()
    out += [metrics.counter(mn.ROLLOUT_CUTOVER_BLOCKED), gallery.embedder_version,
            metrics.gauge(mn.ROLLOUT_PARITY_AGREEMENT), metrics.gauge(mn.ROLLOUT_PHASE)]
    co2 = p.rollout.RolloutCoordinator(state, gallery, lambda r: r @ rotation, 2,
                                       old_embed_fn=_old_embed,
                                       new_embed_fn=lambda c: _old_embed(c) @ rotation,
                                       parity_min_samples=4, parity_threshold=0.9,
                                       chunk_rows=8, metrics=p.Metrics())
    co2.run_stage()
    co2.score_parity([_crop_for(e[0]) for e in embs])
    out += [co2.parity_ok(), co2.parity.agreement]
    co2.cutover()
    out += [gallery.embedder_version, _mirrors(gallery)]
    state.close()
    return out


def test_parity_gate_blocks_disagreeing_embedder(tmp_path, rotation):
    got = {pkg: _parity_gate(pkg, tmp_path / pkg, rotation) for pkg in PACKAGES}
    port, ref = got["port"], got["jax"]
    assert port[:-1] == ref[:-1]
    _assert_mirrors_equal(port[-1], ref[-1])
    assert port[1] is False and port[5] == 1 and port[6] == 1
    assert port[9] is True and port[11] == 2


@pytest.mark.parametrize("case", ["agree", "scrambled", "empty_gallery"])
def test_dual_score_parity_matches_reference(case, rotation):
    """``DualScoreParity`` alone: the same crops and galleries give the same
    top-1 agreement, samples and gauges (host math in both)."""
    rng = np.random.default_rng(6)
    rows = _norm(rng.normal(size=(12, DIM)).astype(np.float32))
    labels = np.arange(12, dtype=np.int32) % 5
    crops = [_crop_for(r + 0.01 * rng.normal(size=DIM).astype(np.float32)) for r in rows]
    new_fn = {"agree": lambda c: _old_embed(c) @ rotation,
              "scrambled": lambda c: _old_embed(c)[:, ::-1].copy(),
              "empty_gallery": lambda c: _old_embed(c) @ rotation}[case]
    n = 0 if case == "empty_gallery" else 12
    got = {}
    for pkg in PACKAGES:
        metrics = PKG[pkg].Metrics()
        parity = PKG[pkg].rollout.DualScoreParity(_old_embed, new_fn, threshold=0.9,
                                                  min_samples=4, window=8, metrics=metrics)
        scored = [parity.score(np.stack(crops[:6]), rows[:n], labels[:n],
                               _norm(rows[:n] @ rotation), labels[:n]),
                  parity.score(crops[6], rows[:n], labels[:n], _norm(rows[:n] @ rotation),
                               labels[:n])]
        got[pkg] = (scored, parity.samples, parity.agreement, parity.disagreement, parity.ok(),
                    metrics.gauge(mn.ROLLOUT_PARITY_SAMPLES),
                    metrics.gauge(mn.ROLLOUT_PARITY_AGREEMENT))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [6, 1] and got["port"][1] == 7


def _live_parity(pkg, root, rotation):
    p = PKG[pkg]
    rng = np.random.default_rng(6)
    state, gallery, names = _writer(pkg, root)
    for i in range(3):
        _enroll(state, gallery, names, rng, i)
    co = p.rollout.RolloutCoordinator(state, gallery, lambda r: r @ rotation, 2,
                                      old_embed_fn=lambda c: _old_embed(c),
                                      new_embed_fn=lambda c: _old_embed(c) @ rotation,
                                      parity_min_samples=1, chunk_rows=8,
                                      live_sample_interval_s=0.0, metrics=p.Metrics())
    co.run_stage()
    pipe = p.fakes.InstantPipeline((16, 16), faces_per_frame=1)
    pipe.gallery = gallery
    connector = p.Conn()
    service = p.rec.RecognizerService(pipe, connector, batch_size=4, frame_shape=(16, 16),
                                      flush_timeout=0.02, metrics=p.Metrics())
    service.rollout = co
    co.start()
    service.start(warmup=False)
    try:
        frame = np.zeros((16, 16), np.float32)
        for i in range(8):
            connector.inject(jax_rec.FRAME_TOPIC, {**p.encode(frame), "meta": {"seq": i}})
        assert service.drain(timeout=10.0)
        deadline = time.monotonic() + 5.0
        while co.parity.samples == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        service.stop()
        co.stop()
    state.close()
    versions = {m.get("embedder_version") for m in connector.messages(jax_rec.RESULT_TOPIC)}
    return co.parity.samples > 0, versions, service.metrics.counter(mn.ROLLOUT_OBSERVE_ERRORS)


def test_live_parity_rides_publish_path(tmp_path, rotation):
    got = {pkg: _live_parity(pkg, tmp_path / pkg, rotation) for pkg in PACKAGES}
    assert got["port"] == got["jax"] == (True, {1}, 0)


def test_a_raising_live_offer_costs_a_counter_never_the_publish(tmp_path):
    class Broken:
        def offer_live(self, frame, faces):
            raise RuntimeError("coordinator bug")

    got = {}
    for pkg in PACKAGES:
        p = PKG[pkg]
        pipe = p.fakes.InstantPipeline((16, 16), faces_per_frame=1)
        conn = p.Conn()
        service = p.rec.RecognizerService(pipe, conn, batch_size=4, frame_shape=(16, 16),
                                          flush_timeout=0.02, metrics=p.Metrics(),
                                          readback_worker=False)
        service.rollout = Broken()
        service._running = True
        for i in range(4):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros((16, 16), np.float32),
                                              "meta": {"seq": i}})
        service._serve_one(service.batcher.get_batch(block=True))
        service._drain(force=True)
        got[pkg] = (len(conn.messages(jax_rec.RESULT_TOPIC)),
                    service.metrics.counter(mn.ROLLOUT_OBSERVE_ERRORS))
    assert got["port"] == got["jax"] == (4, 4)


# ---------- rollback ----------


def _rollback(pkg, root, rotation):
    rng = np.random.default_rng(7)
    state, gallery, names = _writer(pkg, root)
    embs = [_enroll(state, gallery, names, rng, i) for i in range(3)]
    metrics = PKG[pkg].Metrics()
    co = _coordinator(pkg, state, gallery, rotation, metrics=metrics)
    co.run_stage()
    co.cutover(force=True)
    back = co.rollback(lambda rows: rows @ rotation.T)
    out = [back.to_version, back.from_version, back.chunk_rows]
    back.run_stage()
    back.cutover(force=True)
    out += [gallery.embedder_version, _mirrors(gallery), metrics.counter(mn.ROLLOUT_ROLLBACKS)]
    np.testing.assert_allclose(out[4][0][:out[4][3]], _norm(np.concatenate(embs)), atol=1e-5)
    state.close()
    return out


def test_rollback_restores_prior_space(tmp_path, rotation):
    got = {pkg: _rollback(pkg, tmp_path / pkg, rotation) for pkg in PACKAGES}
    port, ref = got["port"], got["jax"]
    assert port[:4] == ref[:4] == [3, 2, 3, 3]
    _assert_mirrors_equal(port[4], ref[4])
    assert port[5] == ref[5] == 1


@BOTH
def test_to_version_must_exceed_the_serving_version(tmp_path, rotation, pkg):
    state, gallery, _names = _writer(pkg, tmp_path)
    with pytest.raises(ValueError, match="must exceed"):
        _coordinator(pkg, state, gallery, rotation, to_version=1)
    state.close()


def test_reembed_fn_with_start_index_matches_reference(tmp_path):
    """``reembed_fn(rows, start)`` gets each chunk's first row index."""
    got = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(8)
        state, gallery, names = _writer(pkg, tmp_path / pkg)
        for i in range(5):
            _enroll(state, gallery, names, rng, i)
        starts = []

        def reembed(rows, start, starts=starts):
            starts.append(start)
            return rows[:, ::-1] + start

        co = PKG[pkg].rollout.RolloutCoordinator(state, gallery, reembed, 2, chunk_rows=2)
        staged = co.run_stage()
        got[pkg] = (staged, starts, co.stage.arrays()[0], co.phase)
        state.close()
    assert got["port"][:2] == got["jax"][:2] == (3, [0, 2, 4])
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    assert got["port"][3] == got["jax"][3] == "ready"


def test_port_written_cutover_passes_the_reference_verifier(tmp_path, rotation):
    """The reference's ``scripts/verify_checkpoint.py`` walks a port-written
    dir across a cutover: one fence record, no version violation."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "verify_checkpoint_rollout", os.path.join(repo, "scripts", "verify_checkpoint.py"))
    verify = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(verify)
    rng = np.random.default_rng(9)
    state, gallery, names = _writer("port", tmp_path)
    for i in range(2):
        _enroll(state, gallery, names, rng, i)
    co = _coordinator("port", state, gallery, rotation)
    co.run_stage()
    state.perform_cutover(2, lambda: gallery.snapshot())
    _enroll(state, gallery, names, rng, 2)  # a v2 row past the fence
    report = verify.verify_state_dir(str(tmp_path))
    assert report["ok"], report
    assert report["wal"]["cutover_records"] == 1 and report["wal"]["version_violations"] == []
    state.close()


@pytest.mark.parametrize("name", ["ROLLOUT_PHASE", "ROLLOUT_STAGED_ROWS", "ROLLOUT_TOTAL_ROWS",
                                  "ROLLOUT_PARITY_AGREEMENT", "ROLLOUT_PARITY_SAMPLES",
                                  "ROLLOUT_STAGE_CHUNKS", "ROLLOUT_STAGE_RESUMES",
                                  "ROLLOUT_STAGE_ERRORS", "ROLLOUT_CUTOVERS",
                                  "ROLLOUT_CUTOVERS_COMPLETED_RECOVERY",
                                  "ROLLOUT_CUTOVER_BLOCKED", "ROLLOUT_ROLLBACKS",
                                  "ROLLOUT_EMBEDDER_VERSION", "ROLLOUT_OBSERVE_ERRORS",
                                  "WAL_CUTOVER_RECORDS"])
def test_rollout_metric_names_equal_the_reference(name):
    assert getattr(mn, name) == getattr(jax_names, name)


def test_rollout_parity_objective_reads_a_live_coordinator(tmp_path, rotation):
    got = {}
    for pkg in PACKAGES:
        p = PKG[pkg]
        state, gallery, names = _writer(pkg, tmp_path / pkg)
        rng = np.random.default_rng(10)
        embs = [_enroll(state, gallery, names, rng, i, n=2) for i in range(3)]
        co = p.rollout.RolloutCoordinator(state, gallery, lambda r: r @ rotation, 2,
                                          old_embed_fn=_old_embed,
                                          new_embed_fn=lambda c: _old_embed(c)[:, ::-1].copy(),
                                          parity_min_samples=2, chunk_rows=8)
        co.run_stage()
        objective = p.slo.rollout_parity_objective(co)
        before = objective.value_fn()
        co.score_parity([_crop_for(e[0]) for e in embs])
        got[pkg] = (before, objective.value_fn(), objective.bound, objective.name)
        state.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0.0 and got["port"][1] > 0.0


# ---------- ROADMAP C.12: the stamp of a batch against a concurrent cutover ----------


def _racing_gallery(pkg):
    """A gallery whose ``load_snapshot`` pauses between re-stamping the
    version and publishing the new arrays (``_install``), when armed."""
    base = JaxGallery if pkg == "jax" else PortGallery

    class Racing(base):
        armed = False

        def _install(self, *args, **kwargs):
            if self.armed:
                self.paused.set()
                assert self.go.wait(10.0)
            return super()._install(*args, **kwargs)

    g = (Racing(capacity=16, dim=DIM, mesh=Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                                                 (DP_AXIS, TP_AXIS)))
         if pkg == "jax" else Racing(16, DIM, device="cpu"))
    g.paused, g.go = threading.Event(), threading.Event()
    return g


def _marking_pipeline(pkg, gallery, marks):
    """An ``InstantPipeline`` that reads the gallery's snapshot once per
    dispatch, as the real pipeline does, and answers one face whose label
    is the version of the rows it matched (``marks``: snapshot id ->
    version)."""
    p = PKG[pkg]

    class Marking(p.fakes.InstantPipeline):
        def recognize_batch_packed(self, frames):
            data = self.gallery.data
            self.last_snapshot = data
            out = super().recognize_batch_packed(frames)
            arr = out._arr if pkg == "jax" else out._packed
            arr[:, 0, 6] = marks[id(data.embeddings)]
            return out

    pipe = Marking((16, 16), faces_per_frame=1)
    pipe.gallery = gallery
    return pipe


def _cutover_race(pkg):
    p = PKG[pkg]
    gallery = _racing_gallery(pkg)
    gallery.add(np.eye(DIM, dtype=np.float32)[:4], np.arange(4, dtype=np.int32))
    marks = {id(gallery.data.embeddings): 1}
    pipe = _marking_pipeline(pkg, gallery, marks)
    conn = p.Conn()
    service = p.rec.RecognizerService(pipe, conn, batch_size=2, frame_shape=(16, 16),
                                      flush_timeout=0.02, similarity_threshold=0.0,
                                      metrics=p.Metrics(), readback_worker=False,
                                      bucket_sizes=(2,))
    service._running = True
    emb, lab, val, size = gallery.snapshot()

    def serve(tag):
        for j in range(2):
            conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros((16, 16), np.float32),
                                              "meta": {"tag": tag, "j": j}})
        service._serve_one(service.batcher.get_batch(block=True))
        service._drain(force=True)

    serve("before")
    gallery.armed = True
    swap = threading.Thread(target=gallery.load_snapshot,
                            args=(-emb, lab, val, size), kwargs={"embedder_version": 2})
    swap.start()
    assert gallery.paused.wait(10.0)
    serve("during")  # the version is re-stamped, the new rows not published yet
    gallery.armed = False
    gallery.go.set()
    swap.join(10.0)
    marks[id(gallery.data.embeddings)] = 2
    serve("after")
    return [(m["meta"]["tag"], m["embedder_version"], m["faces"][0]["label"])
            for m in conn.messages(jax_rec.RESULT_TOPIC)]


def test_result_stamps_pair_with_the_matched_snapshot_across_a_cutover():
    """A dispatch that falls between the cutover's re-stamp and its publish
    (``load_snapshot``): the reference stamps the new version on a batch
    matched against the old rows; the port stamps the version of the
    snapshot its step read, so a result's stamp always names the rows it
    was matched on (ROADMAP C.12). Before and after, both agree."""
    ref, port = _cutover_race("jax"), _cutover_race("port")
    assert [r[0] for r in port] == [r[0] for r in ref] == ["before"] * 2 + ["during"] * 2 + [
        "after"] * 2
    assert all(version == label for _tag, version, label in port)
    assert [v for _t, v, _l in port] == [1, 1, 1, 1, 2, 2]
    # the reference's interleaving mixes: new stamp, old rows
    assert [(v, label) for tag, v, label in ref if tag == "during"] == [(2, 1), (2, 1)]
    assert [r for r in ref if r[0] != "during"] == [r for r in port if r[0] != "during"]


def test_inflight_entry_holds_the_snapshot_its_step_matched(tmp_path):
    """The in-flight entry keeps the matched snapshot (and so its tensors)
    until the readback, however the gallery moved meanwhile."""
    gallery = _port_gallery(capacity=16)
    gallery.add(np.eye(DIM, dtype=np.float32)[:2], np.arange(2, dtype=np.int32))
    first = gallery.data
    pipe = _marking_pipeline("port", gallery, {id(first.embeddings): 1})
    pipe.compute_s = 60.0
    conn = PortConnector()
    service = port_rec.RecognizerService(pipe, conn, batch_size=2, frame_shape=(16, 16),
                                         flush_timeout=0.02, metrics=mn.Metrics(),
                                         readback_worker=False, bucket_sizes=(2,))
    service._running = True
    for j in range(2):
        conn.inject(jax_rec.FRAME_TOPIC, {"frame": np.zeros((16, 16), np.float32),
                                          "meta": {"j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    emb, lab, val, size = gallery.snapshot()
    gallery.load_snapshot(emb, lab, val, size, embedder_version=2)
    entry = service._inflight[0]
    assert entry.snapshot is first and entry.stamp == 1
    assert gallery.data is not first and gallery.data.embedder_version == 2
    assert isinstance(entry.snapshot.embeddings, torch.Tensor)
