"""The port's crash-safe state (``runtime.state_store``, ``runtime.journal``,
``runtime.registry``, ``runtime.replication``) against the JAX package's.

- Formats, both ways: the checkpoint payload equals
  ``flax.serialization.msgpack_serialize`` byte for byte (also in the
  chunked form, with ``MAX_CHUNK_SIZE`` lowered in both modules), a framed
  checkpoint decodes in the other package, WAL lines written by either
  package scan in the other (torn tails, crc flips, tombstones and
  ``registry_*`` records included), and the registry manifests are equal
  byte for byte.
- Recovery across packages: a state dir written by one package (a
  checkpoint, a WAL tail, a tombstone, a torn tail, an IVF sidecar, a
  manifest) recovers in the other to the same host mirrors, size,
  capacity, names, ``wal_seq`` and report as in the writer's own package;
  the reference's ``scripts/verify_checkpoint.py`` passes a port-written
  dir and fails it after a flipped byte.
- The reference's own cases (``tests/test_recovery.py``), run on both
  packages as cases of one test where they repeat.

The JAX side runs on a one-device CPU mesh; the port on ``device="cpu"``.
Tolerance: bit for bit everywhere (host mirrors, names, reports, bytes).
"""

import hashlib
import importlib.util
import json
import os
import shutil
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel import quantizer as jax_quant
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import faults as jax_faults
from opencv_facerecognizer_tpu.runtime import registry as jax_registry
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.utils import metrics as jax_metrics
from opencv_facerecognizer_tpu_torch.parallel import quantizer as port_quant
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import registry as port_registry
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.utils import _msgpack
from opencv_facerecognizer_tpu_torch.utils import metrics as port_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8
RNG = np.random.default_rng(31)

_vspec = importlib.util.spec_from_file_location(
    "verify_checkpoint_torch", os.path.join(REPO, "scripts", "verify_checkpoint.py"))
verify_checkpoint = importlib.util.module_from_spec(_vspec)
_vspec.loader.exec_module(verify_checkpoint)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))


def _jax_gallery(capacity=64, dim=DIM, store=None):
    kwargs = {} if store is None else {"store_dtype": {"bf16": jax.numpy.bfloat16,
                                                       "f32": jax.numpy.float32}[store]}
    return JaxGallery(capacity=capacity, dim=dim, mesh=_mesh1(), **kwargs)


def _port_gallery(capacity=64, dim=DIM, store=None):
    dtype = {None: torch.float32, "f32": torch.float32, "bf16": torch.bfloat16}[store]
    return PortGallery(capacity, dim, store_dtype=dtype, device="cpu")


PKGS = {
    "jax": types.SimpleNamespace(state=jax_state, faults=jax_faults, Metrics=jax_metrics.Metrics,
                                 gallery=_jax_gallery, quant=jax_quant,
                                 registry=jax_registry),
    "torch": types.SimpleNamespace(state=port_state, faults=port_faults,
                                   Metrics=port_metrics.Metrics, gallery=_port_gallery,
                                   quant=port_quant, registry=port_registry),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])
DIRECTIONS = pytest.mark.parametrize("writer, reader", [("jax", "torch"), ("torch", "jax")])


def _rows(n, dim=DIM):
    return RNG.normal(size=(n, dim)).astype(np.float32)


def _enroll(st, g, names, subject, n=2, label=None):
    """One enrolment through the write-ahead path, as the service makes it."""
    label = len(names) if label is None else label
    emb = _rows(n, g.dim)
    labels = np.full(n, label, np.int32)
    if label == len(names):
        names.append(subject)
    st.append_enrollment(emb, labels, subject=subject, label=label,
                         apply_fn=lambda: g.add(emb, labels))
    return emb


def _mirrors(g):
    emb, lab, val, size = g.snapshot()
    return emb, lab, val, size, g.capacity


def _assert_same_gallery(a, b):
    for x, y in zip(_mirrors(a), _mirrors(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------- formats ----------

@pytest.mark.parametrize("chunk", [None, 256])
def test_payload_bytes_equal_flax(chunk, monkeypatch):
    """``pack_pieces`` joined, and ``packb``, are flax's bytes; with a
    lowered ``MAX_CHUNK_SIZE`` the rows take the chunked form in both."""
    from flax import serialization as flax_serialization

    if chunk is not None:
        monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", chunk)
    emb = _rows(40)
    tree = {"emb": emb, "lab": np.arange(40, dtype=np.int32), "val": np.ones(40, bool)}
    want = flax_serialization.msgpack_serialize(tree)
    assert b"".join(_msgpack.pack_pieces(tree)) == want
    assert _msgpack.packb(tree) == want
    assert (b"__msgpack_chunked_array__" in want) == (chunk is not None)
    got = _msgpack.unpackb(want)
    np.testing.assert_array_equal(got["emb"], emb)


@pytest.mark.parametrize("chunk", [None, 256])
@DIRECTIONS
def test_checkpoint_recovers_in_other_package(writer, reader, chunk, tmp_path, monkeypatch):
    """A gallery checkpoint (chunked when ``chunk``) written by one
    package's ``checkpoint_now`` recovers in the other's to the same
    mirrors and names; the payload bytes are the same from both writers."""
    from flax import serialization as flax_serialization

    if chunk is not None:
        monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", chunk)
    emb = _rows(20)
    payloads = {}
    for pkg in (writer, reader):
        p = PKGS[pkg]
        g = p.gallery(capacity=32)
        g.add(emb, np.arange(20, dtype=np.int32) % 3)
        st = p.state.StateLifecycle(str(tmp_path / pkg), metrics=p.Metrics())
        st.bind(g, ["a", "b", "c"])
        assert st.checkpoint_now(wait=True)
        header, payload, _path = p.state.CheckpointStore(
            str(tmp_path / pkg / "checkpoints")).load_latest()
        payloads[pkg] = bytes(payload)
        st.close()
    assert payloads[writer] == payloads[reader]
    src = PKGS[writer]
    g_src = src.gallery(capacity=32)
    g_src.add(emb, np.arange(20, dtype=np.int32) % 3)
    p = PKGS[reader]
    g = p.gallery(capacity=8)
    names = []
    rep = p.state.StateLifecycle(str(tmp_path / writer), metrics=p.Metrics()).recover(g, names)
    assert rep["checkpoint_size"] == 20 and names == ["a", "b", "c"]
    _assert_same_gallery(g, g_src)


@DIRECTIONS
def test_framed_file_decodes_in_other_package(writer, reader, tmp_path):
    meta = {"wal_seq": 7, "subject_names": ["x"]}
    path = PKGS[writer].state.CheckpointStore(str(tmp_path)).save(b"payload-bytes", meta)
    blob = open(path, "rb").read()
    header, payload = PKGS[reader].state._decode_checkpoint(blob, path)
    assert bytes(payload) == b"payload-bytes" and header["meta"] == meta
    assert PKGS[reader].state.read_checkpoint_header(path) == header


def _write_wal(pkg, path):
    """A WAL with enrolments, an abort tombstone, a crc-flipped record, the
    fence kinds the package writes, and a torn tail."""
    p = PKGS[pkg]
    wal = p.state.EnrollmentWAL(path, metrics=p.Metrics())
    rows = {}
    for seq in (1, 2, 3, 4):
        rows[seq] = _rows(seq)
        wal.append_enroll(seq, rows[seq], np.full(seq, seq - 1, np.int32),
                          subject=f"s{seq}", label=seq - 1)
    wal.append_abort(2)
    if pkg == "jax":
        wal.append_cutover(5, 1, 2, rows=3, dim=DIM)
        wal.append_registry_cutover(6, "detector", 1, 2, {"embedder": 1, "detector": 2,
                                                          "cascade": 1})
    wal.append_registry_abort(6, "detector", 2)
    wal.close()
    lines = open(path).read().splitlines()
    rec = json.loads(lines[2])  # seq 3: flip its rows' first base64 digit
    rec["emb"] = ("A" if rec["emb"][0] != "A" else "B") + rec["emb"][1:]
    lines[2] = json.dumps(rec)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n" + '{"kind": "enroll", "seq": 9, "to')
    return rows


@DIRECTIONS
def test_wal_lines_scan_in_other_package(writer, reader, tmp_path):
    path = str(tmp_path / "enroll.wal")
    rows = _write_wal(writer, path)
    scans = {}
    for pkg in (writer, reader):
        shutil.copy(path, str(tmp_path / f"{pkg}.wal"))
        p = PKGS[pkg]
        m = p.Metrics()
        wal = p.state.EnrollmentWAL(str(tmp_path / f"{pkg}.wal"), metrics=m)
        records, highest = wal.scan()
        scans[pkg] = ([(r["kind"], r["seq"]) for r in records], highest,
                      m.counter("wal_corrupt_records"), m.counter("wal_torn_tails_sealed"))
        enrolled = [r for r in records if r["kind"] == "enroll"]
        for r in enrolled:
            np.testing.assert_array_equal(r["embeddings"], rows[r["seq"]])
    assert scans[reader] == scans[writer]
    kinds, highest, corrupt, sealed = scans[reader]
    assert [s for k, s in kinds if k == "enroll"] == [1, 4]  # 2 aborted, 3 corrupt
    assert ("registry_abort", 6) in kinds and highest == 6
    assert corrupt == 1 and sealed == 1


def test_registry_manifest_bytes_equal(tmp_path, monkeypatch):
    """The manifest both packages write (create, install, retire, mirror)
    is the same bytes; each reads the other's."""
    for mod in (jax_registry, port_registry):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    blobs = {}
    for pkg in ("jax", "torch"):
        reg = PKGS[pkg].registry.ModelRegistry(str(tmp_path / pkg))
        reg.install("detector", 2, config={"features": [8, 16]}, params_path="p",
                    params_sha256="ab")
        reg.retire("cascade", 3)
        reg.mirror_embedder(4)
        blobs[pkg] = open(reg.path, "rb").read()
    assert blobs["jax"] == blobs["torch"]
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        got = PKGS[reader].registry.ModelRegistry(str(tmp_path / writer))
        assert got.stamp() == {"embedder": 4, "detector": 2, "cascade": 1}
        assert got.describe("cascade")["retired"] == 3


def test_registry_stamp_key_equals_the_reference(tmp_path):
    """C.17: ``ModelRegistry.stamp_key`` is the hashable form of
    ``stamp()``, equal to the reference's on one manifest, before and
    after an install."""
    port = port_registry.ModelRegistry(str(tmp_path))
    ref = jax_registry.ModelRegistry(str(tmp_path))
    assert port.stamp_key() == ref.stamp_key() == tuple(sorted(port.stamp().items()))
    port.install("detector", 3, params_path="p", params_sha256="ab")
    ref = jax_registry.ModelRegistry(str(tmp_path))
    assert port.stamp_key() == ref.stamp_key()
    assert hash(port.stamp_key()) == hash(ref.stamp_key())


@pytest.mark.parametrize("version", [1, 3])
def test_state_lifecycle_embedder_version_equals_the_reference(tmp_path, version):
    """C.17: ``StateLifecycle.embedder_version`` reads the bound gallery's
    version, as the reference's does, and follows a whole-set install."""
    got = {}
    for pkg in ("jax", "torch"):
        p = PKGS[pkg]
        g = p.gallery()
        g.load_snapshot(*g.snapshot(), embedder_version=version)
        st = p.state.StateLifecycle(str(tmp_path / pkg), metrics=p.Metrics())
        st.bind(g, [])
        before = st.embedder_version
        g.load_snapshot(*g.snapshot(), embedder_version=version + 1)
        got[pkg] = (before, st.embedder_version)
        st.close()
    assert got["torch"] == got["jax"] == (version, version + 1)


def test_registry_flipped_manifest_is_corrupt(tmp_path):
    reg = port_registry.ModelRegistry(str(tmp_path))
    doc = json.loads(open(reg.path).read())
    doc["roles"]["detector"]["version"] = 5
    open(reg.path, "w").write(json.dumps(doc))
    for mod in (port_registry, jax_registry):
        with pytest.raises(mod.RegistryStateError) as exc:
            mod.ModelRegistry(str(tmp_path))
        assert exc.value.reason == "corrupt"


# ---------- recovery across packages ----------

def _quantizer(pkg):
    return PKGS[pkg].quant.CoarseQuantizer(nlist=8, nprobe=4, seed=3, kmeans_iters=4,
                                           train_sample=4096)


def _write_state_dir(pkg, root):
    """A writer's state dir: 60 rows with a built quantizer, enrolments,
    a checkpoint (with its sidecar), a WAL tail past it with an aborted
    enrolment and a torn tail, and a registry manifest. Returns the live
    gallery and names."""
    p = PKGS[pkg]
    injector = p.faults.FaultInjector(seed=0)
    g = p.gallery(capacity=64)
    base = _rows(60)
    g.add(base, np.arange(60, dtype=np.int32) % 6)
    q = _quantizer(pkg)
    g.attach_quantizer(q, mode="ivf")
    assert q.rebuild_now()
    names = [f"base{i}" for i in range(6)]
    st = p.state.StateLifecycle(root, metrics=p.Metrics(), checkpoint_wal_rows=1 << 30,
                                checkpoint_every_s=1e9, fault_injector=injector)
    st.bind(g, names)
    st.attach_registry(p.registry.ModelRegistry(root))
    _enroll(st, g, names, "alice", n=3)
    _enroll(st, g, names, "bob", n=2)  # 65 rows: the gallery grows to 128
    assert st.checkpoint_now(wait=True)
    assert os.path.exists(os.path.join(root, "quantizer.ivf"))
    _enroll(st, g, names, "carol", n=2)
    with pytest.raises(RuntimeError):
        st.append_enrollment(_rows(1), np.array([9], np.int32), subject="ghost", label=9,
                             apply_fn=lambda: (_ for _ in ()).throw(RuntimeError("apply")))
    _enroll(st, g, names, "dave", n=1)
    injector.script("wal", "torn")
    with pytest.raises(p.faults.InjectedCrashError):
        _enroll(st, g, names[:], "erin", n=1, label=len(names))
    st.wal.close()
    return g, names


def _recover(pkg, root, with_quantizer=True):
    p = PKGS[pkg]
    g = p.gallery(capacity=64)
    if with_quantizer:
        g.attach_quantizer(_quantizer(pkg), mode="ivf")
    names = []
    st = p.state.StateLifecycle(root, metrics=p.Metrics())
    rep = st.recover(g, names)
    rep["recovered_checkpoint"] = os.path.basename(rep["recovered_checkpoint"])
    return g, names, st.wal_seq, rep


@DIRECTIONS
def test_state_dir_recovers_in_other_package(writer, reader, tmp_path):
    live, live_names = _write_state_dir(writer, str(tmp_path / "dir"))
    got = {}
    for pkg in (writer, reader):
        root = str(tmp_path / f"copy_{pkg}")
        shutil.copytree(str(tmp_path / "dir"), root)
        got[pkg] = _recover(pkg, root)
    g_w, names_w, seq_w, rep_w = got[writer]
    g_r, names_r, seq_r, rep_r = got[reader]
    _assert_same_gallery(g_r, g_w)
    _assert_same_gallery(g_r, live)
    assert names_r == names_w == live_names
    assert seq_r == seq_w == 5  # the torn record never landed
    assert rep_r == rep_w
    assert rep_r["replayed_records"] == 2 and rep_r["quantizer_sidecar"] == "loaded"
    assert rep_r["registry"] == {"embedder": 1, "detector": 1, "cascade": 1}


def test_port_restored_lists_answer_as_the_live_jax_quantizer(tmp_path):
    """Restored from a JAX sidecar whose build predates the enrolments, the
    port's lists hold every row where the live JAX quantizer's incremental
    inserts put it, and the two-stage match gives the live answers."""
    live, _names = _write_state_dir("jax", str(tmp_path / "dir"))
    g, _n, _seq, _rep = _recover("torch", str(tmp_path / "dir"))
    want, got = live.quantizer.data, g.quantizer.data
    for field in ("centroids", "cell_rows", "cell_q8", "cell_scale"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    n_spill = live.quantizer.spill_count
    assert g.quantizer.spill_count == n_spill
    np.testing.assert_array_equal(got.spill_rows.numpy()[:n_spill],
                                  np.asarray(want.spill_rows)[:n_spill])
    q = live.snapshot()[0][:16]
    jl, _jv, ji = (np.asarray(v) for v in live.match(q, k=3))
    pl, _pv, pi = (v.numpy() for v in g.match(q, k=3))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)


def test_restored_quantizer_trains_again_where_each_package_says(tmp_path):
    """ROADMAP C.9, pinned: the sidecar's build saw 60 rows and the
    checkpoint holds 65. The JAX restore sizes the cells from the 65 rows
    and takes them as ``trained_size``; the port keeps the build's 60, as
    the live quantizer does. Both answer the live two-stage matches here.
    Grown by the same rows to 91 (past 1.5 * 60, short of 1.5 * 65), the
    port and the live quantizer go stale and retrain, the JAX restore
    does not."""
    live, _names = _write_state_dir("jax", str(tmp_path / "dir"))
    got = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / f"copy_{pkg}")
        shutil.copytree(str(tmp_path / "dir"), root)
        got[pkg] = _recover(pkg, root)[0]
    jq, pq = got["jax"].quantizer, got["torch"].quantizer
    assert (live.quantizer.trained_size, jq.trained_size, pq.trained_size) == (60, 65, 60)
    assert (np.asarray(jq.data.cell_rows).shape[1], pq.data.cell_rows.shape[1]) == (24, 16)
    assert not jq.stale() and not pq.stale() and not live.quantizer.stale()
    q = live.snapshot()[0][:live.size]
    _jl, _jv, want = (np.asarray(v) for v in live.match(q, k=3))
    for g in (got["jax"], got["torch"]):
        np.testing.assert_array_equal(np.asarray(g.match(q, k=3)[2]), want)
    versions = {"live": live.quantizer.version, "jax": jq.version, "torch": pq.version}
    grow = _rows(91 - live.size)
    for g in (live, got["jax"], got["torch"]):
        for row in grow:  # one enrolment per row: each add checks stale()
            g.add(row[None, :], np.zeros(1, np.int32))
    for name, quant in (("live", live.quantizer), ("torch", pq)):
        assert _wait_for(lambda: quant.version > versions[name]
                         and quant.trained_size == 91), name
    assert not jq.stale() and jq.version == versions["jax"] and jq.trained_size == 65


def _wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_verify_checkpoint_passes_port_dir_and_fails_flipped_byte(tmp_path):
    root = str(tmp_path / "dir")
    _write_state_dir("torch", root)
    assert verify_checkpoint.main([root]) == 0
    newest = port_state.scan_checkpoint_files(os.path.join(root, "checkpoints"))[0][1]
    blob = bytearray(open(newest, "rb").read())
    blob[-5] ^= 0x01
    open(newest, "wb").write(bytes(blob))
    assert verify_checkpoint.main([root]) == 2


# ---------- the reference's cases ----------

@BOTH
def test_checkpoint_store_retention_and_seq(pkg, tmp_path):
    p = PKGS[pkg]
    m = p.Metrics()
    store = p.state.CheckpointStore(str(tmp_path), keep=3, metrics=m)
    for i in range(5):
        store.save(f"payload-{i}".encode(), {"i": i})
    assert [seq for seq, _ in store.checkpoint_files()] == [5, 4, 3]
    header, payload, _path = store.load_latest()
    assert bytes(payload) == b"payload-4" and header["meta"]["i"] == 4 and header["seq"] == 5
    assert m.counter("checkpoints_written") == 5
    assert p.state.CheckpointStore(str(tmp_path)).next_seq() == 6
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


@BOTH
def test_checkpoint_store_falls_back_past_corrupt_newest(pkg, tmp_path):
    p = PKGS[pkg]
    m = p.Metrics()
    store = p.state.CheckpointStore(str(tmp_path), keep=3, metrics=m)
    store.save(b"old-good", {"gen": "old"})
    newest = store.save(b"new-doomed", {"gen": "new"})
    blob = open(newest, "rb").read()
    open(newest, "wb").write(blob[:len(blob) // 2])
    _header, payload, _path = store.load_latest()
    assert bytes(payload) == b"old-good" and m.counter("checkpoints_corrupt") == 1
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".corrupt")]) == 1
    store.load_latest()
    assert m.counter("checkpoints_corrupt") == 1


@BOTH
def test_checkpoint_header_bitflip_detected(pkg, tmp_path):
    p = PKGS[pkg]
    m = p.Metrics()
    store = p.state.CheckpointStore(str(tmp_path), keep=3, metrics=m)
    store.save(b"old", {"wal_seq": 3})
    newest = store.save(b"new", {"wal_seq": 7})
    blob = bytearray(open(newest, "rb").read())
    blob[len(p.state.CHECKPOINT_MAGIC) + 4 + 5] ^= 0x01
    open(newest, "wb").write(bytes(blob))
    _header, payload, _path = store.load_latest()
    assert bytes(payload) == b"old" and m.counter("checkpoints_corrupt") == 1
    hdr = b"null"
    open(os.path.join(str(tmp_path), "ckpt-00000031.ckpt"), "wb").write(
        p.state.CHECKPOINT_MAGIC + len(hdr).to_bytes(4, "big") + hdr
        + hashlib.sha256(hdr).digest() + b"x")
    assert bytes(store.load_latest()[1]) == b"old" and m.counter("checkpoints_corrupt") == 2


@BOTH
def test_newer_format_checkpoint_skipped_not_quarantined(pkg, tmp_path):
    p = PKGS[pkg]
    m = p.Metrics()
    store = p.state.CheckpointStore(str(tmp_path), keep=3, metrics=m)
    store.save(b"v1-state", {})
    payload = b"future"
    header = {"format_version": 99, "seq": 2, "payload_bytes": len(payload),
              "sha256": hashlib.sha256(payload).hexdigest(), "meta": {}}
    future = os.path.join(str(tmp_path), "ckpt-00000002.ckpt")
    open(future, "wb").write(p.state._encode_checkpoint(header, payload))
    assert bytes(store.load_latest()[1]) == b"v1-state"
    assert m.counter("checkpoints_version_skipped") == 1 and m.counter("checkpoints_corrupt") == 0
    assert os.path.exists(future)
    sweep = store.verify()
    assert len(sweep["newer_version"]) == 1 and not sweep["corrupt"]


@BOTH
def test_wal_fsync_policy_validated_and_never_rotates(pkg, tmp_path):
    p = PKGS[pkg]
    with pytest.raises(ValueError):
        p.state.EnrollmentWAL(str(tmp_path / "w"), fsync="sometimes")
    for policy in ("never", "interval", "always"):
        p.state.EnrollmentWAL(str(tmp_path / f"w-{policy}"), fsync=policy).close()
    m = p.Metrics()
    wal = p.state.EnrollmentWAL(str(tmp_path / "small.wal"), max_bytes=256, metrics=m)
    for seq in range(1, 9):
        wal.append_enroll(seq, _rows(2), np.zeros(2, np.int32))
    assert [r["seq"] for r in wal.enrollments()] == list(range(1, 9))
    assert not os.path.exists(str(tmp_path / "small.wal.1"))
    assert m.counter("wal_over_bytes") == 1
    wal.truncate_below(6)
    assert [r["seq"] for r in wal.enrollments()] == [7, 8]


@BOTH
def test_recover_dedups_after_late_crash(pkg, tmp_path):
    p = PKGS[pkg]
    g = p.gallery()
    names = []
    injector = p.faults.FaultInjector(seed=0)
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics(), checkpoint_wal_rows=1 << 30,
                                checkpoint_every_s=1e9, fault_injector=injector)
    st.bind(g, names)
    _enroll(st, g, names, "a", n=3)
    injector.script("checkpoint", "late")
    with pytest.raises(p.faults.InjectedCrashError):
        st.checkpoint_now(wait=True)
    assert len(list(st.wal.enrollments())) == 1
    g2, names2 = p.gallery(), []
    rep = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(g2, names2)
    assert rep["skipped_records"] == 1 and rep["replayed_records"] == 0
    assert g2.size == 3 and names2 == ["a"]


@BOTH
def test_failed_apply_never_resurrected(pkg, tmp_path):
    p = PKGS[pkg]
    g = p.gallery()
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st.bind(g, [])
    _enroll(st, g, [], "ok", n=2, label=0)

    def failing_apply():
        raise RuntimeError("device fell over mid-add")

    with pytest.raises(RuntimeError, match="fell over"):
        st.append_enrollment(_rows(3), np.ones(3, np.int32), subject="ghost", label=1,
                             apply_fn=failing_apply)
    g2, names2 = p.gallery(), []
    p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(g2, names2)
    assert g2.size == 2 and "ghost" not in names2


@BOTH
def test_seq_not_reused_after_abort_across_restarts(pkg, tmp_path):
    p = PKGS[pkg]
    g = p.gallery()
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st.bind(g, [])
    _enroll(st, g, [], "a", n=1, label=0)
    with pytest.raises(RuntimeError):
        st.append_enrollment(_rows(1), np.ones(1, np.int32), subject="b", label=1,
                             apply_fn=lambda: (_ for _ in ()).throw(RuntimeError("died")))
    g2 = p.gallery()
    st2 = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st2.recover(g2, [])
    assert st2.wal_seq == 2
    c = _rows(1)
    st2.append_enrollment(c, np.ones(1, np.int32), subject="c", label=1,
                          apply_fn=lambda: g2.add(c, np.ones(1, np.int32)))
    g3, names3 = p.gallery(), []
    p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(g3, names3)
    assert g3.size == 2 and names3[1] == "c"


@BOTH
def test_single_flight_and_forced_latch(pkg, tmp_path):
    p = PKGS[pkg]
    g = p.gallery()
    m = p.Metrics()
    st = p.state.StateLifecycle(str(tmp_path), metrics=m)
    st.bind(g, [])
    _enroll(st, g, [], "a", n=1, label=0)
    assert st._ckpt_lock.acquire(blocking=False)  # one in flight
    try:
        assert st.maybe_checkpoint(force=True) is False
        assert st.checkpoint_now() is False
        assert m.counter("checkpoints_skipped_inflight") == 2
        assert st._force_pending is True and st.checkpoint_due()
    finally:
        st._ckpt_lock.release()
    assert st.checkpoint_now(wait=True) is True
    assert st._force_pending is False
    assert list(st.wal.enrollments()) == []


@BOTH
def test_checkpoint_failure_backs_off(pkg, tmp_path, monkeypatch):
    p = PKGS[pkg]
    g = p.gallery()
    m = p.Metrics()
    st = p.state.StateLifecycle(str(tmp_path), metrics=m)
    st.bind(g, [])
    _enroll(st, g, [], "a", n=1, label=0)
    st.checkpoint_wal_rows = 1
    assert st.checkpoint_due() is True

    def failing_save(payload, meta, fault=None):
        raise OSError("disk full")

    monkeypatch.setattr(st.store, "save", failing_save)
    assert st.checkpoint_now(wait=True) is False
    assert m.counter("checkpoint_failures") == 1
    assert st.checkpoint_due() is False
    st.tick()
    assert m.counter("checkpoint_failures") == 1
    monkeypatch.undo()
    st._ckpt_retry_at = 0.0
    assert st.checkpoint_due() is True and st.checkpoint_now(wait=True) is True
    assert st._ckpt_retry_backoff_s == 1.0


@BOTH
def test_dim_mismatch_is_a_value_error(pkg, tmp_path):
    p = PKGS[pkg]
    g = p.gallery()
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st.bind(g, [])
    _enroll(st, g, [], "a", n=1, label=0)
    assert st.checkpoint_now(wait=True)
    with pytest.raises(ValueError, match="dim"):
        p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(
            p.gallery(capacity=32, dim=DIM * 2), [])


@BOTH
def test_bf16_gallery_restores_f32_checkpoint(pkg, tmp_path):
    p = PKGS[pkg]
    f32 = p.gallery(store="f32")
    emb = _rows(12)
    f32.add(emb, (np.arange(12) % 4).astype(np.int32))
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st.bind(f32, [f"s{i}" for i in range(4)])
    assert st.checkpoint_now(wait=True)
    bf16, names = p.gallery(store="bf16"), []
    rep = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(bf16, names)
    assert rep["checkpoint_size"] == 12 and bf16.size == 12
    assert str(bf16.data.embeddings.dtype) in ("bfloat16", "torch.bfloat16")
    assert bf16._host_emb.dtype == np.float32
    _assert_same_gallery(bf16, f32)
    q = emb[:8] / np.linalg.norm(emb[:8], axis=-1, keepdims=True)
    np.testing.assert_array_equal(np.asarray(f32.match(q, k=1)[2]),
                                  np.asarray(bf16.match(q, k=1)[2]))


@BOTH
@pytest.mark.parametrize("sidecar", ["matching", "stale", "corrupt"])
def test_sidecar_restored_or_retrained_by_wal_seq(pkg, sidecar, tmp_path):
    """A sidecar keyed by the recovered checkpoint's ``wal_seq`` loads; one
    of another ``wal_seq`` or a damaged one means a retrain."""
    p = PKGS[pkg]
    root = str(tmp_path)
    g = p.gallery(capacity=64)
    g.add(_rows(60), np.arange(60, dtype=np.int32))
    q = _quantizer(pkg)
    g.attach_quantizer(q, mode="ivf")
    assert q.rebuild_now()
    st = p.state.StateLifecycle(root, metrics=p.Metrics())
    st.bind(g, [])
    assert st.checkpoint_now(wait=True)
    path = os.path.join(root, "quantizer.ivf")
    if sidecar == "stale":
        header, cent, assign = p.quant.decode_sidecar(open(path, "rb").read())
        payload = dict(centroids=cent, assign=assign, nlist=header["nlist"], seed=header["seed"],
                       trained_size=header["trained_size"], version=header["version"])
        open(path, "wb").write(p.quant.encode_sidecar(payload, wal_seq=99))
    elif sidecar == "corrupt":
        blob = bytearray(open(path, "rb").read())
        blob[-3] ^= 0xFF
        open(path, "wb").write(bytes(blob))
    m = p.Metrics()
    g2 = p.gallery(capacity=64)
    g2.attach_quantizer(_quantizer(pkg), mode="ivf")
    rep = p.state.StateLifecycle(root, metrics=m).recover(g2, [])
    if sidecar == "matching":
        assert rep["quantizer_sidecar"] == "loaded" and m.counter("ivf_sidecar_loads") == 1
        np.testing.assert_array_equal(np.asarray(g2.quantizer.data.cell_rows),
                                      np.asarray(q.data.cell_rows))
    else:
        assert "quantizer_sidecar" not in rep
        assert m.counter("ivf_sidecar_stale" if sidecar == "stale" else "ivf_sidecar_errors") == 1


def test_pending_cutover_raises_naming_the_rollout_item(tmp_path):
    """A JAX-written WAL whose embedder ``cutover`` lies past the newest
    checkpoint, with its JAX-written stage: the port's recovery completes
    the cutover to the same gallery, names and report as JAX's own
    recovery (bit for bit). Without the stage both refuse alike
    (``RolloutStateError``). A registry swap without an attached manifest
    raises in both packages."""
    from opencv_facerecognizer_tpu.runtime import rollout as jax_rollout
    from opencv_facerecognizer_tpu_torch.runtime import rollout as port_rollout

    root = str(tmp_path)
    g = _jax_gallery()
    names = []
    st = jax_state.StateLifecycle(root, metrics=jax_metrics.Metrics())
    st.bind(g, names)
    _enroll(st, g, names, "a", n=2)
    assert st.checkpoint_now(wait=True)
    _enroll(st, g, names, "b", n=1)
    emb, lab, _val, size = g.snapshot()
    stage = jax_rollout.ReEmbedStage(root, 2, dim=DIM)
    stage.stage_chunk(0, emb[:size][::-1].copy(), lab[:size])
    st.wal.append_cutover(st.wal_seq + 1, 1, 2, rows=size, dim=DIM)
    st.wal.close()
    reports, galleries, name_lists = {}, {}, {}
    for pkg in ("jax", "torch"):
        copy = str(tmp_path / f"copy_{pkg}")
        shutil.copytree(root, copy)
        p = PKGS[pkg]
        m = p.Metrics()
        galleries[pkg] = p.gallery()
        name_lists[pkg] = []
        reports[pkg] = p.state.StateLifecycle(copy, metrics=m).recover(
            galleries[pkg], name_lists[pkg])
        assert m.counter("rollout_cutovers_completed_recovery") == 1
        assert galleries[pkg].embedder_version == 2
    _assert_same_gallery(galleries["jax"], galleries["torch"])
    assert name_lists["torch"] == name_lists["jax"] == ["a", "b"]
    for key in ("completed_cutover", "embedder_version", "replayed_records",
                "skipped_records", "gallery_size"):
        assert reports["torch"][key] == reports["jax"][key], key
    os.remove(jax_rollout.stage_path(root, 2))
    with pytest.raises(jax_rollout.RolloutStateError):
        jax_state.StateLifecycle(root).recover(_jax_gallery(), [])
    with pytest.raises(port_rollout.RolloutStateError):
        port_state.StateLifecycle(root).recover(_port_gallery(), [])
    with pytest.raises(RuntimeError, match="attach_registry"):
        jax_state.StateLifecycle(root).perform_registry_cutover("detector", 2)
    with pytest.raises(RuntimeError, match="attach_registry"):
        port_state.StateLifecycle(root).perform_registry_cutover("detector", 2)


@pytest.mark.parametrize("params", ["intact", "damaged"])
def test_registry_settle_completes_or_abandons_as_jax(params, tmp_path):
    """A ``registry_cutover`` fence whose manifest install never ran: both
    packages complete it when the staged params verify, and abandon it
    (tombstone, retired version) when they do not."""
    root = str(tmp_path / "dir")
    g = _jax_gallery()
    st = jax_state.StateLifecycle(root, metrics=jax_metrics.Metrics())
    st.bind(g, [])
    reg = jax_registry.ModelRegistry(root)
    st.attach_registry(reg)
    _enroll(st, g, [], "a", n=1, label=0)
    assert st.checkpoint_now(wait=True)
    staged = jax_registry.registry_params_path(root, "detector", 2)
    os.makedirs(os.path.dirname(staged), exist_ok=True)
    open(staged, "wb").write(b"candidate params")
    sha = jax_registry._file_sha256(staged)
    st.wal.append_registry_cutover(2, "detector", 1, 2, {"embedder": 1, "detector": 2,
                                                         "cascade": 1},
                                   params_path=staged, params_sha256=sha)
    st.wal.close()
    if params == "damaged":
        open(staged, "wb").write(b"torn")
    outcomes = {}
    for pkg in ("jax", "torch"):
        copy = str(tmp_path / pkg)
        shutil.copytree(root, copy)
        p = PKGS[pkg]
        fixed = os.path.join(copy, "registry", "detector-v2.params")
        lines = open(os.path.join(copy, "enroll.wal")).read().replace(staged, fixed)
        open(os.path.join(copy, "enroll.wal"), "w").write(lines)
        st2 = p.state.StateLifecycle(copy, metrics=p.Metrics())
        rep = st2.recover(p.gallery(), [])
        st2.close()
        kinds = [r["kind"] for r in p.state.EnrollmentWAL(
            os.path.join(copy, "enroll.wal")).scan()[0]]
        outcomes[pkg] = (rep.get("completed_registry_swaps"),
                         rep.get("abandoned_registry_swaps"), st2.registry.stamp(),
                         st2.registry.describe("detector").get("retired"), kinds)
    assert outcomes["torch"] == outcomes["jax"]
    completed, abandoned, stamp, retired, kinds = outcomes["torch"]
    if params == "intact":
        assert completed and not abandoned and stamp["detector"] == 2
    else:
        assert abandoned and not completed and stamp["detector"] == 1 and retired == 2
        assert "registry_abort" in kinds


@BOTH
def test_wal_torn_tail_sealed_and_crc_guarded(pkg, tmp_path):
    p = PKGS[pkg]
    path = str(tmp_path / "enroll.wal")
    wal = p.state.EnrollmentWAL(path, metrics=p.Metrics())
    wal.append_enroll(1, _rows(2), np.zeros(2, np.int32))
    injector = p.faults.FaultInjector(seed=0)
    injector.script("wal", "torn")
    wal._faults = injector
    with pytest.raises(p.faults.InjectedCrashError):
        wal.append_enroll(2, _rows(2), np.zeros(2, np.int32))
    wal.close()
    m2 = p.Metrics()
    wal2 = p.state.EnrollmentWAL(path, metrics=m2)
    assert m2.counter("wal_torn_tails_sealed") == 1
    emb3 = _rows(2)
    wal2.append_enroll(3, emb3, np.zeros(2, np.int32))
    records = list(wal2.enrollments())
    assert [r["seq"] for r in records] == [1, 3]
    np.testing.assert_array_equal(records[1]["embeddings"], emb3)


def test_concurrent_enrolments_and_checkpoints_lose_nothing(tmp_path):
    """Stress: eight threads enrol while background checkpoints run (a
    shortened switch interval, more threads than cores); every
    acknowledged enrolment is in the recovered gallery, exactly once."""
    import sys
    import threading

    g = _port_gallery(capacity=8)
    names = []
    st = port_state.StateLifecycle(str(tmp_path), metrics=port_metrics.Metrics(),
                                   checkpoint_wal_rows=6, keep_checkpoints=2)
    st.bind(g, names)
    lock = threading.Lock()
    acked = []

    def worker(w):
        rng = np.random.default_rng(w)
        for i in range(12):
            with lock:
                label = len(names)
                names.append(f"w{w}-{i}")
            emb = rng.normal(size=(1, DIM)).astype(np.float32)
            lab = np.array([label], np.int32)
            st.append_enrollment(emb, lab, subject=names[label], label=label,
                                 apply_fn=lambda: g.add(emb, lab))
            with lock:
                acked.append(label)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    st.checkpoint_now(wait=True)  # waits out a background one in flight
    st.close()
    g2, names2 = _port_gallery(capacity=8), []
    port_state.StateLifecycle(str(tmp_path)).recover(g2, names2)
    assert g2.size == len(acked) == 96
    assert sorted(g2.snapshot()[1][:g2.size].tolist()) == sorted(acked)
    assert names2 == names


@BOTH
def test_checkpoint_read_error_raises_and_quarantines_nothing(pkg, tmp_path):
    p = PKGS[pkg]
    m = p.Metrics()
    inj = p.faults.FaultInjector(seed=0)
    store = p.state.CheckpointStore(str(tmp_path), metrics=m, fault_injector=inj)
    store.save(b"precious", {})
    inj.script("storage", "read_error")
    with pytest.raises(OSError):
        store.load_latest()
    assert m.counter("checkpoint_read_errors") == 1 and m.counter("checkpoints_corrupt") == 0
    assert bytes(store.load_latest()[1]) == b"precious"


@BOTH
def test_recovery_reruns_identically(pkg, tmp_path):
    """Recovery only reads: a restore abandoned half way and run again
    lands on the same gallery."""
    p = PKGS[pkg]
    g = p.gallery()
    st = p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics())
    st.bind(g, [])
    _enroll(st, g, [], "a", n=4, label=0)
    for _ in range(2):
        g2 = p.gallery()
        p.state.StateLifecycle(str(tmp_path), metrics=p.Metrics()).recover(g2, [])
        _assert_same_gallery(g2, g)
