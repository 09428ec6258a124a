"""The port's offline verifier (``apps/verify_checkpoint.py``) against the
reference's ``scripts/verify_checkpoint.py``, loaded by path: equal
verdicts, exit codes and reports (with each failure's message text left
out: the two packages word their exceptions apart) on state dirs written
by either package: sound, a flipped checkpoint byte, a corrupt
acknowledged WAL record, a torn tail, a version fence breached, a torn
registry manifest, an unreadable file (rc 3), an empty dir, model files,
and ``--follow`` over a live tail."""

import importlib.util
import json
import os
import shutil
import threading
import time
import types

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import registry as jax_registry
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu_torch.apps import verify_checkpoint as port_verify
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.runtime import registry as port_registry
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "verify_checkpoint_ref", os.path.join(REPO, "scripts", "verify_checkpoint.py"))
ref_verify = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_verify)

DIM = 8


def _jax_gallery():
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    return JaxGallery(capacity=64, dim=DIM, mesh=mesh)


PKG = {"jax": types.SimpleNamespace(state=jax_state, registry=jax_registry,
                                    gallery=_jax_gallery),
       "port": types.SimpleNamespace(state=port_state, registry=port_registry,
                                     gallery=lambda: PortGallery(64, DIM, device="cpu"))}


def _write_dir(writer, root, n_ckpt=3, n_wal=3):
    """A state dir: enrolments, a checkpoint, more enrolments in the WAL."""
    p = PKG[writer]
    gallery, names = p.gallery(), []
    state = p.state.StateLifecycle(root, checkpoint_wal_rows=1 << 30, checkpoint_every_s=1e9)
    state.bind(gallery, names)
    state.attach_registry(p.registry.ModelRegistry(root))
    rng = np.random.default_rng(0)

    def enroll(i):
        emb = rng.normal(size=(2, DIM)).astype(np.float32)
        lab = np.full(2, i, np.int32)
        names.append(f"s{i}")
        state.append_enrollment(emb, lab, subject=f"s{i}", label=i,
                                apply_fn=lambda: gallery.add(emb, lab))

    for i in range(n_ckpt):
        enroll(i)
    assert state.checkpoint_now(wait=True)
    for i in range(n_ckpt, n_ckpt + n_wal):
        enroll(i)
    return state


def _strip(report):
    """The report without failure message text."""
    if isinstance(report, dict):
        return {k: (None if k in ("reason", "error", "unreadable") and isinstance(v, str)
                    else _strip(v)) for k, v in report.items()}
    if isinstance(report, list):
        return [_strip(v) for v in report]
    return report


def _both(path, *flags, capsys):
    out = {}
    for name, mod in (("ref", ref_verify), ("port", port_verify)):
        rc = mod.main([path, *flags])
        out[name] = (rc, json.loads(capsys.readouterr().out))
    return out


def _ckpt(root):
    d = os.path.join(root, "checkpoints")
    return os.path.join(d, sorted(n for n in os.listdir(d) if n.endswith(".ckpt"))[-1])


def _flip_ckpt_byte(root):
    path = _ckpt(root)
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) - 7)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0x40]))


def _corrupt_acked_record(root):
    """Flip one base64 character of the last enroll record: it still
    parses, its crc32 no longer matches."""
    path = os.path.join(root, "enroll.wal")
    with open(path) as fh:
        lines = fh.read().splitlines()
    rec = json.loads(lines[-1])
    emb = rec["emb"]
    rec["emb"] = ("B" if emb[0] != "B" else "C") + emb[1:]
    lines[-1] = json.dumps(rec)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _torn_tail(root):
    with open(os.path.join(root, "enroll.wal"), "a") as fh:
        fh.write('{"kind": "enroll", "seq": 99, "emb": "AAAA')


def _breach_version_fence(root):
    path = os.path.join(root, "enroll.wal")
    with open(path) as fh:
        lines = fh.read().splitlines()
    rec = json.loads(lines[-1])
    rec["embedder_version"] = 2
    lines[-1] = json.dumps(rec)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _torn_manifest(root):
    path = os.path.join(root, "registry.json")
    with open(path) as fh:
        text = fh.read()
    with open(path, "w") as fh:
        fh.write(text[: len(text) // 2])


def _flip_manifest(root):
    path = os.path.join(root, "registry.json")
    doc = json.load(open(path))
    doc["roles"]["detector"]["version"] = 7
    with open(path, "w") as fh:
        json.dump(doc, fh)


def _unreadable_ckpt(root):
    """A path the sweep cannot read (a directory where a checkpoint is):
    the bytes were never seen, so no verdict on them (rc 3)."""
    os.makedirs(os.path.join(root, "checkpoints", "ckpt-00000099.ckpt"))


def _unreadable_wal(root):
    path = os.path.join(root, "enroll.wal")
    os.remove(path)
    os.makedirs(path)


CASES = {"sound": (None, 0), "flipped_checkpoint_byte": (_flip_ckpt_byte, 2),
         "corrupt_acked_record": (_corrupt_acked_record, 2), "torn_tail": (_torn_tail, 0),
         "version_fence_breached": (_breach_version_fence, 2),
         "torn_manifest": (_torn_manifest, 3), "flipped_manifest": (_flip_manifest, 2),
         "unreadable_checkpoint": (_unreadable_ckpt, 3),
         "unreadable_wal": (_unreadable_wal, 3),
         "unreadable_and_corrupt": (lambda r: (_flip_ckpt_byte(r), _unreadable_ckpt(r)), 2)}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_both_verifiers_agree_on_a_state_dir(tmp_path, capsys, writer, case):
    root = str(tmp_path / "state")
    state = _write_dir(writer, root)
    state.close()
    damage, want_rc = CASES[case]
    if damage is not None:
        damage(root)
    out = _both(root, capsys=capsys)
    assert out["port"][0] == out["ref"][0] == want_rc
    assert _strip(out["port"][1]) == _strip(out["ref"][1])
    if case == "torn_tail":
        assert out["port"][1]["wal"]["torn_lines"] == 1
    if case == "sound":
        assert out["port"][1]["embedder_version"] == 1 and out["port"][1]["wal"][
            "valid_records"] == 3


def test_both_verifiers_agree_on_a_checkpoints_dir_an_empty_dir_and_no_path(tmp_path, capsys):
    root = str(tmp_path / "state")
    _write_dir("port", root).close()
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for path, rc in ((os.path.join(root, "checkpoints"), 0), (empty, 2),
                     (str(tmp_path / "nope"), 2)):
        out = _both(path, capsys=capsys)
        assert out["port"][0] == out["ref"][0] == rc, path
        assert _strip(out["port"][1]) == _strip(out["ref"][1])


def test_both_verifiers_agree_on_model_files(tmp_path, capsys):
    """A CNN model checkpoint (the JAX package's ``save_model`` of seeded
    init params) verifies in both; garbage and a truncated file are
    corrupt in both."""
    from opencv_facerecognizer_tpu.models import classifier as jax_classifier
    from opencv_facerecognizer_tpu.models import embedder as jax_embedder
    from opencv_facerecognizer_tpu.models import model as jax_model
    from opencv_facerecognizer_tpu.ops import distance as jax_distance
    from opencv_facerecognizer_tpu.utils import serialization as jax_serialization

    rng = np.random.default_rng(8)
    model = jax_model.PredictableModel(
        jax_embedder.CNNEmbedding(embed_dim=DIM, input_size=(32, 32), stem_features=8,
                                  stage_features=(8, 16), stage_blocks=(1, 1),
                                  train_steps=0, seed=0),
        jax_classifier.NearestNeighbor(jax_distance.CosineDistance()))
    model.compute((rng.random((4, 32, 32)) * 255).astype(np.float32), np.array([0, 0, 1, 1]))
    good = str(tmp_path / "model.msgpack")
    jax_serialization.save_model(good, model)
    garbage = str(tmp_path / "garbage.msgpack")
    with open(garbage, "wb") as fh:
        fh.write(b"\x00garbage")
    truncated = str(tmp_path / "truncated.msgpack")
    with open(good, "rb") as fh:
        blob = fh.read()
    with open(truncated, "wb") as fh:
        fh.write(blob[: len(blob) // 2])
    for path, rc in ((good, 0), (garbage, 2), (truncated, 2)):
        out = _both(path, capsys=capsys)
        assert out["port"][0] == out["ref"][0] == rc, path
        assert _strip(out["port"][1]) == _strip(out["ref"][1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_followers_see_every_record_of_a_live_tail(tmp_path, writer):
    """``--follow`` over a tail a writer is appending to: both followers,
    running together, see every record past the anchor, and a corrupt
    acknowledged record fails both."""
    root = str(tmp_path / "state")
    state = _write_dir(writer, root, n_ckpt=2, n_wal=1)
    reports = {}

    def follow(name, mod):
        reports[name] = mod.follow_wal(root, duration_s=1.5, poll_s=0.05)

    threads = [threading.Thread(target=follow, args=a)
               for a in (("ref", ref_verify), ("port", port_verify))]
    for t in threads:
        t.start()
    rng = np.random.default_rng(5)
    for i in range(6):
        emb = rng.normal(size=(1, DIM)).astype(np.float32)
        state.append_enrollment(emb, np.full(1, 10 + i, np.int32), subject=f"t{i}",
                                label=10 + i)
        time.sleep(0.05)
    for t in threads:
        t.join(30)
    ref, port = reports["ref"], reports["port"]
    assert set(port) == set(ref)
    for key in ("ok", "anchor_wal_seq", "valid_records", "valid_rows", "corrupt_records",
                "aborted_records", "anchor_covered", "reanchors", "torn_lines", "wal_reopens",
                "final_seq"):
        assert port[key] == ref[key], key
    assert port["ok"] and port["valid_records"] == 7
    state.close()
    broken = str(tmp_path / "broken")
    shutil.copytree(root, broken)
    _corrupt_acked_record(broken)
    for mod in (ref_verify, port_verify):
        report = mod.follow_wal(broken, duration_s=0.0)
        assert not report["ok"] and report["corrupt_records"] == 1


def test_the_verifier_runs_as_a_module(tmp_path):
    import subprocess
    import sys

    root = str(tmp_path / "state")
    _write_dir("port", root).close()
    proc = subprocess.run([sys.executable, "-m",
                           "opencv_facerecognizer_tpu_torch.apps.verify_checkpoint", root,
                           "--follow", "--duration", "0.2"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["valid_records"] == 3
