"""The port's CLI (``opencv_facerecognizer_tpu_torch.apps.recognize``)
against the JAX package's ``ocvf-recognize``, and its serving runtime's
failure handling.

The checkpoints are the JAX package's own: ``save_model`` of a
``CNNEmbedding`` model from seeded init params (``train_steps=0``) and
``CNNFaceDetector.save`` of seeded init params (the heatmap bias raised
from -4 so the untrained detector reports faces, the size bias raised so
the boxes are wide enough to crop). The gallery directory mixes PGM (the
native loader) and PNG (cv2) images; the frames are synthetic scenes.

Both CLIs run in float32 (``f32_stacks``): the checkpoints carry no
compute dtype, and in bf16 XLA's fusions and the port's eager ops round at
other points (test_torch_pipeline.py), so parity is held in f32.
Tolerances are test_torch_pipeline.py's: labels and names equal, boxes
within 1e-3 px, sims within 2e-3.
"""

import functools
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.apps import recognize as jax_app
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.models.classifier import NearestNeighbor
from opencv_facerecognizer_tpu.models.model import PredictableModel
from opencv_facerecognizer_tpu.ops.distance import CosineDistance
from opencv_facerecognizer_tpu.utils import serialization as jax_serialization
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_faces, make_synthetic_scenes
from opencv_facerecognizer_tpu_torch.apps import recognize as port_app
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector, encode_frame
from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
    CONTROL_TOPIC, FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC, RecognizerService)
from opencv_facerecognizer_tpu_torch.runtime.resilience import ResiliencePolicy
from opencv_facerecognizer_tpu_torch.utils import metrics as mn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_ATOL = 1e-3
SIM_ATOL = 2e-3
FRAME = 64
DET = dict(features=(8, 16), head_features=16, max_faces=4, space_to_depth=2)
EMB = dict(embed_dim=32, input_size=(32, 32), stem_features=8, stage_features=(8, 16),
           stage_blocks=(2, 1), train_steps=0)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("cli")
    X, y, names = make_synthetic_faces(3, 3, (32, 32), seed=5)
    gallery = root / "gallery"
    for i, (img, label) in enumerate(zip(X, y)):
        (gallery / names[label]).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(gallery / names[label] / f"{i}{'.pgm' if i % 2 else '.png'}"),
                    img.astype(np.uint8))
    model = PredictableModel(jax_embedder.CNNEmbedding(**EMB), NearestNeighbor(CosineDistance()))
    model.compute(X, y)
    jax_serialization.save_model(str(root / "model.ckpt"), model)
    det = jax_detector.CNNFaceDetector(**DET)
    params = jax.tree_util.tree_map(np.asarray, det.net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, FRAME, FRAME)))["params"])
    nb = 2 * len(DET["features"])
    params[f"Conv_{nb + 1}"]["bias"] = np.zeros_like(params[f"Conv_{nb + 1}"]["bias"])
    params[f"Conv_{nb + 2}"]["bias"] = np.full_like(params[f"Conv_{nb + 2}"]["bias"], 3.0)
    det.load_params(params)
    det.save(str(root / "det.ckpt"))
    frames = root / "frames"
    frames.mkdir()
    scenes, _, _ = make_synthetic_scenes(5, (FRAME, FRAME), max_faces=2, seed=7)
    for i, scene in enumerate(scenes):
        cv2.imwrite(str(frames / f"f{i}.png"), scene.astype(np.uint8))
    return dict(root=root, model=str(root / "model.ckpt"), det=str(root / "det.ckpt"),
                gallery=str(gallery), frames=str(frames), names=names,
                scenes=scenes.astype(np.uint8))


@pytest.fixture
def f32_stacks(monkeypatch):
    """Both packages build their nets in float32 (module docstring)."""
    monkeypatch.setattr(jax_detector, "DetectorNet",
                        functools.partial(jax_detector.DetectorNet, dtype=jnp.float32))
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
    monkeypatch.setattr(port_embedder, "FaceEmbedNet",
                        functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))

    class F32Detector(port_detector.CNNFaceDetector):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "dtype": torch.float32})

    monkeypatch.setattr(port_detector, "CNNFaceDetector", F32Detector)


def _common_args(a):
    return ["--model", a["model"], "--detector", a["det"], "--gallery", a["gallery"],
            "--frame-size", str(FRAME), str(FRAME), "--batch-size", "8",
            "--similarity-threshold", "0.0", "--capacity", "64"]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _assert_same_results(got, want, key, sim_atol=SIM_ATOL):
    """Per frame (keyed by ``key(meta)``): face counts, labels and names
    equal; boxes and sims within the tolerances."""
    got = {key(r["meta"]): r for r in got}
    want = {key(r["meta"]): r for r in want}
    assert sorted(got) == sorted(want) and len(got) >= 5
    n_faces = 0
    for k, w in want.items():
        g = got[k]
        assert len(g["faces"]) == len(w["faces"]), k
        for gf, wf in zip(g["faces"], w["faces"]):
            assert (gf["label"], gf["name"]) == (wf["label"], wf["name"]), k
            np.testing.assert_allclose(gf["box"], wf["box"], atol=BOX_ATOL)
            assert abs(gf["similarity"] - wf["similarity"]) <= sim_atol
            n_faces += 1
    assert n_faces >= 5


def test_dir_mode_matches_jax_cli(artifacts, f32_stacks, capsys):
    a = artifacts
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"]]
    assert jax_app.main(argv) == 0
    want = _json_lines(capsys.readouterr().out)
    assert port_app.main(argv + ["--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert sorted(r["meta"]["file"] for r in got) == [f"f{i}.png" for i in range(5)]
    _assert_same_results(got, want, key=lambda m: m["file"])
    assert {f["name"] for r in got for f in r["faces"]} <= set(a["names"])


@pytest.mark.parametrize("variant", [dict(space_to_depth=2), dict(norm="light", block="dense")])
def test_dir_mode_with_an_embedder_variant_matches_jax_cli(variant, artifacts, f32_stacks,
                                                          tmp_path, capsys):
    """A JAX-written checkpoint of an embedder variant (ROADMAP A.9) serves
    in the port's CLI as in the reference's; with ``--fused-embedder`` a
    dense or light embedder is refused, as the reference's ``fused_forward``
    refuses it (held to it in tests/test_torch_embedder_variants.py)."""
    a = dict(artifacts)
    X, y, _names = make_synthetic_faces(3, 3, (32, 32), seed=5)
    model = PredictableModel(jax_embedder.CNNEmbedding(**EMB, **variant),
                             NearestNeighbor(CosineDistance()))
    model.compute(X, y)
    a["model"] = str(tmp_path / "variant.ckpt")
    jax_serialization.save_model(a["model"], model)
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"]]
    assert jax_app.main(argv) == 0
    want = _json_lines(capsys.readouterr().out)
    assert port_app.main(argv + ["--device", "cpu"]) == 0
    _assert_same_results(_json_lines(capsys.readouterr().out), want, key=lambda m: m["file"])
    if "block" in variant:
        with pytest.raises(ValueError, match="covers"):
            port_app.main(argv + ["--fused-embedder", "--device", "cpu"])


def test_dir_mode_through_the_ivf_match(artifacts, f32_stacks, capsys):
    """``--match-mode ivf`` builds the quantizer at start and serves two
    stage; probing every cell (nprobe = nlist) it finds what the exact
    scan finds. Its sims come from the rows quantized to int8 and
    dequantized to bf16 (the reference's rerank too): within 1e-2."""
    from opencv_facerecognizer_tpu_torch.ops.ivf_match import ivf_match_topk

    a = artifacts
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--device", "cpu"]
    assert port_app.main(argv + ["--match-mode", "exact"]) == 0
    exact = _json_lines(capsys.readouterr().out)
    calls = ivf_match_topk.calls
    assert port_app.main(argv + ["--match-mode", "ivf", "--ivf-nlist", "2",
                                 "--ivf-nprobe", "2"]) == 0
    assert ivf_match_topk.calls > calls
    _assert_same_results(_json_lines(capsys.readouterr().out), exact, key=lambda m: m["file"],
                         sim_atol=1e-2)


def test_metrics_jsonl_records(artifacts, tmp_path, capsys):
    """``--metrics-jsonl`` gets the loader's ``startup`` record (its own
    load and embed seconds), the dir replay's and, at shutdown, the ledger
    and the summary (the reference's sink gets none: ROADMAP C.6)."""
    a = artifacts
    sink = tmp_path / "metrics.jsonl"
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--device", "cpu",
                              "--metrics-jsonl", str(sink)]
    assert port_app.main(argv) == 0
    capsys.readouterr()
    records = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [r["event"] for r in records] == ["startup", "dir_replay", "shutdown"]
    startup, replay, shutdown = records
    assert startup["gallery_images"] == 9 and startup["gallery_subjects"] == 3
    assert startup["checkpoint_load_s"] > 0 and startup["gallery_embed_s"] > 0
    assert (replay["files"], replay["answered"]) == (5, 5) and replay["seconds"] > 0
    assert shutdown["ledger"]["completed"] == 5 and shutdown["ledger"]["in_system"] == 0
    assert shutdown["summary"]["frames_completed"] == 5
    assert startup["ts"] <= replay["ts"] <= shutdown["ts"]


def _run_jsonl(main, argv, stdin_text, monkeypatch, capsys):
    """``main`` in jsonl mode on a worker thread with ``stdin_text`` as
    stdin (EOF ends it); returns the parsed stdout lines."""
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    box = {}
    thread = threading.Thread(target=lambda: box.update(rc=main(argv)), daemon=True)
    thread.start()
    thread.join(timeout=300)
    assert not thread.is_alive(), "jsonl mode did not end on stdin EOF"
    assert box["rc"] == 0
    return _json_lines(capsys.readouterr().out)


def test_jsonl_stdin_eof_drains_every_frame_like_jax(artifacts, f32_stacks, monkeypatch,
                                                     capsys):
    """Frames on stdin, a stats request, then EOF on a last line without a
    newline: every frame is answered, as the JAX CLI answers it."""
    a = artifacts
    n = 7
    lines = [json.dumps({"topic": FRAME_TOPIC,
                         "data": {**encode_frame(a["scenes"][i % 5].astype(np.float32)),
                                  "meta": {"seq": i}}}) for i in range(n)]
    stdin_text = "\n".join(lines + [json.dumps({"topic": CONTROL_TOPIC,
                                                "data": {"cmd": "stats"}})])
    argv = _common_args(a) + ["--source", "jsonl"]
    want = _run_jsonl(jax_app.main, argv, stdin_text, monkeypatch, capsys)
    got = _run_jsonl(port_app.main, argv + ["--device", "cpu"], stdin_text, monkeypatch,
                     capsys)
    results = [m["data"] for m in got if m["topic"] == RESULT_TOPIC]
    assert sorted(r["meta"]["seq"] for r in results) == list(range(n))
    _assert_same_results(results, [m["data"] for m in want if m["topic"] == RESULT_TOPIC],
                         key=lambda m: m["seq"])
    stats = [m["data"] for m in got if m["topic"] == STATUS_TOPIC
             and m["data"]["status"] == "stats"]
    assert len(stats) == 1 and stats[0]["gallery_size"] == 9


def test_enroll_over_jsonl_adds_a_name(artifacts):
    """``python -m`` the port's CLI on the CPU, stdin a pipe: an enroll
    command and frames of one scene; once ``enrolled`` is published, later
    frames of the same scene come back with the new name."""
    a = artifacts
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
           "--device", "cpu", *_common_args(a), "--source", "jsonl", "--flush-ms", "5",
           "--no-track-cache"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    out = []

    def read():
        for line in proc.stdout:
            out.append(json.loads(line))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    def send(topic, data):
        proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
        proc.stdin.flush()

    def frame(seq):
        return {**encode_frame(a["scenes"][0]), "meta": {"seq": seq}}

    try:
        send(CONTROL_TOPIC, {"cmd": "enroll", "subject": "newcomer", "count": 2})
        for seq in range(3):
            send(FRAME_TOPIC, frame(seq))
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not any(
                m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled" for m in out):
            time.sleep(0.05)
        for seq in range(3, 6):
            send(FRAME_TOPIC, frame(seq))
        proc.stdin.close()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    reader.join(timeout=10)
    statuses = [m["data"] for m in out if m["topic"] == STATUS_TOPIC]
    enrolled = [s for s in statuses if s["status"] == "enrolled"]
    assert enrolled and enrolled[0]["subject"] == "newcomer"
    assert enrolled[0]["label"] == 3 and enrolled[0]["gallery_size"] == 11
    results = {m["data"]["meta"]["seq"]: m["data"] for m in out if m["topic"] == RESULT_TOPIC}
    assert sorted(results) == list(range(6))
    assert all("newcomer" in {f["name"] for f in results[s]["faces"]} for s in range(3, 6))


def test_socket_source_serves_a_jax_client_until_sigterm(artifacts):
    """``--source socket --port 0``: a JAX-package ``SocketConnector``
    client sends frames and gets one result each; SIGTERM drains and the
    process exits 0."""
    import re
    import signal

    from opencv_facerecognizer_tpu.runtime.connector import SocketConnector

    a = artifacts
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
           "--device", "cpu", *_common_args(a), "--source", "socket", "--port", "0"]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    client = None
    try:
        port = None
        for line in proc.stderr:
            match = re.match(r"serving on [\d.]+:(\d+)", line)
            if match:
                port = int(match.group(1))
                break
        assert port, "the CLI did not report its port"
        client = SocketConnector(port=port, listen=False, reconnect_attempts=0)
        got = []
        client.subscribe(RESULT_TOPIC, lambda _t, m: got.append(m))
        client.start()
        for i in range(5):
            client.publish(FRAME_TOPIC, {**encode_frame(a["scenes"][i]), "meta": {"seq": i}})
        deadline = time.monotonic() + 120
        while len(got) < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sorted(m["meta"]["seq"] for m in got) == list(range(5))
        assert all(m["faces"] for m in got)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "'in_system': 0.0" in proc.stderr.read()
    finally:
        if client is not None:
            client.stop()
        if proc.poll() is None:
            proc.kill()


class _FlakyPipeline:
    """Answers every frame with one empty packed row (CPU), after raising
    ``error`` on its first ``failures`` calls."""

    top_k = 1
    face_size = (8, 8)

    def __init__(self, failures, error="backend UNAVAILABLE: tunnel down"):
        self.failures = failures
        self.error = error
        self.calls = 0

    def recognize_batch_packed(self, frames):
        self.calls += 1
        if self.calls <= self.failures:
            raise RuntimeError(self.error)
        return torch.zeros((len(frames), 4, 8))

    def prewarm_batch_shapes(self, sizes, frame_shape, dtype):
        return len(sizes)


def _serve(pipeline, n, flush_timeout=0.01, **kw):
    """``n`` frames through a service of batch size 4. A short flush
    timeout may split them into partial batches; a long one (1 s) makes
    the batches the frames' groups of 4, in order, however slowly a
    loaded machine delivers them."""
    conn = FakeConnector()
    service = RecognizerService(pipeline, conn, batch_size=4, frame_shape=(8, 8),
                                flush_timeout=flush_timeout, bucket_sizes=(), **kw)
    service.start()
    try:
        for i in range(n):
            conn.inject(FRAME_TOPIC, {"frame": np.full((8, 8), i, np.uint8), "meta": i})
            time.sleep(0.002)
        assert service.drain(timeout=30)
    finally:
        service.stop()
    return conn, service


def test_unavailable_dispatch_retries_then_degrades_and_recovers():
    """Four failures of an outage-shaped error: the batch is retried with
    backoff (no frame lost), degraded mode is published once the failures
    reach ``degraded_after``, recovered on the next success."""
    policy = ResiliencePolicy(dispatch_retries=5, degraded_after=3, backoff_base_s=0.001,
                              backoff_max_s=0.002)
    conn, service = _serve(_FlakyPipeline(failures=4), 8, resilience=policy)
    statuses = [m["status"] for m in conn.messages(STATUS_TOPIC)]
    assert statuses == ["degraded", "recovered"]
    c = service.metrics.counters()
    assert c[mn.DISPATCH_FAILURES] == 4 and c[mn.DISPATCH_RETRIES] == 4
    assert c[mn.DEGRADED_TRANSITIONS] == 1 and c[mn.DEGRADED_RECOVERIES] == 1
    assert sorted(r["meta"] for r in conn.messages(RESULT_TOPIC)) == list(range(8))
    assert service.ledger()["in_system"] == 0 and service.ledger()["completed"] == 8


@pytest.mark.parametrize("error, retried", [("backend UNAVAILABLE", True),
                                            ("shape mismatch", False)])
def test_exhausted_or_permanent_dispatch_abandons_the_batch(error, retried):
    """Retries spent (transient) or a permanent error at once: the batch's
    frames land in ``frames_failed`` and the ledger still closes."""
    policy = ResiliencePolicy(dispatch_retries=2, degraded_after=100, backoff_base_s=0.001)
    pipeline = _FlakyPipeline(failures=3 if retried else 1, error=error)
    # the four frames must form one batch: the failures are counted per batch
    conn, service = _serve(pipeline, 4, flush_timeout=1.0, resilience=policy)
    c = service.metrics.counters()
    assert c[mn.BATCHES_FAILED] == 1 and c[mn.FRAMES_FAILED] == 4
    assert c.get(mn.DISPATCH_RETRIES, 0) == (2 if retried else 0)
    assert not conn.messages(RESULT_TOPIC)
    ledger = service.ledger()
    assert ledger["drops_by_reason"] == {mn.FRAMES_FAILED: 4.0} and ledger["in_system"] == 0


class _StuckReadback:
    """A readback that never becomes ready (a hung device copy)."""

    pending = True

    def __init__(self):
        self._never = threading.Event()

    def ready(self):
        return False

    def wait(self):
        self._never.wait()

    def result(self):
        raise AssertionError("a stuck readback is never materialized")


@pytest.mark.parametrize("worker", [True, False])
def test_readback_past_deadline_dead_letters(monkeypatch, worker):
    """The first batch's readback hangs: it is dead-lettered at the
    deadline (with its frames' metas on the status topic) and the next
    batches publish."""
    service_cls_start = RecognizerService._start_readback
    stuck = {"left": 1}

    def start_readback(self, packed):
        if stuck["left"]:
            stuck["left"] -= 1
            return _StuckReadback()
        return service_cls_start(self, packed)

    monkeypatch.setattr(RecognizerService, "_start_readback", start_readback)
    policy = ResiliencePolicy(readback_deadline_s=0.3)
    conn, service = _serve(_FlakyPipeline(failures=0), 8, resilience=policy,
                           readback_worker=worker)
    dead = [m for m in conn.messages(STATUS_TOPIC) if m["status"] == "dead_letter"]
    assert len(dead) == 1 and dead[0]["frames"] >= 1
    published = sorted(r["meta"] for r in conn.messages(RESULT_TOPIC))
    assert sorted(published + dead[0]["frame_ids"]) == list(range(8))
    c = service.metrics.counters()
    assert c[mn.BATCHES_DEAD_LETTERED] == 1
    assert c[mn.FRAMES_DEAD_LETTERED] == dead[0]["frames"]
    assert service.ledger()["in_system"] == 0


def _refused_argv(parser, flag, value):
    action = next(a for a in parser._actions if flag in a.option_strings)
    if value is not None:
        return [flag, value]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, next(c for c in action.choices if c != action.default)]
    if action.nargs == 2:
        return [flag, "7", "8"]
    return [flag, "7"]


# ---------- pipeline parallelism (ROADMAP A.11) ----------

PP_REFUSALS = {"fused_embedder": ["--fused-embedder"],
               "match_mode_ivf": ["--match-mode", "ivf"],
               "cascade": ["--cascade", "gate.params"],
               "one_device": []}


@pytest.mark.parametrize("case", sorted(PP_REFUSALS))
def test_parallel_pp_refuses_like_the_reference(artifacts, monkeypatch, tmp_path, case):
    """The reference's four ``--parallel pp`` refusals, word for word: the
    three flags that are single-mesh only, and a host with one device
    (the port's ``--device cpu``; the reference's devices cut to one).
    The port refuses each before any checkpoint loads: its paths here do
    not exist."""
    a = artifacts
    extra = ["--parallel", "pp", "--source", "dir", "--dir", a["frames"]] + PP_REFUSALS[case]
    monkeypatch.setattr(jax, "devices", lambda *args: jax.local_devices()[:1])
    with pytest.raises(SystemExit) as want:
        jax_app.main(_common_args(a) + extra)
    missing = str(tmp_path / "missing")
    argv = ["--model", missing, "--detector", missing, "--gallery", missing, "--device", "cpu"]
    with pytest.raises(SystemExit) as got:
        port_app.main(argv + extra)
    assert str(got.value) == str(want.value)
    assert "parallel fused" in str(got.value)
    if case == "one_device":
        assert "needs an even device count >= 2 (have 1)" in str(got.value)


def test_parallel_pp_jsonl_matches_jax_cli(artifacts, f32_stacks, monkeypatch, capsys):
    """``--parallel pp`` served: the port's device count set to 8 CPU slots
    (the reference's 8 virtual devices), so both CLIs split (4, 2) into
    two (2, 2) stage meshes; every frame is answered as the JAX CLI
    answers it, and the gallery lives on the second half."""
    a = artifacts
    monkeypatch.setattr(port_app, "_mesh_devices", lambda device: [torch.device("cpu")] * 8)
    built = []
    real_load = port_app._load_stack

    def load(args, metrics):
        pipeline, names = real_load(args, metrics)
        built.append(pipeline)
        return pipeline, names

    monkeypatch.setattr(port_app, "_load_stack", load)
    n = 7
    lines = [json.dumps({"topic": FRAME_TOPIC,
                         "data": {**encode_frame(a["scenes"][i % 5].astype(np.float32)),
                                  "meta": {"seq": i}}}) for i in range(n)]
    argv = _common_args(a) + ["--source", "jsonl", "--parallel", "pp"]
    want = _run_jsonl(jax_app.main, argv, "\n".join(lines), monkeypatch, capsys)
    got = _run_jsonl(port_app.main, argv + ["--device", "cpu"], "\n".join(lines),
                     monkeypatch, capsys)
    results = [m["data"] for m in got if m["topic"] == RESULT_TOPIC]
    assert sorted(r["meta"]["seq"] for r in results) == list(range(n))
    _assert_same_results(results, [m["data"] for m in want if m["topic"] == RESULT_TOPIC],
                         key=lambda m: m["seq"])
    (pipeline,) = built
    assert type(pipeline).__name__ == "TwoStagePipeline"
    assert pipeline.mesh_a.shape == pipeline.mesh_b.shape == {"dp": 2, "tp": 2}
    assert [s.id for s in pipeline.mesh_b.devices.flat] == [4, 5, 6, 7]
    assert pipeline.gallery.mesh is pipeline.mesh_b


def test_parallel_pp_is_served_not_refused():
    action = next(a for a in port_app.build_parser()._actions
                  if "--parallel" in a.option_strings)
    assert action.choices == ["fused", "pp"] and "refused" not in action.help
    assert port_app.build_parser().parse_args(["--parallel", "pp"]).parallel == "pp"
    assert port_app.pp_layout(8) == (4, 2) and port_app.pp_layout(4) == (4, 1)


def test_every_reference_flag_parses_with_its_default():
    """Any reference command line parses: every flag of the JAX CLI exists
    with the same default and choices."""
    ref = {a.dest: a for a in jax_app.build_parser()._actions if a.option_strings}
    port = {a.dest: a for a in port_app.build_parser()._actions if a.option_strings}
    assert set(ref) <= set(port)
    for dest, a in ref.items():
        p = port[dest]
        assert (p.option_strings, p.nargs, p.choices) == (a.option_strings, a.nargs,
                                                           a.choices), dest
        same = p.default == a.default or (isinstance(a.default, (list, tuple))
                                          and list(p.default) == list(a.default))
        assert same, dest
    assert port["device"].default == "cuda"


def test_cli_without_a_card_raises(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_app.main(_common_args(artifacts) + ["--source", "dir", "--dir",
                                                 artifacts["frames"]])


def test_adaptive_flush_deadline_matches_jax():
    """``--target-latency-ms``: the batcher's deadline is the target less
    an EWMA of the reported service time, clamped to [2 ms, flush], as the
    reference's batcher computes it."""
    from opencv_facerecognizer_tpu.runtime.batcher import FrameBatcher as JaxBatcher
    from opencv_facerecognizer_tpu_torch.runtime.batcher import FrameBatcher

    jax_b = JaxBatcher(4, (8, 8), 0.03, target_latency_s=0.02)
    port_b = FrameBatcher(4, (8, 8), 0.03, target_latency_s=0.02)
    for seconds in (0.001, 0.004, 0.03, -1.0, 0.015, 0.0):
        jax_b.report_service_time(seconds)
        port_b.report_service_time(seconds)
        assert port_b.current_flush_deadline() == pytest.approx(jax_b.current_flush_deadline())
    assert FrameBatcher(4, (8, 8), 0.03).current_flush_deadline() == 0.03


class _OneFacePipeline(_FlakyPipeline):
    """Every frame: one valid face, gallery label 2 at similarity 0.9."""

    def recognize_batch_packed(self, frames):
        packed = torch.zeros((len(frames), 4, 8))
        packed[:, 0] = torch.tensor([10.0, 10.0, 50.0, 50.0, 0.8, 1.0, 2.0, 0.9])
        return packed


def test_identity_cache_settles_coherent_frames_as_cached():
    """One camera stream, the same scene: after the track is confirmed the
    frames are answered from the cache (``completed_cached``, ``exit:
    track_cache``) except the scheduled re-verifies; every frame answered
    once, the ledger closes."""
    from opencv_facerecognizer_tpu_torch.runtime.tracker import IdentityTracker, TrackerConfig

    conn = FakeConnector()
    tracker = IdentityTracker(TrackerConfig(reverify_frames=4), metrics=mn.Metrics())
    service = RecognizerService(_OneFacePipeline(0), conn, batch_size=1, frame_shape=(64, 64),
                                flush_timeout=0.001, bucket_sizes=(), tracker=tracker,
                                subject_names=["a", "b", "carol"])
    scene = np.random.default_rng(0).integers(0, 256, (64, 64)).astype(np.uint8)
    service.start()
    try:
        for i in range(12):
            conn.inject(FRAME_TOPIC, {"frame": scene, "meta": {"stream": "cam", "i": i}})
            assert service.drain(timeout=10)  # one frame at a time: a video stream
    finally:
        service.stop()
    results = conn.messages(RESULT_TOPIC)
    assert [r["meta"]["i"] for r in results] == list(range(12))
    cached = [r for r in results if r.get("exit") == "track_cache"]
    assert 0 < len(cached) < 12
    assert all(r["faces"][0]["name"] == "carol" for r in results)
    ledger = service.ledger()
    assert ledger["completed_cached"] == len(cached)
    assert ledger["completed"] + ledger["completed_cached"] == 12 and ledger["in_system"] == 0


# ---------- --state-dir (durable state) ----------

def _start_state_cli(a, state_dir):
    """The port's CLI in a subprocess, jsonl mode over a pipe, with
    ``--state-dir``; stdout lines are collected as they come."""
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
           "--device", "cpu", *_common_args(a), "--source", "jsonl", "--flush-ms", "5",
           "--no-track-cache", "--state-dir", state_dir]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO))
    out = []
    threading.Thread(target=lambda: out.extend(json.loads(line) for line in proc.stdout),
                     daemon=True).start()
    return proc, out


def _send(proc, topic, data):
    proc.stdin.write(json.dumps({"topic": topic, "data": data}) + "\n")
    proc.stdin.flush()


def _enrol_until_acknowledged(proc, out, a, subject):
    _send(proc, CONTROL_TOPIC, {"cmd": "enroll", "subject": subject, "count": 2})
    for seq in range(3):
        _send(proc, FRAME_TOPIC, {**encode_frame(a["scenes"][0]), "meta": {"seq": seq}})
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled" for m in out):
            return
        assert proc.poll() is None, proc.stderr.read()
        time.sleep(0.05)
    raise AssertionError("no 'enrolled' status")


def _restart_in_process(a, state_dir, monkeypatch, capsys):
    """The CLI again on the same dir, in-process: frames of the enrolled
    scene and EOF; returns (names per frame, stderr)."""
    lines = [json.dumps({"topic": FRAME_TOPIC,
                         "data": {**encode_frame(a["scenes"][0]), "meta": {"seq": i}}})
             for i in range(2)]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    argv = ["--device", "cpu", *_common_args(a), "--source", "jsonl", "--no-track-cache",
            "--state-dir", state_dir]
    assert port_app.main(argv) == 0
    captured = capsys.readouterr()
    results = [m["data"] for m in _json_lines(captured.out) if m["topic"] == RESULT_TOPIC]
    assert len(results) == 2
    return [{f["name"] for f in r["faces"]} for r in results], captured.err


def test_state_dir_sigterm_checkpoints_and_the_restart_names_the_subject(
        artifacts, tmp_path, monkeypatch, capsys):
    """Enrol, SIGTERM: the CLI drains, takes its final checkpoint and exits
    0 with a clean report; restarted, it recovers that checkpoint with
    nothing to replay and still names the subject."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    proc, out = _start_state_cli(a, state_dir)
    try:
        _enrol_until_acknowledged(proc, out, a, "newcomer")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    assert "final checkpoint: written" in err and "shutdown: clean" in err
    names, err2 = _restart_in_process(a, state_dir, monkeypatch, capsys)
    assert all("newcomer" in n for n in names)
    assert "'replayed_records': 0" in err2 and "ckpt-00000002.ckpt" in err2


def test_state_dir_sigkill_restart_replays_the_wal_and_a_second_writer_fails(
        artifacts, tmp_path, monkeypatch, capsys):
    """Enrol, then SIGKILL after ``enrolled``: the restart names the subject
    through WAL replay. While the first writer lives, a second writer on
    the same dir exits naming the lease, before it loads anything."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    proc, out = _start_state_cli(a, state_dir)
    try:
        _enrol_until_acknowledged(proc, out, a, "newcomer")
        argv = ["--device", "cpu", *_common_args(a), "--source", "jsonl",
                "--state-dir", state_dir]
        with pytest.raises(SystemExit, match="writer lease .* is held"):
            port_app.main(argv)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    names, err = _restart_in_process(a, state_dir, monkeypatch, capsys)
    assert all("newcomer" in n for n in names)
    assert "'replayed_records': 1" in err and "ckpt-00000001.ckpt" in err


def test_both_clis_on_one_state_dir_in_turn(artifacts, f32_stacks, tmp_path, capsys):
    """The JAX CLI, then the port's, then the JAX CLI again, on one state
    dir (dir mode): each recovers the checkpoint the other wrote at its
    shutdown and answers every frame as the JAX CLI does."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--state-dir", state_dir]
    runs = []
    for main, extra in ((jax_app.main, []), (port_app.main, ["--device", "cpu"]),
                        (jax_app.main, [])):
        assert main(argv + extra) == 0
        captured = capsys.readouterr()
        runs.append((_json_lines(captured.out), captured.err))
    (jax1, _e1), (port, port_err), (jax2, jax2_err) = runs
    # the JAX CLI's first run checkpoints the fresh dir (1) and shuts down (2)
    assert "ckpt-00000002.ckpt" in port_err and "shutdown: clean" in port_err
    assert "ckpt-00000003.ckpt" in jax2_err
    _assert_same_results(port, jax1, key=lambda m: m["file"])
    _assert_same_results(jax2, jax1, key=lambda m: m["file"])
    assert sorted(os.listdir(os.path.join(state_dir, "checkpoints"))) == [
        "ckpt-00000002.ckpt", "ckpt-00000003.ckpt", "ckpt-00000004.ckpt"]


DURABILITY_FLAGS = ["--state-dir", "--checkpoint-every-s", "--checkpoint-wal-rows",
                    "--keep-checkpoints", "--disk-low-watermark", "--durability-probe-s",
                    "--supervised", "--probe-on-degraded"]


@pytest.mark.parametrize("flag", DURABILITY_FLAGS)
def test_durability_flag_is_served_with_the_reference_default(flag):
    parser = port_app.build_parser()
    args = parser.parse_args(_refused_argv(parser, flag, None))
    ref = {a.dest: a.default for a in jax_app.build_parser()._actions}
    dest = flag.lstrip("-").replace("-", "_")
    assert parser.get_default(dest) == ref[dest]


def test_async_grow_enrolls_past_capacity(artifacts):
    """``--async-grow`` is served: an enrolment of 10 crops into a gallery
    of 9 rows at capacity 18 overflows the tier, ``enrolled`` comes back
    without waiting for the grow, and once the rows land (the grow worker,
    off the serving thread) frames of that scene come back named."""
    a = artifacts
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
           "--device", "cpu", *_common_args(a), "--source", "jsonl", "--flush-ms", "5",
           "--no-track-cache", "--async-grow", "--capacity", "8"]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO))
    out = []
    reader = threading.Thread(
        target=lambda: out.extend(json.loads(line) for line in proc.stdout), daemon=True)
    reader.start()

    def named(seq):
        return any(m["topic"] == RESULT_TOPIC and m["data"]["meta"]["seq"] == seq
                   and "newcomer" in {f["name"] for f in m["data"]["faces"]} for m in out)

    try:
        _send(proc, CONTROL_TOPIC, {"cmd": "enroll", "subject": "newcomer", "count": 10})
        seq = 0
        deadline = time.monotonic() + 120
        while not any(m["topic"] == STATUS_TOPIC and m["data"]["status"] == "enrolled"
                      for m in out):
            assert time.monotonic() < deadline and proc.poll() is None, "no 'enrolled'"
            _send(proc, FRAME_TOPIC, {**encode_frame(a["scenes"][0]), "meta": {"seq": seq}})
            seq += 1
            time.sleep(0.05)
        first_after = seq
        while not named(seq - 1) or seq == first_after:
            assert time.monotonic() < deadline and proc.poll() is None, "never named"
            _send(proc, FRAME_TOPIC, {**encode_frame(a["scenes"][0]), "meta": {"seq": seq}})
            seq += 1
            time.sleep(0.05)
        _send(proc, CONTROL_TOPIC, {"cmd": "stats"})
        proc.stdin.close()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    reader.join(timeout=10)
    statuses = [m["data"] for m in out if m["topic"] == STATUS_TOPIC]
    enrolled = [s for s in statuses if s["status"] == "enrolled"]
    assert len(enrolled) == 1 and enrolled[0]["label"] == 3
    stats = [s for s in statuses if s["status"] == "stats"]
    assert stats and stats[-1]["gallery_size"] == 19
    results = {m["data"]["meta"]["seq"] for m in out if m["topic"] == RESULT_TOPIC}
    assert results == set(range(seq))


# ---------- overload control and observability (ROADMAP A.8.2, A.8.4) ----------

OVERLOAD_OBSERVE_FLAGS = [
    "--max-inflight-frames", "--rate-limit-fps", "--brownout-queue-wait-ms",
    "--shed-stale-after-ms", "--dead-letter-journal", "--journal-fsync",
    "--trace-sample", "--trace-ring", "--trace-jsonl", "--flight-dir", "--expo-port", "--slo",
    "--slo-interval-s", "--slo-e2e-p99-ms", "--slo-queue-wait-p99-ms",
    "--slo-completion-target", "--slo-durability-rows", "--slo-windows", "--slo-loop-stale-s",
    "--profile-dir", "--profile-batches"]


@pytest.mark.parametrize("flag", OVERLOAD_OBSERVE_FLAGS)
def test_overload_flag_is_served_with_the_reference_default(flag):
    parser = port_app.build_parser()
    args = parser.parse_args(_refused_argv(parser, flag, None))
    ref = {a.dest: a.default for a in jax_app.build_parser()._actions}
    dest = flag.lstrip("-").replace("-", "_")
    got, want = parser.get_default(dest), ref[dest]
    assert got == want or list(got) == list(want)
    action = next(a for a in parser._actions if flag in a.option_strings)
    assert action.help and "refused" not in action.help


def test_refused_keeps_only_the_items_still_to_come():
    """Nothing is refused any more: no flag's help names a refusal, and
    the table of refused flags is gone with its last entry."""
    assert not hasattr(port_app, "REFUSED") and not hasattr(port_app, "refuse_unported")
    assert not [a for a in port_app.build_parser()._actions
                if a.help and "refused:" in a.help]
    assert len(OVERLOAD_OBSERVE_FLAGS) == 21 and len(set(OVERLOAD_OBSERVE_FLAGS)) == 21
    assert len(REPLICATION_FLAGS) == 10 and len(set(REPLICATION_FLAGS)) == 10


# ---------- replication and the router (ROADMAP A.8.6) ----------

REPLICATION_FLAGS = ["--replica-role", "--replica-poll-ms", "--replication-lag-rows",
                     "--router", "--router-health", "--router-budget-fps", "--router-writer",
                     "--router-link-deadline-s", "--router-hedge-deadline-s",
                     "--router-dedup-window"]


@pytest.mark.parametrize("flag", REPLICATION_FLAGS)
def test_replication_flag_is_served_with_the_reference_default(flag):
    parser = port_app.build_parser()
    args = parser.parse_args(_refused_argv(parser, flag, None))
    ref = {a.dest: a for a in jax_app.build_parser()._actions if a.option_strings}
    dest = flag.lstrip("-").replace("-", "_")
    assert parser.get_default(dest) == ref[dest].default
    action = next(a for a in parser._actions if flag in a.option_strings)
    assert action.choices == ref[dest].choices and action.type == ref[dest].type
    assert action.help and "refused" not in action.help


class _CliProc:
    """A port CLI subprocess on the CPU: stdout JSON lines and stderr lines
    collected as they come."""

    def __init__(self, argv):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
             "--device", "cpu", *argv], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
        self.out, self.err = [], []
        threading.Thread(target=lambda: self.out.extend(
            json.loads(line) for line in self.proc.stdout if line.startswith("{")),
            daemon=True).start()
        threading.Thread(target=lambda: self.err.extend(self.proc.stderr),
                         daemon=True).start()

    def send(self, topic, data):
        _send(self.proc, topic, data)

    def wait_for(self, pred, what, timeout=120):
        deadline = time.monotonic() + timeout
        while not pred():
            assert self.proc.poll() is None, "".join(self.err)
            assert time.monotonic() < deadline, f"{what}: {''.join(self.err)[-2000:]}"
            time.sleep(0.05)

    def port(self):
        self.wait_for(lambda: any("serving on" in e for e in self.err), "serving on")
        line = next(e for e in self.err if "serving on" in e)
        return int(line.rsplit(":", 1)[1])

    def results(self):
        return [m["data"] for m in list(self.out) if m["topic"] == RESULT_TOPIC]

    def statuses(self):
        return [m["data"] for m in list(self.out) if m["topic"] == STATUS_TOPIC]

    def close(self, sig=None):
        try:
            if sig is None:
                self.proc.stdin.close()
            else:
                self.proc.send_signal(sig)
            return self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()


def test_reader_cli_tails_a_jax_written_dir_answers_as_the_writer_and_refuses_enrolment(
        artifacts, tmp_path, capsys):
    """A JAX-written state dir (the JAX CLI's checkpoint), a port writer
    CLI and a port reader CLI on it, each a subprocess: the writer's
    enrolment reaches the reader through the WAL, both answer the scenes
    alike, and an enrol sent to the reader is refused (``read_replica``)."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    assert jax_app.main(_common_args(a) + ["--source", "dir", "--dir", a["frames"],
                                           "--state-dir", state_dir]) == 0
    capsys.readouterr()
    common = [*_common_args(a), "--source", "jsonl", "--flush-ms", "5", "--no-track-cache",
              "--state-dir", state_dir]
    writer = _CliProc(common)
    reader = _CliProc(common + ["--replica-role", "reader", "--replica-poll-ms", "20"])
    try:
        _enrol_until_acknowledged(writer.proc, writer.out, a, "newcomer")
        seq = [100]

        def named():
            reader.send(FRAME_TOPIC, {**encode_frame(a["scenes"][0]), "meta": {"seq": seq[0]}})
            seq[0] += 1
            time.sleep(0.05)
            return any("newcomer" in {f["name"] for f in r["faces"]} for r in reader.results())

        reader.wait_for(named, "the reader never named the writer's enrolment")
        for proc in (writer, reader):
            for i, scene in enumerate(a["scenes"]):
                proc.send(FRAME_TOPIC, {**encode_frame(scene), "meta": {"seq": 1000 + i}})
        reader.send(CONTROL_TOPIC, {"cmd": "enroll", "subject": "nope", "count": 1})
        for proc in (writer, reader):
            proc.wait_for(lambda p=proc: sum(r["meta"]["seq"] >= 1000 for r in p.results())
                          == len(a["scenes"]), "scene results")
        reader.wait_for(lambda: any(s.get("reason") == "read_replica"
                                    for s in reader.statuses()), "the refusal")
        assert reader.close() == 0 and writer.close() == 0
    finally:
        for proc in (writer, reader):
            if proc.proc.poll() is None:
                proc.proc.kill()
    scenes = {p: [r for r in proc.results() if r["meta"]["seq"] >= 1000]
              for p, proc in (("writer", writer), ("reader", reader))}
    _assert_same_results(scenes["reader"], scenes["writer"], key=lambda m: m["seq"],
                         sim_atol=0.0)
    err = "".join(reader.err)
    assert "replica initial sync" in err and "shutdown: clean" in err
    assert not any(s.get("status") == "enrolling" for s in reader.statuses())


def test_router_cli_in_front_of_two_clis_answers_every_frame_once(artifacts, tmp_path):
    """``--router`` over two port CLIs on sockets: frames of eight topics
    through the router's JSONL each come back exactly once, spread over
    both replicas, and enrolment goes to the writer."""
    a = artifacts
    replicas = [_CliProc([*_common_args(a), "--source", "socket", "--port", "0",
                          "--flush-ms", "5", "--no-track-cache"]) for _ in range(2)]
    router = None
    try:
        ports = [r.port() for r in replicas]
        router = _CliProc([*_common_args(a), "--source", "jsonl", "--router",
                           ",".join(f"127.0.0.1:{p}" for p in ports),
                           "--router-link-deadline-s", "5", "--router-hedge-deadline-s", "30"])
        router.wait_for(lambda: any("routing 2 replicas" in e for e in router.err), "routing")
        n = 0
        for rnd in range(3):
            for t in range(8):
                router.send(f"camera/{t}", {**encode_frame(a["scenes"][t % len(a["scenes"])]),
                                            "priority": "interactive",
                                            "meta": {"cid": n, "cam": t}})
                n += 1
        router.wait_for(lambda: len(router.results()) >= n, "router results")
        time.sleep(0.5)  # a late duplicate would show now
        router.send(CONTROL_TOPIC, {"cmd": "stats"})
        router.wait_for(lambda: any(s.get("status") == "stats" for s in router.statuses()),
                        "stats through the router")
        assert router.close() == 0
    finally:
        for proc in replicas + ([router] if router else []):
            if proc.proc.poll() is None:
                proc.close(signal.SIGTERM)
    cids = sorted(r["meta"]["cid"] for r in router.results())
    assert cids == list(range(n))
    stats = [s for s in router.statuses() if s.get("status") == "stats"]
    assert [s["replica"] for s in stats] == [f"127.0.0.1:{ports[0]}"]  # the writer only
    line = next(e for e in router.err if e.startswith("router registry at shutdown: "))
    registry = json.loads(line.split(": ", 1)[1])
    served = [r["routed"] for r in registry]
    assert sum(served) == n and all(served), registry
    assert [r["writer"] for r in registry] == [True, False]
    assert "router holds a CUDA context: False" in "".join(router.err)


def test_cli_overload_and_observability_flags_end_to_end(artifacts, tmp_path):
    """The CLI in a subprocess with a rate limit, the dead-letter journal,
    the span JSONL and the exposition: over-rate frames come back as
    ``rejected`` statuses, ``/prom`` lints clean, the span journal reads
    back one terminal span per admitted frame, and the ledger closes."""
    from opencv_facerecognizer_tpu_torch.runtime.journal import DeadLetterJournal, RotatingJournal
    from opencv_facerecognizer_tpu_torch.runtime.promtext import lint_prometheus_text
    from opencv_facerecognizer_tpu_torch.utils.tracing import account_spans

    a = artifacts
    spans, journal = str(tmp_path / "spans.jsonl"), str(tmp_path / "dead.jsonl")
    sink = str(tmp_path / "metrics.jsonl")
    cmd = [sys.executable, "-m", "opencv_facerecognizer_tpu_torch.apps.recognize",
           "--device", "cpu", *_common_args(a), "--source", "jsonl", "--flush-ms", "5",
           "--no-track-cache", "--rate-limit-fps", "10", "--dead-letter-journal", journal,
           "--trace-sample", "1.0", "--trace-jsonl", spans, "--expo-port", "0", "--slo",
           "--flight-dir", str(tmp_path / "flight"), "--metrics-jsonl", sink]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO))
    out, err = [], []
    threads = [threading.Thread(target=lambda: out.extend(json.loads(l) for l in proc.stdout),
                                daemon=True),
               threading.Thread(target=lambda: err.extend(proc.stderr), daemon=True)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 120
        while not any(line.startswith("expo endpoint: ") for line in err):
            assert time.monotonic() < deadline and proc.poll() is None, "".join(err)
            time.sleep(0.05)
        base = next(line for line in err if line.startswith("expo endpoint: ")).split()[-1]
        n = 30
        for i in range(n):  # a burst over the 10 fps bucket (a burst of 10)
            _send(proc, FRAME_TOPIC, {**encode_frame(a["scenes"][i % 4]), "meta": {"seq": i}})
        while sum(1 for m in out if m["topic"] == RESULT_TOPIC) < 10:
            assert time.monotonic() < deadline and proc.poll() is None, "".join(err)
            time.sleep(0.05)
        with urllib.request.urlopen(base + "prom", timeout=10) as resp:
            prom = resp.read().decode()
        with urllib.request.urlopen(base + "health", timeout=10) as resp:
            health = json.loads(resp.read().decode())
        proc.stdin.close()
        assert proc.wait(timeout=120) == 0, "".join(err)
    finally:
        if proc.poll() is None:
            proc.kill()
    for t in threads:
        t.join(timeout=10)
    assert lint_prometheus_text(prom) == []
    assert "ocvf_frames_rejected_total{reason=\"rate_limit\"}" in prom
    assert health["state"] in ("ok", "warn", "critical")
    shutdown = [json.loads(line) for line in open(sink)][-1]
    ledger = shutdown["ledger"]
    rejected = shutdown["summary"][mn.FRAMES_REJECTED_PREFIX + "rate_limit"]
    assert ledger["in_system"] == 0 and ledger["admitted"] + rejected == n
    results = [m for m in out if m["topic"] == RESULT_TOPIC]
    assert len(results) == ledger["completed"] > 0
    statuses = [m["data"] for m in out if m["topic"] == STATUS_TOPIC]
    assert sum(s["count"] for s in statuses if s["status"] == "rejected") == rejected
    acct = account_spans(RotatingJournal(spans).records())
    assert acct["traced"] == ledger["admitted"] and acct["completed"] == ledger["completed"]
    assert list(DeadLetterJournal(journal).records()) == []  # nothing was shed
    assert any(f.startswith("flight-") and "sigterm_drain" in f
               for f in os.listdir(tmp_path / "flight"))


# ---------- ingest and the embedder rollout (ROADMAP A.8.3, A.8.8) ----------

INGEST_FLAGS = ["--ingest-mode", "--ingest-ring-depth", "--ingest-decode-workers"]


@pytest.mark.parametrize("flag", INGEST_FLAGS)
def test_ingest_flag_is_served_with_the_reference_default(flag):
    parser = port_app.build_parser()
    args = parser.parse_args(_refused_argv(parser, flag, None))
    ref = {a.dest: a.default for a in jax_app.build_parser()._actions}
    dest = flag.lstrip("-").replace("-", "_")
    assert parser.get_default(dest) == ref[dest]
    action = next(a for a in parser._actions if flag in a.option_strings)
    assert action.help and "refused" not in action.help


def test_jsonl_jpeg_ingest_matches_jax_cli(artifacts, f32_stacks, tmp_path, monkeypatch,
                                           capsys):
    """``--ingest-mode jpeg``: JPEG payloads of the scenes (and one corrupt
    payload) on stdin; both CLIs decode them in their pools and answer
    every good frame alike; the corrupt one is dead-lettered with reason
    ``decode_error`` in both journals, and both ledgers close."""
    from opencv_facerecognizer_tpu_torch.runtime.ingest import encode_jpeg, encode_jpeg_message

    a = artifacts
    n = 6
    payloads = [encode_jpeg(a["scenes"][i % 5]) for i in range(n)]
    lines = [json.dumps({"topic": FRAME_TOPIC,
                         "data": {**encode_jpeg_message(p), "meta": {"seq": i}}})
             for i, p in enumerate(payloads)]
    lines.append(json.dumps({"topic": FRAME_TOPIC, "data": {
        **encode_jpeg_message(payloads[0][:20]), "meta": {"seq": 99}}}))
    stdin_text = "\n".join(lines) + "\n"
    out = {}
    for name, main, extra in (("jax", jax_app.main, []),
                              ("port", port_app.main, ["--device", "cpu"])):
        journal = str(tmp_path / f"{name}.jsonl")
        metrics = str(tmp_path / f"{name}-metrics.jsonl")
        argv = (_common_args(a) + ["--source", "jsonl", "--ingest-mode", "jpeg",
                                   "--no-track-cache", "--dead-letter-journal", journal,
                                   "--metrics-jsonl", metrics] + extra)
        msgs = _run_jsonl(main, argv, stdin_text, monkeypatch, capsys)
        with open(journal) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        out[name] = ([m["data"] for m in msgs if m["topic"] == RESULT_TOPIC], rows)
    results, rows = out["port"]
    assert sorted(r["meta"]["seq"] for r in results) == list(range(n))
    _assert_same_results(results, out["jax"][0], key=lambda m: m["seq"])
    for _results, journal_rows in out.values():
        assert [(r["reason"], [e["meta"]["seq"] for e in r["frames"]])
                for r in journal_rows] == [("decode_error", [99])]
    records = [json.loads(line) for line in open(tmp_path / "port-metrics.jsonl")]
    shutdown = next(r for r in records if r.get("event") == "shutdown")
    assert shutdown["ledger"]["in_system"] == 0
    assert shutdown["ledger"]["drops_by_reason"] == {mn.FRAMES_DROPPED_DECODE: 1.0}


def _dir_with_pending_cutover(a, state_dir, capsys):
    """A state dir the JAX CLI wrote (dir mode, a clean shutdown), then a
    rollout's crash after its fence: the stage of version 2 holds the
    checkpoint's rows negated, and the ``cutover`` record lies past the
    newest checkpoint."""
    from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
    from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
    from opencv_facerecognizer_tpu.runtime import rollout as jax_rollout
    from opencv_facerecognizer_tpu.runtime import state_store as jax_state
    from jax.sharding import Mesh

    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--state-dir", state_dir]
    assert jax_app.main(argv) == 0
    capsys.readouterr()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))
    gallery = JaxGallery(capacity=64, dim=EMB["embed_dim"], mesh=mesh)
    state = jax_state.StateLifecycle(state_dir)
    state.recover(gallery, [])
    emb, lab, _val, size = gallery.snapshot()
    stage = jax_rollout.ReEmbedStage(state_dir, 2, dim=EMB["embed_dim"])
    stage.stage_chunk(0, -emb[:size], lab[:size])
    state.wal.append_cutover(state.wal_seq + 1, 1, 2, rows=size, dim=EMB["embed_dim"])
    state.close()
    return size


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pending_cutover_to_the_declared_version_recovers_and_serves_at_it(
        artifacts, tmp_path, capsys, pkg):
    """``--state-dir`` with a pending cutover and ``--embedder-version 2``:
    the recovery completes the cutover and every result is stamped 2, in
    both packages; then a declared version 3 exits, refusing mixed
    spaces."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    rows = _dir_with_pending_cutover(a, state_dir, capsys)
    main, extra = (jax_app.main, []) if pkg == "jax" else (port_app.main, ["--device", "cpu"])
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"],
                              "--state-dir", state_dir] + extra
    assert main(argv + ["--embedder-version", "2"]) == 0
    captured = capsys.readouterr()
    results = _json_lines(captured.out)
    assert len(results) == 5 and {r["embedder_version"] for r in results} == {2}
    assert "'completed_cutover': {" in captured.err and f"'rows': {rows}" in captured.err
    assert pkg == "jax" or "shutdown: clean" in captured.err  # the port's line (C.6)
    # last: the JAX CLI keeps its writer lease when it exits here in-process
    with pytest.raises(SystemExit, match="refusing to serve mixed spaces"):
        main(argv + ["--embedder-version", "3"])


# ---------- the cascade and the registry (ROADMAP A.8.5) ----------

CASCADE_REGISTRY_FLAGS = ["--cascade", "--cascade-threshold", "--no-cascade",
                          "--registry-swap", "--detector-version", "--cascade-version"]


@pytest.mark.parametrize("flag", CASCADE_REGISTRY_FLAGS)
def test_cascade_and_registry_flag_is_served_with_the_reference_default(flag):
    parser = port_app.build_parser()
    args = parser.parse_args(_refused_argv(parser, flag, None))
    ref = {a.dest: a.default for a in jax_app.build_parser()._actions}
    dest = flag.lstrip("-").replace("-", "_")
    assert parser.get_default(dest) == ref[dest]
    action = next(a for a in parser._actions if flag in a.option_strings)
    assert action.help and "refused" not in action.help


def _jax_gate_file(path):
    """A JAX-written stage-1 gate from seeded flax init params, spread so
    the five scenes score apart; returns the gate (its net in f32)."""
    from opencv_facerecognizer_tpu.models import cascade as jax_cascade

    gate = jax_cascade.FaceGate(features=(4, 8), downsample=4)
    gate.net = jax_cascade.CascadeNet(features=(4, 8), downsample=4, dtype=jnp.float32)
    params = gate.net.init(jax.random.PRNGKey(3), jnp.zeros((1, FRAME, FRAME)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    gate.load_params(jax.tree_util.tree_unflatten(
        tree, [a + 0.3 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)]))
    gate.save(path)
    return gate


@pytest.fixture
def f32_gates(monkeypatch):
    """Both CLIs load their stage-1 gates in float32 (the module docstring's
    reason)."""
    from opencv_facerecognizer_tpu.models import cascade as jax_cascade
    from opencv_facerecognizer_tpu_torch.models import cascade as port_cascade

    monkeypatch.setattr(jax_cascade, "CascadeNet",
                        functools.partial(jax_cascade.CascadeNet, dtype=jnp.float32))

    class F32Gate(port_cascade.FaceGate):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "dtype": torch.float32})

    monkeypatch.setattr(port_cascade, "FaceGate", F32Gate)


def test_dir_mode_with_the_cascade_matches_jax_cli(artifacts, f32_stacks, f32_gates, tmp_path,
                                                   capsys):
    """``--cascade PATH --cascade-threshold P``: both CLIs answer the frames
    scoring below P with no faces (``exit: "cascade"``) and the others as
    the full step does; ``--no-cascade`` serves every frame in full."""
    a = artifacts
    path = str(tmp_path / "gate.msgpack")
    gate = _jax_gate_file(path)
    scores = np.sort(np.asarray(gate.score_batch(a["scenes"].astype(np.float32))))
    thr = float(scores[1:3].mean())  # between two scores: two frames exit, three survive
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--cascade", path,
                              "--cascade-threshold", str(thr), "--no-track-cache"]
    runs = {}
    for name, main, extra in (("jax", jax_app.main, []),
                              ("port", port_app.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        runs[name] = _json_lines(capsys.readouterr().out)
        assert main(argv + extra + ["--no-cascade"]) == 0
        runs[name + "_full"] = _json_lines(capsys.readouterr().out)
    exits = {n: sorted(r["meta"]["file"] for r in runs[n] if r.get("exit") == "cascade")
             for n in ("jax", "port")}
    assert exits["port"] == exits["jax"] and len(exits["port"]) == 2
    for r in runs["port"]:
        if r.get("exit") == "cascade":
            assert r["faces"] == []
    kept = [r for r in runs["port"] if r.get("exit") != "cascade"]
    want = {r["meta"]["file"]: r for r in runs["jax"]}
    for r in kept:
        w = want[r["meta"]["file"]]
        assert [(f["label"], f["name"]) for f in r["faces"]] == [
            (f["label"], f["name"]) for f in w["faces"]]
        for gf, wf in zip(r["faces"], w["faces"]):
            np.testing.assert_allclose(gf["box"], wf["box"], atol=BOX_ATOL)
            assert abs(gf["similarity"] - wf["similarity"]) <= SIM_ATOL
    assert not any(r.get("exit") for n in ("jax_full", "port_full") for r in runs[n])
    _assert_same_results(runs["port_full"], runs["jax_full"], key=lambda m: m["file"])


def _stage_gate(state_dir, version):
    from opencv_facerecognizer_tpu_torch.runtime.registry import registry_params_path

    path = registry_params_path(state_dir, "cascade", version)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _jax_gate_file(path)
    return path


def test_offline_registry_swap_matches_jax_cli(tmp_path, capsys):
    """``--registry-swap ROLE=N`` against a state dir, in each CLI on a copy
    of one dir: the same fence record, the same manifest; and the same
    refusals."""
    import shutil

    from opencv_facerecognizer_tpu.runtime.registry import ModelRegistry as JaxRegistry
    from opencv_facerecognizer_tpu_torch.runtime.registry import ModelRegistry

    base = str(tmp_path / "base")
    _stage_gate(base, 2)
    got = {}
    for name, main in (("jax", jax_app.main), ("port", port_app.main)):
        sd = str(tmp_path / name)
        shutil.copytree(base, sd)
        assert main(["--registry-swap", "cascade=2", "--state-dir", sd]) == 0
        with open(os.path.join(sd, "enroll.wal")) as f:
            fence = [json.loads(line) for line in f]
        for rec in fence:
            rec.pop("ts")
            rec["params_path"] = os.path.relpath(rec["params_path"], sd)
        got[name] = (fence, JaxRegistry(sd, readonly=True).stamp(),
                     ModelRegistry(sd, readonly=True).stamp())
        for bad in (["--registry-swap", "cascade=2", "--state-dir", sd],  # not above v2
                    ["--registry-swap", "cascade=3", "--state-dir", sd],  # not staged
                    ["--registry-swap", "embedder=3", "--state-dir", sd],
                    ["--registry-swap", "cascade=x", "--state-dir", sd],
                    ["--registry-swap", "cascade=3"]):
            with pytest.raises(SystemExit):
                main(bad)
        capsys.readouterr()
    assert got["port"] == got["jax"]
    assert got["port"][1]["cascade"] == 2 and got["port"][0][0]["kind"] == "registry_cutover"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_version_fences_serve_the_manifest_and_refuse_another(artifacts, tmp_path, capsys,
                                                                  pkg):
    """After an offline ``--registry-swap cascade=2``, a start with
    ``--cascade PATH --cascade-version 2`` serves (results stamped with the
    manifest's versions) and ``--detector-version 3`` refuses to start, in
    both CLIs."""
    a = artifacts
    state_dir = str(tmp_path / "state")
    path = _stage_gate(state_dir, 2)
    main, extra = (jax_app.main, []) if pkg == "jax" else (port_app.main, ["--device", "cpu"])
    assert main(["--registry-swap", "cascade=2", "--state-dir", state_dir]) == 0
    argv = _common_args(a) + ["--source", "dir", "--dir", a["frames"], "--state-dir",
                              state_dir, "--cascade", path, "--cascade-version", "2"] + extra
    assert main(argv) == 0
    results = _json_lines(capsys.readouterr().out)
    assert len(results) == 5
    assert all(r.get("exit") == "cascade" or r["registry"] == {
        "embedder": 1, "detector": 1, "cascade": 2} for r in results)
    # last: the JAX CLI keeps its writer lease when it exits here in-process
    with pytest.raises(SystemExit, match="detector-version 3"):
        main(argv + ["--detector-version", "3"])


def test_registry_fence_refuses_an_undeclared_version_like_the_reference(tmp_path):
    import argparse

    from opencv_facerecognizer_tpu_torch.runtime.registry import ModelRegistry

    registry = ModelRegistry(str(tmp_path))
    registry.install("detector", 2)
    for declared, ok in (((0, 0), True), ((2, 0), True), ((2, 1), True), ((1, 0), False),
                         ((0, 2), False)):
        args = argparse.Namespace(detector_version=declared[0], cascade_version=declared[1])
        outcomes = []
        for fence in (lambda: port_app._registry_fence(registry, args),
                      lambda: jax_app._registry_fence(registry, args, "writer")):
            try:
                fence()
                outcomes.append(True)
            except SystemExit:
                outcomes.append(False)
        assert outcomes == [ok, ok], declared


def test_parallel_fused_jsonl_over_8_slots_matches_jax_cli(artifacts, f32_stacks,
                                                          monkeypatch, capsys):
    """``_mesh_devices`` patched to 8 CPU slots: the port lays the
    reference's ``make_mesh()`` (dp 1, tp 8) over them, as the JAX CLI does
    over its 8 devices, and every frame is answered as the JAX CLI answers
    it; ``--match-mode auto`` (the default) attaches no quantizer."""
    a = artifacts
    monkeypatch.setattr(port_app, "_mesh_devices", lambda device: [torch.device("cpu")] * 8)
    built = []
    real_load = port_app._load_stack

    def load(args, metrics):
        pipeline, names = real_load(args, metrics)
        built.append(pipeline)
        return pipeline, names

    monkeypatch.setattr(port_app, "_load_stack", load)
    n = 7
    lines = [json.dumps({"topic": FRAME_TOPIC,
                         "data": {**encode_frame(a["scenes"][i % 5].astype(np.float32)),
                                  "meta": {"seq": i}}}) for i in range(n)]
    argv = _common_args(a) + ["--source", "jsonl"]
    want = _run_jsonl(jax_app.main, argv, "\n".join(lines), monkeypatch, capsys)
    got = _run_jsonl(port_app.main, argv + ["--device", "cpu"], "\n".join(lines),
                     monkeypatch, capsys)
    results = [m["data"] for m in got if m["topic"] == RESULT_TOPIC]
    assert sorted(r["meta"]["seq"] for r in results) == list(range(n))
    _assert_same_results(results, [m["data"] for m in want if m["topic"] == RESULT_TOPIC],
                         key=lambda m: m["seq"])
    (pipeline,) = built
    assert type(pipeline).__name__ == "RecognitionPipeline"
    assert pipeline.gallery.mesh.shape == {"dp": 1, "tp": 8}
    assert pipeline.gallery.quantizer is None and pipeline.gallery.match_mode == "exact"


def test_parallel_fused_refuses_ivf_on_a_mesh_like_the_reference(artifacts, monkeypatch,
                                                                  tmp_path):
    a = artifacts
    with pytest.raises(SystemExit) as want:
        jax_app.main(_common_args(a) + ["--source", "dir", "--dir", a["frames"],
                                        "--match-mode", "ivf"])
    monkeypatch.setattr(port_app, "_mesh_devices", lambda device: [torch.device("cpu")] * 8)
    missing = str(tmp_path / "missing")
    with pytest.raises(SystemExit) as got:
        port_app.main(["--model", missing, "--detector", missing, "--gallery", missing,
                       "--device", "cpu", "--match-mode", "ivf"])
    assert str(got.value) == str(want.value)
    assert "requires a single-device mesh (got 8 devices)" in str(got.value)


def test_parallel_fused_on_one_device_keeps_the_single_device_stack(artifacts, monkeypatch):
    """One device (the CPU, or ``--device`` naming a card) is no mesh: the
    gallery lives on that device and ``auto`` attaches its quantizer."""
    a = artifacts
    built = []
    real_load = port_app._load_stack

    def load(args, metrics):
        pipeline, names = real_load(args, metrics)
        built.append(pipeline)
        return pipeline, names

    monkeypatch.setattr(port_app, "_load_stack", load)
    port_app.main(_common_args(a) + ["--source", "dir", "--dir", a["frames"],
                                     "--device", "cpu"])
    (pipeline,) = built
    assert pipeline.gallery.mesh.size == 1 and pipeline._rows == []
    assert pipeline.gallery.quantizer is not None
    args = port_app.build_parser().parse_args(["--device", "cuda:1"])
    assert port_app._fused_mesh(args, torch.device("cuda", 1)) is None
