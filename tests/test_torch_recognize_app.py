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


@pytest.mark.parametrize("flag, value, item", port_app.REFUSED,
                         ids=[f[0] for f in port_app.REFUSED])
def test_unported_flag_exits_naming_its_roadmap_item(flag, value, item):
    argv = _refused_argv(port_app.build_parser(), flag, value)
    with pytest.raises(SystemExit, match="ROADMAP A") as exc:
        port_app.main(argv)
    assert flag in str(exc.value) and item in str(exc.value)


@pytest.mark.parametrize("flag, value, item", port_app.REFUSED,
                         ids=[f[0] for f in port_app.REFUSED])
def test_refused_flag_help_names_its_item(flag, value, item):
    action = next(a for a in port_app.build_parser()._actions if flag in a.option_strings)
    assert action.help.endswith(f"refused: {item}")
    assert value is None or f"{value} is refused" in action.help


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
    port_app.refuse_unported(parser, args)  # no longer refused
    ref = {a.dest: a.default for a in jax_app.build_parser()._actions}
    dest = flag.lstrip("-").replace("-", "_")
    assert parser.get_default(dest) == ref[dest]
    assert flag not in {f for f, _v, _i in port_app.REFUSED}
    assert ("--replica-role", "reader") in {(f, v) for f, v, _i in port_app.REFUSED}
