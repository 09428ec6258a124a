"""The decision logic of ``chip_smoke.py``'s CPU cross-check, on crafted
results (the script itself needs a card): faces pair by box, and a face
seen on one device only passes only at a decision boundary."""

import os

import numpy as np
import pytest

import chip_smoke
from opencv_facerecognizer_tpu_torch.parallel.pipeline import unpack_result


def _packed(boxes, scores, labels):
    """One frame, slots filled in order, the rest invalid."""
    k = 4
    packed = np.zeros((1, k, 8), np.float32)
    for j, (b, s, lab) in enumerate(zip(boxes, scores, labels)):
        packed[0, j, :4] = b
        packed[0, j, 4] = s
        packed[0, j, 5] = 1.0
        packed[0, j, 6] = lab
        packed[0, j, 7] = 0.99
    return unpack_result(packed, 1)


BOXES = [[0, 0, 20, 20], [50, 50, 70, 70], [100, 100, 120, 120]]


def test_pairs_by_box_whatever_the_slot_order():
    a = _packed(BOXES, [0.9, 0.8, 0.7], [1, 2, 3])
    b = _packed(BOXES[::-1], [0.7, 0.8, 0.9], [3, 2, 1])
    pairs, swaps = chip_smoke.cross_check_frame(a, b, 0, 0.3, 0.4)
    assert swaps == 0
    assert sorted((int(j), int(m)) for j, m, _ in pairs) == [(0, 2), (1, 1), (2, 0)]


def test_lone_face_passes_only_at_a_boundary():
    # the third face sits at the lowest kept score: a cutoff swap
    a = _packed(BOXES, [0.9, 0.8, 0.7], [1, 2, 3])
    b = _packed(BOXES[:2] + [[200, 200, 220, 220]], [0.9, 0.8, 0.7], [1, 2, 4])
    _pairs, swaps = chip_smoke.cross_check_frame(a, b, 0, 0.3, 0.4)
    assert swaps == 2
    # a lone face far from every boundary fails the run
    a = _packed(BOXES, [0.9, 0.8, 0.7], [1, 2, 3])
    b = _packed([BOXES[0], [300, 300, 320, 320], BOXES[2]], [0.9, 0.8, 0.7], [1, 5, 3])
    with pytest.raises(AssertionError, match="not at a decision boundary"):
        chip_smoke.cross_check_frame(a, b, 0, 0.3, 0.4)


# ---------- phases 11 and 12: their host-side helpers ----------


@pytest.mark.parametrize("stamps, ok", [
    ([1, 1, 2, 2, 2], True), ([1, 2], True), ([1, 1, 1], False), ([2, 2], False),
    ([1, 2, 1, 2], False), ([1, 1, 2, 1], False), ([], False), ([1, 3, 2], False)])
def test_stamps_move_once(stamps, ok):
    assert chip_smoke.stamps_move_once(stamps, 1, 2) is ok


def test_jpeg_fixture_is_seeded_and_corrupts_its_share():
    from opencv_facerecognizer_tpu_torch.runtime.ingest import (
        JPEG_KEY, decode_jpeg, decode_jpeg_payload)

    frames = np.random.default_rng(3).integers(0, 256, (4, 32, 32), dtype=np.uint8)
    jpegs, line_for, is_corrupt = chip_smoke.jpeg_lines(frames, 85, 50)
    again, line_again, _c = chip_smoke.jpeg_lines(frames.copy(), 85, 50)
    assert jpegs == again and line_for(7, {"_fid": 7}, "bulk") == line_again(
        7, {"_fid": 7}, "bulk")
    assert [i for i in range(200) if is_corrupt(i)] == [49, 99, 149, 199]
    import json

    good = json.loads(line_for(5, {"_fid": 5}, "interactive"))
    assert good["topic"] == chip_smoke.FRAME_TOPIC and good["data"]["meta"] == {"_fid": 5}
    assert decode_jpeg_payload(good["data"]) == jpegs[1]
    assert decode_jpeg(jpegs[1]).shape == (32, 32)
    bad = json.loads(line_for(49, {"_fid": 49}, "interactive"))
    assert JPEG_KEY in bad["data"] and len(decode_jpeg_payload(bad["data"])) == 64
    with pytest.raises(Exception):
        decode_jpeg(decode_jpeg_payload(bad["data"]))


def test_rotation_is_a_seeded_orthogonal_map():
    a, b = chip_smoke.rotation(12, 16), chip_smoke.rotation(12, 16)
    assert np.array_equal(a, b) and not np.array_equal(a, chip_smoke.rotation(13, 16))
    np.testing.assert_allclose(a @ a.T, np.eye(16), atol=1e-5)


def test_row_normalization_is_the_rollouts():
    from opencv_facerecognizer_tpu_torch.runtime import rollout

    rows = np.random.default_rng(4).normal(size=(9, 8)).astype(np.float32)
    rows[3] = 0.0
    assert np.array_equal(chip_smoke._l2norm(rows), rollout._l2norm(rows))


def test_htod_sums_the_profiles_host_to_device_copies():
    class Row:
        def __init__(self, key, count, us):
            self.key, self.count, self.self_device_time_total = key, count, us

    rows = [Row("Memcpy HtoD (Pinned -> Device)", 4, 800.0),
            Row("Memcpy DtoH (Device -> Pinned)", 4, 100.0), Row("sepblock_kernel", 24, 5.0),
            Row("Memcpy HtoD (Pinned -> Device)", 1, 200.0)]
    assert chip_smoke._htod(rows) == {"Memcpy HtoD (Pinned -> Device)": (5, 1.0)}


# ---------- phase 13: its host-side helpers ----------


def test_threshold_leaves_room_on_both_sides_or_refuses():
    scores = np.linspace(0.0, 1.0, 201)
    thr = chip_smoke.choose_threshold(scores, 26, 70)
    m = chip_smoke.CASC_MARGIN
    assert (scores >= thr + m).sum() >= 26 and (scores < thr - m).sum() >= 70
    with pytest.raises(AssertionError, match="no threshold"):
        chip_smoke.choose_threshold(np.full(200, 0.5), 26, 70)


def test_cascade_batches_draw_their_survivors_without_repeats():
    scores = np.random.default_rng(2).random(300)
    pool = np.arange(300)[:, None, None] * np.ones((1, 2, 2))
    thr = chip_smoke.choose_threshold(scores, 26, 70)
    batches = chip_smoke.cascade_batches(pool, scores, thr, seed=5)
    seen = np.concatenate([b[0][:, 0, 0] for b in batches]).astype(int)
    assert len(set(seen)) == len(seen) == chip_smoke.BATCH * len(chip_smoke.CASC_SURVIVORS)
    for n, (frames, keep) in zip(chip_smoke.CASC_SURVIVORS, batches):
        idx = frames[:, 0, 0].astype(int)
        assert keep.sum() == n and np.array_equal(keep, scores[idx] >= thr)
        assert (np.abs(scores[idx] - thr) >= chip_smoke.CASC_MARGIN).all()


def test_face_rows_read_a_result_as_the_service_publishes_it():
    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.fakes import InstantPipeline
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import (
        FRAME_TOPIC, RESULT_TOPIC, RecognizerService)

    pipe = InstantPipeline((16, 16), faces_per_frame=2, max_faces=3)
    conn = FakeConnector()
    service = RecognizerService(pipe, conn, batch_size=2, frame_shape=(16, 16),
                                readback_worker=False, bucket_sizes=(2,))
    service._running = True
    for j in range(2):
        conn.inject(FRAME_TOPIC, {"frame": np.zeros((16, 16), np.float32), "meta": {"j": j}})
    service._serve_one(service.batcher.get_batch(block=True))
    service._drain(force=True)
    packed = pipe.recognize_batch_packed(np.zeros((2, 16, 16), np.float32)).result()
    result = unpack_result(packed, 1)
    for msg in conn.messages(RESULT_TOPIC):
        assert chip_smoke.published_rows(msg) == chip_smoke.face_rows(
            result, msg["meta"]["j"], service.similarity_threshold)
        assert len(msg["faces"]) == 2


def test_perturbed_weights_are_seeded_and_small():
    import torch

    params = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0)),
              "b": torch.tensor([1.5])}
    a, b = chip_smoke.perturbed(params, 3, 1e-3), chip_smoke.perturbed(params, 3, 1e-3)
    assert all(torch.equal(a[k], b[k]) for k in params)
    assert not torch.equal(a["w"], chip_smoke.perturbed(params, 4, 1e-3)["w"])
    assert float((a["w"] - params["w"]).abs().max()) < 0.01 * float(params["w"].std())


# ---------- phase 14: its host-side helpers ----------


def test_ticks_feed_each_connector_and_time_each_tick():
    import time

    from opencv_facerecognizer_tpu_torch.runtime.connector import FakeConnector
    from opencv_facerecognizer_tpu_torch.runtime.recognizer import FRAME_TOPIC, RESULT_TOPIC

    conns = {"a": FakeConnector(), "b": FakeConnector()}
    ticks = chip_smoke._Ticks(conns, np.zeros((3, 4, 4), np.uint8))
    ticks.paused["b"].set()
    ticks.thread.start()
    deadline = time.monotonic() + 10
    while len(conns["a"].messages(FRAME_TOPIC)) < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    ticks.stop.set()
    ticks.thread.join(10)
    assert not ticks.errors and not conns["b"].messages(FRAME_TOPIC)
    frames = conns["a"].messages(FRAME_TOPIC)
    assert [m["meta"]["j"] for m in frames[:6]] == [0, 1, 2, 0, 1, 2]
    for m in frames[:3]:  # the first tick's results, 5 ms after its inject
        t = ticks.sent[m["meta"]["tick"]] + 0.005
        conns["a"].publish(RESULT_TOPIC, {"meta": m["meta"], "faces": []})
        ticks.published["a"][-1] = (t, *ticks.published["a"][-1][1:])
    tick0 = frames[0]["meta"]["tick"]
    assert ticks.tick_ms("a") == pytest.approx([5.0])
    assert ticks.tick_ms("a", [(ticks.sent[tick0] + 1, ticks.sent[tick0] + 2)]) == []


def test_wrap_calls_keeps_the_calls_it_is_told_to():
    obj = type("O", (), {"f": lambda self, x: x * 2})()
    calls = chip_smoke._wrap_calls(obj, "f", keep=lambda r: r > 2)
    assert [obj.f(1), obj.f(3)] == [2, 6]
    assert [r for _t, _dt, r in calls] == [6] and calls[0][1] >= 0


def test_galleries_equal_holds_rows_labels_and_flags():
    import torch

    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

    rows = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    a, b = (ShardedGallery(8, 8, store_dtype=torch.bfloat16, device="cpu") for _ in range(2))
    a.add(rows, np.arange(6))
    b.load_snapshot(*a.snapshot())
    chip_smoke.galleries_equal(a, b, "equal")
    b.add(rows[:1], np.array([9]))
    with pytest.raises(AssertionError, match="differs"):
        chip_smoke.galleries_equal(a, b, "one more row")


def test_paced_send_keeps_its_rate():
    sent = []
    times = chip_smoke._paced_send(5, 100.0, sent.append)
    assert sent == list(range(5)) and times[4] - times[0] >= 0.039
    port = chip_smoke._free_port()
    assert 0 < port < 65536


def test_replication_verify_reads_rc_0_then_rc_2_on_the_flipped_copy(tmp_path):
    """Phase 14 (c) on a port-written state dir and its copy."""
    import shutil

    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
    from opencv_facerecognizer_tpu_torch.runtime.state_store import StateLifecycle

    root = str(tmp_path / "state")
    gallery = ShardedGallery(16, 8, device="cpu")
    state = StateLifecycle(root, checkpoint_wal_rows=1 << 30, checkpoint_every_s=1e9)
    state.bind(gallery, [])
    assert state.checkpoint_now(wait=True)
    rng = np.random.default_rng(1)
    for i in range(3):
        emb = rng.standard_normal((1, 8)).astype(np.float32)
        state.append_enrollment(emb, np.array([i]), subject=f"s{i}", label=i,
                                apply_fn=lambda e=emb, i=i: gallery.add(e, np.array([i])))
    state.close()
    copy = str(tmp_path / "copy")
    shutil.copytree(root, copy)
    out = chip_smoke.replication_verify(root, copy)()
    assert (out["sound"]["rc"], out["flipped"]["rc"]) == (0, 2)
    assert out["flipped"]["corrupt_records"] == 1 and out["sound"]["corrupt_records"] == 0



def test_cross_check_pads_a_short_batch_to_the_top_rung():
    """Every direct call of the cross-check runs BATCH frames: a call at a
    size off the ladder runs other kernels than the served rungs."""
    import types

    import torch

    n, k = 40, 2
    seen = []

    def recognize_batch_packed(batch):
        seen.append(len(batch))
        packed = np.zeros((len(batch), k, 8), np.float32)
        packed[:, 0, :6] = (10, 20, 30, 40, 0.9, 1.0)
        packed[:, 0, 6] = batch[:, 0, 0]  # the frame's label
        packed[:, 0, 7] = 0.5
        return torch.from_numpy(packed)

    direct = types.SimpleNamespace(
        recognize_batch_packed=recognize_batch_packed,
        detector=types.SimpleNamespace(max_faces=k, score_threshold=0.5, iou_threshold=0.3))
    frames = np.zeros((n, 4, 4), np.float32)
    frames[:, 0, 0] = np.arange(n) % 3
    messages = [{"faces": [{"box": [20, 10, 40, 30], "detection_score": 0.9,
                            "label": int(i % 3), "similarity": 0.5}]} for i in range(n)]
    out = chip_smoke.cross_check_messages(direct, frames, messages, "padded")
    assert seen == [32, 32] and out["faces"] == n and out["max_sim"] == 0.0


def test_pod_vs_single_holds_the_sharded_match_to_one_kernel_call(monkeypatch):
    """Phase 15 (a)'s gate on CPU slots: ``match_pod`` equal to the single
    call (0.0), and a merge that loses a row is refused."""
    import torch

    from opencv_facerecognizer_tpu_torch.parallel import gallery as port_gallery
    from opencv_facerecognizer_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator().manual_seed(3)
    g = torch.randn(256, 32, generator=gen)
    q = torch.randn(16, 32, generator=gen)
    valid = torch.rand(256, generator=gen) > 0.2
    labels = torch.arange(256, dtype=torch.int32)
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert chip_smoke._pod_vs_single(q, g, valid, labels, mesh, 5) == 0.0
    real = port_gallery.match_pod

    def lossy(*args, **kwargs):
        lab, sims, idx = real(*args, **kwargs)
        return lab, sims, torch.where(idx == idx[0, 0], -1, idx)

    monkeypatch.setattr(port_gallery, "match_pod", lossy)
    with pytest.raises(AssertionError, match="differs from single-device"):
        chip_smoke._pod_vs_single(q, g, valid, labels, mesh, 5)


def test_pp_check_pairs_faces_by_box_and_refuses_a_label_flip():
    """Phase 15 (b)'s gate: two slots in another order pass, a flipped
    label does not."""
    import torch

    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionResult

    def result(order, label_of_first=1):
        boxes = torch.tensor([BOXES[i] for i in order] + [[0, 0, 0, 0]], dtype=torch.float32)
        scores = torch.tensor([[0.9, 0.8, 0.7][i] for i in order] + [0.0])
        labels = torch.tensor([[label_of_first, 2, 3][i] for i in order] + [0])
        return RecognitionResult(boxes=boxes[None], det_scores=scores[None],
                                 valid=torch.tensor([[True, True, True, False]]),
                                 labels=labels[None, :, None],
                                 similarities=torch.full((1, 4, 1), 0.9))

    got = chip_smoke._pp_results_close(result([0, 1, 2]), result([2, 0, 1]), "t", 0.3, 0.4)
    assert got["faces"] == 3 and got["boundary_swaps"] == 0 and got["max_box_diff"] == 0.0
    with pytest.raises(AssertionError, match="labels differ"):
        chip_smoke._pp_results_close(result([0, 1, 2]), result([0, 1, 2], 5), "t", 0.3, 0.4)


# ---------- phase 16: the chaos soak ----------


def test_chaos_launch_check_holds_each_kernel_to_its_count_a_step():
    want = {"streaming_match": 40, "sepblock": 240, "nms": 40}
    assert chip_smoke.chaos_launch_check(dict(want), 40, 0) == {
        "streaming_match": 1.0, "sepblock": 6.0, "nms": 1.0}
    for name in want:  # one launch too many or too few, and no restart
        for delta in (-1, 1):
            with pytest.raises(AssertionError, match="launches"):
                chip_smoke.chaos_launch_check({**want, name: want[name] + delta}, 40, 0)
    # a restart's re-capture launches more, never fewer
    chip_smoke.chaos_launch_check({**want, "sepblock": 252}, 40, 1)
    with pytest.raises(AssertionError):
        chip_smoke.chaos_launch_check({**want, "nms": 39}, 40, 1)
    with pytest.raises(AssertionError):
        chip_smoke.chaos_launch_check({k: 0 for k in want}, 0, 0)


def test_chaos_staging_check_holds_allocations_to_forfeits():
    """A real ring: two forfeits, one healed by the acquire that found its
    rung empty, one still an open credit."""
    from opencv_facerecognizer_tpu_torch.runtime.ingest import StagingRing
    from opencv_facerecognizer_tpu_torch.utils.metrics import (
        INGEST_STAGING_ALLOCS, INGEST_STAGING_FORFEITS, Metrics)

    metrics = Metrics()
    ring = StagingRing((4, 8), (2, 2), np.uint8, depth=1, metrics=metrics)
    a = ring.acquire(8)
    ring.forfeit(a)
    b = ring.acquire(4)
    ring.forfeit(b)
    healed = ring.acquire(8)  # the 8-rung is empty: the forfeit's heal
    assert healed is not None
    counters = metrics.counters()
    got = chip_smoke.chaos_staging_check(counters[INGEST_STAGING_ALLOCS],
                                         counters[INGEST_STAGING_FORFEITS], ring)
    assert got == dict(preallocated=2, allocs_past_prealloc=1, forfeits=2,
                       open_heal_credits=1, pinned=False)
    with pytest.raises(AssertionError, match="forfeits"):  # an allocation no forfeit opened
        chip_smoke.chaos_staging_check(counters[INGEST_STAGING_ALLOCS] + 1,
                                       counters[INGEST_STAGING_FORFEITS], ring)


def test_chaos_thread_check_allows_only_its_margin():
    assert chip_smoke.chaos_thread_check(10, 12, 2) == dict(before=10, after=12, margin=2)
    assert chip_smoke.chaos_thread_check(10, 9, 2)["after"] == 9
    with pytest.raises(AssertionError, match="leaked"):
        chip_smoke.chaos_thread_check(10, 13, 2)


def test_chaos_probe_check_wants_each_face_in_its_frames_planted_rows():
    ranges = [(0, 2), (2, 3), (3, 3)]

    def result(i, labels, sim=0.995):
        return {"meta": {"probe": i},
                "faces": [{"label": lab, "similarity": sim} for lab in labels]}

    got = chip_smoke.chaos_probe_check([result(0, [1, 0]), result(1, [2]), result(2, [])],
                                       ranges)
    assert got == dict(frames=3, faces=3)
    with pytest.raises(AssertionError, match="planted"):  # frame 1's row in frame 0
        chip_smoke.chaos_probe_check([result(0, [2])], ranges)
    with pytest.raises(AssertionError, match="planted"):
        chip_smoke.chaos_probe_check([result(0, [0], sim=0.98)], ranges)
    with pytest.raises(AssertionError, match="no face"):
        chip_smoke.chaos_probe_check([result(2, [])], ranges)


def test_e2e_ms_reads_the_answered_offers_only():
    sent = {("seq", i): 10.0 + i for i in range(4)}
    done = {("seq", 0): 10.010, ("seq", 1): 11.030, ("seq", 3): 13.020}
    got = chip_smoke._e2e_ms(sent, done)
    assert got["n"] == 3 and abs(got["p50"] - 20.0) < 1e-6
    assert chip_smoke._e2e_ms(sent, {}) == dict(n=0, p50=None, p99=None)


def test_chaos_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 16 end to end at a tiny size on the CPU (no kernel launches
    here): the soak passes its gates, and the crash rolls the gallery back
    to its checkpoint and names the planted faces after the restart."""
    import torch

    for name, value in (("BATCH", 8), ("FRAME", (64, 64)), ("GALLERY_ROWS", 1024),
                        ("CHAOS_SECONDS", 1.0), ("CHAOS_FPS", 100.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((1024, chip_smoke.DIM), dtype=np.float32)
    labels = np.arange(1024, dtype=np.int32) + 100000
    frames = rng.integers(0, 256, (16, 64, 64), dtype=np.uint8)
    stack = chip_smoke.build_stack(dev, 0, chip_smoke.ShardedGallery(
        1024, chip_smoke.DIM, store_dtype=torch.bfloat16, device=dev))
    _b, _s, valid, emb = stack.embed_frames(frames[:8])
    planted = emb[valid.reshape(-1)].float().numpy()
    n = len(planted)
    rows[-n:] = planted
    labels[-n:] = np.arange(n)
    stack.gallery.add(rows, labels)
    out = chip_smoke.chaos_phase(dev, 0, "cpu", dict(stack=stack, frames=frames, n_plant=n))
    soak = out["soak"]
    assert soak["ledger"]["in_system"] == 0 and soak["probe"]["faces"] >= 1
    assert soak["threads"]["after"] <= soak["threads"]["before"] + 2
    assert out["restart"]["gallery_rows"] == 1024 and out["restart"]["faces_named"] >= 1
    assert stack.gallery.size == 1024


def test_block_shapes_follow_the_space_to_depth_strides():
    """Phase 17's new kernel-B shapes: s = 2 opens stage 1 at 16x16 and
    stage 3 stride 1 without a residual; s = 4 has stages 2 and 3 stride 1."""
    nets = {s: chip_smoke.variant_net("cpu", 0, dict(space_to_depth=s)) for s in (1, 2, 4)}
    assert chip_smoke.block_shapes(nets[1]) == [tuple(b) for b in chip_smoke.SERVING_BLOCKS]
    assert chip_smoke.block_shapes(nets[2]) == [
        (16, 16, 32, 64, 2), (8, 8, 64, 64, 1), (8, 8, 64, 128, 2), (4, 4, 128, 128, 1),
        (4, 4, 128, 256, 1), (4, 4, 256, 256, 1)]
    assert chip_smoke.block_shapes(nets[4])[:3] == [
        (8, 8, 32, 64, 2), (4, 4, 64, 64, 1), (4, 4, 64, 128, 1)]
    assert [b.residual for b in nets[2].blocks] == [False, True, False, True, False, True]


def test_train_cli_reads_its_report_and_refuses_a_silent_run(tmp_path, monkeypatch):
    """``train_cli`` runs ``ocvf-train-torch`` (here on the CPU) and reads
    its stage line and accuracy (for ``--model auto``, the selection's); ``checkpoint_labels_agree`` holds the
    checkpoint on two devices (here the CPU twice); a run that exits
    nonzero raises."""
    import torch

    monkeypatch.setattr(chip_smoke, "ACC_SIZE", (32, 32))
    X, y, names = chip_smoke.dataset_utils.make_synthetic_faces(3, 4, (32, 32), seed=1)
    data = str(tmp_path / "data")
    chip_smoke.write_dataset(data, X, y, names)
    assert sorted(os.listdir(data)) == names
    ckpt = str(tmp_path / "m.ckpt")
    run = chip_smoke.train_cli(torch.device("cpu"), data, ckpt, ("--model", "eigenfaces"))
    assert run["rc"] == 0 and 0.0 <= run["accuracy"] <= 1.0 and run["folds"] == 3
    assert {"read", "fit", "predict", "save"} <= set(run["seconds"])
    got = chip_smoke.checkpoint_labels_agree(torch.device("cpu"), ckpt, X[:5])
    assert got["labels_equal"] and got["queries"] == 5
    auto = chip_smoke.train_cli(torch.device("cpu"), data, ckpt,
                                ("--model", "auto", "--train-steps", "2", "--embed-dim", "16"))
    assert auto["selected"] in auto["scores"] and auto["accuracy"] == max(auto["scores"].values())
    with pytest.raises(AssertionError, match="rc 2"):
        chip_smoke.train_cli(torch.device("cpu"), data, ckpt, ("--svm-kernel", "poly"))


def test_train_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 17 end to end at a tiny size on the CPU (no kernel launches
    here; ``torch.cuda.synchronize`` a no-op): the variants against their
    CPU versions, kernel B's plain version at the new shapes, the s = 2
    stack served and the light and dense variants refused, two protocols
    of ``apps.measure_accuracy.CONFIGS`` at 6 x 4 faces and 2-fold, the
    oracle rows at 6 x 4 faces and 2-fold, and the CLI's TRAIN_RUNS on a
    4 x 6 dataset."""
    import torch

    from opencv_facerecognizer_tpu_torch.apps import measure_accuracy, oracle_parity

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    classic = measure_accuracy.classic_kfold
    monkeypatch.setattr(measure_accuracy, "classic_kfold",
                        lambda model, _n, _p, _k, device="cuda", **kw: classic(
                            model, 6, 4, 2, device=device, size=(40, 40), **kw))
    monkeypatch.setattr(oracle_parity, "CONFIGS", {
        key: (kind, dict(kw, num_subjects=6, per_subject=4), 2)
        for key, (kind, kw, _k) in oracle_parity.CONFIGS.items()})
    baseline = dict(list(chip_smoke.ACC_BASELINE.items())[:2])
    for name, value in (("BATCH", 4), ("FRAME", (64, 64)), ("VAR_FACES", 8),
                        ("SEP_BATCHES", (3, 2)), ("ACC_BASELINE", baseline),
                        ("ACC_TOL", 1.0), ("ORACLE_DELTA", 1.0), ("ACC_SIZE", (40, 40)),
                        ("YALEB_SUBJECTS", 4), ("YALEB_PER_SUBJECT", 6),
                        ("TRAIN_CHECK_QUERIES", 8)):
        monkeypatch.setattr(chip_smoke, name, value)
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    gallery = chip_smoke.ShardedGallery(1024, chip_smoke.DIM, store_dtype=torch.bfloat16,
                                        device=dev)
    stack = chip_smoke.build_stack(dev, 0, gallery)
    gallery.add(rng.standard_normal((512, chip_smoke.DIM)).astype(np.float32),
                np.arange(512, dtype=np.int32))
    frames = rng.integers(0, 256, (8, 64, 64), dtype=np.uint8)
    out = chip_smoke.train_phase(dev, 0, "cpu", {"stack": stack, "frames": frames})
    assert set(out["variants"]) == {"serving_s1_fused_min_cos_vs_unfused", "s2", "s4",
                                    "light", "dense"}
    assert len(out["new_blocks"]) == 8
    assert out["serving_s2"]["results"] == 8 and set(out["serving_s2"]["refused"]) == {
        "light", "dense"}
    assert out["protocols"]["lbp_agreement"] == {"r2": 1.0, "r3": 1.0}
    assert set(out["protocols"]) == {"eigenfaces_orl", "fisherfaces_yaleb", "lbp_agreement"}
    for row in ("eigenfaces_orl", "fisherfaces_yaleb"):
        got = out["protocols"][row]
        assert got["folds"] == 2 and got["dataset"].startswith("synthetic 6x4 40x40 ")
        assert got["baseline"] == chip_smoke.ACC_BASELINE[row]
    assert set(out["oracle"]) == set(chip_smoke.ORACLE_ROWS)
    for key, row in out["oracle"].items():
        assert row["delta"] == round(row["framework"] - row["oracle"], 4)
        assert row["dataset"].startswith("synthetic 40x40 ") and row["dataset"].endswith(
            "2-fold")
    for name, _flags in chip_smoke.TRAIN_RUNS:
        assert out["train_cli"][name]["checkpoint"]["labels_equal"]
    assert out["launches"] == {"streaming_match": 0, "sepblock": 0, "nms": 0}


def test_training_phase_rehearses_on_the_cpu(monkeypatch, tmp_path):
    """Phase 18 end to end at a tiny size on the CPU (no kernel launches
    here): the card-against-CPU steps (the CPU against itself), a short
    ArcFace run through ``cnn_verification`` with its recorder, the
    trained net served from a small gallery, the three detector and gate
    recipes at a few steps, ``ocvf-train-torch --model cnn`` and
    ``--model auto`` in subprocesses, each checkpoint on two devices, and
    the embedder gate's row at 2 steps of a narrow dense s = 2 light net."""
    import torch

    from opencv_facerecognizer_tpu_torch.apps import measure_accuracy
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding

    data = (*chip_smoke.dataset_utils.make_synthetic_faces(6, 4, (32, 32), seed=11)[:2],
            *chip_smoke.dataset_utils.make_synthetic_faces(4, 4, (32, 32), seed=77)[:2])
    monkeypatch.setattr(measure_accuracy, "hard_protocol", lambda: data)
    monkeypatch.setattr(measure_accuracy, "hard_embedder", lambda steps, device: CNNEmbedding(
        embed_dim=16, input_size=(32, 32), stem_features=8, stage_features=(8, 16),
        stage_blocks=(1, 1), train_steps=steps, batch_size=8, augment=True,
        lr_schedule="cosine", tta=True, device=device))
    small_serving = dict(chip_smoke.DET_SERVING_TRAIN, num_scenes=4, scene_size=(64, 64),
                         face_size_range=(12, 20))
    for name, value in (
            ("ARC_BATCH", 8), ("DET_GRAD_BATCH", 2), ("FRAME", (64, 64)), ("ARC_STEPS", 12),
            ("ARC_MIN_ACC", 0.0), ("ARC_ENROL", 2), ("ARC_RANK1_MIN", 0.0), ("FINETUNE_STEPS", 3),
            ("GALLERY_ROWS", 512), ("DET_SMALL_TRAIN", dict(steps=3, batch_size=4)),
            ("DET_BANDS", {}), ("GATE_TRAIN", dict(steps=3, batch_size=8)),
            ("DET_SERVING_TRAIN", small_serving),
            ("DET_SERVING_HELD", dict(small_serving, seed=9)), ("DET_SERVING_STEPS", 2),
            ("DET_SERVING_RECALL_TOL", 1.0), ("VAR_FUSED_COS", 0.99),
            ("ACC_SIZE", (32, 32)), ("YALEB_SUBJECTS", 3), ("YALEB_PER_SUBJECT", 4),
            ("AUTO_SUBJECTS", 3), ("AUTO_PER_SUBJECT", 4), ("TRAIN_CHECK_QUERIES", 4),
            ("TRAINING_CLI_RUNS", tuple((n, d, (*f, "--train-steps", "2", "--embed-dim", "16"))
                                        for n, d, f in chip_smoke.TRAINING_CLI_RUNS)),
            ("GATE_STEPS", 2), ("GATE_MIN_ACC", 0.0),
            ("GATE_ARGV", (*chip_smoke.GATE_ARGV, "--stage-features", "8,16", "--stage-blocks",
                           "1,1", "--embed-dim", "16", "--batch-size", "8",
                           "--input-size", "32"))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "variant_net", lambda dev, seed, kw, dtype=torch.bfloat16:
                        chip_smoke.embedder_mod.FaceEmbedNet(
                            embed_dim=16, stem_features=8, stage_features=(8, 16),
                            stage_blocks=(1, 1), input_size=(64, 64), dtype=dtype,
                            generator=torch.Generator().manual_seed(seed + 1)).to(dev))
    monkeypatch.setattr(chip_smoke, "DIM", 16)
    rng = np.random.default_rng(0)
    ctx = {"rows": rng.standard_normal((512, 16)).astype(np.float32),
           "labels": np.arange(512, dtype=np.int32) + 100000}
    monkeypatch.chdir(tmp_path)
    out = chip_smoke.training_phase(torch.device("cpu"), 0, "cpu", ctx)
    for what in ("arcface", "detector", "gate"):
        assert out["steps_vs_cpu"][what]["max_grad_rel_err"] == 0.0
    arc = out["arcface"]
    assert arc["steps"] == 12 and 0.0 <= arc["accuracy"] <= 1.0
    assert arc["loss_first"] is not None and arc["loss_last"] is not None
    assert out["served"]["enrolled"] == 8 and out["served"]["queries"] == 8
    assert out["served"]["finetune"]["serving_unchanged"] and out["served"]["finetune"]["copy_moved"]
    assert set(out["recipes"]) == {"small", "gate", "serving", "launches"}
    assert out["recipes"]["serving"]["jax_cpu_recall"] == 125 / 126
    assert {"cnn", "auto"} == set(out["train_cli"])
    assert out["train_cli"]["auto"]["selected"] in out["train_cli"]["auto"]["scores"]
    for run in out["train_cli"].values():
        assert run["rc"] == 0 and run["checkpoint"]["labels_equal"]
        assert run["counts"]["fit"] >= 1
    gate = out["gate"]
    assert tuple(gate)[:-1] == chip_smoke.GATE_FIELDS and gate["tag"] == "dense_s2d2_light"
    assert gate["config"]["steps"] == 2 and gate["config"]["stage_features"] == "8,16"
    assert out["launches"] == {"streaming_match": 0, "sepblock": 0, "nms": 0}


def test_step_recorder_reports_the_losses_windows():
    import torch

    rec = chip_smoke.StepRecorder(torch.device("cpu"))
    for i in range(250):
        rec(i, torch.tensor(float(i)))
    out = rec.report(250)
    assert out["loss_first"] == 49.5 and out["loss_last"] == 199.5
    assert "ms_per_step" not in out  # no card: no events


def test_fused_mesh_check_rehearses_on_the_cpu(monkeypatch):
    """Phase 15 (d) at a tiny size on CPU slots (kernel A's selection forced,
    its plain version runs): the mesh step equals the eager mesh step and
    the single-device step on each dp row, again after every step was
    evicted, and the service answers every frame, the lone frame at rung 8
    on the dp-2 mesh."""
    import torch

    from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

    for name, value in (("BATCH", 8), ("FRAME", (64, 64))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(ShardedGallery, "kernel_enabled", lambda self, capacity=None: True)
    for timer in ("step_time_ms", "back_to_back_ms"):  # the card's numbers only
        monkeypatch.setattr(chip_smoke, timer, lambda pipeline, batch, iters=20: 0.0)
    dev = torch.device("cpu")
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((4096, chip_smoke.DIM), dtype=np.float32)
    labels = np.arange(4096, dtype=np.int32) + 100000
    frames = rng.integers(0, 256, (32, 64, 64), dtype=np.uint8)
    stack = chip_smoke.build_stack(dev, 0, chip_smoke.ShardedGallery(
        4096, chip_smoke.DIM, store_dtype=torch.bfloat16, device=dev), fused=False)
    _b, _s, valid, emb = stack.embed_frames(frames[:8])
    planted = emb[valid.reshape(-1)].float().numpy()
    n = len(planted)
    rows[-n:] = planted
    labels[-n:] = np.arange(n)
    ctx = dict(rows=rows, labels=labels, frames=frames, n_plant=n)
    out = chip_smoke.fused_mesh_check(dev, 0, ctx, [dev] * 8)
    for shape, rung in (("1x2", 1), ("2x2", 8)):
        rec = out["meshes"][shape]
        assert rec["bit_equal_eager"] and rec["bit_equal_single_by_row"]
        assert rec["recapture_after_evict_equal"]
        assert rec["service"]["lone_frame_rung"] == rung
        assert rec["service"]["frames"] == 33 and rec["service"]["planted_found"] == n
    assert out["launches"] == {"streaming_match": 0, "sepblock": 0, "nms": 0}


def test_sharded_training_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 19 at the dryrun's widths on CPU slots: every layout's f32
    steps within the phase's bars of the one-slot step with the copies
    bit-equal, no timing off the card, and the dryrun's four lines."""
    import torch

    for name, value in (("SH_NET", dict(embed_dim=32, stem_features=8, stage_features=(8, 16),
                                        stage_blocks=(1, 1))),
                        ("SH_FACE", (32, 32)), ("SH_BATCH", 8), ("SH_CLASSES", 8),
                        ("SH_STEPS", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.sharded_training_phase(torch.device("cpu"), 0, "cpu")
    for layout in ("1x2", "2x1", "2x2"):
        rec = out["vs_one_slot"][layout]
        assert rec["copies_bit_equal_every_step"] and len(rec["losses"]) == 4
        assert rec["max_grad_rel_err"] <= chip_smoke.SH_GRAD_RTOL
    assert out["bf16_ms_per_step"] is None
    assert out["dryrun"]["lines"][0] == "[dryrun] mesh: dp=2 tp=2 on 4 devices"
    assert out["launches"] == {"streaming_match": 0, "sepblock": 0, "nms": 0}
