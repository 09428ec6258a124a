"""The decision logic of ``chip_smoke.py``'s CPU cross-check, on crafted
results (the script itself needs a card): faces pair by box, and a face
seen on one device only passes only at a decision boundary."""

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
