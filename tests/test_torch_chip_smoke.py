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
