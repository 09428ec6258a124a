"""Statistical twins of ``tests/test_detector.py``'s trained-detector
tests on the PyTorch port (CPU): the reference's recipe (features
(8, 16, 32), head 32, 4 faces, threshold 0.25, 250 steps of batch 16 at
lr 2e-3 on 48 96x96 scenes, seed 3) trained from the port's own seeded
init, then the reference's quality bands on 32 held-out scenes (seed
99): recall and precision at IoU 0.5 >= 0.9, matched IoU >= 0.7; and the
single-image ``detect`` API."""

import numpy as np
import pytest

from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector, evaluate_detector
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_scenes
from torch_train_support import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def trained_detector():
    scenes, boxes, counts = make_synthetic_scenes(48, (96, 96), max_faces=2, seed=3)
    det = CNNFaceDetector(features=(8, 16, 32), head_features=32, max_faces=4,
                          score_threshold=0.25, space_to_depth=1, device="cpu")
    return det.train(scenes, boxes, counts, steps=250, batch_size=16, learning_rate=2e-3)


def test_detector_quality_bands(trained_detector):
    scenes, boxes, counts = make_synthetic_scenes(32, (96, 96), max_faces=2, seed=99)
    m = evaluate_detector(trained_detector, scenes, boxes, counts, iou_threshold=0.5)
    assert m["recall"] >= 0.9, m
    assert m["precision"] >= 0.9, m
    assert m["mean_matched_iou"] >= 0.7, m
    assert m["num_gt"] == int(counts.sum())


def test_detect_single_image_reference_api(trained_detector):
    scenes, boxes, counts = make_synthetic_scenes(4, (96, 96), max_faces=1, seed=7)
    i = int(np.flatnonzero(counts > 0)[0])
    rects = trained_detector.detect(scenes[i])
    assert isinstance(rects, list) and rects
    assert all(len(r) == 4 and all(isinstance(v, int) for v in r) for r in rects)
    x0, y0, x1, y1 = rects[0]
    assert x1 > x0 and y1 > y0
