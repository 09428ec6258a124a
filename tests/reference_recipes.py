"""Reference figures that ``chip_smoke.py`` holds the port's training
against, measured with the JAX package on the CPU (``chip_smoke.py``
imports no JAX, so it keeps them as constants; this script is how each
was produced).

    JAX_PLATFORMS=cpu python tests/reference_recipes.py serving-detector

``serving-detector``: the serving detector's recipe of
``bench_serving.py:64-71`` (``CNNFaceDetector(max_faces=8,
score_threshold=0.3)``: features (64, 64), space-to-depth 4; 48 scenes
of 256x256 with up to 8 faces of 24-56 px, seed 7; 150 steps of batch
16 at its default lr 1e-3, from flax's init at seed 0), evaluated by
``evaluate_detector`` at IoU 0.5 on 32 held-out scenes of the same
distribution (seed 9). Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (scenes, size, max faces, face sizes, seed) of the training and held-out sets
SERVING_TRAIN = dict(num_scenes=48, scene_size=(256, 256), max_faces=8,
                     face_size_range=(24, 56), seed=7)
SERVING_HELD = dict(SERVING_TRAIN, num_scenes=32, seed=9)


def serving_detector() -> dict:
    from opencv_facerecognizer_tpu.models.detector import CNNFaceDetector, evaluate_detector
    from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_scenes

    det = CNNFaceDetector(max_faces=8, score_threshold=0.3)
    t0 = time.perf_counter()
    det.train(*make_synthetic_scenes(**SERVING_TRAIN), steps=150, batch_size=16)
    train_s = time.perf_counter() - t0
    m = evaluate_detector(det, *make_synthetic_scenes(**SERVING_HELD), iou_threshold=0.5)
    return {"recipe": "serving-detector", **m, "train_s": train_s}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "serving-detector"
    if which != "serving-detector":
        sys.exit(f"unknown recipe {which!r}")
    print(json.dumps(serving_detector()))
