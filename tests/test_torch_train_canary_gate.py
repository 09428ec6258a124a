"""Statistical twin of ``tests/test_cascade.py``'s trained-gate tests on
the PyTorch port (CPU): ``FaceGate()`` at the reference's recipe (300
steps of batch 32 on 96 96x96 scenes, seed 3), scored on 48 held-out
scenes (seed 99).

The reference's own band (every face scene kept, >= 0.75 of face-free
scenes rejected) fails in the JAX package since the seed (0.708
rejected), so the port is held to what the JAX package gives at the
same seeds, trained in the same test: the port keeps at least the
reference's share of face scenes, and rejects at least its share of
face-free scenes less SEPARATION_SLACK (one seed's spread, on the CPU:
the port from flax's init at seeds 0-3 rejects 0.92-1.0, the JAX package
0.71 at 0).
``evaluate_gate`` and the gate file follow."""

import numpy as np
import torch
import pytest

from opencv_facerecognizer_tpu.models import cascade as jax_cascade
from opencv_facerecognizer_tpu_torch.models import cascade as port_cascade
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_scenes
from torch_train_support import one_torch_thread  # noqa: F401

SEPARATION_SLACK = 0.1


@pytest.fixture(scope="module")
def scenes():
    return (make_synthetic_scenes(96, (96, 96), max_faces=2, seed=3),
            make_synthetic_scenes(48, (96, 96), max_faces=2, seed=99))


def _shares(scores, counts, threshold):
    has = counts > 0
    return float((scores[has] >= threshold).mean()), float((scores[~has] < threshold).mean())


def test_face_gate_separates_scenes_as_the_reference(scenes, tmp_path):
    (train, held) = scenes
    ref = jax_cascade.FaceGate().train(*train, steps=300, batch_size=32)
    gate = port_cascade.FaceGate(device="cpu").train(*train, steps=300, batch_size=32)
    want_kept, want_rejected = _shares(np.asarray(ref.score_batch(held[0])), held[2],
                                       ref.threshold)
    scores = gate.score_batch(held[0]).numpy()
    kept, rejected = _shares(scores, held[2], gate.threshold)
    assert kept >= want_kept, (kept, want_kept)
    assert rejected >= want_rejected - SEPARATION_SLACK, (rejected, want_rejected)
    # the trained gate file loads in the JAX package and scores alike (bf16)
    path = str(tmp_path / "gate.msgpack")
    gate.save(path)
    loaded = jax_cascade.FaceGate.load(path)
    np.testing.assert_allclose(np.asarray(loaded.score_batch(held[0][:8])), scores[:8],
                               atol=0.02)


def test_evaluate_gate_with_and_without_labels(scenes):
    """``evaluate_gate``'s operating point over a detector that fires on
    every frame: with ``gt_counts`` its false positives leave the recall's
    denominator (the reference's test)."""
    (train, held) = scenes
    gate = port_cascade.FaceGate(device="cpu").train(*train, steps=60, batch_size=32)

    class FiresEverywhere:
        def detect_batch(self, chunk):
            n = len(chunk)
            return np.zeros((n, 1, 4)), np.ones((n, 1)), np.ones((n, 1), bool)

    import torch

    class Wrapped(FiresEverywhere):
        def detect_batch(self, chunk):
            return tuple(torch.as_tensor(v) for v in super().detect_batch(chunk))

    frames, _b, counts = held
    no_gt = port_cascade.evaluate_gate(gate, Wrapped(), frames)
    with_gt = port_cascade.evaluate_gate(gate, Wrapped(), frames, gt_counts=counts)
    assert with_gt["detector_fp_frames"] == int((counts == 0).sum())
    assert with_gt["detectable_frames"] == int((counts > 0).sum())
    assert "detector_fp_frames" not in no_gt
    assert no_gt["detectable_frames"] == len(frames)
