"""Statistical twin of ``tests/test_accuracy.py::test_canary_cnn_verification``
on the PyTorch port (CPU): a tiny ArcFace embedder trained from the
port's own seeded init (not flax's: ROADMAP C.22) on 12 identities, then
verified on 8 disjoint ones over 600 pairs. The reference's config
plateaus at 0.82-0.85; an algorithmic break lands near 0.5, so the
reference's 0.75 bar is kept."""

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces
from opencv_facerecognizer_tpu_torch.utils.verification import (
    make_verification_pairs, verification_accuracy)
from torch_train_support import one_torch_thread  # noqa: F401


def test_canary_cnn_verification():
    size = (32, 32)
    X_tr, y_tr, _ = make_synthetic_faces(num_subjects=12, per_subject=8, size=size,
                                         seed=11, noise=10.0)
    X_te, y_te, _ = make_synthetic_faces(num_subjects=8, per_subject=8, size=size,
                                         seed=77, noise=10.0)
    emb = CNNEmbedding(embed_dim=32, input_size=size, stem_features=8,
                       stage_features=(16, 32), stage_blocks=(1, 1), train_steps=150,
                       batch_size=32, learning_rate=2e-3, seed=3, device="cpu")
    emb.compute(X_tr, y_tr)
    e = emb.extract(np.asarray(X_te, np.float32)).numpy()
    assert e.shape == (len(y_te), 32)
    np.testing.assert_allclose(np.linalg.norm(e, axis=1), 1.0, atol=1e-5)
    a, b, same = make_verification_pairs(y_te, num_pairs=600, seed=5)
    acc, _, _ = verification_accuracy(e[a], e[b], same, folds=5)
    assert acc >= 0.75, f"cnn verification canary accuracy {acc:.3f}"
    assert isinstance(emb.get_state()["head"], np.ndarray) and torch.is_tensor(emb._head)
