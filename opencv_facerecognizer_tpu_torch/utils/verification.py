"""Face-verification evaluation, the LFW 6000-pair protocol: port of
``opencv_facerecognizer_tpu/utils/verification.py`` (numpy).

``make_verification_pairs`` builds a balanced same/different pair list
from any labeled dataset; ``verification_accuracy`` runs the 10-fold
threshold-selection protocol (threshold chosen on nine folds, applied to
the held-out one) over cosine similarity. Embeddings may be numpy arrays
or tensors on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def make_verification_pairs(
    labels: np.ndarray, num_pairs: int = 6000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Balanced (idx_a, idx_b, is_same) arrays, LFW-style: half genuine
    pairs, half impostor pairs, no self-pairs."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    by_class = {c: np.flatnonzero(labels == c) for c in np.unique(labels)}
    multi = [c for c, idx in by_class.items() if len(idx) >= 2]
    classes = list(by_class)
    if len(multi) == 0 or len(classes) < 2:
        raise ValueError("need >=1 class with >=2 samples and >=2 classes")
    half = num_pairs // 2
    a, b, same = [], [], []
    for _ in range(half):
        c = multi[rng.integers(len(multi))]
        i, j = rng.choice(by_class[c], size=2, replace=False)
        a.append(i), b.append(j), same.append(True)
    for _ in range(num_pairs - half):
        c1, c2 = rng.choice(len(classes), size=2, replace=False)
        i = rng.choice(by_class[classes[c1]])
        j = rng.choice(by_class[classes[c2]])
        a.append(i), b.append(j), same.append(False)
    return np.asarray(a), np.asarray(b), np.asarray(same)


def cosine_similarity(e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    e1 = e1 / np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-12)
    e2 = e2 / np.maximum(np.linalg.norm(e2, axis=-1, keepdims=True), 1e-12)
    return np.sum(e1 * e2, axis=-1)


def _best_threshold(similarities: np.ndarray, is_same: np.ndarray) -> float:
    order = np.argsort(similarities)
    s_sorted = similarities[order]
    y_sorted = is_same[order].astype(np.int64)
    # For threshold between s[i-1] and s[i]: predictions below are "diff".
    # accuracy(i) = (#diff in [0,i)) + (#same in [i,n)).
    diff_below = np.concatenate([[0], np.cumsum(1 - y_sorted)])
    same_at_or_above = y_sorted.sum() - np.concatenate([[0], np.cumsum(y_sorted)])
    correct = diff_below + same_at_or_above
    i = int(np.argmax(correct))
    if i == 0:
        return float(s_sorted[0] - 1e-6)
    if i == len(s_sorted):
        return float(s_sorted[-1] + 1e-6)
    return float((s_sorted[i - 1] + s_sorted[i]) / 2)


def verification_accuracy(
    emb_a: np.ndarray, emb_b: np.ndarray, is_same: np.ndarray, folds: int = 10,
    return_folds: bool = False,
):
    """10-fold LFW protocol: per fold, pick the accuracy-optimal cosine
    threshold on the other folds, evaluate on the held-out fold.

    Returns (mean_accuracy, std_accuracy, mean_threshold), plus the
    per-fold accuracy list when ``return_folds`` — recorded so callers
    can gate on the fold MINIMUM, not just the mean (a spread whose
    lower edge sits on the bar is not "beating" it).
    """
    sims = cosine_similarity(_host(emb_a), _host(emb_b))
    is_same = np.asarray(is_same, dtype=bool)
    n = len(sims)
    idx = np.arange(n)
    fold_ids = idx % folds
    accs, thresholds = [], []
    for f in range(folds):
        test = fold_ids == f
        train = ~test
        t = _best_threshold(sims[train], is_same[train])
        pred = sims[test] >= t
        accs.append(float(np.mean(pred == is_same[test])))
        thresholds.append(t)
    out = (float(np.mean(accs)), float(np.std(accs)),
           float(np.mean(thresholds)))
    return (*out, accs) if return_folds else out
