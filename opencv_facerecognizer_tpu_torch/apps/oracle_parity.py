"""Oracle parity for the classic models: port of ``scripts/oracle_parity.py``.

A same-data baseline column for the port's classic models: an
independent NumPy/SciPy implementation of the published math
(Turk-Pentland PCA, Belhumeur PCA(N-c)+LDA, Ahonen LBPH with chi-square,
and the LBP-Fisherfaces recipe) run k-fold on the same synthetic
datasets and the same stratified folds as the port's ``TheTrainer``
(``framework_kfold``, on ``--device``), on the easy and hard protocols.

Shared with the framework (data plumbing, not the algorithm under
test): ``utils.dataset.make_synthetic_faces`` and
``utils.validation.stratified_kfold_indices``. Everything algorithmic —
preprocessing, subspace fits, LBP codes, histograms, distances,
classification — is derived here in NumPy, with no import from the
port's ops or models. Agreement bar: a framework-vs-oracle gap above ~2
points must be fixed or root-caused.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.oracle_parity \
        [--only CONFIG ...] [--skip-framework] [--device cuda] \
        [--cache PATH] [--baseline-md PATH]

It prints the rows as JSON and writes a file only where told: ``--cache``
merges them into that JSON file (atomically; an unreadable cache is
ignored with a note) and ``--baseline-md`` rewrites that file's ORACLE
block (``render_oracle_block``). ``--device`` defaults to ``cuda`` and
raises without a card (the oracle column runs on the host).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
from scipy import linalg as sla
from scipy import ndimage

from opencv_facerecognizer_tpu_torch.apps.measure_accuracy import (
    HARD_POSE, HARD_WILD, device_stamp, read_cache, replace_block)

BEGIN = "<!-- ORACLE:BEGIN (scripts/oracle_parity.py) -->"
END = "<!-- ORACLE:END -->"
#: the protocols' image size
SIZE = (70, 70)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Oracle algorithm implementations (NumPy/SciPy only)
# ---------------------------------------------------------------------------


def tan_triggs_np(x: np.ndarray, alpha=0.1, tau=10.0, gamma=0.2,
                  sigma0=2.0, sigma1=4.0) -> np.ndarray:
    """Tan & Triggs 2010 illumination normalization: gamma -> DoG ->
    two-stage contrast equalization -> tanh squash. [N, H, W] float."""
    x = np.asarray(x, np.float32)
    xg = np.power(x + 1.0, gamma)
    # truncate=3.0 + mode="nearest": a radius-ceil(3 sigma), edge-replicated blur
    blur = lambda img, s: ndimage.gaussian_filter(  # noqa: E731
        img, sigma=(0, s, s), mode="nearest", truncate=3.0)
    dog = blur(xg, sigma0) - blur(xg, sigma1)
    m1 = np.mean(np.abs(dog) ** alpha, axis=(-2, -1), keepdims=True)
    dog = dog / np.maximum(m1, 1e-12) ** (1.0 / alpha)
    m2 = np.mean(np.minimum(np.abs(dog), tau) ** alpha, axis=(-2, -1), keepdims=True)
    dog = dog / np.maximum(m2, 1e-12) ** (1.0 / alpha)
    return tau * np.tanh(dog / tau)


def pca_fit_np(X: np.ndarray, k: int):
    """Turk-Pentland eigenfaces fit on row-vectors [N, D] via SVD."""
    mean = X.mean(axis=0)
    Xc = X - mean
    # economy SVD: right singular vectors are the eigenfaces
    _, _s, vt = np.linalg.svd(Xc, full_matrices=False)
    return mean, vt[:k].T  # [D, k]


def fisherfaces_fit_np(X: np.ndarray, y: np.ndarray):
    """Belhumeur Fisherfaces: PCA to (N - c) dims, then LDA to (c - 1).

    LDA solved as the generalized symmetric eigenproblem Sb v = l Sw v via
    ``scipy.linalg.eigh``, an independent route from the framework's
    Cholesky-whitening implementation."""
    classes = np.unique(y)
    c = len(classes)
    n = X.shape[0]
    mean, Wpca = pca_fit_np(X, max(1, n - c))
    Z = (X - mean) @ Wpca  # [N, n-c]
    gmean = Z.mean(axis=0)
    d = Z.shape[1]
    Sw = np.zeros((d, d), np.float64)
    Sb = np.zeros((d, d), np.float64)
    for cls in classes:
        Zi = Z[y == cls]
        mi = Zi.mean(axis=0)
        Zc = Zi - mi
        Sw += Zc.T @ Zc
        dm = (mi - gmean)[:, None]
        Sb += len(Zi) * (dm @ dm.T)
    # shrinkage-regularized Sw (the PCA'd scatter is near-singular in its
    # trailing directions) ...
    Sw += np.eye(d) * 1e-4 * np.trace(Sw) / d
    evals, evecs = sla.eigh(Sb, Sw)
    order = np.argsort(evals)[::-1][: c - 1]
    Wlda = evecs[:, order]  # [n-c, c-1]
    # ... and unit-norm projection columns: generalized eigenvectors come
    # back Sw-orthonormal, which scales noise directions up by orders of
    # magnitude; unit norm is the published Fisherfaces convention
    Wlda = Wlda / np.maximum(np.linalg.norm(Wlda, axis=0, keepdims=True), 1e-12)
    return mean, Wpca @ Wlda  # [D, c-1]


def lbp_codes_np(x: np.ndarray, radius: int = 2, neighbors: int = 8) -> np.ndarray:
    """Ahonen extended/circular LBP codes with bilinear sampling.

    [N, H, W] -> [N, H-2r, W-2r] uint8-range ints. Sample k at angle
    2 pi k / P, (dy, dx) = (-r sin, r cos), >= comparison to the center."""
    x = np.asarray(x, np.float32)
    _n, h, w = x.shape
    c = x[:, radius:h - radius, radius:w - radius]
    code = np.zeros(c.shape, np.int32)
    for k in range(neighbors):
        theta = 2.0 * math.pi * k / neighbors
        dy, dx = -radius * math.sin(theta), radius * math.cos(theta)
        fy, fx = math.floor(dy), math.floor(dx)
        ty, tx = dy - fy, dx - fx
        patch = np.zeros_like(c)
        for (oy, ox, wgt) in ((0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
                              (1, 0, ty * (1 - tx)), (1, 1, ty * tx)):
            if wgt == 0.0:
                continue
            y0, x0 = radius + fy + oy, radius + fx + ox
            patch += wgt * x[:, y0:y0 + c.shape[1], x0:x0 + c.shape[2]]
        code += (1 << k) * (patch >= c).astype(np.int32)
    return code


def spatial_hist_np(codes: np.ndarray, grid=(8, 8), num_bins=256) -> np.ndarray:
    """Per-cell L1-normalized histograms over a center-cropped grid,
    concatenated: [N, Hc, Wc] -> [N, gy*gx*num_bins]."""
    n, h, w = codes.shape
    gy, gx = grid
    ch, cw = h // gy, w // gx
    y0, x0 = (h - gy * ch) // 2, (w - gx * cw) // 2
    codes = codes[:, y0:y0 + gy * ch, x0:x0 + gx * cw]
    cells = codes.reshape(n, gy, ch, gx, cw).transpose(0, 1, 3, 2, 4)
    cells = cells.reshape(n, gy * gx, ch * cw)
    out = np.zeros((n, gy * gx, num_bins), np.float32)
    for i in range(n):
        for j in range(gy * gx):
            out[i, j] = np.bincount(cells[i, j], minlength=num_bins)
    out /= np.maximum(out.sum(axis=-1, keepdims=True), 1e-12)
    return out.reshape(n, gy * gx * num_bins)


def nn_classify_np(train_f, train_y, test_f, metric: str) -> np.ndarray:
    """1-NN under euclidean, chi-square, or cosine, blocked to bound memory."""
    preds = np.empty(len(test_f), train_y.dtype)
    if metric == "cosine":  # loop-invariant: normalize the train side once
        train_n = train_f / np.maximum(np.linalg.norm(train_f, axis=-1, keepdims=True), 1e-12)
    for i0 in range(0, len(test_f), 64):
        t = test_f[i0:i0 + 64]
        if metric == "euclidean":
            d = ((t[:, None, :] - train_f[None, :, :]) ** 2).sum(-1)
        elif metric == "chi_square":
            diff = t[:, None, :] - train_f[None, :, :]
            s = np.maximum(t[:, None, :] + train_f[None, :, :], 1e-12)
            d = (diff * diff / s).sum(-1)
        elif metric == "cosine":
            tn = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
            d = 1.0 - tn @ train_n.T
        else:
            raise ValueError(metric)
        preds[i0:i0 + 64] = train_y[np.argmin(d, axis=1)]
    return preds


# ---------------------------------------------------------------------------
# the two k-fold columns, on the framework's folds
# ---------------------------------------------------------------------------


def oracle_kfold(kind: str, X: np.ndarray, y: np.ndarray, k: int) -> float:
    """The oracle's mean k-fold accuracy of ``kind`` on (X, y)."""
    from opencv_facerecognizer_tpu_torch.utils.validation import stratified_kfold_indices

    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    if kind == "lbph":
        # descriptors are per-image and fold-independent: compute once
        feats_all = spatial_hist_np(lbp_codes_np(X, radius=2, neighbors=8))
    elif kind == "lbp_fisherfaces":
        # RAW radius-3 codes on a coarse 6x6 grid
        feats_all = spatial_hist_np(lbp_codes_np(X, radius=3, neighbors=8), grid=(6, 6))
    folds = stratified_kfold_indices(y, k, seed=0)
    correct = total = 0
    for test_idx in folds:
        if len(test_idx) == 0:
            continue
        mask = np.ones(len(y), bool)
        mask[test_idx] = False
        if kind == "eigenfaces":
            Xtr = X[mask].reshape(mask.sum(), -1)
            Xte = X[test_idx].reshape(len(test_idx), -1)
            mean, W = pca_fit_np(Xtr, min(Xtr.shape))
            preds = nn_classify_np((Xtr - mean) @ W, y[mask], (Xte - mean) @ W, "euclidean")
        elif kind == "fisherfaces":
            # the trainer's default chain: TanTriggs(sigma0=2, sigma1=4) first
            Xp = tan_triggs_np(X)
            Xtr = Xp[mask].reshape(mask.sum(), -1)
            Xte = Xp[test_idx].reshape(len(test_idx), -1)
            mean, W = fisherfaces_fit_np(Xtr, y[mask])
            preds = nn_classify_np((Xtr - mean) @ W, y[mask], (Xte - mean) @ W, "euclidean")
        elif kind == "lbph":
            preds = nn_classify_np(feats_all[mask], y[mask], feats_all[test_idx], "chi_square")
        elif kind == "lbp_fisherfaces":
            mean, W = fisherfaces_fit_np(feats_all[mask], y[mask])
            preds = nn_classify_np((feats_all[mask] - mean) @ W, y[mask],
                                   (feats_all[test_idx] - mean) @ W, "cosine")
        else:
            raise ValueError(kind)
        correct += int((preds == y[test_idx]).sum())
        total += len(test_idx)
    return correct / total


def framework_kfold(kind: str, X, y, names, k: int, device="cuda") -> float:
    """The port's ``TheTrainer(model=kind)`` mean k-fold accuracy on
    ``device``, at the images' own size (the reference's trainer resizes
    to its default 70x70, the protocols' size)."""
    from opencv_facerecognizer_tpu_torch.runtime.trainer import TheTrainer, TrainerConfig

    X = np.asarray(X)
    trainer = TheTrainer(TrainerConfig(model=kind, kfold=k, image_size=X.shape[1:]),
                         device=device)
    trainer.train(X, y, names, validate=True)
    return float(trainer.mean_accuracy)


# ---------------------------------------------------------------------------
# Protocol matrix: identical datasets for both columns
# ---------------------------------------------------------------------------

#: key -> (kind, make_synthetic_faces arguments, k)
CONFIGS = {
    "eigenfaces_easy": ("eigenfaces", dict(num_subjects=40, per_subject=10, seed=1), 10),
    "eigenfaces_hard": ("eigenfaces", dict(num_subjects=40, per_subject=10, seed=1,
                                           **HARD_POSE), 10),
    "fisherfaces_easy": ("fisherfaces", dict(num_subjects=30, per_subject=12, seed=2,
                                             illumination=0.7, noise=14.0), 10),
    "fisherfaces_hard": ("fisherfaces", dict(num_subjects=30, per_subject=12, seed=2,
                                             illumination=0.7, noise=14.0, **HARD_POSE), 10),
    "lbph_easy": ("lbph", dict(num_subjects=40, per_subject=8, seed=3, noise=18.0), 10),
    "lbph_hard": ("lbph", dict(num_subjects=40, per_subject=8, seed=3, noise=18.0,
                               **HARD_WILD), 10),
    "lbp_fisherfaces_easy": ("lbp_fisherfaces",
                             dict(num_subjects=30, per_subject=12, seed=2, illumination=0.7,
                                  noise=14.0), 10),
    "lbp_fisherfaces_hard": ("lbp_fisherfaces",
                             dict(num_subjects=30, per_subject=12, seed=2, illumination=0.7,
                                  noise=14.0, **HARD_POSE), 10),
}

LABELS = {
    "eigenfaces": "Eigenfaces (PCA+NN)",
    "fisherfaces": "Fisherfaces (TanTriggs + PCA+LDA+NN)",
    "lbph": "LBPH (ExtendedLBP r=2 + ChiSquare NN)",
    "lbp_fisherfaces": "LBP-Fisherfaces (raw r=3 6x6 + PCA+LDA + cosine)",
}


def parity_row(key: str, device="cuda", skip_framework: bool = False, row=None,
               size=SIZE) -> dict:
    """One ``CONFIGS`` row: the oracle's accuracy and seconds, the
    framework's on ``device`` (kept from ``row`` when skipped), the delta
    and the dataset's description."""
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces

    kind, data_kwargs, k = CONFIGS[key]
    X, y, names = make_synthetic_faces(size=tuple(size), **data_kwargs)
    row = dict(row or {})
    t0 = time.perf_counter()
    row["oracle"] = round(oracle_kfold(kind, X, y, k), 4)
    row["oracle_s"] = round(time.perf_counter() - t0, 1)
    if not skip_framework:
        t0 = time.perf_counter()
        row["framework"] = round(framework_kfold(kind, X, y, names, k, device), 4)
        row["framework_s"] = round(time.perf_counter() - t0, 1)
    if "framework" in row:
        row["delta"] = round(row["framework"] - row["oracle"], 4)
    row["dataset"] = (f"synthetic {size[0]}x{size[1]} "
                      + ", ".join(f"{kk}={vv}" for kk, vv in data_kwargs.items())
                      + f", {k}-fold")
    return row


def render_oracle_block(results: dict, framework_on: str) -> str:
    """The ORACLE block (markers included) for the rows of ``results``;
    the framework column's header names ``framework_on`` (the card)."""
    lines = [BEGIN, "",
             f"| Config | Protocol | Framework ({framework_on}) | Oracle (NumPy/SciPy) | Delta |",
             "|---|---|---|---|---|"]
    for key in sorted(CONFIGS):
        if key not in results:
            continue
        r = results[key]
        proto = "hard" if key.endswith("hard") else "easy"
        fw = f"{r['framework']:.4f}" if "framework" in r else "—"
        dl = f"{r['delta']:+.4f}" if "delta" in r else "—"
        lines.append(f"| {LABELS[CONFIGS[key][0]]} | {proto} | **{fw}** | {r['oracle']:.4f} "
                     f"| {dl} |")
    lines += [
        "",
        "Same synthetic datasets, same stratified folds "
        "(`utils.validation.stratified_kfold_indices`), independent NumPy/SciPy "
        "implementations of the published algorithms "
        "(`opencv_facerecognizer_tpu_torch/apps/oracle_parity.py`). Easy rows use each "
        "config's noise/illumination distribution only; hard rows add the pose/scale/"
        "elastic/occlusion axes. Agreement within ~2 pts means the framework's numbers are "
        "the algorithms' ceiling on that data, not implementation artifacts. Refreshed "
        f"{results['_meta']['date']}.", END]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=sorted(CONFIGS), default=None)
    ap.add_argument("--skip-framework", action="store_true",
                    help="oracle column only (framework values keep their cached ones)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the framework column (default cuda; raises "
                         "without a card)")
    ap.add_argument("--cache", default=None,
                    help="JSON file the rows merge into (written atomically); default: none")
    ap.add_argument("--baseline-md", default=None,
                    help="a BASELINE.md whose ORACLE block is rewritten; default: none")
    args = ap.parse_args(argv)
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device
    from opencv_facerecognizer_tpu_torch.utils.serialization import (
        atomic_write_json, atomic_write_text)

    device = resolve_device(args.device)
    selected = args.only or sorted(CONFIGS)
    results = read_cache(args.cache)
    for key in selected:
        row = parity_row(key, device, args.skip_framework, results.get(key))
        results[key] = row
        _log(f"[{key}] oracle {row['oracle']:.4f}"
             + (f" framework {row['framework']:.4f} delta {row['delta']:+.4f}"
                if "framework" in row else ""))
    stamp = device_stamp(device)
    results["_meta"] = dict(stamp)
    if args.cache:
        atomic_write_json(args.cache, results)
    print(json.dumps(results, indent=2))
    if args.baseline_md:
        with open(args.baseline_md) as fh:
            text = fh.read()
        atomic_write_text(args.baseline_md, replace_block(
            text, render_oracle_block(results, stamp["device"]), BEGIN, END,
            "## Oracle parity (classic models, same data/folds)"))
        _log(f"{args.baseline_md}: oracle block updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
