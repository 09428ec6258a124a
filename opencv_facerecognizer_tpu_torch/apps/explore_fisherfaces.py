"""Fisherfaces robustness attack: port of ``scripts/explore_fisherfaces.py``.

The hard Yale-B-analog row (30 x 12 at 70x70, illumination 0.7, noise 14,
the HARD pose axes) measures 0.8283 with TanTriggs -> Fisherfaces -> NN.
The sweep attacks the algorithm with the framework's own robustness
toolbox, 22 candidates in four rounds (``candidates``):

- locality: ``SpatialHistogram`` of LBP codes survives occluding
  rectangles (a cutout corrupts a few cells, not every projection
  coefficient of a global Fisher axis);
- discriminative locality: ``SpatialHistogram`` -> ``Fisherfaces``;
- occlusion-robust distances on histograms: chi-square, histogram
  intersection, L1 bin ratio;
- a nonlinear decision: ``KernelSVM(kernel="rbf")`` over the Fisher
  projection; k = 3 neighbour voting; raw LBP without TanTriggs; the LBP
  grid and radius around the round-3 winner.

Every candidate runs the fisherfaces row's protocol of
``apps.measure_accuracy`` (``PROTOCOL``, ``FOLDS``) through
``PredictableModel`` and ``KFoldCrossValidation`` on ``--device``.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.explore_fisherfaces \
        [--device cuda] [--only NAME ...] [--out PATH]

Each row is printed as one JSON line and appended to ``--out`` only when
that is given (the reference appends to ``scripts/.fisher_attack.jsonl``
on every run). ``--device`` defaults to ``cuda`` and raises without a
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: the fisherfaces_yaleb protocol of ``apps.measure_accuracy``, verbatim
PROTOCOL = dict(num_subjects=30, per_subject=12, size=(70, 70), seed=2,
                illumination=0.7, noise=14.0, rotation=8.0,
                scale_jitter=0.08, elastic=1.2, occlusion=0.25)
FOLDS = 10


def candidates() -> dict:
    """name -> ``build(device) -> (feature, classifier)``, in the sweep's
    order."""
    from opencv_facerecognizer_tpu_torch.models.classifier import KernelSVM, NearestNeighbor
    from opencv_facerecognizer_tpu_torch.models.feature import (
        Fisherfaces, SpatialHistogram, TanTriggsPreprocessing)
    from opencv_facerecognizer_tpu_torch.models.operators import ChainOperator, CombineOperator
    from opencv_facerecognizer_tpu_torch.ops.distance import (
        ChiSquareDistance, CosineDistance, EuclideanDistance, HistogramIntersection,
        L1BinRatioDistance)
    from opencv_facerecognizer_tpu_torch.ops.lbp import ExtendedLBP

    def tt(d):
        return TanTriggsPreprocessing(sigma0=2.0, sigma1=4.0, device=d)

    def hist(d, r=2, sz=(8, 8)):
        return SpatialHistogram(ExtendedLBP(radius=r, neighbors=8), sz=sz, device=d)

    def fisher(d):
        return Fisherfaces(device=d)

    def nn(d, dist, k=1):
        return NearestNeighbor(dist, k=k, device=d)

    return {
        # the measured baseline, re-run so every comparison shares one path
        "baseline_fisher_nn": lambda d: (ChainOperator(tt(d), fisher(d)),
                                         nn(d, EuclideanDistance())),
        # nonlinear decision over the same linear feature
        "fisher_rbf_svm": lambda d: (ChainOperator(tt(d), fisher(d)),
                                     KernelSVM(kernel="rbf", device=d)),
        # locality only (the lbph recipe on this protocol)
        "lbp_chi2": lambda d: (ChainOperator(tt(d), hist(d)), nn(d, ChiSquareDistance())),
        "lbp_histint": lambda d: (ChainOperator(tt(d), hist(d)),
                                  nn(d, HistogramIntersection())),
        "lbp_l1brd": lambda d: (ChainOperator(tt(d), hist(d)), nn(d, L1BinRatioDistance())),
        # discriminative locality: LDA over the local histograms
        "lbp_fisher_cosine": lambda d: (
            ChainOperator(tt(d), ChainOperator(hist(d), fisher(d))), nn(d, CosineDistance())),
        "lbp_fisher_nn": lambda d: (
            ChainOperator(tt(d), ChainOperator(hist(d), fisher(d))), nn(d, EuclideanDistance())),
        # finer grid: more cells, finer occlusion containment
        "lbp10_fisher_cosine": lambda d: (
            ChainOperator(tt(d), ChainOperator(hist(d, sz=(10, 10)), fisher(d))),
            nn(d, CosineDistance())),
        "lbp10_chi2": lambda d: (ChainOperator(tt(d), hist(d, sz=(10, 10))),
                                 nn(d, ChiSquareDistance())),
        # round 2: ensembles and preprocessing ablations. Global Fisher axes
        # and local LBP-Fisher axes see different error modes
        # (illumination gradient against occlusion): concatenate them
        "combine_fisher_lbpfisher": lambda d: (
            CombineOperator(ChainOperator(tt(d), fisher(d)),
                            ChainOperator(tt(d), ChainOperator(hist(d), fisher(d)))),
            nn(d, CosineDistance())),
        # LBP is illumination-invariant by construction: TanTriggs' gamma
        # and DoG may destroy the texture the codes read
        "rawlbp_chi2": lambda d: (hist(d), nn(d, ChiSquareDistance())),
        "rawlbp_fisher_cosine": lambda d: (ChainOperator(hist(d), fisher(d)),
                                           nn(d, CosineDistance())),
        # k = 3 neighbour voting over the baseline feature
        "fisher_knn3": lambda d: (ChainOperator(tt(d), fisher(d)),
                                  nn(d, EuclideanDistance(), k=3)),
        "fisher_cosine": lambda d: (ChainOperator(tt(d), fisher(d)), nn(d, CosineDistance())),
        # round 3: around the round-2 winner (rawlbp_fisher_cosine)
        "rawlbp1_fisher_cosine": lambda d: (ChainOperator(hist(d, r=1), fisher(d)),
                                            nn(d, CosineDistance())),
        "rawlbp10_fisher_cosine": lambda d: (ChainOperator(hist(d, sz=(10, 10)), fisher(d)),
                                             nn(d, CosineDistance())),
        "rawlbp6_fisher_cosine": lambda d: (ChainOperator(hist(d, sz=(6, 6)), fisher(d)),
                                            nn(d, CosineDistance())),
        "rawlbp_fisher_euclid": lambda d: (ChainOperator(hist(d), fisher(d)),
                                           nn(d, EuclideanDistance())),
        "rawlbp_fisher_knn3": lambda d: (ChainOperator(hist(d), fisher(d)),
                                         nn(d, CosineDistance(), k=3)),
        # round 4: grid and radius around the 6x6 winner
        "rawlbp4_fisher_cosine": lambda d: (ChainOperator(hist(d, sz=(4, 4)), fisher(d)),
                                            nn(d, CosineDistance())),
        "rawlbp5_fisher_cosine": lambda d: (ChainOperator(hist(d, sz=(5, 5)), fisher(d)),
                                            nn(d, CosineDistance())),
        "rawlbp6r3_fisher_cosine": lambda d: (
            ChainOperator(hist(d, r=3, sz=(6, 6)), fisher(d)), nn(d, CosineDistance())),
    }


def run_candidate(name: str, build, device="cuda") -> dict:
    """``FOLDS``-fold accuracy of ``build(device)``'s model over
    ``PROTOCOL``'s faces; the reference's row (``backend`` the device type)."""
    from opencv_facerecognizer_tpu_torch.models.model import PredictableModel
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device
    from opencv_facerecognizer_tpu_torch.utils.validation import KFoldCrossValidation

    device = resolve_device(device)
    X, y, _ = make_synthetic_faces(**PROTOCOL)
    model = PredictableModel(*build(device))
    t0 = time.perf_counter()
    cv = KFoldCrossValidation(k=FOLDS).validate(model, X, y)
    return {
        "name": name,
        "accuracy": round(float(cv.mean_accuracy), 4),
        "folds": FOLDS,
        "protocol": "fisherfaces_yaleb HARD (BASELINE row)",
        "seconds": round(time.perf_counter() - t0, 1),
        "date": time.strftime("%Y-%m-%d"),
        "backend": device.type,
    }


def main(argv=None) -> int:
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--only", action="append")
    ap.add_argument("--out", default=None,
                    help="JSONL file each row is appended to; default: none, nothing written")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"backend: {device.type}", file=sys.stderr)

    cands = candidates()
    for name in args.only or list(cands):
        if name not in cands:
            raise SystemExit(f"unknown candidate {name!r}; have {sorted(cands)}")
        row = run_candidate(name, cands[name], device)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
