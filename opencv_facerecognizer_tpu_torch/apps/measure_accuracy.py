"""The CNN row of the accuracy protocols: port of
``scripts/measure_accuracy.py``'s ``cnn_verification``.

An ArcFace embedder trained on the HARD synthetic distribution (rotation
12 degrees, scale jitter 0.12, elastic 1.8 px, occlusion p 0.3, noise
10): 300 identities x 12 faces at 64x64 (seed 11), then verified on 48
held-out identities x 12 (seed 77, disjoint) over 6000 pairs (seed 5),
10-fold. The embedder is the serving structure's widths (embed 256,
stages 64 / 128 / 256), batch 192, lr 2e-3 with cosine decay, in-step
augmentation and flip test-time augmentation, seed 3; the reference
trains it for 30000 steps. The six classic protocols live in
``chip_smoke.py`` (phase 17 (b)).

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.measure_accuracy --only cnn \
        [--steps 30000] [--device cuda]

It prints one JSON object keyed as the reference's cache,
``{"cnn_verification": {"accuracy", "std", "fold_min", "threshold",
"dataset", "seconds", "device", "date"}}``; it writes no file.
``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

#: the HARD protocol's in-the-wild distortions (``HARD_WILD``)
HARD_WILD = dict(rotation=12.0, scale_jitter=0.12, elastic=1.8, occlusion=0.3)
SIZE = (64, 64)
#: the reference's training length for the north-star figure
STEPS = 30000


def hard_protocol():
    """(X_train, y_train, X_test, y_test): 300 x 12 training faces and 48
    x 12 held-out faces of disjoint identities."""
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces

    X_tr, y_tr, _ = make_synthetic_faces(num_subjects=300, per_subject=12, size=SIZE,
                                         seed=11, noise=10.0, **HARD_WILD)
    X_te, y_te, _ = make_synthetic_faces(num_subjects=48, per_subject=12, size=SIZE,
                                         seed=77, noise=10.0, **HARD_WILD)
    return X_tr, y_tr, X_te, y_te


def hard_embedder(steps: int = STEPS, device="cuda"):
    """The protocol's untrained ``CNNEmbedding`` on ``device``."""
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding

    return CNNEmbedding(embed_dim=256, input_size=SIZE, stem_features=32,
                        stage_features=(64, 128, 256), stage_blocks=(2, 2, 2),
                        train_steps=int(steps), batch_size=192, learning_rate=2e-3, seed=3,
                        augment=True, lr_schedule="cosine", tta=True, device=device)


def cnn_verification(steps: int = STEPS, device="cuda", embedder=None,
                     data: Optional[tuple] = None) -> dict:
    """Train (``embedder`` or ``hard_embedder(steps, device)``) on the
    protocol's training faces, verify the held-out ones; returns the
    reference's fields. ``data`` reuses ``hard_protocol()``'s arrays."""
    from opencv_facerecognizer_tpu_torch.utils.verification import (
        make_verification_pairs, verification_accuracy)

    emb = embedder if embedder is not None else hard_embedder(steps, device)
    X_tr, y_tr, X_te, y_te = data if data is not None else hard_protocol()
    t0 = time.perf_counter()
    emb.compute(X_tr, y_tr)
    if emb.device.type == "cuda":
        torch.cuda.synchronize(emb.device)
    train_s = time.perf_counter() - t0
    e = emb.extract(np.asarray(X_te, np.float32)).float().cpu().numpy()
    a, b, same = make_verification_pairs(y_te, num_pairs=6000, seed=5)
    acc, std, thr, fold_accs = verification_accuracy(e[a], e[b], same, folds=10,
                                                     return_folds=True)
    return {
        "accuracy": round(acc, 4), "std": round(std, 4),
        "fold_min": round(float(min(fold_accs)), 4), "threshold": round(thr, 3),
        "dataset": "synthetic verification, HARD protocol (rot 12deg, scale 0.12, "
                   "elastic 1.8px, occlusion p=0.3): train 300 identities x12, eval 48 "
                   f"disjoint x12, 6000 pairs, 10-fold; embed_dim=256, stages 64/128/256, "
                   f"{emb.train_steps} steps batch 192, in-step flip/rot/scale/shift/cutout "
                   "augmentation, cosine lr, flip-TTA",
        "seconds": round(train_s, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=["cnn"], default=None,
                    help="the rows to measure (the port holds the CNN row)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="ArcFace steps (default: the reference's 30000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    stamp = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else str(device)),
             "date": time.strftime("%Y-%m-%d")}
    results = {}
    for i, key in enumerate(args.only or ["cnn"]):
        print(f"[{i + 1}] {key} ...", file=sys.stderr)
        results["cnn_verification"] = {**cnn_verification(args.steps, device), **stamp}
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
