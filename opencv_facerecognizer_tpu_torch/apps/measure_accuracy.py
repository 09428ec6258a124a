"""The published accuracy protocols: port of ``scripts/measure_accuracy.py``.

Seven rows, keyed as the reference's (``CONFIGS``):

- six classic rows, ``TheTrainer`` 10-fold on the synthetic analogs of
  ORL, Yale-B and LFW at 70x70 (``classic_kfold``): Eigenfaces on the
  ORL analog, Fisherfaces and LBP-Fisherfaces on the Yale-B analog,
  LBPH and LBP-Fisherfaces on the LFW analog, LBP-Fisherfaces on the ORL
  analog, every one with the HARD protocol's pose axes (``HARD_POSE``,
  ``HARD_WILD``);
- the CNN row (``cnn_verification``): an ArcFace embedder trained on the
  HARD synthetic distribution (rotation 12 degrees, scale jitter 0.12,
  elastic 1.8 px, occlusion p 0.3, noise 10), 300 identities x 12 faces
  at 64x64 (seed 11), verified on 48 held-out identities x 12 (seed 77,
  disjoint) over 6000 pairs (seed 5), 10-fold. The embedder is the
  serving structure's widths (embed 256, stages 64 / 128 / 256), batch
  192, lr 2e-3 with cosine decay, in-step augmentation and flip test-time
  augmentation, seed 3; the reference trains it for 30000 steps.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.measure_accuracy \
        [--only KEY ...] [--steps 30000] [--device cuda] \
        [--cache PATH] [--baseline-md PATH]

It prints one JSON object keyed as the reference's cache (each row with
the reference's fields and a ``device`` / ``date`` stamp, plus
``_meta``). Unlike the reference it writes a file only where told:
``--cache`` merges the rows into that JSON file (rows not selected keep
their cached values; an unreadable cache is ignored with a note; the
write is atomic) and ``--baseline-md`` rewrites that file's MEASURED
block (``render_measured_block``). ``--device`` defaults to ``cuda`` and
raises without a card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys
import time
from typing import Optional

import numpy as np
import torch

#: the HARD protocol's pose axes: every classic row adds in-plane
#: rotation, scale jitter, elastic deformation and occluding rectangles;
#: the LFW-analog rows and the CNN row take the stronger settings
HARD_POSE = dict(rotation=8.0, scale_jitter=0.08, elastic=1.2, occlusion=0.25)
HARD_WILD = dict(rotation=12.0, scale_jitter=0.12, elastic=1.8, occlusion=0.3)
#: the classic rows' image size
CLASSIC_SIZE = (70, 70)
#: the CNN row's face size
SIZE = (64, 64)
#: the reference's training length for the north-star figure
STEPS = 30000

BEGIN = "<!-- MEASURED:BEGIN (scripts/measure_accuracy.py) -->"
END = "<!-- MEASURED:END -->"


def classic_kfold(model_kind: str, num_subjects: int, per_subject: int, kfold: int,
                  device="cuda", size=CLASSIC_SIZE, **faces_kwargs) -> dict:
    """``TheTrainer(model=model_kind)`` k-folded on ``device`` over
    ``make_synthetic_faces(num_subjects, per_subject, size, **faces_kwargs)``;
    the reference's row fields."""
    from opencv_facerecognizer_tpu_torch.runtime.trainer import TheTrainer, TrainerConfig
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces

    size = tuple(size)
    X, y, names = make_synthetic_faces(num_subjects=num_subjects, per_subject=per_subject,
                                       size=size, **faces_kwargs)
    trainer = TheTrainer(TrainerConfig(model=model_kind, kfold=kfold, image_size=size),
                         device=device)
    t0 = time.perf_counter()
    trainer.train(X, y, names, validate=True)
    return {
        "accuracy": round(trainer.mean_accuracy, 4),
        "folds": kfold,
        "dataset": f"synthetic {num_subjects}x{per_subject} {size[0]}x{size[1]} "
                   + ", ".join(f"{k}={v}" for k, v in faces_kwargs.items()),
        "seconds": round(time.perf_counter() - t0, 1),
    }


@functools.lru_cache(maxsize=1)
def _hard_protocol_arrays():
    from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces

    X_tr, y_tr, _ = make_synthetic_faces(num_subjects=300, per_subject=12, size=SIZE,
                                         seed=11, noise=10.0, **HARD_WILD)
    X_te, y_te, _ = make_synthetic_faces(num_subjects=48, per_subject=12, size=SIZE,
                                         seed=77, noise=10.0, **HARD_WILD)
    return X_tr, y_tr, X_te, y_te


def hard_protocol():
    """(X_train, y_train, X_test, y_test): 300 x 12 training faces and 48
    x 12 held-out faces of disjoint identities. Made once a process (the
    smoke run trains on them twice); each call returns its own copies."""
    return tuple(a.copy() for a in _hard_protocol_arrays())


def hard_embedder(steps: int = STEPS, device="cuda"):
    """The protocol's untrained ``CNNEmbedding`` on ``device``."""
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding

    return CNNEmbedding(embed_dim=256, input_size=SIZE, stem_features=32,
                        stage_features=(64, 128, 256), stage_blocks=(2, 2, 2),
                        train_steps=int(steps), batch_size=192, learning_rate=2e-3, seed=3,
                        augment=True, lr_schedule="cosine", tta=True, device=device)


def cnn_verification(steps: int = STEPS, device="cuda", embedder=None,
                     data: Optional[tuple] = None, stats: Optional[dict] = None) -> dict:
    """Train (``embedder`` or ``hard_embedder(steps, device)``) on the
    protocol's training faces, verify the held-out ones; returns the
    reference's fields. ``data`` reuses ``hard_protocol()``'s arrays;
    ``stats``, when given, receives the unrounded ``accuracy``, ``std``,
    ``threshold``, ``fold_accs`` and ``train_s``."""
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
    if stats is not None:
        stats.update(accuracy=float(acc), std=float(std), threshold=float(thr),
                     fold_accs=[float(v) for v in fold_accs], train_s=train_s)
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


def _classic(model_kind: str, num_subjects: int, per_subject: int, kfold: int, **faces):
    """A classic row's thunk: ``thunk(device, steps)`` (steps unused)."""
    return lambda device="cuda", steps=STEPS: classic_kfold(
        model_kind, num_subjects, per_subject, kfold, device=device, **faces)


#: measurement key -> (result key, ``thunk(device, steps)``): the
#: reference's keys, result keys and protocols
CONFIGS = {
    "eigenfaces": ("eigenfaces_orl", _classic("eigenfaces", 40, 10, 10, seed=1, **HARD_POSE)),
    "fisherfaces": ("fisherfaces_yaleb",
                    _classic("fisherfaces", 30, 12, 10, seed=2, illumination=0.7, noise=14.0,
                             **HARD_POSE)),
    "lbph": ("lbph_lfw", _classic("lbph", 40, 8, 10, seed=3, noise=18.0, **HARD_WILD)),
    # raw-LBP spatial histograms -> Fisherfaces -> cosine NN on the
    # fisherfaces row's Yale-B-analog protocol
    "lbp_fisherfaces": ("lbp_fisherfaces_yaleb",
                        _classic("lbp_fisherfaces", 30, 12, 10, seed=2, illumination=0.7,
                                 noise=14.0, **HARD_POSE)),
    # the same config on the lbph row's LFW-analog protocol ...
    "lbp_fisherfaces_lfw": ("lbp_fisherfaces_lfw",
                            _classic("lbp_fisherfaces", 40, 8, 10, seed=3, noise=18.0,
                                     **HARD_WILD)),
    # ... and on the eigenfaces row's ORL-analog protocol
    "lbp_fisherfaces_orl": ("lbp_fisherfaces_orl",
                            _classic("lbp_fisherfaces", 40, 10, 10, seed=1, **HARD_POSE)),
    "cnn": ("cnn_verification",
            lambda device="cuda", steps=STEPS: cnn_verification(steps, device)),
}

#: the MEASURED block's rows in the reference's order: (label, result key)
MEASURED_ROWS = (
    ("Eigenfaces (PCA+NN) k-fold, ORL-analog", "eigenfaces_orl"),
    ("Fisherfaces (TanTriggs s0=2,s1=4 + PCA+LDA+NN) k-fold, Yale-B-analog",
     "fisherfaces_yaleb"),
    ("LBPH (SpatialHistogram r=2 + ChiSquare NN) k-fold, LFW-analog", "lbph_lfw"),
    ("LBP-Fisherfaces (raw ExtendedLBP r=3 6x6 + PCA+LDA + cosine NN) k-fold, Yale-B-analog",
     "lbp_fisherfaces_yaleb"),
    ("LBP-Fisherfaces, same config on the LFW-analog protocol", "lbp_fisherfaces_lfw"),
    ("LBP-Fisherfaces, same config on the ORL-analog protocol", "lbp_fisherfaces_orl"),
    ("CNN ArcFace embedding, 6000-pair verification, disjoint identities", "cnn_verification"),
)


def render_measured_block(results: dict) -> str:
    """The MEASURED block of ``BASELINE.md`` (markers included) for the
    rows of ``results`` that it holds, in the reference's order;
    ``results["_meta"]`` dates the block."""
    lines = [BEGIN, "",
             "| Config (synthetic analog — see scripts/measure_accuracy.py) "
             "| Measured accuracy | Protocol |",
             "|---|---|---|"]
    for label, key in MEASURED_ROWS:
        if key not in results:
            continue
        r = results[key]
        acc = f"{r['accuracy']:.4f}"
        if "std" in r:
            acc += f" ± {r['std']:.4f}"
        lines.append(f"| {label} | **{acc}** | {r['dataset']} |")
    meta = results["_meta"]
    lines += ["",
              f"Last refreshed {meta['date']} on {meta['device']} by "
              "`opencv_facerecognizer_tpu_torch/apps/measure_accuracy.py`; per-row "
              "measurement dates in its `--cache` file. Regression bands asserted in "
              "`tests/test_accuracy.py`. The ROS live-stream config (BASELINE.json row 4) "
              "is measured by `bench_serving.py` (end-to-end latency/throughput artifact).",
              END]
    return "\n".join(lines)


def replace_block(text: str, block: str, begin: str, end: str, heading: str) -> str:
    """``text`` with its ``begin`` .. ``end`` block replaced by ``block``
    (appended under ``heading`` when it has none)."""
    if begin in text:
        return re.sub(re.escape(begin) + r".*?" + re.escape(end), lambda _m: block, text,
                      flags=re.S)
    return text.rstrip() + f"\n\n{heading}\n\n" + block + "\n"


def read_cache(path: Optional[str]) -> dict:
    """The rows of the JSON cache at ``path`` ({} when there is none or it
    cannot be read: a run killed mid-write must not wedge later runs)."""
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as fh:
            return dict(json.load(fh))
    except (json.JSONDecodeError, OSError, TypeError, ValueError) as e:
        print(f"ignoring unreadable cache {path}: {e}", file=sys.stderr)
        return {}


def device_stamp(device: torch.device) -> dict:
    """A row's provenance: the card's name (or the device) and the date."""
    return {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            "date": time.strftime("%Y-%m-%d")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", action="append", choices=sorted(CONFIGS), default=None,
                    help="measure only these configs; others keep their cached values "
                         "(repeatable)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="the cnn row's ArcFace steps (default: the reference's 30000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--cache", default=None,
                    help="JSON file the rows merge into (written atomically); "
                         "default: none, nothing is written")
    ap.add_argument("--baseline-md", default=None,
                    help="a BASELINE.md whose MEASURED block is rewritten from the rows; "
                         "default: none")
    args = ap.parse_args(argv)
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device
    from opencv_facerecognizer_tpu_torch.utils.serialization import (
        atomic_write_json, atomic_write_text)

    device = resolve_device(args.device)
    selected = args.only or sorted(CONFIGS)
    results = read_cache(args.cache)
    missing = [k for k, (rk, _) in CONFIGS.items() if k not in selected and rk not in results]
    if missing and args.baseline_md:
        print(f"note: no cached value yet for {missing}; the MEASURED table will omit "
              "those rows until they are measured", file=sys.stderr)
    stamp = device_stamp(device)
    for i, key in enumerate(selected):
        result_key, thunk = CONFIGS[key]
        print(f"[{i + 1}/{len(selected)}] {key} ...", file=sys.stderr)
        results[result_key] = {**thunk(device, args.steps), **stamp}  # per-row provenance
    results["_meta"] = dict(stamp)
    if args.cache:
        atomic_write_json(args.cache, results)
    print(json.dumps(results, indent=2))
    if args.baseline_md:
        with open(args.baseline_md) as fh:
            text = fh.read()
        atomic_write_text(args.baseline_md, replace_block(
            text, render_measured_block(results), BEGIN, END,
            "## Measured accuracy (this framework)"))
        print(f"{args.baseline_md}: measured block updated", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
