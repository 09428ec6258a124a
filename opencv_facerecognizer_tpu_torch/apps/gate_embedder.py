"""Accuracy gate for embedder structural variants: port of
``scripts/gate_embedder.py``.

Runs ``apps.measure_accuracy``'s CNN protocol (``hard_protocol`` and
``cnn_verification``: the HARD distribution, disjoint identities, 6000
pairs, 10-fold) with a net built from the flags (``--block``,
``--space-to-depth``, ``--norm``, widths), so a faster structure becomes
a serving or accuracy default only on measured equal-or-better accuracy.
The row records the fold spread's lower edges (``mean_minus_2std``,
``fold_min``) beside the mean.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.gate_embedder --block dense \
        --space-to-depth 4 [--norm full] [--steps 9000] [--tag name] \
        [--device cuda] [--out PATH]

It prints the row as JSON and appends it as one line to ``--out`` only
when that is given. ``--device`` defaults to ``cuda`` and raises without
a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", default="separable")
    ap.add_argument("--space-to-depth", type=int, default=1)
    ap.add_argument("--norm", default="full")
    ap.add_argument("--steps", type=int, default=9000)
    ap.add_argument("--stage-features", default="64,128,256")
    ap.add_argument("--stage-blocks", default="2,2,2")
    ap.add_argument("--embed-dim", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--learning-rate", type=float, default=2e-3)
    ap.add_argument("--margin", type=float, default=None,
                    help="unused unless the train step grows a flag; recorded for provenance")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--input-size", type=int, default=64,
                    help="embedder input resolution; the 64x64 dataset is resized up in "
                         "normalize_faces, so 112 gates the serving-exact structure at "
                         "serving resolution")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--out", default=None,
                    help="JSONL file the row is appended to; default: none, nothing written")
    return ap


def build_embedder(args, device="cuda"):
    """The port's ``CNNEmbedding`` the flags describe, on ``device``."""
    from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding

    return CNNEmbedding(
        embed_dim=args.embed_dim, input_size=(args.input_size, args.input_size),
        stem_features=32,
        stage_features=tuple(int(v) for v in args.stage_features.split(",")),
        stage_blocks=tuple(int(v) for v in args.stage_blocks.split(",")),
        block=args.block, space_to_depth=args.space_to_depth, norm=args.norm,
        train_steps=args.steps, batch_size=args.batch_size,
        learning_rate=args.learning_rate, seed=args.seed,
        augment=True, lr_schedule="cosine", tta=True, device=device)


def main(argv=None) -> dict:
    """Gate one structure; returns the row (also printed)."""
    from opencv_facerecognizer_tpu_torch.apps import measure_accuracy
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    emb = build_embedder(args, device)
    stats = {}
    result = measure_accuracy.cnn_verification(args.steps, device, embedder=emb,
                                               data=measure_accuracy.hard_protocol(),
                                               stats=stats)
    row = {
        "tag": args.tag or f"{args.block}_s2d{args.space_to_depth}_{args.norm}",
        "accuracy": result["accuracy"],
        "std": result["std"],
        "mean_minus_2std": round(stats["accuracy"] - 2 * stats["std"], 4),
        "fold_min": result["fold_min"],
        "threshold": result["threshold"],
        "train_s": result["seconds"],
        "config": {
            "block": args.block, "space_to_depth": args.space_to_depth,
            "norm": args.norm, "steps": args.steps,
            "stage_features": args.stage_features, "stage_blocks": args.stage_blocks,
            "embed_dim": args.embed_dim, "batch_size": args.batch_size,
            "learning_rate": args.learning_rate, "seed": args.seed,
            "input_size": args.input_size,
        },
        "date": time.strftime("%Y-%m-%d"),
    }
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(json.dumps(row, indent=2))
    return row


if __name__ == "__main__":
    main()
    sys.exit(0)
