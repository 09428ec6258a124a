"""``ocvf-train-torch``: a dataset directory -> a validated, checkpointed
model, on the card. Port of ``opencv_facerecognizer_tpu/apps/train.py``.

    ocvf-train-torch DATASET MODEL_PATH [--model fisherfaces] [--device cuda|cpu] ...

Walk the folder-per-subject dataset, resize, fit the model (Fisherfaces
with Tan-Triggs and a nearest neighbour by default), k-fold validate it
and save it; the checkpoint loads in either package. It takes every flag
of ``ocvf-train`` and ``--device`` (default ``cuda``; without a card it
raises, ``cpu`` runs the plain PyTorch path). ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the run. ``--model cnn`` trains an
ArcFace embedder for ``--train-steps`` steps; ``--model auto`` k-folds
every family, the CNN last, and fits the winner.

Besides the reference's output it prints one stderr line, ``train
stages: {...}``: seconds and entries by stage (read; preprocess: Tan-
Triggs, LBP; pca and lda: the subspace fits; fit: the rest of a fit, the
classifier's or the ArcFace steps; predict; save; other;
``utils.stage_clock``), the folds, the device and, on the card,
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocvf-train-torch", description="Train a face recognition model on the card")
    p.add_argument("dataset", help="dataset dir: one sub-folder of images per subject")
    p.add_argument("model_path", help="output checkpoint path (.ckpt)")
    p.add_argument("--model", default="fisherfaces",
                   choices=["fisherfaces", "eigenfaces", "lbph",
                            "lbp_fisherfaces", "cnn", "auto"],
                   help="model family; 'auto' k-folds every family on the "
                        "dataset and keeps the measured winner")
    p.add_argument("--image-size", type=int, nargs=2, default=(70, 70),
                   metavar=("H", "W"))
    p.add_argument("--kfold", type=int, default=3)
    p.add_argument("--num-components", type=int, default=0)
    p.add_argument("--knn-k", type=int, default=1)
    p.add_argument("--no-tan-triggs", action="store_true")
    p.add_argument("--classifier", default="nn", choices=["nn", "svm", "kernel_svm"],
                   help="classifier stage over the feature projection")
    p.add_argument("--svm-kernel", default="rbf", choices=["rbf", "poly", "linear"],
                   help="kernel for --classifier kernel_svm")
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--eigenfaces-plot", default=None,
                   help="optional PNG path: render top subspace components")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler Chrome trace (CPU, and CUDA on the "
                        "card) of the whole train+validate run into this directory")
    p.add_argument("--keep-checkpoints", type=int, default=0,
                   help="retain the previous N model checkpoints as "
                        "model.ckpt.1..N when overwriting (the write itself is "
                        "always atomic: tmp + fsync + rename)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises without a "
                        "card). cpu runs the plain PyTorch path")
    return p


def _print_report(clock, device, trainer) -> None:
    report = {**clock.report(), "device": str(device),
              "folds": len(trainer.validation.results) if trainer.validation else 0}
    if device.type == "cuda":
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print(f"train stages: {json.dumps(report)}", file=sys.stderr)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.svm_kernel != "rbf" and args.classifier != "kernel_svm":
        parser.error("--svm-kernel only applies with --classifier kernel_svm")
    if args.knn_k != 1 and args.classifier != "nn":
        parser.error(f"--knn-k only applies with --classifier nn "
                     f"(got --classifier {args.classifier})")
    from opencv_facerecognizer_tpu_torch.runtime.trainer import (
        TheTrainer, TrainerConfig, select_model)
    from opencv_facerecognizer_tpu_torch.utils import stage_clock
    from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

    if args.model == "auto" and (args.profile_dir or args.eigenfaces_plot
                                 or args.keep_checkpoints):
        # flags that select one artifact's shape don't compose with selection
        parser.error("--profile-dir/--eigenfaces-plot/--keep-checkpoints "
                     "don't apply with --model auto (selection saves "
                     "candidate models repeatedly; run the winner "
                     "single-model to use them)")
    device = resolve_device(args.device)
    if args.model == "auto":
        from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils

        with stage_clock.record(device) as clock:
            with stage_clock.stage("read"):
                images, labels, names = dataset_utils.read_images(
                    args.dataset, image_size=tuple(args.image_size))
            trainer, scores = select_model(
                images, labels, names, model_path=args.model_path, device=device,
                image_size=tuple(args.image_size), kfold=args.kfold,
                num_components=args.num_components, knn_k=args.knn_k,
                tan_triggs=not args.no_tan_triggs, embed_dim=args.embed_dim,
                train_steps=args.train_steps, classifier=args.classifier,
                svm_kernel=args.svm_kernel)
        _print_report(clock, device, trainer)
        for kind in sorted(scores, key=scores.get, reverse=True):
            print(f"  {kind:>16}: {scores[kind]:.4f} k-fold")
        print(f"selected: {trainer.config.model} "
              f"({trainer.mean_accuracy:.4f} mean k-fold accuracy)")
        print(f"model saved to {args.model_path}")
        return 0
    config = TrainerConfig(
        model=args.model, image_size=tuple(args.image_size), kfold=args.kfold,
        num_components=args.num_components, knn_k=args.knn_k,
        tan_triggs=not args.no_tan_triggs, classifier=args.classifier,
        svm_kernel=args.svm_kernel, embed_dim=args.embed_dim,
        train_steps=args.train_steps)
    trainer = TheTrainer(config, device=device)
    trainer.keep_checkpoints = args.keep_checkpoints
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    try:
        with stage_clock.record(device) as clock:
            model = trainer.train_from_dir(args.dataset, model_path=args.model_path)
    finally:
        if prof is not None:
            prof.stop()
            path = os.path.join(args.profile_dir, f"trace-{os.getpid()}.json")
            prof.export_chrome_trace(path)
            print(f"profile trace written to {path}", file=sys.stderr)
    _print_report(clock, device, trainer)
    if trainer.validation:
        for result in trainer.validation.results:
            print(result)
        print(f"mean k-fold accuracy: {trainer.mean_accuracy:.4f}")
    print(f"subjects: {model.subject_names}")
    print(f"model saved to {args.model_path}")
    if args.eigenfaces_plot:
        from opencv_facerecognizer_tpu_torch.models.feature import Fisherfaces, PCA
        from opencv_facerecognizer_tpu_torch.models.operators import FeatureOperator
        from opencv_facerecognizer_tpu_torch.utils import visual

        feature = model.feature
        while isinstance(feature, FeatureOperator):
            feature = feature.model2
        if isinstance(feature, (PCA, Fisherfaces)):
            path = visual.plot_eigenfaces(feature, tuple(args.image_size),
                                          filename=args.eigenfaces_plot)
            print(f"eigenfaces plot: {path}")
        else:
            print("eigenfaces plot skipped: model has no subspace components")
    return 0


if __name__ == "__main__":
    sys.exit(main())
