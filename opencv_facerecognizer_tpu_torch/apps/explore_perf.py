"""Detector-stem and embedder-structure sweep: port of ``scripts/explore_perf.py``.

Candidate detector stems (space-to-depth x features) are each trained on
the bench workload's synthetic scenes, quality-checked (recall and
precision at IoU 0.5, matched IoU) and their net's forward timed at batch
32; candidate embedder structures (block type, space-to-depth, norm,
widths, input size) are timed at batch 256 with their FLOPs and MFU.
The serving defaults were chosen from this table, and
``apps/gate_embedder.py`` gates an embedder structure's accuracy.

Times come from the chained-differencing instrument
(``utils.benchtime.scalar_chain_ms``: a CUDA graph of k dependent calls a
chain, timed by CUDA events). Off the card nothing is timed: a row's ms is
``None`` with ``"invalid": "not timed off the card"``, its other columns
filled. FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
over one forward (convolutions and matmuls, 2 per multiply-add); the MFU
divides them by the H100's dense bf16 peak.

Usage::

    python -m opencv_facerecognizer_tpu_torch.apps.explore_perf \
        [--skip-detector] [--skip-embedder] [--device cuda]

It prints one JSON object, ``{"device", "date", "detector", "embedder"}``,
on stdout and writes no file. On the card ``device`` is the card's name
and power limit as ``nvidia-smi`` gives them. ``--device`` defaults to
``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from opencv_facerecognizer_tpu_torch.models.detector import CNNFaceDetector, evaluate_detector
from opencv_facerecognizer_tpu_torch.models.embedder import (
    FaceEmbedNet, init_embedder, normalize_faces)
from opencv_facerecognizer_tpu_torch.utils import dataset
from opencv_facerecognizer_tpu_torch.utils.benchtime import scalar_chain_ms
from opencv_facerecognizer_tpu_torch.utils.device import resolve_device

#: the MFU denominator: NVIDIA H100 SXM5, dense bf16 tensor-core peak
#: (NVIDIA's data sheet; ``chip_smoke.py``'s ``BF16_FLOPS``)
H100_BF16_PEAK_FLOPS = 989e12
#: a row's ``invalid`` when its chain never cleared the instrument's
#: resolution, and when it ran off the card
UNRESOLVED = "under-resolved"
NOT_TIMED = "not timed off the card"

DETECTOR_VARIANTS = {
    "baseline_s1_16-32-64": dict(features=(16, 32, 64), space_to_depth=1),
    "s2d4_64-64": dict(features=(64, 64), space_to_depth=4),
    "s2d4_64-96": dict(features=(64, 96), space_to_depth=4),
    "s2d4_96-96": dict(features=(96, 96), space_to_depth=4),
    "s2d8_96": dict(features=(96,), space_to_depth=8),
    "s2d2_32-64-64": dict(features=(32, 64, 64), space_to_depth=2),
}
#: the bench workload's scenes: size, faces a scene and their sizes, the
#: training and held-out sets (count, seed)
SCENE_SIZE = (256, 256)
MAX_FACES = 8
FACE_SIZE_RANGE = (24, 56)
TRAIN_SCENES = (64, 7)
TEST_SCENES = (48, 1234)
DETECTOR_TRAIN = dict(steps=200, batch_size=16)
DETECTOR_BATCH = 32

#: the structural grid: block types, the stem's space-to-depth, the
#: per-block norms, wider channels at lower resolution, and the accuracy
#: gate's 64x64 input ("@64")
EMBEDDER_VARIANTS = {
    "baseline_sep_s1_full": dict(block="separable"),
    "sep_s1_light": dict(block="separable", norm="light"),
    "sep_s2d2_full": dict(block="separable", space_to_depth=2),
    "sep_s2d4_full": dict(block="separable", space_to_depth=4),
    "sep_s2d4_light": dict(block="separable", space_to_depth=4,
                           norm="light"),
    "sep_s2d2_light": dict(block="separable", space_to_depth=2,
                           norm="light"),
    "dense_s2d4": dict(block="dense", space_to_depth=4),
    "dense_s2d4_wide_96-192-256": dict(block="dense", space_to_depth=4,
                                       stage_features=(96, 192, 256)),
    "sep_s2d4_light_wide_96-192-256": dict(
        block="separable", space_to_depth=4, norm="light",
        stage_features=(96, 192, 256)),
    "acc_cfg_sep_s1_full_64-128-256@64": dict(
        block="separable", stage_features=(64, 128, 256), input_size=64,
        embed_dim=256),
    "dense_s2d4_64-128-256@64": dict(
        block="dense", space_to_depth=4, stage_features=(64, 128, 256),
        input_size=64, embed_dim=256),
    "dense_s2d2_64-128-256@64": dict(
        block="dense", space_to_depth=2, stage_features=(64, 128, 256),
        input_size=64, embed_dim=256),
}
#: 32 frames x 8 slots: the fused graph's embed batch
EMBEDDER_BATCH = 256


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def chained_ms(fn: Callable[..., torch.Tensor], args: tuple) -> Optional[float]:
    """ms per call of ``fn(*args) -> scalar`` by ``scalar_chain_ms`` (the
    last argument carries the dependency), without autograd; None when the
    chain is unresolved or ``args[-1]`` is off the card."""
    if args[-1].device.type != "cuda":
        return None
    with torch.no_grad():
        return scalar_chain_ms(fn, args)


def unresolved(device: torch.device) -> str:
    """A row's ``invalid`` reason for an ms of None on ``device``."""
    return UNRESOLVED if device.type == "cuda" else NOT_TIMED


def forward_flops(fn: Callable[..., torch.Tensor], *args) -> float:
    """FLOPs of one ``fn(*args)`` by ``FlopCounterMode``."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def n_params(net: torch.nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


def detector_scenes():
    """(train, test) scene sets: each (scenes, boxes, counts)."""
    return tuple(dataset.make_synthetic_scenes(num_scenes=n, scene_size=SCENE_SIZE,
                                               max_faces=MAX_FACES,
                                               face_size_range=FACE_SIZE_RANGE, seed=seed)
                 for n, seed in (TRAIN_SCENES, TEST_SCENES))


def detector_forward(net: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """frames -> sum(heatmap) + sum(size) + sum(offset) of ``net``."""
    def fwd(frames):
        out = net(frames)
        return out["heatmap"].sum() + out["size"].sum() + out["offset"].sum()
    return fwd


def detector_variants(device="cuda") -> dict:
    """A row a ``DETECTOR_VARIANTS`` entry: ms of the net's forward at
    ``DETECTOR_BATCH`` held-out scenes, quality, params, training s."""
    device = resolve_device(device)
    train, test = detector_scenes()
    frames = torch.as_tensor(test[0][:DETECTOR_BATCH], dtype=torch.float32, device=device)
    rows = {}
    for name, cfg in DETECTOR_VARIANTS.items():
        det = CNNFaceDetector(max_faces=MAX_FACES, score_threshold=0.3, device=device, **cfg)
        t0 = time.perf_counter()
        det.train(*train, **DETECTOR_TRAIN)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
        quality = evaluate_detector(det, *test)
        ms = chained_ms(detector_forward(det.net), (frames,))
        row = {
            "ms_per_batch32_fwd": None if ms is None else round(ms, 3),
            "recall": round(quality["recall"], 4),
            "precision": round(quality["precision"], 4),
            "mean_iou": round(quality["mean_matched_iou"], 3),
            "params": n_params(det.net),
            "train_s": round(train_s, 1),
        }
        if ms is None:  # quality and training columns stand regardless
            row = {"ms_per_batch32_fwd": None, "invalid": unresolved(device), **row}
            _log(f"[det {name}] {row['invalid']} ({row['params']} params)")
        else:
            _log(f"[det {name}] {ms:.3f} ms/b32, recall {quality['recall']:.3f} "
                 f"precision {quality['precision']:.3f} iou "
                 f"{quality['mean_matched_iou']:.3f} ({row['params']} params)")
        rows[name] = row
    return rows


def embedder_net(cfg: dict, device="cuda"):
    """(``cfg``'s ``FaceEmbedNet`` initialized from seed 0 on ``device``,
    its input size)."""
    sz = int(cfg.get("input_size", 112))
    size = (sz, sz)
    net = FaceEmbedNet(embed_dim=cfg.get("embed_dim", 128), stem_features=32,
                       stage_features=cfg.get("stage_features", (64, 128, 128)),
                       stage_blocks=cfg.get("stage_blocks", (2, 2, 2)),
                       block=cfg.get("block", "separable"),
                       space_to_depth=cfg.get("space_to_depth", 1),
                       norm=cfg.get("norm", "full"), input_size=size)
    init_embedder(net, num_classes=8, input_shape=size, seed=0)
    return net.to(device).eval(), size


def embedder_forward(net: torch.nn.Module, size) -> Callable[[torch.Tensor], torch.Tensor]:
    """frames -> sum(net(normalize_faces(frames, size)))."""
    def fwd(frames):
        return net(normalize_faces(frames, size)).sum()
    return fwd


def embedder_frames(size, device) -> torch.Tensor:
    """``EMBEDDER_BATCH`` frames of normal(120, 40) from numpy seed 0."""
    return torch.as_tensor(np.random.default_rng(0).normal(120, 40, (EMBEDDER_BATCH, *size)),
                           dtype=torch.float32, device=device)


def embedder_variants(device="cuda") -> dict:
    """A row an ``EMBEDDER_VARIANTS`` entry: ms of the forward at
    ``EMBEDDER_BATCH``, its GFLOP and MFU, params."""
    device = resolve_device(device)
    rows = {}
    for name, cfg in EMBEDDER_VARIANTS.items():
        net, size = embedder_net(cfg, device)
        frames = embedder_frames(size, device)
        fwd = embedder_forward(net, size)
        flops = forward_flops(fwd, frames)
        ms = chained_ms(fwd, (frames,))
        params = n_params(net)
        if ms is None:
            rows[name] = {"ms_per_256crops_fwd": None, "invalid": unresolved(device),
                          "params": params}
            _log(f"[emb {name}] {rows[name]['invalid']} ({params} params)")
            continue
        mfu = flops / (ms / 1e3) / H100_BF16_PEAK_FLOPS
        rows[name] = {
            "ms_per_256crops_fwd": round(ms, 3),
            "gflop": round(flops / 1e9, 3),
            "mfu_vs_bf16_peak": round(mfu, 4),
            "params": params,
        }
        _log(f"[emb {name}] {ms:.3f} ms/256 crops, MFU {mfu:.3f} ({params} params)")
    return rows


def device_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    the device off the card."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(["nvidia-smi", f"--id={device.index}", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-embedder", action="store_true")
    ap.add_argument("--skip-detector", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": device_name(device), "date": time.strftime("%Y-%m-%d")}
    if not args.skip_detector:
        out["detector"] = detector_variants(device)
    if not args.skip_embedder:
        out["embedder"] = embedder_variants(device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
