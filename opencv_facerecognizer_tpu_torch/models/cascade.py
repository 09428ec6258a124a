"""Stage 1 of the detection cascade: port of
``opencv_facerecognizer_tpu/models/cascade.py``.

``CascadeNet`` average-pools a frame by ``downsample`` (256x256 -> 64x64
at the default 4), then two SAME 3x3 stride-2 convolutions with GroupNorm
and ReLU map it to one face logit per ``downsample * TILE_CONV_STRIDE``
pixel tile. ``frame_scores`` reduces the tile map to one face-possible
probability per frame, ``sigmoid(max tile logit)``: one confident tile
keeps the frame. The serving runtime gates whole frames on it (see
``parallel.pipeline.RecognitionPipeline.cascade_scores`` and
``runtime.recognizer``): a frame below the threshold settles as
``completed_empty`` and never reaches the full detector.

Numerics follow the flax module: parameters in float32, compute in
``dtype`` (bf16 by default), the input divided by 255 in the compute
dtype, GroupNorm statistics in float32, the 1x1 head in float32 with its
bias initialized at -2.0. ``FaceGate.save`` / ``load`` write and read the
JAX package's gate file (a msgpack blob of ``header.config_json`` and the
flax-layout ``params``). Training is the reference's: per-tile weighted
BCE (``gate_loss``, ``pos_weight`` buying recall) against
``tile_targets``, Adam steps over the reference's batches
(``train_face_gate``), on the scenes ``train_detector`` takes.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.models._layers import (
    ConvSame, GroupNorm, reset_all, track_casts)
from opencv_facerecognizer_tpu_torch.models._train import adam, fixed_batches
from opencv_facerecognizer_tpu_torch.utils import _msgpack, serialization
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)
from opencv_facerecognizer_tpu_torch.utils.params import (
    cascade_params_from_flax, cascade_params_to_flax)

#: pixels per tile logit at ``downsample=d`` is ``d * TILE_CONV_STRIDE``:
#: the two stride-2 convolutions halve the pooled map twice
TILE_CONV_STRIDE = 4

#: the default operating point (``FaceGate.threshold`` and the serving
#: ``--cascade-threshold`` default)
DEFAULT_THRESHOLD = 0.3

#: the head's initial bias: an untrained gate scores every frame
#: face-unlikely (sigmoid(-2) = 0.12)
HEAD_BIAS_INIT = -2.0


class CascadeNet(nn.Module):
    """Avg-pool by ``downsample`` -> ``len(features)`` conv blocks (SAME
    3x3 stride 2, GroupNorm(min(4, f)), ReLU) -> a float32 1x1 head: the
    tile logit map ``[N, Ht, Wt]``. Parameter names follow the flax
    module's order: ``convs[i]`` is ``Conv_i``, ``norms[i]``
    ``GroupNorm_i``, and ``head`` the last ``Conv_*``."""

    def __init__(self, features: Sequence[int] = (8, 16), downsample: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.downsample = int(downsample)
        self.dtype = dtype
        convs, norms = [], []
        in_ch = 1
        for feats in self.features:
            convs.append(ConvSame(in_ch, feats, (3, 3), stride=2))
            norms.append(GroupNorm(min(4, feats), feats))
            in_ch = feats
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.head = ConvSame(in_ch, 1, (1, 1), bias=True)
        self.reset_parameters(generator)
        track_casts(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init (LeCun-normal convs, the head's bias -2, as flax)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        reset_all(self, gen)
        with torch.no_grad():
            self.head.bias.fill_(HEAD_BIAS_INIT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W] (or [N, H, W, 1]) pixel values -> [N, Ht, Wt] tile logits."""
        if x.ndim == 4:
            x = x[..., 0]
        x = x.to(self.dtype)[:, None] / 255.0
        d = self.downsample
        if d > 1:
            x = F.avg_pool2d(x, d, stride=d)
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x, self.dtype), self.dtype))
        return self.head(x, torch.float32)[:, 0]


def frame_scores(net: CascadeNet, frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W] frames -> [N] face-possible probabilities: the max tile
    logit through a sigmoid (what the serving pipeline graphs per rung)."""
    return torch.sigmoid(torch.amax(net(frames), dim=(1, 2)))


def tile_targets(boxes: np.ndarray, num_boxes: np.ndarray,
                 image_size: Tuple[int, int], tile_px: int) -> np.ndarray:
    """Per-tile targets from padded pixel yxyx boxes: a tile is positive
    when a face-box center lands in it, dilated by one tile in every
    direction. Returns ``[N, Ht, Wt]`` float32 0/1 (the reference's)."""
    n = boxes.shape[0]
    ht = max(1, image_size[0] // tile_px)
    wt = max(1, image_size[1] // tile_px)
    targets = np.zeros((n, ht, wt), dtype=np.float32)
    for i in range(n):
        for b in range(int(num_boxes[i])):
            y0, x0, y1, x1 = boxes[i, b]
            ty = int(np.clip((y0 + y1) / 2 / tile_px, 0, ht - 1))
            tx = int(np.clip((x0 + x1) / 2 / tile_px, 0, wt - 1))
            targets[i, max(0, ty - 1):ty + 2, max(0, tx - 1):tx + 2] = 1.0
    return targets


def gate_loss(logits: torch.Tensor, targets: torch.Tensor,
              pos_weight: float = 2.0) -> torch.Tensor:
    """Per-tile weighted BCE: a missed face tile costs ``pos_weight``
    times a passed background tile."""
    p = torch.clamp(torch.sigmoid(logits), 1e-6, 1.0 - 1e-6)
    bce = -(pos_weight * targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    return bce.mean()


def train_face_gate(net: CascadeNet, images, boxes, num_boxes, *, steps: int = 400,
                    batch_size: int = 32, learning_rate: float = 3e-3,
                    pos_weight: float = 2.0, seed: int = 0,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    log_every: int = 0) -> Dict[str, torch.Tensor]:
    """Train ``net`` in place on (images [N, H, W] in 0..255, padded
    boxes, counts), the scenes ``train_detector`` takes, on its device:
    from ``params`` (a state dict) or, when None, from a fresh init drawn
    from ``seed``. Returns its state dict."""
    images = np.asarray(images, np.float32)
    h, w = images.shape[1], images.shape[2]
    tile_px = net.downsample * TILE_CONV_STRIDE
    targets = tile_targets(np.asarray(boxes, np.float32), num_boxes, (h, w), tile_px)
    if params is None:
        net.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict(params)
    dev = next(net.parameters()).device
    if dev.type == "cuda":
        disable_tf32()
    optimizer = adam(net.parameters(), learning_rate)
    n = images.shape[0]
    batch_size = min(batch_size, n)
    batches = fixed_batches(n, batch_size, steps, seed, dev)
    x_all = torch.as_tensor(images).to(dev)
    t_all = torch.as_tensor(targets).to(dev)
    for i in range(steps):
        idx = batches[i]
        optimizer.zero_grad(set_to_none=True)
        loss = gate_loss(net(x_all[idx]), t_all[idx], pos_weight)
        loss.backward()
        optimizer.step()
        if log_every and (i + 1) % log_every == 0:
            print(f"  gate step {i + 1}/{steps}: loss {float(loss):.4f}")
    return net.state_dict()


class FaceGate:
    """Stage-1 wrapper with ``CNNFaceDetector``'s lifecycle: ``train``,
    ``score_batch``, ``load_params``, ``save`` / ``load``, and the
    operating ``threshold`` the serving runtime defaults to."""

    def __init__(self, features: Sequence[int] = (8, 16), downsample: int = 4,
                 threshold: float = DEFAULT_THRESHOLD, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.net = CascadeNet(features=features, downsample=downsample, dtype=dtype,
                              generator=generator).to(self.device).eval()
        self.threshold = float(threshold)
        #: weights were loaded or trained: ``train`` fine-tunes them (else
        #: it starts from a fresh init, as the reference's does)
        self._loaded = False

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Load a state dict (``utils.params.cascade_params_from_flax``
        turns the JAX package's params into one) in place."""
        self.net.load_state_dict(params)
        self._loaded = True

    @property
    def tile_px(self) -> int:
        return self.net.downsample * TILE_CONV_STRIDE

    def train(self, images, boxes, num_boxes, **kwargs) -> "FaceGate":
        """``train_face_gate`` on this gate's net and device; fine-tunes
        loaded or trained weights, else starts from ``seed``'s init."""
        train_face_gate(self.net, images, boxes, num_boxes,
                        params=self.net.state_dict() if self._loaded else None, **kwargs)
        self._loaded = True
        return self

    @torch.no_grad()
    def score_batch(self, frames) -> torch.Tensor:
        """[N, H, W] -> [N] face-possible probabilities on the gate's
        device. Offline use; serving goes through
        ``RecognitionPipeline.cascade_scores`` (one graph per rung)."""
        frames = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        return frame_scores(self.net, frames)

    # -- the gate file: the reference's format, both ways --

    def save(self, path: str) -> None:
        """Write ``{"header": {"format_version", "config_json"}, "params":
        flax tree}`` atomically: the JAX package's ``FaceGate.load`` reads
        it."""
        payload = {
            "header": {
                "format_version": 1,
                "config_json": json.dumps({
                    "features": list(self.net.features),
                    "downsample": self.net.downsample,
                    "threshold": self.threshold,
                }),
            },
            "params": cascade_params_to_flax(self.net),
        }
        serialization.atomic_write_bytes(path, _msgpack.packb(payload))

    @classmethod
    def load(cls, path: str, device: DeviceLike = DEFAULT_DEVICE,
             dtype: torch.dtype = torch.bfloat16) -> "FaceGate":
        """A gate from a file written by either package, on ``device``."""
        payload = serialization.read_payload(path)
        config = json.loads(payload["header"]["config_json"])
        gate = cls(features=tuple(config["features"]), downsample=config["downsample"],
                   threshold=config.get("threshold", DEFAULT_THRESHOLD), dtype=dtype,
                   device=device)
        cascade_params_from_flax(payload["params"], gate.net)
        gate._loaded = True
        return gate


def evaluate_gate(gate: FaceGate, detector, scenes: np.ndarray,
                  gt_counts: Optional[np.ndarray] = None,
                  threshold: Optional[float] = None,
                  batch_size: int = 32) -> Dict[str, Any]:
    """The gate's operating point against the full detector's own
    verdicts (the reference's): stage-1 recall over the frames stage 2
    detects a face in (with ``gt_counts``: and that hold one), and the
    reject rate over the others; with ``gt_counts`` also the detector's
    false-positive frames and how many of them the gate rejects."""
    thr = gate.threshold if threshold is None else float(threshold)
    scenes = np.asarray(scenes, np.float32)
    detectable = kept_detectable = facefree = rejected_facefree = 0
    fp_frames = fp_suppressed = 0
    for start in range(0, len(scenes), batch_size):
        chunk = scenes[start:start + batch_size]
        _boxes, _scores, valid = detector.detect_batch(chunk)
        fires = valid.cpu().numpy().any(axis=1)
        keep = gate.score_batch(chunk).cpu().numpy() >= thr
        if gt_counts is not None:
            gt = np.asarray(gt_counts[start:start + batch_size]) > 0
            has_face = fires & gt
            fp = fires & ~gt
            fp_frames += int(fp.sum())
            fp_suppressed += int((fp & ~keep).sum())
        else:
            has_face = fires
        detectable += int(has_face.sum())
        kept_detectable += int((has_face & keep).sum())
        facefree += int((~has_face).sum())
        rejected_facefree += int((~has_face & ~keep).sum())
    out = {
        "threshold": thr,
        "detectable_frames": detectable,
        "stage1_recall": kept_detectable / detectable if detectable else float("nan"),
        "facefree_frames": facefree,
        "facefree_reject_rate": (rejected_facefree / facefree if facefree
                                 else float("nan")),
    }
    if gt_counts is not None:
        out["detector_fp_frames"] = fp_frames
        out["detector_fp_suppressed"] = fp_suppressed
    return out
