"""CNN face detector, inference: port of
``opencv_facerecognizer_tpu/models/detector.py``.

A stride-8 anchor-free ("center-heatmap") FCN: conv blocks -> heatmap,
size and offset heads; ``decode_detections`` turns the maps into exactly
``max_faces`` boxes per image (sigmoid, 3x3 max-pool peaks, top-k, box
assembly, fixed-K NMS, clip). ``CNNFaceDetector.save`` / ``load`` write
and read the JAX package's detector checkpoint (a msgpack blob of
``header.config_json`` and the flax-layout ``params``). Training stays in
the JAX package.

Numerics follow the flax module: bf16 compute with float32 parameters,
the input divided by 255 in the compute dtype, GroupNorm statistics in
float32, the three 1x1 heads in float32. Public tensors keep the
reference's layouts: frames [N, H, W], maps [N, Hs, Ws] and
[N, Hs, Ws, 2].
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.models._layers import (
    ConvSame, GroupNorm, reset_all, space_to_depth_nhwc, track_casts)
from opencv_facerecognizer_tpu_torch.ops import nms as nms_ops
from opencv_facerecognizer_tpu_torch.utils import _msgpack, serialization
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)
from opencv_facerecognizer_tpu_torch.utils.params import (
    detector_params_from_flax, detector_params_to_flax)

STRIDE = 8
#: the heatmap head's initial bias (flax: constant(-4.0)): an untrained
#: detector starts near sigmoid(-4) = 0.018, below any score threshold
HEATMAP_BIAS_INIT = -4.0


class DetectorNet(nn.Module):
    """Stride-8 FCN: downsampling conv blocks -> heatmap/size/offset heads.

    ``space_to_depth`` folds an s x s pixel block into s^2 input channels
    before the first conv; the conv blocks then downsample 8/s.
    Parameter names follow the flax module's order: ``convs[i]`` is
    ``Conv_i`` and ``norms[i]`` ``GroupNorm_i`` for the backbone, then the
    head conv and the heatmap/size/offset heads (the last four
    ``Conv_*``)."""

    def __init__(self, features: Sequence[int] = (16, 32, 64),
                 head_features: int = 64, space_to_depth: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s = int(space_to_depth)
        if STRIDE % s:
            raise ValueError(
                f"space_to_depth={s} must divide the decode stride {STRIDE}")
        self.features = tuple(int(f) for f in features)
        self.head_features = int(head_features)
        self.space_to_depth = s
        self.dtype = dtype
        remaining = STRIDE // s
        accum = 1
        convs, norms = [], []
        in_ch = s * s
        for feats in self.features:
            stride = 2 if accum < remaining else 1
            accum *= stride
            convs.append(ConvSame(in_ch, feats, (3, 3), stride=stride))
            norms.append(GroupNorm(4, feats))
            convs.append(ConvSame(feats, feats, (3, 3)))
            norms.append(GroupNorm(4, feats))
            in_ch = feats
        if accum != remaining:
            raise ValueError(
                f"features={self.features!r} with space_to_depth={s} cannot "
                f"reach stride {STRIDE}: blocks provide x{accum}, need "
                f"x{remaining} (add blocks or lower space_to_depth)")
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.head = ConvSame(in_ch, self.head_features, (3, 3), bias=True)
        self.heatmap = ConvSame(self.head_features, 1, (1, 1), bias=True)
        self.size = ConvSame(self.head_features, 2, (1, 1), bias=True)
        self.offset = ConvSame(self.head_features, 2, (1, 1), bias=True)
        self.reset_parameters(generator)
        track_casts(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded init (LeCun-normal convs, heatmap bias -4, as flax)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        reset_all(self, gen)
        with torch.no_grad():
            self.heatmap.bias.fill_(HEATMAP_BIAS_INIT)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[N, H, W] or [N, H, W, C] pixel values -> {"heatmap" [N, Hs, Ws]
        logits, "size" [N, Hs, Ws, 2], "offset" [N, Hs, Ws, 2]}."""
        if x.ndim == 3:
            x = x[..., None]
        x = x.to(self.dtype) / 255.0
        if self.space_to_depth > 1:
            x = space_to_depth_nhwc(x, self.space_to_depth)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x, self.dtype), self.dtype))
        h = torch.relu(self.head(x, self.dtype))
        heat = self.heatmap(h, torch.float32)
        size = self.size(h, torch.float32)
        offset = self.offset(h, torch.float32)
        return {
            "heatmap": heat[:, 0],
            "size": size.permute(0, 2, 3, 1),
            "offset": offset.permute(0, 2, 3, 1),
        }


def decode_detections(outputs: Dict[str, torch.Tensor], max_faces: int = 16,
                      score_threshold: float = 0.3, iou_threshold: float = 0.4):
    """Batched static-shape decode: outputs -> (boxes [N, K, 4] pixel yxyx,
    scores [N, K], valid [N, K])."""
    heat = torch.sigmoid(outputs["heatmap"].float())  # [N, Hs, Ws]
    size = outputs["size"].float()
    offset = outputs["offset"].float()
    n, hs, ws = heat.shape
    # CenterNet peak NMS: keep cells that are their 3x3 neighborhood max
    # (max_pool2d pads with -inf, as flax's SAME max_pool).
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(heat >= pooled - 1e-6, heat, torch.zeros_like(heat))
    flat = peaks.reshape(n, hs * ws)
    k = min(max_faces * 4, hs * ws)  # over-collect, NMS trims
    scores, idx = nms_ops.stable_topk(flat, k)  # most peaks tie at 0
    cy = torch.div(idx, ws, rounding_mode="floor").float()
    cx = (idx % ws).float()
    gather = idx[..., None].expand(n, k, 2)
    sz = torch.gather(size.reshape(n, hs * ws, 2), 1, gather)
    off = torch.gather(offset.reshape(n, hs * ws, 2), 1, gather)
    cy = cy + off[..., 0]
    cx = cx + off[..., 1]
    bh = torch.clamp(sz[..., 0], min=1e-3)
    bw = torch.clamp(sz[..., 1], min=1e-3)
    boxes = torch.stack([(cy - bh / 2) * STRIDE, (cx - bw / 2) * STRIDE,
                         (cy + bh / 2) * STRIDE, (cx + bw / 2) * STRIDE], dim=-1)
    boxes, scores, valid = nms_ops.nms_fixed(boxes, scores, max_faces,
                                             iou_threshold, score_threshold)
    # Clamp to the decoded canvas (exclusive yxyx bounds); invalid slots
    # are zero boxes, unaffected.
    return clip_boxes(boxes, hs * STRIDE, ws * STRIDE), scores, valid


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """yxyx boxes clamped to [0, height] x [0, width]; the limits are
    kernel arguments, no tensor is copied to the device."""
    y = boxes[..., 0::2].clamp(0.0, float(height))
    x = boxes[..., 1::2].clamp(0.0, float(width))
    return torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)


class CNNFaceDetector:
    """Inference wrapper: ``detect_batch`` on device tensors, ``detect``
    -> host list of (x0, y0, x1, y1) like the reference's CascadedDetector.

    Defaults are the serving detector of the JAX package: features
    (64, 64), space_to_depth 4, 16 faces per image."""

    def __init__(self, features: Sequence[int] = (64, 64),
                 head_features: int = 64, max_faces: int = 16,
                 score_threshold: float = 0.3, iou_threshold: float = 0.4,
                 space_to_depth: int = 4, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.net = DetectorNet(features=features, head_features=head_features,
                               space_to_depth=space_to_depth, dtype=dtype,
                               generator=generator).to(self.device).eval()
        self.max_faces = int(max_faces)
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Load a state dict (``utils.params.detector_params_from_flax``
        turns the JAX package's params into one) in place: every parameter
        and its cached compute-dtype copy keep their addresses, so a
        captured serving step runs the new weights on its next replay."""
        self.net.load_state_dict(params)

    # -- checkpoints: the reference's format, both ways --

    def save(self, path: str) -> None:
        """Write ``{"header": {"format_version", "config_json"}, "params":
        flax tree}`` atomically: the JAX package's ``CNNFaceDetector.load``
        reads it."""
        payload = {
            "header": {
                "format_version": 1,
                "config_json": json.dumps({
                    "features": list(self.net.features),
                    "head_features": self.net.head_features,
                    "max_faces": self.max_faces,
                    "score_threshold": self.score_threshold,
                    "iou_threshold": self.iou_threshold,
                    "space_to_depth": self.net.space_to_depth,
                }),
            },
            "params": detector_params_to_flax(self.net),
        }
        serialization.atomic_write_bytes(path, _msgpack.packb(payload))

    @classmethod
    def load(cls, path: str, device: DeviceLike = DEFAULT_DEVICE) -> "CNNFaceDetector":
        """A detector from a checkpoint written by either package, on
        ``device``; ``space_to_depth`` defaults to 1 for older files."""
        payload = serialization.read_payload(path)
        config = json.loads(payload["header"]["config_json"])
        det = cls(features=tuple(config["features"]),
                  head_features=config["head_features"],
                  max_faces=config["max_faces"],
                  score_threshold=config["score_threshold"],
                  iou_threshold=config["iou_threshold"],
                  space_to_depth=config.get("space_to_depth", 1),
                  device=device)
        detector_params_from_flax(payload["params"], det.net)
        return det

    @torch.no_grad()
    def detect_batch(self, images):
        """[N, H, W] -> (boxes [N, K, 4] yxyx, scores [N, K], valid [N, K])
        on the detector's device. Any H/W: inputs are edge-padded to the
        decode stride and boxes clipped back to the caller's extent."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if images.is_cuda:
            disable_tf32()  # the float32 heads stay full float32
        h, w = images.shape[1], images.shape[2]
        ph, pw = (-h) % STRIDE, (-w) % STRIDE
        if ph or pw:
            images = F.pad(images[:, None], (0, pw, 0, ph), mode="replicate")[:, 0]
        boxes, scores, valid = decode_detections(
            self.net(images), self.max_faces, self.score_threshold,
            self.iou_threshold)
        return clip_boxes(boxes, h, w), scores, valid

    def detect(self, img):
        """One grayscale image -> [(x0, y0, x1, y1)] ints, x-first."""
        boxes, _scores, valid = self.detect_batch(np.asarray(img, np.float32)[None])
        out = []
        for b, ok in zip(boxes[0].cpu().numpy(), valid[0].cpu().numpy()):
            if ok:
                y0, x0, y1, x1 = (int(round(float(v))) for v in b)
                out.append((x0, y0, x1, y1))
        return out
