"""CNN face detector, inference: port of
``opencv_facerecognizer_tpu/models/detector.py``.

A stride-8 anchor-free ("center-heatmap") FCN: conv blocks -> heatmap,
size and offset heads; ``decode_detections`` turns the maps into exactly
``max_faces`` boxes per image (sigmoid, 3x3 max-pool peaks, top-k, box
assembly, fixed-K NMS, clip). ``CNNFaceDetector.save`` / ``load`` write
and read the JAX package's detector checkpoint (a msgpack blob of
``header.config_json`` and the flax-layout ``params``).

Training is the reference's center-heatmap recipe: ``gaussian_heatmap_targets``
(host numpy, the reference's code), ``detector_loss`` (penalty-reduced
focal loss on the heatmap plus masked L1 on size and offset), Adam steps
over the reference's batches (``train_detector``), and
``evaluate_detector``'s greedy matching of ``detect_batch``'s boxes on
the host.

Numerics follow the flax module: bf16 compute with float32 parameters,
the input divided by 255 in the compute dtype, GroupNorm statistics in
float32, the three 1x1 heads in float32. Public tensors keep the
reference's layouts: frames [N, H, W], maps [N, Hs, Ws] and
[N, Hs, Ws, 2].
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

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
from opencv_facerecognizer_tpu_torch.models._train import adam, fixed_batches
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


# ---------- training (the reference's detector.py:162-326) ----------


def gaussian_heatmap_targets(boxes: np.ndarray, num_boxes: np.ndarray,
                             image_size: Tuple[int, int], max_boxes: int):
    """Host-side target builder: padded pixel yxyx boxes [N, B, 4] + counts
    -> (heatmap [N, Hs, Ws], size [N, Hs, Ws, 2], offset [N, Hs, Ws, 2],
    mask [N, Hs, Ws]), float32 numpy, the reference's arithmetic. The
    Gaussian splat's radius follows the box size."""
    n = boxes.shape[0]
    hs, ws = image_size[0] // STRIDE, image_size[1] // STRIDE
    heat = np.zeros((n, hs, ws), dtype=np.float32)
    size = np.zeros((n, hs, ws, 2), dtype=np.float32)
    offset = np.zeros((n, hs, ws, 2), dtype=np.float32)
    mask = np.zeros((n, hs, ws), dtype=np.float32)
    ys, xs = np.mgrid[0:hs, 0:ws]
    for i in range(n):
        for b in range(int(num_boxes[i])):
            y0, x0, y1, x1 = boxes[i, b] / STRIDE
            cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
            bh, bw = max(y1 - y0, 1e-3), max(x1 - x0, 1e-3)
            iy, ix = int(np.clip(cy, 0, hs - 1)), int(np.clip(cx, 0, ws - 1))
            sigma = max((bh + bw) / 8.0, 0.7)
            g = np.exp(-((ys - iy) ** 2 + (xs - ix) ** 2) / (2 * sigma**2))
            heat[i] = np.maximum(heat[i], g)
            size[i, iy, ix] = (bh, bw)
            offset[i, iy, ix] = (cy - iy, cx - ix)
            mask[i, iy, ix] = 1.0
    return heat, size, offset, mask


def detector_loss(outputs: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                  alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """Penalty-reduced focal loss on the heatmap + masked L1 on size and
    offset, each summed over the batch and divided by the positives."""
    pred = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-6, 1.0 - 1e-6)
    gt = targets["heatmap"]
    pos = (gt >= 0.999).to(torch.float32)
    pos_loss = -pos * ((1 - pred) ** alpha) * torch.log(pred)
    neg_loss = -(1 - pos) * ((1 - gt) ** beta) * (pred ** alpha) * torch.log(1 - pred)
    num_pos = torch.clamp(pos.sum(), min=1.0)
    heat_loss = (pos_loss.sum() + neg_loss.sum()) / num_pos
    m = targets["mask"][..., None]
    size_loss = (torch.abs(outputs["size"] - targets["size"]) * m).sum() / num_pos
    off_loss = (torch.abs(outputs["offset"] - targets["offset"]) * m).sum() / num_pos
    return heat_loss + 0.1 * size_loss + off_loss


def make_detector_train_step(model: DetectorNet, optimizer):
    """``step(images, targets) -> loss``: one Adam step of ``model`` in place."""

    def step(images: torch.Tensor, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = detector_loss(model(images), targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_detector(model: DetectorNet, images, boxes, num_boxes, *, steps: int = 300,
                   batch_size: int = 16, learning_rate: float = 1e-3, seed: int = 0,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   log_every: int = 0) -> Dict[str, torch.Tensor]:
    """Train ``model`` in place on (images [N, H, W] in 0..255, padded
    boxes [N, B, 4], counts [N]) on its device, from ``params`` (a state
    dict) or, when None, from a fresh init drawn from ``seed``. Returns
    its state dict."""
    images = np.asarray(images, np.float32)
    boxes = np.asarray(boxes, np.float32)
    h, w = images.shape[1], images.shape[2]
    heat, size, offset, mask = gaussian_heatmap_targets(boxes, num_boxes, (h, w),
                                                        boxes.shape[1])
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        disable_tf32()
    step = make_detector_train_step(model, adam(model.parameters(), learning_rate))
    n = images.shape[0]
    batch_size = min(batch_size, n)
    batches = fixed_batches(n, batch_size, steps, seed, dev)
    x = torch.as_tensor(images).to(dev)
    t_all = {k: torch.as_tensor(v).to(dev) for k, v in
             (("heatmap", heat), ("size", size), ("offset", offset), ("mask", mask))}
    for i in range(steps):
        idx = batches[i]
        loss = step(x[idx], {k: v[idx] for k, v in t_all.items()})
        if log_every and (i + 1) % log_every == 0:
            print(f"  detector step {i + 1}/{steps}: loss {float(loss):.4f}")
    return model.state_dict()


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def evaluate_detector(detector: "CNNFaceDetector", scenes, gt_boxes, gt_counts,
                      iou_threshold: float = 0.5, batch_size: int = 32) -> Dict[str, float]:
    """Detection quality against oracle boxes: recall / precision at IoU.
    Greedy matching per image on the host, as the reference's: predictions
    in descending score order claim the best still-unmatched ground-truth
    box with IoU >= threshold. Returns {"recall", "precision", "f1",
    "mean_matched_iou", "num_gt", "num_pred"}."""
    scenes = np.asarray(scenes, np.float32)
    gt_boxes = np.asarray(gt_boxes, np.float32)
    gt_counts = np.asarray(gt_counts)
    tp = fp = 0
    total_gt = int(gt_counts.sum())
    matched_ious = []
    for start in range(0, len(scenes), batch_size):
        chunk = scenes[start:start + batch_size]
        boxes, scores, valid = (_host(v) for v in detector.detect_batch(chunk))
        for i in range(len(chunk)):
            gi = start + i
            gts = gt_boxes[gi, :int(gt_counts[gi])]
            taken = np.zeros(len(gts), dtype=bool)
            for j in np.argsort(-scores[i]):
                if not valid[i, j]:
                    continue
                py0, px0, py1, px1 = boxes[i, j]
                best_iou, best_g = 0.0, -1
                for gidx, (gy0, gx0, gy1, gx1) in enumerate(gts):
                    if taken[gidx]:
                        continue
                    iy = max(0.0, min(py1, gy1) - max(py0, gy0))
                    ix = max(0.0, min(px1, gx1) - max(px0, gx0))
                    inter = iy * ix
                    union = (py1 - py0) * (px1 - px0) + (gy1 - gy0) * (gx1 - gx0) - inter
                    iou = inter / union if union > 0 else 0.0
                    if iou > best_iou:
                        best_iou, best_g = iou, gidx
                if best_g >= 0 and best_iou >= iou_threshold:
                    taken[best_g] = True
                    tp += 1
                    matched_ious.append(best_iou)
                else:
                    fp += 1
    recall = tp / total_gt if total_gt else float("nan")
    precision = tp / (tp + fp) if (tp + fp) else float("nan")
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"recall": recall, "precision": precision, "f1": f1,
            "mean_matched_iou": float(np.mean(matched_ious)) if matched_ious else 0.0,
            "num_gt": total_gt, "num_pred": tp + fp}


class CNNFaceDetector:
    """``detect_batch`` on device tensors, ``detect`` -> host list of
    (x0, y0, x1, y1) like the reference's CascadedDetector, and ``train``.

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
        #: weights were loaded or trained: ``train`` fine-tunes them (else
        #: it starts from a fresh init, as the reference's does)
        self._loaded = False

    def train(self, images, boxes, num_boxes, **kwargs) -> "CNNFaceDetector":
        """``train_detector`` on this detector's net and device; fine-tunes
        loaded or trained weights, else starts from ``seed``'s init."""
        train_detector(self.net, images, boxes, num_boxes,
                       params=self.net.state_dict() if self._loaded else None, **kwargs)
        self._loaded = True
        return self

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Load a state dict (``utils.params.detector_params_from_flax``
        turns the JAX package's params into one) in place: every parameter
        and its cached compute-dtype copy keep their addresses, so a
        captured serving step runs the new weights on its next replay."""
        self.net.load_state_dict(params)
        self._loaded = True

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
        det._loaded = True
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
