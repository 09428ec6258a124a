"""Plain PyTorch reference of the serving step's nets, in float32.

A frozen, independent copy of what the served step computes for one batch
of uint8 frames: the centre-heatmap detector (space-to-depth, SAME-padded
convs with the stride-2 pad on the high side, GroupNorm with statistics as
E[x^2] - E[x]^2, eps 1e-6), its decode (sigmoid, 3x3 peak pooling, a stable
top-k of 4 x max_faces candidates, boxes at stride 8), greedy NMS, the
crop (two tent-weight contractions) and per-face standardization, and the
separable embedder (stem, depthwise-separable blocks, global depthwise
conv, linear head, L2 normalization).

Everything runs in float32 with TF32 off, unless ``quant`` is given: then
each operand of a convolution, a contraction and the linear head passes
through ``quant`` first (the benchmark's fp8 control uses it). No module of
the system under test is imported here, and nothing the system made is
read: the weights are the benchmark's own state dict.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

STRIDE = 8

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


# ---- parameter shapes (the state dict both sides load) ----


def detector_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of the detector's parameters."""
    s = cfg["space_to_depth"]
    out: Dict[str, Tuple[int, ...]] = {}
    convs, norms = [], []
    in_ch = s * s
    for feats in cfg["features"]:
        convs += [(feats, in_ch, 3, 3), (feats, feats, 3, 3)]
        norms += [feats, feats]
        in_ch = feats
    for i, shape in enumerate(convs):
        out[f"convs.{i}.weight"] = shape
    for i, c in enumerate(norms):
        out[f"norms.{i}.weight"] = (c,)
        out[f"norms.{i}.bias"] = (c,)
    h = cfg["head_features"]
    out["head.weight"] = (h, in_ch, 3, 3)
    out["head.bias"] = (h,)
    for name, n in (("heatmap", 1), ("size", 2), ("offset", 2)):
        out[f"{name}.weight"] = (n, h, 1, 1)
        out[f"{name}.bias"] = (n,)
    return out


def embedder_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of the separable embedder's parameters."""
    out: Dict[str, Tuple[int, ...]] = {}
    stem = cfg["stem_features"]
    out["stem.weight"] = (stem, 1, 3, 3)
    out["stem_norm.weight"] = (stem,)
    out["stem_norm.bias"] = (stem,)
    in_ch, i = stem, 0
    for feats, nblocks in zip(cfg["stage_features"], cfg["stage_blocks"]):
        for b in range(nblocks):
            c = in_ch if b == 0 else feats
            out[f"blocks.{i}.dw.weight"] = (c, 1, 3, 3)
            out[f"blocks.{i}.gn1.weight"] = (c,)
            out[f"blocks.{i}.gn1.bias"] = (c,)
            out[f"blocks.{i}.pw.weight"] = (feats, c, 1, 1)
            out[f"blocks.{i}.gn2.weight"] = (feats,)
            out[f"blocks.{i}.gn2.bias"] = (feats,)
            i += 1
        in_ch = feats
    total_stride = 2 ** (1 + len(cfg["stage_features"]))
    gh, gw = (-(-d // total_stride) for d in cfg["face_size"])
    out["gdc.weight"] = (in_ch, 1, gh, gw)
    out["dense.weight"] = (cfg["embed_dim"], in_ch)
    out["dense.bias"] = (cfg["embed_dim"],)
    return out


# ---- layers ----


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
         stride: int = 1, groups: int = 1, same: bool = True, quant: Quant = None):
    """NCHW convolution; SAME padding puts the odd pad on the high side."""
    if same:
        ph = _same_pad(x.shape[2], w.shape[2], stride)
        pw = _same_pad(x.shape[3], w.shape[3], stride)
        x = F.pad(x, (*pw, *ph))
    return F.conv2d(_q(x, quant), _q(w, quant), b, stride=stride, groups=groups)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 4, eps: float = 1e-6) -> torch.Tensor:
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return y * weight.reshape(shape) + bias.reshape(shape)


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """[N, H, W] -> [N, s*s, H/s, W/s], channel index dy*s + dx."""
    n, h, w = x.shape
    x = x.reshape(n, h // s, s, w // s, s).permute(0, 2, 4, 1, 3)
    return x.reshape(n, s * s, h // s, w // s)


# ---- detector ----


def detector_maps(p: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
                  quant: Quant = None):
    """uint8 or float frames [N, H, W] -> (heatmap logits [N, Hs, Ws],
    size [N, Hs, Ws, 2], offset [N, Hs, Ws, 2])."""
    s = cfg["space_to_depth"]
    x = frames.to(torch.float32) / 255.0
    x = space_to_depth(x, s) if s > 1 else x[:, None]
    remaining, accum, i = STRIDE // s, 1, 0
    for _ in cfg["features"]:
        stride = 2 if accum < remaining else 1
        accum *= stride
        for st in (stride, 1):
            x = conv(x, p[f"convs.{i}.weight"], stride=st, quant=quant)
            x = torch.relu(group_norm(x, p[f"norms.{i}.weight"], p[f"norms.{i}.bias"]))
            i += 1
    h = torch.relu(conv(x, p["head.weight"], p["head.bias"], quant=quant))
    heat = conv(h, p["heatmap.weight"], p["heatmap.bias"], quant=quant)[:, 0]
    size = conv(h, p["size.weight"], p["size.bias"], quant=quant).permute(0, 2, 3, 1)
    offset = conv(h, p["offset.weight"], p["offset.bias"], quant=quant).permute(0, 2, 3, 1)
    return heat, size, offset


def stable_topk(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def iou_matrix(b: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] yxyx -> [..., K, K] IoU."""
    y0 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    x0 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    y1 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    x1 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(y1 - y0, min=0.0) * torch.clamp(x1 - x0, min=0.0)
    area = (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0.0))
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
               score_thr: float) -> torch.Tensor:
    """[N, K] keep mask: visit in stable descending score order, keep a box
    above the score threshold that no kept earlier box overlaps above the
    IoU threshold."""
    n, k = scores.shape
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    b = torch.gather(boxes, 1, order[..., None].expand(n, k, 4))
    s = torch.gather(scores, 1, order)
    over = iou_matrix(b) > iou_thr
    keep = torch.zeros((n, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        hit = (keep[:, :i] & over[:, i, :i]).any(-1) if i else torch.zeros_like(keep[:, 0])
        keep[:, i] = (s[:, i] > score_thr) & ~hit
    return torch.zeros_like(keep).scatter(1, order, keep)


def decode(heat: torch.Tensor, size: torch.Tensor, offset: torch.Tensor, cfg: dict):
    """Maps -> (boxes [N, K, 4] pixel yxyx, scores [N, K], valid [N, K]),
    K = max_faces, best first, empty slots zero boxes and -inf scores."""
    kmax = cfg["max_faces"]
    heat = torch.sigmoid(heat)
    n, hs, ws = heat.shape
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(heat >= pooled - 1e-6, heat, torch.zeros_like(heat))
    k = min(4 * kmax, hs * ws)
    scores, idx = stable_topk(peaks.reshape(n, hs * ws), k)
    cy = torch.div(idx, ws, rounding_mode="floor").float()
    cx = (idx % ws).float()
    gather = idx[..., None].expand(n, k, 2)
    sz = torch.gather(size.reshape(n, hs * ws, 2), 1, gather)
    off = torch.gather(offset.reshape(n, hs * ws, 2), 1, gather)
    cy, cx = cy + off[..., 0], cx + off[..., 1]
    bh, bw = torch.clamp(sz[..., 0], min=1e-3), torch.clamp(sz[..., 1], min=1e-3)
    boxes = torch.stack([(cy - bh / 2) * STRIDE, (cx - bw / 2) * STRIDE,
                         (cy + bh / 2) * STRIDE, (cx + bw / 2) * STRIDE], dim=-1)
    keep = greedy_nms(boxes, scores, cfg["iou_threshold"], cfg["score_threshold"])
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top, ti = stable_topk(masked, kmax)
    tb = torch.gather(boxes, 1, ti[..., None].expand(n, kmax, 4))
    valid = torch.isfinite(top)
    tb = torch.where(valid[..., None], tb, torch.zeros_like(tb))
    y = tb[..., 0::2].clamp(0.0, float(hs * STRIDE))
    x = tb[..., 1::2].clamp(0.0, float(ws * STRIDE))
    tb = torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)
    return tb, top, valid


# ---- crop and embedder ----


def crop_faces(frames: torch.Tensor, boxes: torch.Tensor, size: Tuple[int, int],
               quant: Quant = None) -> torch.Tensor:
    """Bilinear crops [N, K, h, w] of yxyx boxes, samples clamped to the
    frame: crop = Ay @ frame @ Ax^T with tent weights."""
    frames = frames.to(torch.float32)
    n, h, w = frames.shape
    oh, ow = size
    dev = frames.device
    ty = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    tx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    ys = boxes[..., 0, None] + (boxes[..., 2] - boxes[..., 0])[..., None] * ty - 0.5
    xs = boxes[..., 1, None] + (boxes[..., 3] - boxes[..., 1])[..., None] * tx - 0.5
    ys, xs = ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0)
    ay = torch.clamp(1.0 - (ys[..., None] - torch.arange(h, device=dev)).abs(), min=0.0)
    ax = torch.clamp(1.0 - (xs[..., None] - torch.arange(w, device=dev)).abs(), min=0.0)
    tmp = torch.einsum("nkih,nhw->nkiw", _q(ay, quant), _q(frames, quant))
    return torch.einsum("nkiw,nkjw->nkij", _q(tmp, quant), _q(ax, quant))


def standardize(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(x.std(dim=(-2, -1), keepdim=True, correction=0), min=1e-6)
    return (x - mean) / std


def embed(p: Dict[str, torch.Tensor], faces: torch.Tensor, cfg: dict,
          quant: Quant = None) -> torch.Tensor:
    """Standardized faces [M, h, w] -> unit embeddings [M, embed_dim]."""
    x = conv(faces[:, None], p["stem.weight"], stride=2, quant=quant)
    x = torch.relu(group_norm(x, p["stem_norm.weight"], p["stem_norm.bias"]))
    in_ch, i = cfg["stem_features"], 0
    for feats, nblocks in zip(cfg["stage_features"], cfg["stage_blocks"]):
        for b in range(nblocks):
            stride = 2 if b == 0 else 1
            c = x.shape[1]
            y = conv(x, p[f"blocks.{i}.dw.weight"], stride=stride, groups=c, quant=quant)
            y = torch.relu(group_norm(y, p[f"blocks.{i}.gn1.weight"],
                                      p[f"blocks.{i}.gn1.bias"]))
            y = group_norm(conv(y, p[f"blocks.{i}.pw.weight"], quant=quant),
                           p[f"blocks.{i}.gn2.weight"], p[f"blocks.{i}.gn2.bias"])
            if stride == 1 and c == feats:
                y = y + x
            x = torch.relu(y)
            i += 1
        in_ch = feats
    x = conv(x, p["gdc.weight"], groups=in_ch, same=False, quant=quant).flatten(1)
    x = F.linear(_q(x, quant), _q(p["dense.weight"], quant), p["dense.bias"])
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def recognize_faces(det_p: Dict[str, torch.Tensor], emb_p: Dict[str, torch.Tensor],
                    frames: torch.Tensor, det_cfg: dict, emb_cfg: dict,
                    quant: Quant = None) -> Dict[str, torch.Tensor]:
    """uint8 frames [N, H, W] -> {"boxes" [N, K, 4], "scores" [N, K],
    "valid" [N, K], "emb" [N, K, E]}; every slot is embedded, as served."""
    heat, size, offset = detector_maps(det_p, frames, det_cfg, quant)
    boxes, scores, valid = decode(heat, size, offset, det_cfg)
    face = tuple(emb_cfg["face_size"])
    crops = crop_faces(frames, boxes, face, quant)
    n, k = valid.shape
    emb = embed(emb_p, standardize(crops.reshape(n * k, *face)), emb_cfg, quant)
    return {"boxes": boxes, "scores": scores, "valid": valid, "emb": emb.reshape(n, k, -1)}
