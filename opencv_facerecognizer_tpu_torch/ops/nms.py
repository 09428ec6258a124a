"""Non-maximum suppression with static shapes.

Port of ``opencv_facerecognizer_tpu/ops/nms.py``. ``nms_mask`` takes
exactly K candidate boxes and returns a boolean keep-mask; ``nms_fixed``
returns exactly ``max_outputs`` slots. Both take an optional leading batch
dimension (the reference vmaps them over images).

The greedy keep-loop is one hand-written CUDA kernel on the card
(``csrc/nms.cu``: one CTA per image, the IoU flags as bits in shared
memory, the K-step scan by one warp), where eager PyTorch ran K steps of
about six launches each; the reference runs it as one ``lax.fori_loop``
in its jitted step. ``nms_mask_plain`` is that loop in PyTorch, the
version CPU tensors take and the kernel's oracle on the card.

Ties follow the reference: ``jnp.argsort`` and ``lax.top_k`` put equal
scores in index order, lowest first. ``torch.topk`` does not promise
that, so the orderings here are stable descending sorts.

Boxes are [y0, x0, y1, x1] in any consistent unit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opencv_facerecognizer_tpu_torch.ops import _build

#: the largest K the kernel takes (its scan keeps one 32-bit keep word per
#: lane of one warp)
KERNEL_MAX_K = 1024


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, equal values in
    index order (lowest index first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    h = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    w = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return h * w


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., K, 4], [..., M, 4] -> [..., K, M] IoU."""
    y0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(y1 - y0, min=0.0) * torch.clamp(x1 - x0, min=0.0)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _sorted_candidates(boxes: torch.Tensor, scores: torch.Tensor):
    """(order, boxes, scores) in stable descending score order, the
    reference's ``argsort(-scores)`` tie order (lowest index first)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True)[1]
    boxes_sorted = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    return order, boxes_sorted, torch.gather(scores, -1, order)


def nms_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float = 0.45,
                   score_threshold: float = 0.0) -> torch.Tensor:
    """Greedy NMS as a fixed-K boolean mask (True = kept), [..., K].

    Candidates are visited in descending score order; a box is kept iff
    no already-kept, higher-ranked box overlaps it above
    ``iou_threshold``. K sequential steps over the batch, as the
    reference's ``fori_loop``."""
    k = boxes.shape[-2]
    order, boxes_sorted, scores_sorted = _sorted_candidates(boxes, scores)
    iou = pairwise_iou(boxes_sorted, boxes_sorted)
    candidate = scores_sorted > score_threshold
    # suppress[..., i, j]: an earlier (j < i) box that overlaps box i
    earlier = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    suppress = (iou > iou_threshold) & earlier
    keep = candidate.clone()
    for i in range(k):
        overlapped = (keep & suppress[..., i, :]).any(-1)
        keep[..., i] = candidate[..., i] & ~overlapped
    # Scatter back to the original candidate order.
    return torch.zeros_like(keep).scatter(-1, order, keep)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.45,
             score_threshold: float = 0.0) -> torch.Tensor:
    """``nms_mask_plain``'s keep-mask, [..., K] bool.

    CPU tensors take the plain version; CUDA tensors (f32, K <= 1024)
    sort in PyTorch and launch the kernel for the keep-loop, or raise."""
    if boxes.shape[-1:] != (4,) or boxes.shape[:-1] != scores.shape:
        raise ValueError(f"boxes [..., K, 4] and scores [..., K] expected, got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, scores, iou_threshold, score_threshold)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError("boxes and scores must lie on one CUDA device (or the CPU)")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"the kernel takes f32 boxes and scores, got {boxes.dtype} "
                         f"and {scores.dtype}")
    k = boxes.shape[-2]
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {KERNEL_MAX_K}, got K={k}")
    keep = torch.empty(scores.shape, dtype=torch.bool, device=boxes.device)
    batch = scores.numel() // k
    if batch == 0:
        return keep
    order, boxes_sorted, scores_sorted = _sorted_candidates(boxes, scores)
    order, boxes_sorted, scores_sorted = (
        t.contiguous() for t in (order, boxes_sorted, scores_sorted))
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    # the library sets its shared-memory attribute and launches on the
    # current device: make that the tensors' device
    with torch.cuda.device(boxes.device):
        err = _lib().nms_keep(boxes_sorted.data_ptr(), scores_sorted.data_ptr(),
                              order.data_ptr(), keep.data_ptr(), batch, k,
                              iou_threshold, score_threshold, stream)
    _build.count_launch(nms_mask)
    _build.check(err, "nms")
    return keep


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    lib.nms_keep.restype = ctypes.c_int
    lib.nms_keep.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.nms_smem_bytes.restype = ctypes.c_size_t
    lib.nms_smem_bytes.argtypes = [ctypes.c_int]
    return lib


#: kernel launches through this wrapper (the serving run reads it to show
#: the main path went through the kernel)
nms_mask.launches = 0


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
              iou_threshold: float = 0.45, score_threshold: float = 0.0):
    """NMS returning exactly ``max_outputs`` (boxes, scores, valid-mask),
    best first; unused slots are zero boxes with -inf score."""
    keep = nms_mask(boxes, scores, iou_threshold, score_threshold)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = stable_topk(masked, max_outputs)
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
    valid = torch.isfinite(top_scores)
    return (
        torch.where(valid[..., None], top_boxes, torch.zeros_like(top_boxes)),
        torch.where(valid, top_scores, torch.full_like(top_scores, float("-inf"))),
        valid,
    )
