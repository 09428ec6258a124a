"""The port's compile-check entry point: port of ``__graft_entry__.py``'s
``entry()``.

``entry()`` returns ``(fn, example_args)``: the fused recognition forward
(detect -> align -> embed -> match, top-1) on one card, at the
reference's tiny shapes (batch 4, 128x128 frames, a 1024-row gallery,
``max_faces=8``). ``fn(det_params, emb_params, gallery, labels, frames)``
takes the nets' parameters as state dicts (``torch.func.functional_call``),
as the reference's jittable ``fn`` takes them as arguments, and returns
(boxes, det_scores, valid, top_labels, top_sims). The nets are the
serving detector and embedder with the port's seeded init; the gallery,
labels and frames come from the same numpy generator calls as the
reference's, so they are equal in both packages.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import functional_call

from opencv_facerecognizer_tpu_torch.models.detector import (
    CNNFaceDetector, decode_detections)
from opencv_facerecognizer_tpu_torch.models.embedder import (
    SERVING_EMBEDDER_KWARGS, SERVING_FACE_SIZE, FaceEmbedNet, normalize_faces)
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)

BATCH, HEIGHT, WIDTH = 4, 128, 128
GALLERY_ROWS = 1024
MAX_FACES = 8


def entry(device: DeviceLike = DEFAULT_DEVICE,
          dtype: torch.dtype = torch.bfloat16) -> Tuple[Callable, tuple]:
    """(fn, example_args): the single-card fused recognition forward, its
    nets computing in ``dtype``."""
    dev = resolve_device(device)
    det = CNNFaceDetector(max_faces=MAX_FACES, score_threshold=0.3, dtype=dtype,
                          device=dev, generator=torch.Generator().manual_seed(0))
    net = FaceEmbedNet(**SERVING_EMBEDDER_KWARGS, input_size=SERVING_FACE_SIZE,
                       dtype=dtype, generator=torch.Generator().manual_seed(1)).to(dev).eval()
    face_size = SERVING_FACE_SIZE
    embed_dim = SERVING_EMBEDDER_KWARGS["embed_dim"]

    rng = np.random.default_rng(0)
    gallery = rng.normal(size=(GALLERY_ROWS, embed_dim)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=-1, keepdims=True)
    labels = rng.integers(0, 64, size=GALLERY_ROWS).astype(np.int32)
    frames = rng.uniform(0, 255, size=(BATCH, HEIGHT, WIDTH)).astype(np.float32)

    @torch.no_grad()
    def fn(det_params, emb_params, gallery, labels, frames):
        outputs = functional_call(det.net, det_params, (frames,))
        boxes, det_scores, valid = decode_detections(
            outputs, det.max_faces, det.score_threshold, det.iou_threshold)
        crops = image_ops.batched_crop_resize(frames, boxes, face_size)
        flat = crops.reshape(frames.shape[0] * det.max_faces, *face_size)
        emb = functional_call(net, emb_params, (normalize_faces(flat, face_size),))
        # bf16 operands, f32 products (the reference's dot_general with
        # preferred_element_type=f32), ties to the lowest row
        sims = emb.to(torch.bfloat16).float() @ gallery.to(torch.bfloat16).float().T
        top_sims, top_idx = stable_topk(sims, 1)
        return boxes, det_scores, valid, labels[top_idx], top_sims

    example_args = (
        {k: v.detach().clone() for k, v in det.net.named_parameters()},
        {k: v.detach().clone() for k, v in net.named_parameters()},
        torch.from_numpy(gallery).to(dev),
        torch.from_numpy(labels).to(dev),
        torch.from_numpy(frames).to(dev),
    )
    return fn, example_args
