"""The serving step: detect -> align -> embed -> match for one frame batch.

Port of ``opencv_facerecognizer_tpu/parallel/pipeline.py`` on one device.
Every frame contributes exactly ``max_faces`` slots; empty slots ride
along as invalid work, so every batch has the same shapes. The step runs
eagerly (the reference compiles it with ``jax.jit``; CUDA graphs are a
later change). The outputs leave the device as one packed
``[B, K, 6 + 2k]`` array with the reference's byte layout. The match is
the gallery's choice: the exact scan, or the two-stage IVF match once the
gallery's quantizer is ready; the step reads the gallery snapshot and the
quantizer snapshot once each and pins the choice for the batch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)


class RecognitionResult(NamedTuple):
    boxes: torch.Tensor  # [B, K, 4] pixel yxyx
    det_scores: torch.Tensor  # [B, K]
    valid: torch.Tensor  # [B, K] bool
    labels: torch.Tensor  # [B, K, k] gallery labels, best first
    similarities: torch.Tensor  # [B, K, k] cosine similarity


def pack_result(result: RecognitionResult) -> torch.Tensor:
    """[B, K, 6 + 2k] f32: boxes | det_score | valid | labels | sims (one
    array, so the serving loop reads back once per batch; labels ride as
    f32, exact below 2^24)."""
    return torch.cat([
        result.boxes.float(),
        result.det_scores.float()[..., None],
        result.valid.float()[..., None],
        result.labels.float(),
        result.similarities.float(),
    ], dim=-1)


def unpack_result(packed: np.ndarray, top_k: int) -> RecognitionResult:
    """Host-side inverse of ``pack_result`` (numpy views, no copies)."""
    return RecognitionResult(
        boxes=packed[..., 0:4],
        det_scores=packed[..., 4],
        valid=packed[..., 5] > 0.5,
        labels=packed[..., 6:6 + top_k].astype(np.int32),
        similarities=packed[..., 6 + top_k:6 + 2 * top_k],
    )


class RecognitionPipeline:
    """Holds the nets and the gallery and runs the per-batch step on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, detector: detector_mod.CNNFaceDetector,
                 embed_net: embedder_mod.FaceEmbedNet,
                 gallery: ShardedGallery,
                 face_size: Tuple[int, int] = embedder_mod.SERVING_FACE_SIZE,
                 top_k: int = 1, fused_embedder: bool = False,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()  # the f32 heads, f32 stacks and the crop stay full f32
        for name, dev in (("detector", detector.device),
                          ("gallery", gallery.device),
                          ("embed_net", next(embed_net.parameters()).device)):
            if dev != self.device:
                raise ValueError(f"{name} lives on {dev}, pipeline on {self.device}")
        self.detector = detector
        self.embed_net = embed_net.eval()
        self.gallery = gallery
        self.face_size = tuple(face_size)
        self.top_k = int(top_k)
        # The fused embed schedule (ops.sepblock, one kernel per stage
        # block): same parameters and math, off by default as in the
        # reference until a measurement on the card says otherwise.
        self.fused_embedder = bool(fused_embedder)

    def _as_device_frames(self, frames) -> torch.Tensor:
        """uint8 frames travel as uint8 (4x fewer bytes) and become float32
        on the device; anything else is float32 already on the host."""
        t = torch.as_tensor(frames)
        if t.dtype != torch.uint8:
            t = t.to(torch.float32)
        return t.to(self.device).to(torch.float32)

    @torch.no_grad()
    def embed_frames(self, frames) -> Tuple[torch.Tensor, ...]:
        """Detect -> align -> embed: [B, H, W] frames -> (boxes [B, K, 4],
        det_scores [B, K], valid [B, K], embeddings [B*K, E] unit-norm)."""
        frames = self._as_device_frames(frames)
        det = self.detector
        boxes, det_scores, valid = detector_mod.decode_detections(
            det.net(frames), det.max_faces, det.score_threshold,
            det.iou_threshold)
        crops = image_ops.batched_crop_resize(frames, boxes, self.face_size)
        faces = embedder_mod.normalize_faces(
            crops.reshape(-1, *self.face_size), self.face_size)
        if self.fused_embedder:
            emb = embedder_mod.fused_forward(self.embed_net, faces)
        else:
            emb = self.embed_net(faces)
        return boxes, det_scores, valid, emb

    @torch.no_grad()
    def recognize_batch(self, frames) -> RecognitionResult:
        """[B, H, W] frames (float32 or uint8) -> RecognitionResult on the
        device."""
        boxes, det_scores, valid, emb = self.embed_frames(frames)
        data = self.gallery.data  # one snapshot read
        ivf = self.gallery._ivf_data(data)  # one epoch-checked quantizer read
        match = self.gallery.match_fn(self.top_k, data.capacity, use_ivf=ivf is not None)
        args = (emb, data.embeddings, data.valid, data.labels)
        labels, sims, _ = match(*args, ivf) if ivf is not None else match(*args)
        b, k = valid.shape
        return RecognitionResult(
            boxes=boxes, det_scores=det_scores, valid=valid,
            labels=labels.reshape(b, k, -1),
            similarities=sims.reshape(b, k, -1))

    def recognize_batch_packed(self, frames) -> torch.Tensor:
        """The same step, its outputs packed into one [B, K, 6 + 2k] f32
        array (``pack_result``); decode on the host with
        ``unpack_result``."""
        return pack_result(self.recognize_batch(frames))

    def install_detector_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Publish new detector weights in place (same architecture)."""
        self.detector.load_params(params)

    def prewarm_batch_shapes(self, batch_sizes: Sequence[int], frame_shape,
                             dtype=np.float32) -> int:
        """Run the packed step once per batch size on zero frames, so the
        first real batch of each size pays no kernel build or convolution
        algorithm search. Returns the number of sizes run."""
        sizes = sorted({int(b) for b in batch_sizes})
        for b in sizes:
            out = self.recognize_batch_packed(np.zeros((b, *frame_shape), dtype))
            out.cpu()  # wait for the step to finish
        return len(sizes)
