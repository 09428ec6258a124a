"""The port's entry points: port of ``__graft_entry__.py``'s ``entry()``
and ``dryrun_multichip()``.

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

``dryrun_multichip(n_devices)`` runs the reference's three parts on a
(dp, tp) mesh of ``n_devices`` slots (tp 2 when n is even) at its tiny
shapes and prints its ``[dryrun]`` lines: one sharded ArcFace training
step (``parallel.train``: the batch over dp, the head's classes over tp),
one fused recognition batch over the mesh (frames over dp, a 32-row
gallery over tp) and, when dp is even, one two-stage batch over
``split_mesh``'s halves. The reference's fall-back to virtual CPU devices
when its backend is unusable is not ported (ROADMAP C.31): without a card
it raises, and the CPU runs only when the caller names it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from opencv_facerecognizer_tpu_torch.models.detector import (
    CNNFaceDetector, decode_detections)
from opencv_facerecognizer_tpu_torch.models.embedder import (
    SERVING_EMBEDDER_KWARGS, SERVING_FACE_SIZE, FaceEmbedNet, init_embedder, normalize_faces)
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, _local_devices
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


def dryrun_multichip(n_devices: int, device: DeviceLike = DEFAULT_DEVICE,
                     devices: Optional[Sequence[DeviceLike]] = None) -> None:
    """One sharded ArcFace step, one fused recognition batch and (dp even)
    one two-stage batch on a (dp, tp) mesh of ``n_devices`` slots: the
    first ``n_devices`` of ``devices``, a slot list (``["cpu"] * 4``, or
    four slots of one card), by default every card, or with
    ``device="cpu"`` ``n_devices`` CPU slots. Raises with fewer devices."""
    from opencv_facerecognizer_tpu_torch.parallel import (
        ShardedArcFaceStep, ShardedGallery, TwoStagePipeline, make_mesh, split_mesh)
    from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline

    if devices is None:
        dev = resolve_device(device)
        devices = [dev] * n_devices if dev.type == "cpu" else _local_devices()
    devices = list(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    tp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(dp=n_devices // tp, tp=tp, devices=devices[:n_devices])
    dp = mesh.shape[DP_AXIS]
    home = mesh.home.device
    print(f"[dryrun] mesh: dp={dp} tp={mesh.shape[TP_AXIS]} on {n_devices} devices")

    # 1) the ArcFace step: the batch over dp, the head's classes over tp
    face = (32, 32)
    num_classes = 8
    batch = dp * max(2, -(-8 // dp))  # a multiple of dp, at least 8
    net = FaceEmbedNet(embed_dim=32, stem_features=8, stage_features=(8, 16),
                       stage_blocks=(1, 1), input_size=face).to(home)
    head = init_embedder(net, num_classes, face, seed=0)
    step = ShardedArcFaceStep(mesh, net, head, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 255, size=(batch, *face)).astype(np.float32)).to(home)
    y = torch.from_numpy(rng.integers(0, num_classes, size=batch).astype(np.int32)).to(home)
    loss = step.step(normalize_faces(x, face), y)
    print(f"[dryrun] sharded ArcFace train step OK, loss={float(loss):.4f}")

    # 2) a fused recognition batch: frames over dp, the gallery over tp
    det = CNNFaceDetector(features=(8, 16, 32), head_features=32, max_faces=4,
                          score_threshold=0.3, device=home,
                          generator=torch.Generator().manual_seed(1))
    gallery = ShardedGallery(32, 32, mesh=mesh)
    emb0 = rng.normal(size=(16, 32)).astype(np.float32)
    gallery.add(emb0, np.arange(16, dtype=np.int32))
    pipe = RecognitionPipeline(det, net, gallery, face_size=face, device=home)
    frames = rng.uniform(0, 255, size=(batch, 64, 64)).astype(np.float32)
    result = pipe.recognize_batch(frames)
    print(f"[dryrun] fused recognition batch OK: boxes {tuple(result.boxes.shape)}, "
          f"labels {tuple(result.labels.shape)}")

    # 3) pipeline parallel: the two stages on disjoint halves of the mesh
    if dp >= 2 and dp % 2 == 0:
        mesh_a, mesh_b = split_mesh(mesh)
        gal_b = ShardedGallery(32, 32, mesh=mesh_b)
        gal_b.add(emb0, np.arange(16, dtype=np.int32))
        pp = TwoStagePipeline(det, net, None, gal_b, mesh_a, face_size=face)
        pp_out = pp.recognize_batch(frames)
        print(f"[dryrun] pipeline-parallel batch OK: stage meshes {mesh_a.shape} | "
              f"{mesh_b.shape}, labels {tuple(pp_out.labels.shape)}")
    else:
        print(f"[dryrun] pipeline-parallel skipped (dp={dp} not an even split)")
