"""The system under test: the live recognizer of
``opencv_facerecognizer_tpu_torch`` built as a configuration states it,
fed by the benchmark's connector. The benchmark hands it the weights, the
gallery's raw rows and the frames, and takes from it only its results,
its tracer's spans and its kernels' names.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models import detector as detector_mod
from opencv_facerecognizer_tpu_torch.models import embedder as embedder_mod
from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
from opencv_facerecognizer_tpu_torch.runtime.ingest import IngestConfig
from opencv_facerecognizer_tpu_torch.runtime.recognizer import RecognizerService
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.tracing import Tracer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_kernels() -> float:
    """Build the program's CUDA kernels that are not built yet (its own
    cache under ``build/kernels/`` in the checkout); seconds taken."""
    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def build_service(cfg: dict, det_state: dict, emb_state: dict, rows: np.ndarray,
                  labels: np.ndarray, connector, device, tracer=None):
    """(service, pipeline, timings): the detector and embedder loaded with
    the benchmark's weights, the gallery filled with ``rows``, the
    pipeline, and the service wired to ``connector``, not started."""
    det_cfg, emb_cfg, gal, svc = cfg["detector"], cfg["embedder"], cfg["gallery"], cfg["service"]
    dtype = DTYPES[cfg["compute_dtype"]]
    t = {}
    t0 = time.perf_counter()
    det = detector_mod.CNNFaceDetector(
        features=tuple(det_cfg["features"]), head_features=det_cfg["head_features"],
        max_faces=det_cfg["max_faces"], score_threshold=det_cfg["score_threshold"],
        iou_threshold=det_cfg["iou_threshold"], space_to_depth=det_cfg["space_to_depth"],
        dtype=dtype, device=device)
    det.load_params(det_state)
    net = embedder_mod.FaceEmbedNet(
        embed_dim=emb_cfg["embed_dim"], stem_features=emb_cfg["stem_features"],
        stage_features=tuple(emb_cfg["stage_features"]),
        stage_blocks=tuple(emb_cfg["stage_blocks"]), block=emb_cfg["block"],
        space_to_depth=emb_cfg["space_to_depth"], norm=emb_cfg["norm"], dtype=dtype,
        input_size=tuple(emb_cfg["face_size"])).to(device)
    net.load_state_dict(emb_state)
    t["nets_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gallery = ShardedGallery(gal["rows"], gal["dim"], store_dtype=DTYPES[gal["dtype"]],
                             device=device)
    gallery.add(rows, labels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t["gallery_s"] = time.perf_counter() - t0
    pipeline = RecognitionPipeline(det, net, gallery, face_size=tuple(emb_cfg["face_size"]),
                                   top_k=gal["top_k"], fused_embedder=emb_cfg["fused"],
                                   device=device)
    frames = cfg["frames"]
    service = RecognizerService(
        pipeline, connector, batch_size=frames["batch"],
        frame_shape=(frames["height"], frames["width"]),
        flush_timeout=svc["flush_ms"] / 1e3, inflight_depth=svc["inflight_depth"],
        similarity_threshold=svc["similarity_threshold"], metrics=mn.Metrics(),
        readback_worker=svc["readback_worker"], bucket_sizes=tuple(svc["bucket_sizes"]),
        ingest=IngestConfig(mode=svc["ingest_mode"]), tracer=tracer, cascade=False)
    return service, pipeline, t


def make_tracer(frames_cap: int) -> Tracer:
    """Every frame traced, the rings sized for the run (three frame spans
    a frame, five batch spans a batch)."""
    return Tracer(ring_size=max(4096, 3 * frames_cap), sample=1.0)


def start(service) -> float:
    """Start the service (its warm-up captures every rung); seconds taken."""
    t0 = time.perf_counter()
    service.start(warmup=True)
    return time.perf_counter() - t0
