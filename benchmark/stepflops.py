"""Operations of one serving step at a rung: the reference's detector,
crop and embedder forwards counted by ``FlopCounterMode`` at the step's
shapes (on shapes alone, no data), plus the exact match over the valid
gallery rows."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

import roofline
from reference import nets


def nets_flops(cfg: dict, batch: int) -> float:
    det_cfg, emb_cfg, fr = cfg["detector"], cfg["embedder"], cfg["frames"]
    meta = torch.device("meta")
    det = {k: torch.empty(s, device=meta) for k, s in nets.detector_shapes(det_cfg).items()}
    emb = {k: torch.empty(s, device=meta) for k, s in nets.embedder_shapes(emb_cfg).items()}
    frames = torch.empty((batch, fr["height"], fr["width"]), device=meta)
    k = det_cfg["max_faces"]
    face = tuple(emb_cfg["face_size"])
    boxes = torch.empty((batch, k, 4), device=meta)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        nets.detector_maps(det, frames, det_cfg)
        crops = nets.crop_faces(frames, boxes, face)
        nets.embed(emb, crops.reshape(batch * k, *face), emb_cfg)
    return float(counter.get_total_flops())


def step_flops(cfg: dict, batch: int) -> float:
    gal = cfg["gallery"]
    queries = batch * cfg["detector"]["max_faces"]
    return nets_flops(cfg, batch) + roofline.match_flops(queries, gal["rows"], gal["dim"])
