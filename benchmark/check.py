"""What decides ``correct``: the served results judged against the plain
reference (``reference/``), which recomputes everything from the inputs.

Each sampled result is one frame of the pool as the system answered it: up
to ``max_faces`` faces, each a box, a detection score, a label and a
similarity. The judge maps every served face to the reference's grid cell
whose box is nearest, and reads five numbers, each the worst over the
sample:

- ``box_px``: how far (px, largest coordinate) a served box lies from that
  cell's reference box;
- ``score``: the gap between the served detection score and the cell's;
- ``selection``: how far the served set is from a valid greedy selection
  under the reference's scores: a served face below the score threshold, a
  served pair overlapping above the IoU threshold, or a reference peak left
  out that nothing served overlaps, each by the score it would take to
  excuse it (0 when the selection is valid);
- ``sim``: the gap between the served similarity and the reference's best
  similarity for the face as served: the reference crops the served box,
  embeds the crop and matches it over the whole gallery itself (so a box
  that moved by rounding is judged by ``box_px``, and not again here);
- ``label_gap``: for a face served with a label, how far the reference's
  similarity to the labelled row lies below its best.

Beside them the run counts ``lost``: frames sent that the service neither
answered nor accounted for as refused or dropped in its ledger, with the
limit 0. (A refused or dropped frame is a failure, counted in ``failed``.)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import cells as ref_cells
from reference import match as ref_match
from reference import nets

NUMBERS = ("box_px", "score", "selection", "sim", "label_gap")
#: IoU slack when reading NMS decisions off the reference's boxes (the
#: served boxes move by rounding)
IOU_SLACK = 0.01
#: pixels a unit of detection score weighs when a served face is mapped to
#: the nearest grid cell
SCORE_PX = 100.0


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), back in float32: the control's arithmetic."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Reference:
    """The reference's view of one run's inputs: the weights, the pool of
    frames, and the gallery (raw rows drawn again block by block from the
    seed, the planted rows written over them)."""

    def __init__(self, det_p, emb_p, det_cfg: dict, emb_cfg: dict, frames: torch.Tensor,
                 row_blocks: Callable[[], Sequence], quant=None, chunk: int = 32):
        nets.no_tf32()
        self.det_p, self.emb_p = det_p, emb_p
        self.det_cfg, self.emb_cfg = det_cfg, emb_cfg
        self.frames = frames
        self.row_blocks = row_blocks
        self.quant = quant
        self.chunk = chunk
        self._grid: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def recognize(self, idx: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The reference's own served faces for pool frames ``idx``."""
        parts = [nets.recognize_faces(self.det_p, self.emb_p,
                                      self.frames[list(idx[i:i + self.chunk])],
                                      self.det_cfg, self.emb_cfg, self.quant)
                 for i in range(0, len(idx), self.chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    @torch.no_grad()
    def grid(self) -> Dict[str, torch.Tensor]:
        """Every pool frame's grid candidates (``reference.cells``)."""
        if self._grid is None:
            parts = []
            for i in range(0, self.frames.shape[0], self.chunk):
                maps = nets.detector_maps(self.det_p, self.frames[i:i + self.chunk],
                                          self.det_cfg, self.quant)
                parts.append(ref_cells.grid_candidates(*maps))
            self._grid = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        return self._grid

    @torch.no_grad()
    def embed_boxes(self, frame_idx: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Embeddings of faces cropped at ``boxes`` [M, 4] of pool frames
        ``frame_idx`` [M]."""
        face = tuple(self.emb_cfg["face_size"])
        out = []
        for i in range(0, len(boxes), 1024):
            f = self.frames[frame_idx[i:i + 1024]]
            crops = nets.crop_faces(f, boxes[i:i + 1024, None], face, self.quant)[:, 0]
            out.append(nets.embed(self.emb_p, nets.standardize(crops), self.emb_cfg,
                                  self.quant))
        return torch.cat(out)

    @torch.no_grad()
    def top1(self, queries: torch.Tensor):
        return ref_match.top1(queries, self.row_blocks(), self.quant)

    @torch.no_grad()
    def row_sims(self, queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Similarity of each query with gallery row ``rows[i]``."""
        want = torch.zeros((len(rows), queries.shape[1]), device=queries.device)
        for start, block in self.row_blocks():
            hit = (rows >= start) & (rows < start + block.shape[0])
            if bool(hit.any()):
                want[hit] = block[rows[hit] - start].to(torch.float32)
        return ref_match.sims_at(queries, want)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[A, 4] x [B, 4] yxyx -> [A, B] IoU (float64)."""
    y0 = np.maximum(a[:, None, 0], b[None, :, 0])
    x0 = np.maximum(a[:, None, 1], b[None, :, 1])
    y1 = np.minimum(a[:, None, 2], b[None, :, 2])
    x1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(y1 - y0, 0, None) * np.clip(x1 - x0, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def faces_of(message: dict) -> np.ndarray:
    """A result message's faces as [F, 7]: y0, x0, y1, x1, score, label, sim."""
    rows = [[f["box"][1], f["box"][0], f["box"][3], f["box"][2], f["detection_score"],
             f["label"], f["similarity"]] for f in message.get("faces", ())]
    return np.asarray(rows, dtype=np.float64).reshape(-1, 7)


def _selection_gap(chosen: np.ndarray, grid_boxes: np.ndarray, grid_scores: np.ndarray,
                   margin: np.ndarray, peaks: np.ndarray, cfg: dict) -> float:
    """How far the chosen cells are from a valid greedy selection under
    the reference's scores: the decode's candidates are the 4 x max_faces
    best peaks (cells at least as high as their 8 neighbours), NMS keeps a
    candidate above the score threshold that no kept better one overlaps
    above the IoU threshold, and the best ``max_faces`` kept are served.
    Each departure is read as the score it would take to excuse it."""
    thr, iou_thr, kmax = cfg["score_threshold"], cfg["iou_threshold"], cfg["max_faces"]
    ranked = np.sort(grid_scores[peaks])[::-1]
    n_cand = 4 * kmax
    last_in = ranked[n_cand - 1] if len(ranked) >= n_cand else 0.0
    first_out = ranked[n_cand] if len(ranked) > n_cand else 0.0
    s = grid_scores[chosen]
    # served below the threshold, outside the candidates, or not a peak
    worst = float(np.max(np.maximum(np.maximum(thr - s, last_in - s), -margin[chosen]),
                         initial=0.0))
    b = grid_boxes[chosen]
    if len(chosen) > 1:
        iou = _iou(b, b)
        np.fill_diagonal(iou, 0.0)
        hit = iou > iou_thr + IOU_SLACK
        if hit.any():
            # no change of score excuses a pair NMS had to split: the
            # lower face's whole score is the gap
            worst = max(worst, float(np.minimum(s[:, None], s[None, :])[hit].max()))
    floor = max(thr if len(chosen) < kmax else float(s.min()), first_out)
    left = np.setdiff1d(np.flatnonzero(peaks & (grid_scores > floor)), chosen)
    if len(left) and len(chosen):
        covered = (_iou(grid_boxes[left], b) > iou_thr - IOU_SLACK).any(axis=1)
        left = left[~covered]
    if len(left):
        # a candidate that nothing served overlaps, left out: excused by
        # the score that would drop it below the floor or off its peak
        worst = max(worst, float(np.minimum(grid_scores[left] - floor, margin[left]).max()))
    return worst


@torch.no_grad()
def judge(samples: List[tuple], ref: Reference, det_cfg: dict) -> Dict[str, float]:
    """The five numbers over ``samples``, each (pool index of the frame,
    its result message)."""
    grid = ref.grid()
    g_boxes = grid["boxes"].double().cpu().numpy()
    g_raw = grid["raw"].double().cpu().numpy()
    g_scores = grid["scores"].double().cpu().numpy()
    g_peak = grid["peak"].cpu().numpy()
    g_margin = grid["margin"].double().cpu().numpy()
    out = dict.fromkeys(NUMBERS, 0.0)
    frame_idx, served = [], []
    for p, msg in samples:
        p = int(p)
        faces = faces_of(msg)
        if len(faces) == 0:
            chosen = np.zeros(0, np.int64)
        else:
            d = np.abs(faces[:, None, :4] - g_boxes[p][None]).max(-1)  # [F, C]
            # clipping can give cells at the frame's edge the same box: the
            # score tells them apart
            ds = np.abs(faces[:, None, 4] - g_scores[p][None])
            chosen = (d + SCORE_PX * ds).argmin(1)
            out["box_px"] = max(out["box_px"], float(d[np.arange(len(faces)), chosen].max()))
            out["score"] = max(out["score"], float(
                np.abs(faces[:, 4] - g_scores[p][chosen]).max()))
            frame_idx += [p] * len(faces)
            served.append(faces)
        out["selection"] = max(out["selection"], _selection_gap(
            chosen, g_raw[p], g_scores[p], g_margin[p], g_peak[p], det_cfg))
    if served:
        dev = ref.frames.device
        faces = np.concatenate(served)
        # every sampled answer of one pool frame asks about the same faces:
        # embed and match each (frame, box) once
        keys = np.concatenate([np.asarray(frame_idx, np.float64)[:, None], faces[:, :4]], 1)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        fi = torch.as_tensor(uniq[:, 0].astype(np.int64), device=dev)
        boxes = torch.as_tensor(uniq[:, 1:], dtype=torch.float32, device=dev)
        emb = ref.embed_boxes(fi, boxes)
        best, _ = ref.top1(emb)
        best_np = best.double().cpu().numpy()[inverse]
        out["sim"] = float(np.abs(faces[:, 6] - best_np).max())
        labelled = np.flatnonzero(faces[:, 5] >= 0)
        if len(labelled):
            q = emb[torch.as_tensor(inverse[labelled], device=dev)]
            rows = torch.as_tensor(faces[labelled, 5].astype(np.int64), device=dev)
            at = ref.row_sims(q, rows).double().cpu().numpy()
            out["label_gap"] = float((best_np[labelled] - at).max())
    return out


def answers(boxes, scores, valid, labels, sims, pool_index, sim_threshold: float
            ) -> List[tuple]:
    """(pool index, result message in the service's schema) from arrays
    [N, K, ...] (the control's answers, and the tests'): a face below
    ``sim_threshold`` is served without a label."""
    out = []
    for i in range(len(valid)):
        faces = []
        for j in np.flatnonzero(valid[i]):
            sim, lab = float(sims[i, j]), int(labels[i, j])
            y0, x0, y1, x1 = (float(v) for v in boxes[i, j])
            faces.append({"box": [x0, y0, x1, y1], "detection_score": float(scores[i, j]),
                          "label": lab if sim >= sim_threshold and lab >= 0 else -1,
                          "similarity": sim})
        out.append((int(pool_index[i]), {"meta": int(pool_index[i]), "faces": faces}))
    return out


@torch.no_grad()
def control_answers(ctl: Reference, pool_index: Sequence[int], sim_threshold: float
                    ) -> List[tuple]:
    """The control's answers: ``ctl`` (the reference in a lower precision)
    put in the system's place for the pool frames ``pool_index``."""
    own = ctl.recognize(list(pool_index))
    n, k = own["valid"].shape
    best, idx = ctl.top1(own["emb"].reshape(n * k, -1))
    return answers(own["boxes"].cpu().numpy(), own["scores"].cpu().numpy(),
                   own["valid"].cpu().numpy(), idx.reshape(n, k).cpu().numpy(),
                   best.reshape(n, k).cpu().numpy(), pool_index, sim_threshold)
