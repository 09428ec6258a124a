"""Every cell's candidate face in the reference: the box and score that the
decode would give each position of the stride-8 grid, before peak pooling
and NMS. A served face is judged against the cell whose box is nearest to
its own, so a face that a rounding difference moves in or out of the
selection is still judged on its box, score and identity.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from reference import nets


def grid_candidates(heat: torch.Tensor, size: torch.Tensor, offset: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Maps -> {"boxes" [N, C, 4] pixel yxyx clipped to the frame, as
    served, "raw" the same unclipped (what NMS compares), "scores" [N, C]
    sigmoid, "margin" [N, C] (the score less the best of its 8 neighbours),
    "peak" [N, C] bool (a 3x3 maximum, as the decode tests it)} over all
    C = Hs * Ws cells."""
    prob = torch.sigmoid(heat)
    n, hs, ws = prob.shape
    pooled = F.max_pool2d(prob[:, None], 3, stride=1, padding=1)[:, 0]
    peak = (prob >= pooled - 1e-6).reshape(n, hs * ws)
    padded = F.pad(prob[:, None], (1, 1, 1, 1), value=float("-inf"))
    around = torch.stack([padded[:, 0, dy:dy + hs, dx:dx + ws]
                          for dy in range(3) for dx in range(3) if (dy, dx) != (1, 1)])
    margin = (prob - around.amax(0)).reshape(n, hs * ws)
    cy = torch.arange(hs, device=heat.device, dtype=torch.float32)[:, None].expand(hs, ws)
    cx = torch.arange(ws, device=heat.device, dtype=torch.float32)[None, :].expand(hs, ws)
    cy = cy.reshape(-1) + offset[..., 0].reshape(n, -1)
    cx = cx.reshape(-1) + offset[..., 1].reshape(n, -1)
    bh = torch.clamp(size[..., 0].reshape(n, -1), min=1e-3)
    bw = torch.clamp(size[..., 1].reshape(n, -1), min=1e-3)
    s = nets.STRIDE
    raw = torch.stack([(cy - bh / 2) * s, (cx - bw / 2) * s,
                       (cy + bh / 2) * s, (cx + bw / 2) * s], dim=-1)
    y = raw[..., 0::2].clamp(0.0, float(hs * s))
    x = raw[..., 1::2].clamp(0.0, float(ws * s))
    boxes = torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], dim=-1)
    return {"boxes": boxes, "raw": raw, "scores": prob.reshape(n, -1), "margin": margin,
            "peak": peak}
