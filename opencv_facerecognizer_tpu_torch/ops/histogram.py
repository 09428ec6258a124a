"""Spatial histograms of code maps (the LBPH descriptor): port of
``opencv_facerecognizer_tpu/ops/histogram.py``.

The reference histograms each grid cell by a one-hot sum, a ``[..., gy,
gx, cell pixels, bins]`` float32 array (9 GB for a 6x6 grid over 2432
70x70 images). The port counts with one ``scatter_add_`` on the flat
(sample, cell, code) index instead. The counts are integers, so the
histograms, and the L1 normalization after them, equal the reference's
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch


def spatial_histogram(codes, grid: Tuple[int, int] = (8, 8), num_bins: int = 256,
                      normalize: bool = True) -> torch.Tensor:
    """[..., H, W] integer codes -> [..., gy*gx*num_bins] concatenated cell
    histograms. The map is center-cropped to a multiple of the grid; each
    cell's histogram is L1-normalized when ``normalize``. A code outside
    [0, num_bins) counts nowhere, as in the reference's one-hot."""
    codes = torch.as_tensor(codes)
    gy, gx = grid
    h, w = codes.shape[-2], codes.shape[-1]
    ch, cw = h // gy, w // gx
    if ch == 0 or cw == 0:
        raise ValueError(f"code map {h}x{w} smaller than grid {grid}")
    y0 = (h - gy * ch) // 2
    x0 = (w - gx * cw) // 2
    codes = codes[..., y0:y0 + gy * ch, x0:x0 + gx * cw]
    batch = codes.shape[:-2]
    cells = codes.reshape(-1, gy, ch, gx, cw).transpose(2, 3).reshape(-1, gy * gx, ch * cw)
    codes64 = cells.to(torch.int64)
    inside = (codes64 >= 0) & (codes64 < num_bins)
    cell_id = torch.arange(gy * gx, device=codes.device)[None, :, None]
    flat = (cell_id * num_bins + torch.where(inside, codes64, 0)).reshape(cells.shape[0], -1)
    hist = torch.zeros((cells.shape[0], gy * gx * num_bins), dtype=torch.float32,
                       device=codes.device)
    hist.scatter_add_(1, flat, inside.reshape(cells.shape[0], -1).to(torch.float32))
    hist = hist.reshape(-1, gy * gx, num_bins)
    if normalize:
        hist = hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1e-12)
    return hist.reshape(*batch, gy * gx * num_bins)
