"""The benchmark's inputs, all drawn from ``--seed``: the nets' weights (one
state dict, made on the device in one draw), the pool of frames, and the
gallery's raw rows (made on the device in blocks, each block from its own
seed, so the check can draw any block again). Both the system under test
and the reference are handed these, and nothing either side made.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference import nets

#: gallery rows drawn per generator call (each block has its own seed)
ROW_BLOCK = 1 << 20


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``."""
    h = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), *map(int, tags)])
    return int(h.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _draw_state(shapes: Dict[str, Tuple[int, ...]], init: Dict[str, float], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """One normal draw on ``device`` split into the leaves: a conv or
    linear weight scaled by fan_in^-0.5 (LeCun normal), a norm weight
    1 + 0.1 n, any other bias 0.1 n, and the leaves named in ``init`` set
    to that constant."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        x = flat[at:at + n].reshape(shape)
        at += n
        if name in init:
            x = torch.full(shape, float(init[name]), device=device)
        elif name.endswith("weight") and len(shape) >= 2:
            x = x * float(np.prod(shape[1:])) ** -0.5
        elif ("norm" in name or ".gn" in name) and name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        out[name] = x.contiguous()
    return out


def make_weights(seed: int, det_cfg: dict, emb_cfg: dict, device):
    """(detector state dict, embedder state dict), float32 on ``device``."""
    det = _draw_state(nets.detector_shapes(det_cfg), det_cfg.get("init", {}),
                      sub_seed(seed, 1), device)
    emb = _draw_state(nets.embedder_shapes(emb_cfg), emb_cfg.get("init", {}),
                      sub_seed(seed, 2), device)
    return det, emb


def make_scenes(num_scenes: int, scene_size: Tuple[int, int], max_faces: int,
                face_size_range: Tuple[int, int], seed: int) -> np.ndarray:
    """Textured backgrounds with 0..max_faces bright ellipse "faces" with
    dark eyes pasted in, as uint8 [N, H, W] (the scene generator of the
    project's detection tests)."""
    rng = np.random.default_rng(seed)
    h, w = scene_size
    out = np.zeros((num_scenes, h, w), dtype=np.uint8)
    for i in range(num_scenes):
        bg = rng.normal(scale=1.0, size=(-(-h // 8), -(-w // 8))).astype(np.float32)
        bg = np.kron(bg, np.ones((8, 8), dtype=np.float32))[:h, :w]
        scene = 80.0 + 20.0 * bg + rng.normal(scale=6.0, size=(h, w)).astype(np.float32)
        n_faces = int(rng.integers(0, max_faces + 1))
        placed, attempts, boxes = 0, 0, []
        while placed < n_faces and attempts < 20:
            attempts += 1
            fs = int(rng.integers(face_size_range[0], face_size_range[1] + 1))
            y0 = int(rng.integers(0, h - fs + 1))
            x0 = int(rng.integers(0, w - fs + 1))
            if any(not (y0 + fs < by0 or by1 < y0 or x0 + fs < bx0 or bx1 < x0)
                   for by0, bx0, by1, bx1 in boxes):
                continue
            yy, xx = np.mgrid[0:fs, 0:fs].astype(np.float32)
            ellipse = (((yy - fs / 2) / (fs * 0.5)) ** 2
                       + ((xx - fs / 2) / (fs * 0.42)) ** 2) <= 1.0
            face = 190.0 + 30.0 * np.cos(yy / fs * 3.1) + rng.normal(scale=8.0, size=(fs, fs))
            for ex in (0.32, 0.68):
                eyy, exx, rr = int(fs * 0.38), int(fs * ex), max(1, fs // 10)
                face[eyy - rr:eyy + rr, exx - rr:exx + rr] -= 90.0
            region = scene[y0:y0 + fs, x0:x0 + fs]
            region[ellipse] = face[ellipse]
            boxes.append((y0, x0, y0 + fs, x0 + fs))
            placed += 1
        out[i] = np.clip(scene, 0, 255).astype(np.uint8)
    return out


def row_block(seed: int, block: int, rows: int, dim: int, device) -> torch.Tensor:
    """Raw (unnormalized) gallery rows ``[block * ROW_BLOCK, ...)``, at most
    ``ROW_BLOCK`` of them, float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3, block))
    return torch.randn((rows, dim), generator=gen, device=device, dtype=torch.float32)


def blocks(n_rows: int):
    """(block index, first row, rows) over ``n_rows``."""
    for b, start in enumerate(range(0, n_rows, ROW_BLOCK)):
        yield b, start, min(ROW_BLOCK, n_rows - start)


def plant_positions(seed: int, n_rows: int, n_plant: int) -> np.ndarray:
    """Distinct gallery rows, drawn from the seed, that hold planted rows."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    return np.sort(rng.choice(n_rows, size=n_plant, replace=False)).astype(np.int64)


def gallery_rows(seed: int, n_rows: int, dim: int, device, planted: torch.Tensor,
                 positions: np.ndarray) -> np.ndarray:
    """The raw rows as one host float32 array, the planted rows written at
    ``positions`` (drawn block by block on ``device``)."""
    host = np.empty((n_rows, dim), dtype=np.float32)
    host_t = torch.from_numpy(host)
    pos = torch.as_tensor(positions, device=device)
    for b, start, n in blocks(n_rows):
        block = row_block(seed, b, n, dim, device)
        mine = (pos >= start) & (pos < start + n)
        if bool(mine.any()):
            block[pos[mine] - start] = planted[mine].to(block.dtype)
        host_t[start:start + n].copy_(block)
    return host
