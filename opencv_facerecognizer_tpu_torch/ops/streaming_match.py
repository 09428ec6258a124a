"""Streaming gallery match: top-k of ``q . g^T`` over the valid gallery
rows without materializing the ``[Q, N]`` score matrix.

Port of ``opencv_facerecognizer_tpu/ops/pallas_match.py``
``streaming_match_topk``. The CUDA kernel is ``csrc/streaming_match.cu``
(its header says what bounds it on the H100 and how the design answers);
``streaming_match_topk_plain`` is the same function in plain PyTorch.

Semantics shared by both:

- operands are rounded to bf16 and the products accumulated in f32; a
  bf16 gallery is read as bf16, any other dtype as f32 (and rounded to
  bf16 at the product, as the Pallas kernel does);
- invalid rows never surface;
- equal similarities break toward the LOWEST gallery index;
- when fewer than ``k`` valid rows exist, the empty slots carry sim
  ``-1e30`` and index ``-1``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from opencv_facerecognizer_tpu_torch.ops import _build

NEG_INF = -1e30
#: gallery rows per chunk of the plain version (bounds its [Q, chunk]
#: score block)
PLAIN_CHUNK = 65536
#: the kernel keeps a running top-K per query in registers, K a power of
#: two up to this
MAX_K = 16
#: CTAs to aim for: four per SM on the H100's 132 SMs
TARGET_CTAS = 4 * 132


def streaming_match_topk_plain(q: torch.Tensor, g: torch.Tensor,
                               valid: torch.Tensor, *, k: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: chunked matmul + stable top-k merge.

    The running candidates sit before each new chunk (their indices are
    lower), so a stable descending sort keeps the lowest index first on
    ties, across chunks as within one."""
    qn = q.shape[0]
    qb = q.float().to(torch.bfloat16).float()
    vals = torch.full((qn, k), NEG_INF, dtype=torch.float32, device=q.device)
    idx = torch.full((qn, k), -1, dtype=torch.int64, device=q.device)
    valid = valid.to(torch.bool)
    for n0 in range(0, g.shape[0], PLAIN_CHUNK):
        gb = g[n0:n0 + PLAIN_CHUNK].to(torch.bfloat16).float()
        s = qb @ gb.T
        s = torch.where(valid[n0:n0 + PLAIN_CHUNK][None, :], s,
                        torch.full_like(s, NEG_INF))
        cols = torch.arange(n0, n0 + gb.shape[0], device=q.device)
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([idx, cols[None, :].expand(qn, -1)], dim=1)
        order = torch.sort(cand_v, dim=1, descending=True, stable=True)[1][:, :k]
        vals = torch.gather(cand_v, 1, order)
        idx = torch.gather(cand_i, 1, order)
    idx = torch.where(vals > NEG_INF * 0.5, idx, torch.full_like(idx, -1))
    return vals, idx.to(torch.int32)


def _kpad(k: int) -> int:
    kp = 1
    while kp < k:
        kp *= 2
    return kp


def _split(qn: int, n: int, block_q: int, block_n: int) -> Tuple[int, int]:
    """(splits, rows_per_split): enough N-splits that Q-tiles x splits
    fill the card, each split a whole number of gallery tiles."""
    q_tiles = -(-qn // block_q)
    n_tiles = max(1, -(-n // block_n))
    splits = max(1, min(n_tiles, -(-TARGET_CTAS // q_tiles)))
    rows = -(-n_tiles // splits) * block_n
    return max(1, -(-n // rows)), rows


def streaming_match_topk(q: torch.Tensor, g: torch.Tensor,
                         valid: torch.Tensor, *, k: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, D] float, g [N, D] (bf16 read as bf16, else f32), valid [N]
    bool -> (sims [Q, k] f32, indices [Q, k] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``D`` a multiple of 16, ``k <= 16``) or raise."""
    if q.ndim != 2 or g.ndim != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"q [Q, D] and g [N, D] expected, got {tuple(q.shape)}"
                         f" and {tuple(g.shape)}")
    if valid.shape != (g.shape[0],):
        raise ValueError(f"valid must be [{g.shape[0]}], got {tuple(valid.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if q.device.type == "cpu":
        return streaming_match_topk_plain(q, g, valid, k=k)
    if q.device.type != "cuda" or g.device != q.device or valid.device != q.device:
        raise ValueError("q, g and valid must lie on one CUDA device (or the CPU)")
    qn, d = q.shape
    n = g.shape[0]
    if d % 16 or k > MAX_K:
        raise ValueError(f"kernel needs D % 16 == 0 and k <= {MAX_K}; got D={d}, k={k}")
    q = q.to(torch.float32).contiguous()
    g_bf16 = g.dtype == torch.bfloat16
    g = (g if g_bf16 else g.to(torch.float32)).contiguous()
    valid = valid.to(torch.bool).contiguous()
    lib = _build.load("streaming_match")
    fn = lib.streaming_match_topk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    kp = _kpad(k)
    splits, rows = _split(qn, n, lib.streaming_match_block_q(),
                          lib.streaming_match_block_n())
    part_vals = torch.empty((splits, qn, kp), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((splits, qn, kp), dtype=torch.int32, device=q.device)
    vals = torch.empty((qn, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((qn, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), g.data_ptr(), int(g_bf16), valid.data_ptr(),
             part_vals.data_ptr(), part_idx.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), qn, n, d, k, kp, splits, rows, stream)
    streaming_match_topk.launches += 1
    _build.check(err, "streaming_match")
    return vals, idx


#: kernel launches through this wrapper (the serving run reads it to show
#: the main path went through the kernel)
streaming_match_topk.launches = 0
