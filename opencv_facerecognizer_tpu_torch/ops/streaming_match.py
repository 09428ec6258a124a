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
from opencv_facerecognizer_tpu_torch.utils.device import sm_count

NEG_INF = -1e30
#: gallery rows per chunk of the plain version (bounds its [Q, chunk]
#: score block)
PLAIN_CHUNK = 65536
#: one pass of the kernel keeps a running top-K per query in registers, K
#: a power of two up to ROUND_K; a larger k, any k, runs ceil(k / ROUND_K)
#: passes over the gallery
ROUND_K = 16
#: the two kernel paths: "wgmma" (TMA + wgmma; bf16 gallery, D % 64 == 0,
#: D <= WGMMA_MAX_D) and "wmma" (any gallery dtype, D % 16 == 0); each
#: path's gallery rows per tile and CTAs per SM
WGMMA_MAX_D = 256
BLOCK_N = {"wgmma": 128, "wmma": 64}
CTAS_PER_SM = {"wgmma": 1, "wmma": 4}


def block_q(path: str, k: int) -> int:
    """Queries per CTA: the "wgmma" path runs four warpgroups of 64
    queries at k = 1 and two above, the "wmma" path 128."""
    return (256 if kpad(k) == 1 else 128) if path == "wgmma" else 128


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


def kpad(k: int) -> int:
    """K of the kernel's per-pass lists: the next power of two of k up to
    ROUND_K, else ROUND_K (and ceil(k / ROUND_K) passes)."""
    kp = 1
    while kp < min(k, ROUND_K):
        kp *= 2
    return kp


def match_path(g_dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel path a gallery takes: "wgmma" for a bf16 gallery with
    D % 64 == 0 and D <= WGMMA_MAX_D (16-byte aligned q and g, which TMA
    needs), else "wmma"."""
    if g_dtype == torch.bfloat16 and d % 64 == 0 and d <= WGMMA_MAX_D and aligned:
        return "wgmma"
    return "wmma"


def launch_plan(qn: int, n: int, path: str, sms: int, k: int = 1) -> Tuple[int, int]:
    """(splits, rows_per_split) of one pass: the grid is ceil(qn /
    block_q(path, k)) query tiles x splits CTAs; split s streams gallery
    rows [s * rows_per_split, min(n, (s + 1) * rows_per_split)), a whole
    number of tiles. Enough splits that the grid fills CTAS_PER_SM[path]
    CTAs on each of ``sms`` SMs (one CTA per SM for "wgmma", whose grid is
    then one wave) and no split is empty."""
    block_n = BLOCK_N[path]
    target = CTAS_PER_SM[path] * sms
    q_tiles = -(-qn // block_q(path, k))
    n_tiles = max(1, -(-n // block_n))
    splits = max(1, min(n_tiles, target // q_tiles if path == "wgmma"
                        else -(-target // q_tiles)))
    rows = -(-n_tiles // splits) * block_n
    return max(1, -(-n // rows)), rows


_checked = False


def _lib() -> ctypes.CDLL:
    """The kernel's library, its constants checked against the wrapper's."""
    global _checked
    lib = _build.load("streaming_match")
    if not _checked:
        for name in ("wgmma_block_q", "wgmma_block_n", "wmma_block_q", "wmma_block_n",
                     "round_k", "wgmma_max_d"):
            const = getattr(lib, f"streaming_match_{name}")
            const.restype = ctypes.c_int
            const.argtypes = [ctypes.c_int] if name == "wgmma_block_q" else []
        consts = (lib.streaming_match_wgmma_block_q(1), lib.streaming_match_wgmma_block_q(2),
                  lib.streaming_match_wgmma_block_n(), lib.streaming_match_wmma_block_q(),
                  lib.streaming_match_wmma_block_n(), lib.streaming_match_round_k(),
                  lib.streaming_match_wgmma_max_d())
        mine = (block_q("wgmma", 1), block_q("wgmma", 2), BLOCK_N["wgmma"],
                block_q("wmma", 1), BLOCK_N["wmma"], ROUND_K, WGMMA_MAX_D)
        if consts != mine:
            raise RuntimeError(f"streaming_match library constants {consts} differ "
                               f"from the wrapper's {mine}")
        lib.streaming_match_smem_bytes.restype = ctypes.c_longlong
        lib.streaming_match_smem_bytes.argtypes = [ctypes.c_int] * 3
        fn = lib.streaming_match_topk
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        _checked = True
    return lib


def match_smem_bytes(d: int, k: int, path: str) -> int:
    """Dynamic shared memory of one CTA of the kernel's ``path`` at
    dimension ``d`` and top-``k``."""
    return int(_lib().streaming_match_smem_bytes(d, kpad(k), int(path == "wgmma")))


def streaming_match_topk(q: torch.Tensor, g: torch.Tensor,
                         valid: torch.Tensor, *, k: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, D] float, g [N, D] (bf16 read as bf16, else f32), valid [N]
    bool -> (sims [Q, k] f32, indices [Q, k] int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``D`` a multiple of 16, any k) or raise. The path the last
    launch took is ``streaming_match_topk.last_path``."""
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
    if d % 16:
        raise ValueError(f"kernel needs D % 16 == 0; got D={d}")
    if qn == 0 or n == 0:  # nothing to launch: every slot is empty
        return (torch.full((qn, k), NEG_INF, dtype=torch.float32, device=q.device),
                torch.full((qn, k), -1, dtype=torch.int32, device=q.device))
    q = q.to(torch.float32).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    g_bf16 = g.dtype == torch.bfloat16
    g = (g if g_bf16 else g.to(torch.float32)).contiguous()
    valid = valid.to(torch.bool).contiguous()
    path = match_path(g.dtype, d, aligned=g.data_ptr() % 16 == 0)
    fn = _lib().streaming_match_topk
    kp = kpad(k)
    splits, rows = launch_plan(qn, n, path, sm_count(q.device), k)
    dev = q.device
    part_vals = torch.empty((splits, qn, kp), dtype=torch.float32, device=dev)
    part_idx = torch.empty((splits, qn, kp), dtype=torch.int32, device=dev)
    vals = torch.empty((qn, k), dtype=torch.float32, device=dev)
    idx = torch.empty((qn, k), dtype=torch.int32, device=dev)
    bounds = ((torch.empty(qn, dtype=torch.float32, device=dev),
               torch.empty(qn, dtype=torch.int32, device=dev)) if k > kp else None)
    bound_ptrs = (bounds[0].data_ptr(), bounds[1].data_ptr()) if bounds else (None, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), g.data_ptr(), int(g_bf16), valid.data_ptr(),
             part_vals.data_ptr(), part_idx.data_ptr(), vals.data_ptr(),
             idx.data_ptr(), *bound_ptrs, qn, n, d, k, kp,
             int(path == "wgmma"), splits, rows, stream)
    streaming_match_topk.launches += 1
    streaming_match_topk.last_path = path
    _build.check(err, "streaming_match")
    return vals, idx


#: kernel launches through this wrapper (the serving run reads it to show
#: the main path went through the kernel)
streaming_match_topk.launches = 0
streaming_match_topk.last_path = None
