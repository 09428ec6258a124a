"""The yardstick: the H100's published peaks, and the operations and bytes
each kernel of the step needs at its shapes, from which its least time
follows. Counts follow the project's own kernel notes: each input byte
read once, each output byte written once.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: NVIDIA H100 SXM (data sheet, dense, 700 W): bf16 tensor-core FLOP/s,
#: float32 FLOP/s outside the tensor cores, HBM3 bytes/s
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

#: kernel names as the profiler shows them
KERNEL_A = "match_wgmma_kernel"
KERNEL_B = "sepblock_kernel"
KERNEL_C = "nms_keep_kernel"


def match_flops(queries: int, rows: int, dim: int) -> float:
    """Exact top-1: one multiply-add per query, row and dimension."""
    return 2.0 * queries * rows * dim


def kernel_a_bound_s(queries: int, rows: int, dim: int, row_bytes: int = 2,
                     k: int = 1) -> Tuple[float, str]:
    """Kernel A's least time and what sets it: bf16 products at the bf16
    peak against the gallery rows, queries, validity flags and the
    top-k out (values f32, indices int32) once through HBM."""
    t_ops = match_flops(queries, rows, dim) / BF16_FLOPS
    nbytes = rows * dim * row_bytes + queries * dim * 4 + rows + queries * k * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sep_blocks(face_size: Sequence[int], stem: int, stage_features: Sequence[int],
               stage_blocks: Sequence[int]):
    """(H, W, C, F, stride) of each separable block of the embedder at its
    input resolution (the stem halves the face)."""
    h, w = face_size[0] // 2, face_size[1] // 2
    out, c = [], stem
    for feats, n in zip(stage_features, stage_blocks):
        for b in range(n):
            stride = 2 if b == 0 else 1
            out.append((h, w, c, feats, stride))
            h, w, c = h // stride, w // stride, feats
    return out


def sepblock_bound_s(batch: int, blocks: Iterable[Tuple[int, int, int, int, int]]
                     ) -> Tuple[float, str]:
    """Kernel B's least time for one forward (every block once): per block,
    bf16 activations in and out and the f32 parameters through HBM,
    against the pointwise product at the bf16 peak and the depthwise taps
    and norms at the f32 peak; the larger of the two, summed."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for h, w, c, f, stride in blocks:
        p = (h // stride) * (w // stride)
        nbytes = batch * h * w * c * 2 + batch * p * f * 2 + (9 * c + 2 * c + 2 * f) * 4 + c * f * 4
        t_ops = (2 * batch * p * c * f / BF16_FLOPS
                 + (2 * 9 * batch * p * c + 10 * batch * p * (c + f)) / F32_FLOPS)
        t_bytes = nbytes / HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        by["bytes" if t_bytes >= t_ops else "operations"] += max(t_ops, t_bytes)
    return total, max(by, key=by.get)
