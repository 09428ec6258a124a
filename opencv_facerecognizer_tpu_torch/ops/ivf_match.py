"""Two-stage IVF match: centroid shortlist, then an exact rerank of the
shortlisted cells with the streaming match kernel (kernel A).

Port of ``opencv_facerecognizer_tpu/ops/ivf_match.py``
(``parallel.quantizer`` owns the state; this module the math):

- **stage 1** (``shortlist_cells``) scores the queries against the
  ``nlist`` centroids and takes the batch's union of each query's
  top-``nprobe`` cells, in a static number of slots
  ``U = min(nlist, Q * nprobe)``, pads last as cell id ``nlist``;
- **bucket** (``gather_bucket``): the union's cell blocks and the spill,
  sorted by gallery row id and dequantized to bf16;
- **stage 2**: ``streaming_match_topk`` over the bucket (on a CUDA tensor
  the kernel, on the CPU its plain version), its local indices mapped back
  to gallery rows.

Sorting the bucket by row id turns the kernel's lowest-local-index
tie-break into the exact scan's lowest-gallery-index one. Also here: the
tie-aware comparators of two matchers' top-1 answers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.ops.streaming_match import streaming_match_topk

_INT32_MAX = 2**31 - 1


def shortlist_cells(q: torch.Tensor, centroids: torch.Tensor,
                    nprobe: int) -> torch.Tensor:
    """[U] ascending cell ids probed by any query, pads (id ``nlist``)
    last, U = min(nlist, Q * nprobe): no query's cell is ever dropped,
    and no shape depends on the data (no host sync).

    The scores are the reference's bf16 x bf16 -> f32 product: operands
    rounded to bf16 and multiplied in f32 (a bf16 matmul would round the
    scores to bf16 and change the shortlist; TF32 cannot change them, a
    bf16 value being exact in TF32). Equal scores go to the lowest cell
    id (``stable_topk``, as ``lax.top_k``)."""
    nlist = centroids.shape[0]
    p = min(int(nprobe), nlist)
    scores = q.to(torch.bfloat16).float() @ centroids.to(torch.bfloat16).float().T
    _, cells = stable_topk(scores, p)  # [Q, P]
    # index_fill_ takes the value as a kernel argument; ``mark[cells] =
    # True`` would copy a host scalar to the card on every call.
    mark = torch.zeros((nlist,), dtype=torch.bool, device=q.device).index_fill_(
        0, cells.reshape(-1), True)
    ids = torch.arange(nlist, device=q.device)
    u = min(nlist, q.shape[0] * p)
    return torch.sort(torch.where(mark, ids, nlist)).values[:u]


def gather_bucket(sel: torch.Tensor, valid: torch.Tensor, ivf
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rerank bucket of the cells ``sel`` plus the spill: (gallery
    row ids [N] int32, -1 pad; rows [N, D] bf16; valid [N] bool), N =
    U * max_cell + spill_cap, in ascending row id with pads last."""
    (_c, cell_rows, cell_q8, cell_scale,
     spill_rows, spill_q8, spill_scale) = tuple(ivf)[:7]
    nlist, max_cell, d = cell_q8.shape
    pad_cell = sel >= nlist
    selc = sel.clamp(max=nlist - 1)
    ids = torch.where(pad_cell[:, None], -1, cell_rows[selc]).reshape(-1)
    all_ids = torch.cat([ids, spill_rows])
    all_q8 = torch.cat([cell_q8[selc].reshape(-1, d), spill_q8])
    all_scale = torch.cat([cell_scale[selc].reshape(-1), spill_scale])
    order = torch.sort(torch.where(all_ids < 0, _INT32_MAX, all_ids),
                       stable=True).indices
    all_ids = all_ids[order]
    # Dequantize as the reference does: bf16(q8) * bf16(scale), rounded to
    # bf16 (not an f32 product).
    bucket = all_q8[order].to(torch.bfloat16) * all_scale[order].to(torch.bfloat16)[:, None]
    # Mask, never clip: a list entry past THIS gallery snapshot's capacity
    # (a fresher quantizer paired with an older snapshot of the same epoch
    # across a grow) must be skipped, not scored as row capacity - 1.
    cap = valid.shape[0]
    in_range = (all_ids >= 0) & (all_ids < cap)
    bvalid = in_range & valid[all_ids.clamp(0, cap - 1).long()]
    return all_ids, bucket, bvalid


def ivf_match_topk(q: torch.Tensor, valid: torch.Tensor, ivf, *, k: int = 1,
                   nprobe: int = 8, rerank=streaming_match_topk
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k over an IVF-quantized gallery.

    q [Q, D] float queries; valid [capacity] bool, the gallery's validity
    mask (list row ids index it); ivf an ``IVFDeviceData`` (or any tuple
    of its seven arrays). Returns (sims [Q, k] f32, gallery row indices
    [Q, k] int32), empty slots sim -1e30 and index -1. ``rerank`` is the
    stage-2 matcher (the plain version serves as the kernel's oracle on
    the card). Each call adds one to ``ivf_match_topk.calls``."""
    q = q.to(torch.float32)
    sel = shortlist_cells(q, ivf[0], nprobe)
    ids, bucket, bvalid = gather_bucket(sel, valid, ivf)
    vals, lidx = rerank(q, bucket, bvalid, k=k)
    gidx = torch.where(lidx < 0, -1, ids[lidx.clamp(min=0).long()])
    ivf_match_topk.calls += 1
    return vals, gidx


#: two-stage matches run (the serving run reads it to show the step took
#: the IVF path, not the exact fallback)
ivf_match_topk.calls = 0


# ---- tie-aware matcher comparison ----

def tie_aware_mismatch(vals_a, idx_a, vals_b, idx_b,
                       atol: float = 2e-2) -> np.ndarray:
    """Rows whose top-1 answers really disagree: the indices differ AND
    the two matchers' sims for their own winners differ beyond ``atol``
    (any index attaining the maximum is a right answer). Takes [Q] or
    [Q, 1] columns (numpy or CPU tensors)."""
    vals_a = np.asarray(vals_a, np.float32).reshape(-1)
    vals_b = np.asarray(vals_b, np.float32).reshape(-1)
    idx_a = np.asarray(idx_a).reshape(-1)
    idx_b = np.asarray(idx_b).reshape(-1)
    return (idx_a != idx_b) & (np.abs(vals_a - vals_b) > atol)


def tie_aware_agreement(vals_a, idx_a, vals_b, idx_b,
                        atol: float = 2e-2) -> float:
    """Fraction of rows whose top-1 agrees modulo ties: the recall of a
    two-stage answer against the exact one."""
    mism = tie_aware_mismatch(vals_a, idx_a, vals_b, idx_b, atol=atol)
    return float(1.0 - mism.mean()) if mism.size else 1.0
