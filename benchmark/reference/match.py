"""Plain exact top-1 of unit queries against the raw gallery rows, in float32
blocks with TF32 off. The rows are normalized here (the reference works the
normalization out itself); ties go to the lowest row.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

#: rows and queries per product, so a [queries, rows] block stays near 1 GiB
CHUNK_ROWS = 1 << 16
CHUNK_QUERIES = 4096


def normalize_rows(rows: torch.Tensor) -> torch.Tensor:
    rows = rows.to(torch.float32)
    return rows / torch.clamp(torch.linalg.vector_norm(rows, dim=-1, keepdim=True), min=1e-12)


def top1(queries: torch.Tensor, row_blocks: Iterable[Tuple[int, torch.Tensor]],
         quant: Quant = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best similarity and its row for each query, over ``(first row,
    raw rows)`` blocks taken in order. With ``quant``, queries and
    normalized rows pass through it before the product."""
    q = queries.to(torch.float32)
    if quant is not None:
        q = quant(q)
    best = torch.full((q.shape[0],), float("-inf"), device=q.device)
    arg = torch.full((q.shape[0],), -1, dtype=torch.int64, device=q.device)
    for start, rows in row_blocks:
        for at in range(0, rows.shape[0], CHUNK_ROWS):
            g = normalize_rows(rows[at:at + CHUNK_ROWS])
            if quant is not None:
                g = quant(g)
            for q0 in range(0, q.shape[0], CHUNK_QUERIES):
                v, i = (q[q0:q0 + CHUNK_QUERIES] @ g.T).max(dim=1)  # first max: lowest row
                better = v > best[q0:q0 + CHUNK_QUERIES]  # strictly: earlier rows keep a tie
                best[q0:q0 + CHUNK_QUERIES] = torch.where(better, v, best[q0:q0 + CHUNK_QUERIES])
                arg[q0:q0 + CHUNK_QUERIES] = torch.where(
                    better, i + start + at, arg[q0:q0 + CHUNK_QUERIES])
    return best, arg


def sims_at(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Similarity of each query with its own raw row (one row per query)."""
    return (queries.to(torch.float32) * normalize_rows(rows)).sum(-1)
