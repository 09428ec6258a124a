"""Distance metrics, pairwise by construction: port of
``opencv_facerecognizer_tpu/ops/distance.py``.

The unit of work is a pairwise block ``(Q queries, G gallery) -> [Q, G]``,
smaller meaning more similar (the similarities are negated or
complemented), in full float32 (the reference runs its products at
``Precision.HIGHEST``; on the card the port turns TF32 off before each).
Euclidean, cosine and correlation are one product plus elementwise terms.
The histogram family (chi-square, intersection, the bin ratios,
Manhattan) reduces a ``[Q, G, D]`` broadcast, which the reference builds
whole: 35 GB at Extended Yale-B's size under LBPH. The port computes the
same function in chunks of queries whose temporaries stay within
``PAIRWISE_BYTES``; a budget that cannot hold one query's block raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32

_EPS = 1e-12

#: bytes the temporaries of one broadcast chunk may take (module docstring)
PAIRWISE_BYTES = 4 << 30

PairwiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _as_2d(x) -> torch.Tensor:
    """Flatten anything to [batch, dim] float32; a single vector to [1, dim]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim == 1:
        return x[None, :]
    return x.reshape(x.shape[0], -1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product, out of TF32 on the card."""
    if a.is_cuda:
        disable_tf32()
    return a @ b


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=_EPS)


def euclidean(p, q) -> torch.Tensor:
    """Pairwise L2 distance [Q, G] via ||p||^2 + ||q||^2 - 2 p.q."""
    return torch.sqrt(squared_euclidean(p, q))


def squared_euclidean(p, q) -> torch.Tensor:
    p, q = _as_2d(p), _as_2d(q)
    p2 = (p * p).sum(dim=-1)[:, None]
    q2 = (q * q).sum(dim=-1)[None, :]
    return torch.clamp(p2 + q2 - 2.0 * _mm(p, q.T), min=0.0)


def cosine(p, q) -> torch.Tensor:
    """Negative cosine similarity (min == most similar), one product."""
    p, q = _as_2d(p), _as_2d(q)
    return -_mm(_unit(p), _unit(q).T)


def normalized_correlation(p, q) -> torch.Tensor:
    """1 - Pearson correlation: mean-center each vector, then cosine."""
    p, q = _as_2d(p), _as_2d(q)
    pc = p - p.mean(dim=-1, keepdim=True)
    qc = q - q.mean(dim=-1, keepdim=True)
    return 1.0 - _mm(_unit(pc), _unit(qc).T)


def _chunked(p, q, block, temporaries: int,
             pair: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block(p_chunk [c, D], q [G, D], pair_chunk) -> [c, G]`` over
    chunks of the queries, each chunk's ``temporaries`` float32 [c, G, D]
    arrays within the byte budget. ``pair`` ([Q, G] or None) is computed
    once for all queries and sliced with them, so a chunk's values do not
    depend on how the queries were split."""
    budget = PAIRWISE_BYTES
    per_query = temporaries * 4 * q.shape[0] * max(q.shape[1], 1)
    rows = budget // per_query
    if rows < 1:
        raise MemoryError(
            f"one query's pairwise block ({temporaries} x [{q.shape[0]}, {q.shape[1]}] "
            f"float32, {per_query} bytes) exceeds the budget of {budget} bytes")
    if rows >= p.shape[0]:
        return block(p, q, pair)
    return torch.cat([block(p[i:i + rows], q, None if pair is None else pair[i:i + rows])
                      for i in range(0, p.shape[0], rows)])


def _chi_square(p, q, _pair):
    pb, qb = p[:, None, :], q[None, :, :]
    d = pb - qb
    return torch.sum(d * d / torch.clamp(pb + qb, min=_EPS), dim=-1)


def chi_square(p, q) -> torch.Tensor:
    """Chi-square histogram distance: sum (p-q)^2 / (p+q)."""
    return _chunked(_as_2d(p), _as_2d(q), _chi_square, 4)


def _intersection(p, q, _pair):
    return -torch.sum(torch.minimum(p[:, None, :], q[None, :, :]), dim=-1)


def histogram_intersection(p, q) -> torch.Tensor:
    """Negated histogram intersection -sum(min(p, q)), so min == best."""
    return _chunked(_as_2d(p), _as_2d(q), _intersection, 1)


def _brd(p, q, temporaries: int, weight) -> torch.Tensor:
    """The bin-ratio family: the per-pair cross factor a = |1 - <p, q>|
    (one product over all queries), the per-bin numerator (p-q)^2 + 2a p
    q over (p+q)^2, times ``weight(p - q, p + q)``, summed. The
    reference's docstring states the domain caveat (histograms that sum
    to 1)."""
    p, q = _as_2d(p), _as_2d(q)

    def block(pc, qc, a):
        pb, qb = pc[:, None, :], qc[None, :, :]
        d = pb - qb
        num = d * d + 2.0 * a[:, :, None] * pb * qb
        s = torch.clamp(pb + qb, min=_EPS)
        ratio = num / (s * s)
        return torch.abs(torch.sum(ratio if weight is None else weight(d, s) * ratio, dim=-1))

    return _chunked(p, q, block, temporaries, torch.abs(1.0 - _mm(p, q.T)))


def bin_ratio(p, q) -> torch.Tensor:
    """Bin Ratio Dissimilarity: sum ((p-q)^2 + 2|1-p.q| p q) / (p+q)^2."""
    return _brd(p, q, 6, None)


def l1_bin_ratio(p, q) -> torch.Tensor:
    """L1-weighted BRD: sum |p-q| ((p-q)^2 + 2|1-p.q| p q) / (p+q)^2."""
    return _brd(p, q, 6, lambda d, s: torch.abs(d))


def chi_square_bin_ratio(p, q) -> torch.Tensor:
    """Chi-square-weighted BRD: sum ((p-q)^2/(p+q)) ((p-q)^2 + 2|1-p.q| p
    q) / (p+q)^2."""
    return _brd(p, q, 7, lambda d, s: d * d / s)


def _manhattan(p, q, _pair):
    return torch.sum(torch.abs(p[:, None, :] - q[None, :, :]), dim=-1)


def manhattan(p, q) -> torch.Tensor:
    """Pairwise L1 distance."""
    return _chunked(_as_2d(p), _as_2d(q), _manhattan, 2)


class AbstractDistance:
    """Carries a name and a pairwise function; ``__call__`` on two single
    vectors returns a scalar, on batches the whole block."""

    name: str = "abstract"
    pairwise: PairwiseFn = None  # type: ignore[assignment]

    def __call__(self, p, q) -> torch.Tensor:
        p = torch.as_tensor(p)
        q = torch.as_tensor(q)
        out = type(self).pairwise(p, q)
        return out[0, 0] if p.ndim == 1 and q.ndim == 1 else out

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"

    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, config: dict) -> "AbstractDistance":
        return cls(**config)


class EuclideanDistance(AbstractDistance):
    name = "euclidean"
    pairwise = staticmethod(euclidean)


class SquaredEuclideanDistance(AbstractDistance):
    name = "squared_euclidean"
    pairwise = staticmethod(squared_euclidean)


class CosineDistance(AbstractDistance):
    name = "cosine"
    pairwise = staticmethod(cosine)


class NormalizedCorrelation(AbstractDistance):
    name = "normalized_correlation"
    pairwise = staticmethod(normalized_correlation)


class ChiSquareDistance(AbstractDistance):
    name = "chi_square"
    pairwise = staticmethod(chi_square)


class HistogramIntersection(AbstractDistance):
    name = "histogram_intersection"
    pairwise = staticmethod(histogram_intersection)


class BinRatioDistance(AbstractDistance):
    name = "bin_ratio"
    pairwise = staticmethod(bin_ratio)


class L1BinRatioDistance(AbstractDistance):
    name = "l1_bin_ratio"
    pairwise = staticmethod(l1_bin_ratio)


class ChiSquareBRD(AbstractDistance):
    name = "chi_square_brd"
    pairwise = staticmethod(chi_square_bin_ratio)


class ManhattanDistance(AbstractDistance):
    name = "manhattan"
    pairwise = staticmethod(manhattan)


DISTANCES: Dict[str, type] = {cls.name: cls for cls in (
    EuclideanDistance, SquaredEuclideanDistance, CosineDistance, NormalizedCorrelation,
    ChiSquareDistance, HistogramIntersection, BinRatioDistance, L1BinRatioDistance,
    ChiSquareBRD, ManhattanDistance)}


def distance_from_spec(spec: dict) -> AbstractDistance:
    """``{"type", "config"}`` -> a distance; an unknown name raises
    ``KeyError``."""
    kind = spec["type"]
    if kind not in DISTANCES:
        raise KeyError(f"unknown distance {kind!r}; known: {sorted(DISTANCES)}")
    return DISTANCES[kind].from_config(spec["config"])
