"""Distance metrics, pairwise by construction: the part of
``opencv_facerecognizer_tpu/ops/distance.py`` a CNN model uses.

The unit of work is a pairwise block ``(Q queries, G gallery) -> [Q, G]``,
smaller meaning more similar (cosine is negated), in full float32 (the
reference runs these products at ``Precision.HIGHEST``). The histogram
family of the reference (chi-square, bin ratio, intersection, ...) serves
the classic features and waits for them (ROADMAP A.12).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

_EPS = 1e-12

PairwiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _as_2d(x) -> torch.Tensor:
    """Flatten anything to [batch, dim] float32; a single vector to [1, dim]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim == 1:
        return x[None, :]
    return x.reshape(x.shape[0], -1)


def euclidean(p, q) -> torch.Tensor:
    """Pairwise L2 distance [Q, G] via ||p||^2 + ||q||^2 - 2 p.q."""
    p, q = _as_2d(p), _as_2d(q)
    p2 = (p * p).sum(dim=-1)[:, None]
    q2 = (q * q).sum(dim=-1)[None, :]
    return torch.sqrt(torch.clamp(p2 + q2 - 2.0 * (p @ q.T), min=0.0))


def cosine(p, q) -> torch.Tensor:
    """Negative cosine similarity (min == most similar), one product."""
    p, q = _as_2d(p), _as_2d(q)
    pn = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=_EPS)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    return -(pn @ qn.T)


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


class CosineDistance(AbstractDistance):
    name = "cosine"
    pairwise = staticmethod(cosine)


DISTANCES: Dict[str, type] = {cls.name: cls for cls in (EuclideanDistance, CosineDistance)}

#: the reference's other distances, refused by name until ROADMAP A.12
NOT_PORTED = ("squared_euclidean", "normalized_correlation", "chi_square",
              "histogram_intersection", "bin_ratio", "l1_bin_ratio",
              "chi_square_brd", "manhattan")


def distance_from_spec(spec: dict) -> AbstractDistance:
    """``{"type", "config"}`` -> a distance; an unported one raises
    ``KeyError`` naming its ROADMAP item."""
    kind = spec["type"]
    if kind not in DISTANCES:
        hint = " (not ported yet: ROADMAP A.12)" if kind in NOT_PORTED else ""
        raise KeyError(f"unknown distance {kind!r}{hint}; ported: {sorted(DISTANCES)}")
    return DISTANCES[kind].from_config(spec["config"])
