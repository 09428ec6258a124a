"""Eigen-solvers of the subspace features (PCA, LDA, Fisherfaces): port
of ``opencv_facerecognizer_tpu/ops/linalg.py``.

Every fit runs on the tensor's device in float32 (on the card:
cuSOLVER's ``syevd`` for ``eigh``, ``potrf`` for the Cholesky factor,
triangular solves, cuBLAS products with TF32 off, as the reference's
``Precision.HIGHEST``). The Gram trick keeps PCA's eigenproblem at
[N, N] when D > N (70 x 70 = 4900 pixels over a few hundred to a few
thousand images). LDA whitens the regularized within-class scatter by
its Cholesky factor and takes ``eigh`` of the whitened between-class
scatter.

Eigenvectors are defined up to sign, and those on (near-)equal
eigenvalues up to a rotation; LAPACK, XLA and cuSOLVER may pick
differently there, so the tests compare subspaces by their projectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32


class PCAState(NamedTuple):
    mean: torch.Tensor  # [D]
    components: torch.Tensor  # [D, K] column eigenvectors, descending eigenvalue
    eigenvalues: torch.Tensor  # [K]


class LDAState(NamedTuple):
    components: torch.Tensor  # [D, K]
    eigenvalues: torch.Tensor  # [K]


def _f32(x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32)
    if x.is_cuda:
        disable_tf32()
    return x


def _unit_columns(m: torch.Tensor) -> torch.Tensor:
    return m / torch.clamp(torch.linalg.vector_norm(m, dim=0, keepdim=True), min=1e-12)


def pca_fit(x, num_components: int) -> PCAState:
    """PCA of the row matrix ``x`` [N, D], the top ``num_components``
    (1 <= K <= min(N, D)): eigh of the [N, N] Gram matrix when D > N,
    else of the [D, D] scatter. Eigenvalues are the scatter's."""
    x = _f32(x)
    n, d = x.shape
    k = int(num_components)
    if k <= 0 or k > min(n, d):
        raise ValueError(f"num_components={k} must be in [1, min(N={n}, D={d})]")
    mean = x.mean(dim=0)
    xc = x - mean
    if d > n:
        evals, evecs = torch.linalg.eigh(xc @ xc.T)
        evals = evals.flip(0)[:k]
        comps = _unit_columns(xc.T @ evecs.flip(1)[:, :k])
    else:
        evals, evecs = torch.linalg.eigh(xc.T @ xc)
        evals = evals.flip(0)[:k]
        comps = evecs.flip(1)[:, :k]
    return PCAState(mean=mean, components=comps.contiguous(),
                    eigenvalues=torch.clamp(evals, min=0.0))


def pca_project(state: PCAState, x) -> torch.Tensor:
    """[..., D] -> [..., K]: (x - mean) W."""
    return (_f32(x) - state.mean) @ state.components


def pca_reconstruct(state: PCAState, z) -> torch.Tensor:
    """[..., K] -> [..., D] back-projection."""
    return _f32(z) @ state.components.T + state.mean


def lda_fit(x, y, num_classes: int, num_components: int, reg: float = 1e-4) -> LDAState:
    """Fisher LDA of the row matrix ``x`` [N, D] with labels ``y`` [N] in
    [0, num_classes): Sb v = lambda Sw v through the Cholesky factor L of
    Sw + reg tr(Sw) / D I, as eigh of L^-1 Sb L^-T mapped back by L^-T."""
    x = _f32(x)
    y = torch.as_tensor(y, device=x.device).to(torch.int64)
    n, d = x.shape
    c = int(num_classes)
    k = int(num_components)
    if k <= 0 or k > c - 1:
        raise ValueError(f"num_components={k} must be in [1, num_classes-1={c - 1}]")
    onehot = (y[:, None] == torch.arange(c, device=x.device)[None, :]).to(torch.float32)
    counts = onehot.sum(dim=0)
    class_means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    total_mean = x.mean(dim=0)
    centered = x - onehot @ class_means
    sw = centered.T @ centered
    md = class_means - total_mean
    sb = (md * counts[:, None]).T @ md
    sw = sw + reg * torch.trace(sw) / d * torch.eye(d, dtype=torch.float32, device=x.device)
    chol = torch.linalg.cholesky(sw)
    linv_sb = torch.linalg.solve_triangular(chol, sb, upper=False)
    m = torch.linalg.solve_triangular(chol, linv_sb.T, upper=False).T
    evals, evecs = torch.linalg.eigh(0.5 * (m + m.T))
    evals = evals.flip(0)[:k]
    evecs = evecs.flip(1)[:, :k]
    comps = torch.linalg.solve_triangular(chol.T, evecs, upper=True)
    return LDAState(components=_unit_columns(comps).contiguous(),
                    eigenvalues=torch.clamp(evals, min=0.0))


def lda_project(state: LDAState, x) -> torch.Tensor:
    return _f32(x) @ state.components
