"""Feature plugins, the ``AbstractFeature.compute/extract`` boundary: port
of ``opencv_facerecognizer_tpu/models/feature.py``.

``compute(X, y)`` fits on a dataset and returns the projected batch;
``extract(X)`` transforms one sample or a batch with a leading N dim. The
classic features (``Identity``, ``PCA``, ``LDA``, ``Fisherfaces``,
``SpatialHistogram``) and the preprocessing plugins that share the
protocol so they chain (``TanTriggsPreprocessing``,
``HistogramEqualization``, ``Resize``, ``MinMaxNormalize``) take
``device=`` (the card unless the caller names another): their inputs go
there, and fits and transforms run there as whole batches. ``get_state``
gives the reference's keys as float32 numpy arrays, so checkpoints load
in either package.

The preprocessing (LBP codes and histograms, Tan-Triggs, equalization,
resize, min/max) is marked as the ``preprocess`` stage of
``utils.stage_clock``, the subspace fits as ``pca`` and ``lda``; a mark
costs nothing unless a recording is active.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops import histogram as hist_ops
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops import lbp as lbp_ops
from opencv_facerecognizer_tpu_torch.ops import linalg as linalg_ops
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)
from opencv_facerecognizer_tpu_torch.utils.stage_clock import stage


def _to(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor, an array or a list of samples) as float32 on ``device``."""
    if isinstance(x, (list, tuple)):
        x = torch.stack([torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                                         else v) for v in x])
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.require(np.asarray(x), requirements="W"))
    return x.to(device=device, dtype=torch.float32)


def as_row_matrix(x, device: DeviceLike = DEFAULT_DEVICE) -> torch.Tensor:
    """A list of images or an array [N, ...] -> [N, D] float32 on ``device``."""
    x = _to(x, resolve_device(device))
    return x.reshape(x.shape[0], -1)


def as_column_matrix(x, device: DeviceLike = DEFAULT_DEVICE) -> torch.Tensor:
    return as_row_matrix(x, device).T


def _labels_to_indices(y) -> Tuple[np.ndarray, np.ndarray]:
    """Arbitrary int labels -> (sorted unique classes, contiguous indices)."""
    classes, idx = np.unique(np.asarray(y), return_inverse=True)
    return classes, idx.astype(np.int32)


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().to(torch.float32).cpu().numpy()


class AbstractFeature:
    name = "abstract_feature"
    #: ndim of one raw input sample (2 = grayscale image): ``extract`` on
    #: an input of this ndim returns one row, else a batch
    sample_ndim = 2

    def compute(self, X, y):
        raise NotImplementedError

    def extract(self, X) -> torch.Tensor:
        """Dispatch single sample vs batch; delegate to ``_extract_batch``."""
        X = torch.as_tensor(X, dtype=torch.float32)
        if X.ndim == self.sample_ndim:
            return self._extract_batch(X[None])[0]
        return self._extract_batch(X)

    def _extract_batch(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- serialization protocol (utils.serialization) --
    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, config: dict,
                    device: DeviceLike = DEFAULT_DEVICE) -> "AbstractFeature":
        """``device``: where a plugin that holds tensors keeps them (a
        plugin without any ignores it)."""
        return cls(**config)

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v}" for k, v in self.get_config().items())
        return f"{type(self).__name__}({cfg})"


class _DeviceFeature(AbstractFeature):
    """A classic plugin: its inputs go to, and its work runs on, ``device``."""

    def __init__(self, device: DeviceLike = DEFAULT_DEVICE):
        self.device = resolve_device(device)

    def extract(self, X) -> torch.Tensor:
        X = _to(X, self.device)
        if X.ndim == self.sample_ndim:
            return self._extract_batch(X[None])[0]
        return self._extract_batch(X)

    @classmethod
    def from_config(cls, config: dict, device: DeviceLike = DEFAULT_DEVICE):
        return cls(**config, device=device)


class Identity(_DeviceFeature):
    """Flattens samples to vectors."""

    name = "identity"

    def compute(self, X, y):
        return as_row_matrix(X, self.device)

    def _extract_batch(self, X):
        return X.reshape(X.shape[0], -1)


class _SubspaceFeature(_DeviceFeature):
    """Extract of features projecting flat [D] vectors: anything with
    exactly D elements is one sample (unless it is an explicit [1, D]
    batch), everything else a batch flattened to [N, D], so chains whose
    intermediate features are 1-D (PCA -> LDA) keep the single-sample
    contract."""

    def _input_dim(self) -> int:
        raise NotImplementedError

    def extract(self, X):
        X = _to(X, self.device)
        d = self._input_dim()
        if X.numel() == d and not (X.ndim == 2 and X.shape[0] == 1):
            return self._extract_batch(X.reshape(1, -1))[0]
        return self._extract_batch(X.reshape(X.shape[0], -1))


class PCA(_SubspaceFeature):
    """Eigenfaces: mean-center, eigh by the Gram trick, the top-k
    eigenvectors. ``num_components=0`` keeps all."""

    name = "pca"

    def __init__(self, num_components: int = 0, device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.num_components = int(num_components)
        self._state: Optional[linalg_ops.PCAState] = None

    def compute(self, X, y):
        Xm = as_row_matrix(X, self.device)
        n, d = Xm.shape
        k = self.num_components if self.num_components > 0 else min(n, d)
        with stage("pca"):
            self._state = linalg_ops.pca_fit(Xm, min(k, n, d))
            return linalg_ops.pca_project(self._state, Xm)

    def _input_dim(self):
        if self._state is None:
            raise RuntimeError("PCA.extract called before compute()")
        return int(self._state.components.shape[0])

    def _extract_batch(self, X):
        if self._state is None:
            raise RuntimeError("PCA.extract called before compute()")
        return linalg_ops.pca_project(self._state, X.reshape(X.shape[0], -1))

    def reconstruct(self, z):
        return linalg_ops.pca_reconstruct(self._state, _to(z, self.device))

    @property
    def mean(self):
        return self._state.mean if self._state else None

    @property
    def eigenvectors(self):
        return self._state.components if self._state else None

    @property
    def eigenvalues(self):
        return self._state.eigenvalues if self._state else None

    def get_config(self):
        return {"num_components": self.num_components}

    def get_state(self):
        if self._state is None:
            return {}
        return {"mean": _host(self._state.mean),
                "components": _host(self._state.components),
                "eigenvalues": _host(self._state.eigenvalues)}

    def set_state(self, state):
        if state:
            self._state = linalg_ops.PCAState(
                mean=_to(state["mean"], self.device),
                components=_to(state["components"], self.device),
                eigenvalues=_to(state["eigenvalues"], self.device))


class LDA(_SubspaceFeature):
    """Fisher LDA of flattened samples. ``num_components=0`` -> classes - 1."""

    name = "lda"

    def __init__(self, num_components: int = 0, device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.num_components = int(num_components)
        self._state: Optional[linalg_ops.LDAState] = None

    def compute(self, X, y):
        Xm = as_row_matrix(X, self.device)
        _, y_idx = _labels_to_indices(y)
        c = int(y_idx.max()) + 1
        k = self.num_components if self.num_components > 0 else c - 1
        with stage("lda"):
            self._state = linalg_ops.lda_fit(Xm, torch.as_tensor(y_idx), num_classes=c,
                                             num_components=min(k, c - 1))
            return linalg_ops.lda_project(self._state, Xm)

    def _input_dim(self):
        if self._state is None:
            raise RuntimeError("LDA.extract called before compute()")
        return int(self._state.components.shape[0])

    def _extract_batch(self, X):
        if self._state is None:
            raise RuntimeError("LDA.extract called before compute()")
        return linalg_ops.lda_project(self._state, X.reshape(X.shape[0], -1))

    def get_config(self):
        return {"num_components": self.num_components}

    def get_state(self):
        if self._state is None:
            return {}
        return {"components": _host(self._state.components),
                "eigenvalues": _host(self._state.eigenvalues)}

    def set_state(self, state):
        if state:
            self._state = linalg_ops.LDAState(
                components=_to(state["components"], self.device),
                eigenvalues=_to(state["eigenvalues"], self.device))


class Fisherfaces(_SubspaceFeature):
    """PCA to N - c dims, then LDA to c - 1: one projection W = W_pca @
    W_lda, one product per batch at extract."""

    name = "fisherfaces"

    def __init__(self, num_components: int = 0, device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.num_components = int(num_components)
        self._mean: Optional[torch.Tensor] = None
        self._components: Optional[torch.Tensor] = None
        self._eigenvalues: Optional[torch.Tensor] = None

    def compute(self, X, y):
        Xm = as_row_matrix(X, self.device)
        n, d = Xm.shape
        _, y_idx = _labels_to_indices(y)
        c = int(y_idx.max()) + 1
        pca_k = max(1, min(n - c, n, d))
        with stage("pca"):
            pca_state = linalg_ops.pca_fit(Xm, pca_k)
            proj = linalg_ops.pca_project(pca_state, Xm)
        k = self.num_components if self.num_components > 0 else c - 1
        with stage("lda"):
            lda_state = linalg_ops.lda_fit(proj, torch.as_tensor(y_idx), num_classes=c,
                                           num_components=min(k, c - 1, pca_k))
        self._mean = pca_state.mean
        self._components = pca_state.components @ lda_state.components  # [D, k]
        self._eigenvalues = lda_state.eigenvalues
        return self._extract_batch(Xm)

    def _input_dim(self):
        if self._components is None:
            raise RuntimeError("Fisherfaces.extract called before compute()")
        return int(self._components.shape[0])

    def _extract_batch(self, X):
        if self._components is None:
            raise RuntimeError("Fisherfaces.extract called before compute()")
        return (X.reshape(X.shape[0], -1) - self._mean) @ self._components

    @property
    def eigenvectors(self):
        return self._components

    @property
    def eigenvalues(self):
        return self._eigenvalues

    def get_config(self):
        return {"num_components": self.num_components}

    def get_state(self):
        if self._components is None:
            return {}
        return {"mean": _host(self._mean), "components": _host(self._components),
                "eigenvalues": _host(self._eigenvalues)}

    def set_state(self, state):
        if state:
            self._mean = _to(state["mean"], self.device)
            self._components = _to(state["components"], self.device)
            self._eigenvalues = _to(state["eigenvalues"], self.device)


class _StatelessImageFeature(_DeviceFeature):
    def compute(self, X, y):
        return self._extract_batch(_to(X, self.device))


class SpatialHistogram(_StatelessImageFeature):
    """LBPH: LBP codes -> a grid of cell histograms, concatenated."""

    name = "spatial_histogram"

    def __init__(self, lbp_operator: Optional[lbp_ops.LocalBinaryOperator] = None,
                 sz: Tuple[int, int] = (8, 8), device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.lbp_operator = lbp_operator or lbp_ops.ExtendedLBP(radius=1, neighbors=8)
        self.sz = tuple(int(v) for v in sz)

    def _extract_batch(self, X):
        with stage("preprocess"):
            return hist_ops.spatial_histogram(self.lbp_operator(X), grid=self.sz,
                                              num_bins=self.lbp_operator.num_bins)

    def get_config(self):
        return {"lbp_operator": {"type": self.lbp_operator.name,
                                 "config": self.lbp_operator.get_config()},
                "sz": list(self.sz)}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        op_spec = config.get("lbp_operator")
        op = None
        if op_spec:
            op = lbp_ops.LBP_OPERATORS[op_spec["type"]].from_config(op_spec["config"])
        return cls(lbp_operator=op, sz=tuple(config.get("sz", (8, 8))), device=device)


class TanTriggsPreprocessing(_StatelessImageFeature):
    name = "tan_triggs"

    def __init__(self, alpha: float = 0.1, tau: float = 10.0, gamma: float = 0.2,
                 sigma0: float = 1.0, sigma1: float = 2.0,
                 device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.alpha, self.tau, self.gamma = float(alpha), float(tau), float(gamma)
        self.sigma0, self.sigma1 = float(sigma0), float(sigma1)

    def _extract_batch(self, X):
        with stage("preprocess"):
            return image_ops.tan_triggs(X, self.alpha, self.tau, self.gamma,
                                        self.sigma0, self.sigma1)

    def get_config(self):
        return {"alpha": self.alpha, "tau": self.tau, "gamma": self.gamma,
                "sigma0": self.sigma0, "sigma1": self.sigma1}


class HistogramEqualization(_StatelessImageFeature):
    name = "histogram_equalization"

    def __init__(self, num_bins: int = 256, device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.num_bins = int(num_bins)

    def _extract_batch(self, X):
        with stage("preprocess"):
            return image_ops.histogram_equalize(X, self.num_bins)

    def get_config(self):
        return {"num_bins": self.num_bins}


class Resize(_StatelessImageFeature):
    name = "resize"

    def __init__(self, size: Tuple[int, int] = (70, 70), device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.size = tuple(int(v) for v in size)

    def _extract_batch(self, X):
        with stage("preprocess"):
            return image_ops.resize(X, self.size)

    def get_config(self):
        return {"size": list(self.size)}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        return cls(size=tuple(config["size"]), device=device)


class MinMaxNormalize(_StatelessImageFeature):
    name = "minmax_normalize"

    def __init__(self, low: float = 0.0, high: float = 1.0,
                 device: DeviceLike = DEFAULT_DEVICE):
        super().__init__(device)
        self.low, self.high = float(low), float(high)

    def _extract_batch(self, X):
        with stage("preprocess"):
            return image_ops.minmax_normalize(X, self.low, self.high)

    def get_config(self):
        return {"low": self.low, "high": self.high}
