"""Classifier plugins, the ``AbstractClassifier.compute/predict``
boundary: port of ``opencv_facerecognizer_tpu/models/classifier.py``.

``NearestNeighbor.predict`` on a batch is one pairwise-distance block, a
top-k with ties to the lowest gallery row (``lax.top_k``'s rule) and a
one-hot vote in which the nearest neighbour's class gets half a vote
more, so exactly one class wins.

``SVM`` (linear) and ``KernelSVM`` (RBF, polynomial or linear kernel, by
the representer theorem) minimize the Crammer-Singer hinge plus their
norm with full-batch Adam from zero weights, as the reference's optax
loop under ``lax.scan`` does: ``torch.autograd`` for the gradient,
``torch.optim.Adam`` with optax's settings (b1 0.9, b2 0.999, eps 1e-8)
for the same number of epochs, on ``device``. The subgradients follow
JAX's at ties, which matter from the first step (every wrong class ties
at zero weights): ``torch.amax`` splits a tied max evenly, as
``jnp.max``'s gradient does (``Tensor.max(dim)`` would send it all to
one class), and ``torch.maximum`` halves it at 0 as ``jnp.maximum``
does (``clamp`` would not). The spreads have ddof 0 (``jnp.std``,
``jnp.var``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops import distance as distance_ops
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)


def _require_int_labels(y) -> np.ndarray:
    """Labels must be integers; subject names belong in
    ``ExtendedPredictableModel.subject_names``."""
    y = np.asarray(y)
    if not np.issubdtype(y.dtype, np.integer):
        raise TypeError(
            f"labels must be integers, got dtype {y.dtype}; map subject names to "
            "ids and carry the names in ExtendedPredictableModel.subject_names")
    return y


class AbstractClassifier:
    """``compute(X, y)`` fits or enrols; ``predict(q)`` -> (label, info)."""

    name = "abstract_classifier"

    def compute(self, X, y):
        raise NotImplementedError

    def predict(self, q):
        raise NotImplementedError

    # -- serialization protocol --
    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, config: dict,
                    device: DeviceLike = DEFAULT_DEVICE) -> "AbstractClassifier":
        """``device``: where a plugin that holds tensors keeps them (a
        plugin without any ignores it)."""
        return cls(**config)

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def knn_predict(pairwise_fn, gallery: torch.Tensor, gallery_labels: torch.Tensor,
                num_classes: int, queries: torch.Tensor, k: int):
    """(predicted class index [Q], top-k labels [Q, k], top-k distances
    [Q, k]): majority vote over the k nearest, the nearest neighbour's
    class breaking ties."""
    d = pairwise_fn(queries, gallery)
    k = min(int(k), int(gallery.shape[0]))
    neg_topd, top_idx = stable_topk(-d, k)
    top_labels = gallery_labels[top_idx]
    votes = torch.nn.functional.one_hot(top_labels.long(), num_classes).float().sum(dim=-2)
    bonus = 0.5 * torch.nn.functional.one_hot(top_labels[..., 0].long(), num_classes).float()
    return torch.argmax(votes + bonus, dim=-1), top_labels, -neg_topd


class NearestNeighbor(AbstractClassifier):
    """Brute-force k-NN over the enrolled rows, batched."""

    name = "nearest_neighbor"

    def __init__(self, dist_metric: Optional[distance_ops.AbstractDistance] = None,
                 k: int = 1, device: DeviceLike = DEFAULT_DEVICE):
        self.dist_metric = dist_metric or distance_ops.EuclideanDistance()
        self.k = int(k)
        self.device = resolve_device(device)
        self._gallery: Optional[torch.Tensor] = None  # [G, D] float32
        self._labels: Optional[torch.Tensor] = None  # [G] int32 class indices
        self._classes: Optional[np.ndarray] = None  # [C] original label values

    def compute(self, X, y):
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        self._gallery = X.reshape(X.shape[0], -1)
        classes, idx = np.unique(_require_int_labels(y), return_inverse=True)
        self._classes = np.asarray(classes)
        self._labels = torch.as_tensor(idx.astype(np.int32), device=self.device)

    def predict(self, q):
        """One query -> ``[label, {"labels": [k], "distances": [k]}]`` (the
        reference's return shape); a batch [Q, D] -> (labels [Q], info)."""
        if self._gallery is None:
            raise RuntimeError("NearestNeighbor.predict called before compute()")
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        single = q.ndim == 1
        qb = q[None] if single else q.reshape(q.shape[0], -1)
        pred_idx, top_labels, top_dist = knn_predict(
            self.dist_metric.pairwise, self._gallery, self._labels,
            len(self._classes), qb, self.k)
        pred = self._classes[pred_idx.cpu().numpy()]
        info = {"labels": self._classes[top_labels.cpu().numpy()],
                "distances": top_dist.cpu().numpy()}
        if single:
            return [pred[0], {"labels": info["labels"][0], "distances": info["distances"][0]}]
        return pred, info

    def get_config(self):
        return {"dist_metric": {"type": self.dist_metric.name,
                                "config": self.dist_metric.get_config()},
                "k": self.k}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        spec = config.get("dist_metric")
        metric = distance_ops.distance_from_spec(spec) if spec else None
        return cls(dist_metric=metric, k=config.get("k", 1), device=device)

    def get_state(self):
        """The reference's keys and dtypes (its ``classes`` is int32)."""
        if self._gallery is None:
            return {}
        return {"gallery": self._gallery.cpu().numpy(),
                "labels": self._labels.cpu().numpy().astype(np.int32),
                "classes": np.asarray(self._classes).astype(np.int32)}

    def set_state(self, state):
        if state:
            self._gallery = torch.as_tensor(np.array(state["gallery"], np.float32),
                                            device=self.device)
            self._labels = torch.as_tensor(np.array(state["labels"], np.int32),
                                           device=self.device)
            self._classes = np.asarray(state["classes"])

    def __repr__(self):
        return f"NearestNeighbor(dist_metric={self.dist_metric!r}, k={self.k})"


def _crammer_singer_hinge(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """Multi-class hinge: the margin against the best wrong class."""
    correct = torch.sum(logits * y_onehot, dim=-1)
    wrong = torch.amax(logits - 1e9 * y_onehot, dim=-1)
    return torch.maximum(torch.zeros_like(correct), 1.0 + wrong - correct)


def _logits_predict(classes: np.ndarray, logits: torch.Tensor, single: bool):
    """The SVMs' (label, {"logits"}) return shape."""
    pred = classes[torch.argmax(logits, dim=-1).cpu().numpy()]
    info = {"logits": logits.detach().cpu().numpy()}
    if single:
        return [pred[0], {"logits": info["logits"][0]}]
    return pred, info


def _adam_fit(params: dict, loss_fn, learning_rate: float, epochs: int) -> dict:
    """``epochs`` full-batch Adam steps on ``params`` (leaf tensors),
    optax's ``adam(learning_rate)``."""
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss_fn(params).backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def _rows(q, device: torch.device) -> torch.Tensor:
    q = torch.as_tensor(np.asarray(q) if not isinstance(q, torch.Tensor) else q)
    return q.to(device=device, dtype=torch.float32)


class SVM(AbstractClassifier):
    """Linear multi-class SVM (Crammer-Singer hinge) on standardized
    features, trained for ``epochs`` full-batch Adam steps."""

    name = "svm"

    def __init__(self, reg: float = 1e-4, learning_rate: float = 0.05, epochs: int = 300,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.reg = float(reg)
        self.learning_rate = float(learning_rate)
        self.epochs = int(epochs)
        self.device = resolve_device(device)
        self._params: Optional[dict] = None
        self._classes: Optional[np.ndarray] = None
        self._feat_mean: Optional[torch.Tensor] = None
        self._feat_scale: Optional[torch.Tensor] = None

    def compute(self, X, y):
        X = _rows(X, self.device)
        X = X.reshape(X.shape[0], -1)
        if X.is_cuda:
            disable_tf32()
        classes, idx = np.unique(_require_int_labels(y), return_inverse=True)
        self._classes = np.asarray(classes)
        c = len(classes)
        self._feat_mean = X.mean(dim=0)
        self._feat_scale = torch.clamp(X.std(dim=0, correction=0), min=1e-6)
        xs = (X - self._feat_mean) / self._feat_scale
        y_onehot = torch.nn.functional.one_hot(
            torch.as_tensor(idx, device=self.device).long(), c).to(torch.float32)
        d = xs.shape[1]
        reg = self.reg

        def loss_fn(p):
            logits = xs @ p["w"] + p["b"]
            return torch.mean(_crammer_singer_hinge(logits, y_onehot)) + reg * torch.sum(p["w"] ** 2)

        with torch.enable_grad():
            self._params = _adam_fit(
                {"w": torch.zeros((d, c), device=self.device, requires_grad=True),
                 "b": torch.zeros((c,), device=self.device, requires_grad=True)},
                loss_fn, self.learning_rate, self.epochs)

    def decision_function(self, q) -> torch.Tensor:
        q = _rows(q, self.device)
        qb = q.reshape(-1, q.shape[-1]) if q.ndim > 1 else q[None]
        qs = (qb.reshape(qb.shape[0], -1) - self._feat_mean) / self._feat_scale
        return qs @ self._params["w"] + self._params["b"]

    def predict(self, q):
        if self._params is None:
            raise RuntimeError("SVM.predict called before compute()")
        return _logits_predict(self._classes, self.decision_function(q), np.ndim(q) == 1)

    def get_config(self):
        return {"reg": self.reg, "learning_rate": self.learning_rate, "epochs": self.epochs}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        return cls(**config, device=device)

    def get_state(self):
        """The reference's keys and dtypes (float32 arrays, int32 classes)."""
        if self._params is None:
            return {}
        return {"w": _f32_host(self._params["w"]), "b": _f32_host(self._params["b"]),
                "classes": np.asarray(self._classes).astype(np.int32),
                "feat_mean": _f32_host(self._feat_mean),
                "feat_scale": _f32_host(self._feat_scale)}

    def set_state(self, state):
        if state:
            self._params = {"w": _f32_dev(state["w"], self.device),
                            "b": _f32_dev(state["b"], self.device)}
            self._classes = np.asarray(state["classes"])
            self._feat_mean = _f32_dev(state["feat_mean"], self.device)
            self._feat_scale = _f32_dev(state["feat_scale"], self.device)


def _f32_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _f32_dev(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _kernel_matrix(kind: str, gamma, coef0, degree, A: torch.Tensor,
                   B: torch.Tensor) -> torch.Tensor:
    """K[i, j] = k(A[i], B[j]), each kernel a product plus elementwise terms."""
    if kind == "linear":
        return A @ B.T
    if kind == "poly":
        return (gamma * (A @ B.T) + coef0) ** degree
    if kind == "rbf":
        sq = (A * A).sum(dim=-1)[:, None] - 2.0 * (A @ B.T) + (B * B).sum(dim=-1)[None, :]
        return torch.exp(-gamma * torch.clamp(sq, min=0.0))
    raise ValueError(f"unknown kernel {kind!r}; pick linear | poly | rbf")


class KernelSVM(AbstractClassifier):
    """Multi-class kernel SVM: f_c(x) = sum_i alpha[i, c] k(x_i, x) + b_c,
    ``alpha`` [N, C] trained on the Crammer-Singer hinge plus the RKHS norm
    tr(alpha^T K alpha), with the kernel matrix computed once. ``gamma``
    defaults to 1 / (D var(X)) (sklearn's "scale")."""

    name = "kernel_svm"

    def __init__(self, kernel: str = "rbf", gamma: Optional[float] = None,
                 coef0: float = 1.0, degree: int = 3, reg: float = 1e-3,
                 learning_rate: float = 0.05, epochs: int = 400,
                 device: DeviceLike = DEFAULT_DEVICE):
        if kernel not in ("linear", "poly", "rbf"):
            raise ValueError(f"unknown kernel {kernel!r}; pick linear | poly | rbf")
        self.kernel = kernel
        self.gamma = None if gamma is None else float(gamma)
        self.coef0 = float(coef0)
        self.degree = int(degree)
        self.reg = float(reg)
        self.learning_rate = float(learning_rate)
        self.epochs = int(epochs)
        self.device = resolve_device(device)
        self._sv: Optional[torch.Tensor] = None  # [N, D] training vectors
        self._alpha: Optional[torch.Tensor] = None  # [N, C]
        self._b: Optional[torch.Tensor] = None  # [C]
        self._gamma_eff: Optional[float] = None
        self._classes: Optional[np.ndarray] = None

    def _k(self, A, B):
        if A.is_cuda:
            disable_tf32()
        return _kernel_matrix(self.kernel, self._gamma_eff, self.coef0, self.degree, A, B)

    def compute(self, X, y):
        X = _rows(X, self.device)
        X = X.reshape(X.shape[0], -1)
        classes, idx = np.unique(_require_int_labels(y), return_inverse=True)
        self._classes = np.asarray(classes)
        c = len(classes)
        self._sv = X
        if self.gamma is not None:
            self._gamma_eff = self.gamma
        else:
            var = float(X.var(correction=0))
            self._gamma_eff = 1.0 / (X.shape[1] * max(var, 1e-12))
        K = self._k(X, X)
        y_onehot = torch.nn.functional.one_hot(
            torch.as_tensor(idx, device=self.device).long(), c).to(torch.float32)
        reg = self.reg

        def loss_fn(p):
            logits = K @ p["alpha"] + p["b"]
            rkhs = torch.sum(p["alpha"] * (K @ p["alpha"]))
            return torch.mean(_crammer_singer_hinge(logits, y_onehot)) + reg * rkhs

        with torch.enable_grad():
            params = _adam_fit(
                {"alpha": torch.zeros((X.shape[0], c), device=self.device, requires_grad=True),
                 "b": torch.zeros((c,), device=self.device, requires_grad=True)},
                loss_fn, self.learning_rate, self.epochs)
        self._alpha, self._b = params["alpha"], params["b"]

    def decision_function(self, q) -> torch.Tensor:
        q = _rows(q, self.device)
        qb = q[None] if q.ndim == 1 else q.reshape(q.shape[0], -1)
        return self._k(qb, self._sv) @ self._alpha + self._b

    def predict(self, q):
        if self._alpha is None:
            raise RuntimeError("KernelSVM.predict called before compute()")
        return _logits_predict(self._classes, self.decision_function(q), np.ndim(q) == 1)

    def get_config(self):
        return {"kernel": self.kernel, "gamma": self.gamma, "coef0": self.coef0,
                "degree": self.degree, "reg": self.reg,
                "learning_rate": self.learning_rate, "epochs": self.epochs}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        return cls(**config, device=device)

    def get_state(self):
        if self._alpha is None:
            return {}
        return {"sv": _f32_host(self._sv), "alpha": _f32_host(self._alpha),
                "b": _f32_host(self._b), "gamma_eff": np.float32(self._gamma_eff),
                "classes": np.asarray(self._classes).astype(np.int32)}

    def set_state(self, state):
        if state:
            self._sv = _f32_dev(state["sv"], self.device)
            self._alpha = _f32_dev(state["alpha"], self.device)
            self._b = _f32_dev(state["b"], self.device)
            self._gamma_eff = float(state["gamma_eff"])
            self._classes = np.asarray(state["classes"])

    def __repr__(self):
        return (f"KernelSVM(kernel={self.kernel!r}, gamma={self.gamma}, "
                f"degree={self.degree}, reg={self.reg})")


CLASSIFIERS = {cls.name: cls for cls in (NearestNeighbor, SVM, KernelSVM)}
