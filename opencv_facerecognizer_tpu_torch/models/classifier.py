"""The ``AbstractClassifier`` boundary and ``NearestNeighbor``: port of
that part of ``opencv_facerecognizer_tpu/models/classifier.py``.

``NearestNeighbor.predict`` on a batch is one pairwise-distance block, a
top-k with ties to the lowest gallery row (``lax.top_k``'s rule) and a
one-hot vote in which the nearest neighbour's class gets half a vote
more, so exactly one class wins. The SVMs wait for ROADMAP A.12.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.ops import distance as distance_ops
from opencv_facerecognizer_tpu_torch.ops.nms import stable_topk
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, resolve_device)


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
