"""Feature operators, features composed as a DAG: port of
``opencv_facerecognizer_tpu/models/operators.py``.

``ChainOperator`` is ``model2(model1(X))`` (Tan-Triggs -> Fisherfaces,
LBP histograms -> Fisherfaces); ``CombineOperator`` concatenates both
features' flattened outputs; ``CombineOperatorND`` concatenates them
along one per-sample axis without flattening. Composition is plain
function composition over batched tensors, on the devices the member
features were given.
"""

from __future__ import annotations

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models.feature import AbstractFeature
from opencv_facerecognizer_tpu_torch.utils.device import DEFAULT_DEVICE, DeviceLike


def _ndim(x) -> int:
    return x.ndim if isinstance(x, torch.Tensor) else np.ndim(x)


class FeatureOperator(AbstractFeature):
    """Base of the binary feature operators."""

    name = "feature_operator"

    def __init__(self, model1: AbstractFeature, model2: AbstractFeature):
        self.model1 = model1
        self.model2 = model2

    @property
    def sample_ndim(self):  # type: ignore[override]
        return self.model1.sample_ndim

    def get_config(self):
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return {"model1": serialization.serialize_spec(self.model1),
                "model2": serialization.serialize_spec(self.model2)}

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return cls(serialization.deserialize_spec(config["model1"], device),
                   serialization.deserialize_spec(config["model2"], device))

    def get_state(self):
        return {"model1": self.model1.get_state(), "model2": self.model2.get_state()}

    def set_state(self, state):
        if state:
            self.model1.set_state(state.get("model1", {}))
            self.model2.set_state(state.get("model2", {}))

    def __repr__(self):
        return f"{type(self).__name__}({self.model1!r}, {self.model2!r})"


class ChainOperator(FeatureOperator):
    """model2(model1(X))."""

    name = "chain_operator"

    def compute(self, X, y):
        return self.model2.compute(self.model1.compute(X, y), y)

    def extract(self, X):
        return self.model2.extract(self.model1.extract(X))

    def _extract_batch(self, X):
        return self.extract(X)


class CombineOperatorND(FeatureOperator):
    """Both features' outputs concatenated along ``hstack_axis`` without
    flattening; the axis counts the per-sample axes (0 = the first), so
    batched and single-sample calls concatenate along the same one."""

    name = "combine_operator_nd"

    def __init__(self, model1: AbstractFeature, model2: AbstractFeature,
                 hstack_axis: int = -1):
        super().__init__(model1, model2)
        self.hstack_axis = int(hstack_axis)

    def _axis(self, batched: bool) -> int:
        if self.hstack_axis < 0:
            return self.hstack_axis
        return self.hstack_axis + (1 if batched else 0)

    def get_config(self):
        cfg = super().get_config()
        cfg["hstack_axis"] = self.hstack_axis
        return cfg

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return cls(serialization.deserialize_spec(config["model1"], device),
                   serialization.deserialize_spec(config["model2"], device),
                   hstack_axis=config.get("hstack_axis", -1))

    def compute(self, X, y):
        a = self.model1.compute(X, y)
        b = self.model2.compute(X, y)
        return torch.cat([a, b.to(a.device)], dim=self._axis(batched=True))

    def extract(self, X):
        batched = _ndim(X) != self.sample_ndim
        a = self.model1.extract(X)
        b = self.model2.extract(X)
        return torch.cat([a, b.to(a.device)], dim=self._axis(batched))

    def _extract_batch(self, X):
        return self.extract(X)


class CombineOperator(FeatureOperator):
    """Both features' flattened outputs concatenated along the last axis."""

    name = "combine_operator"

    @staticmethod
    def _flat2(a: torch.Tensor, batched: bool) -> torch.Tensor:
        return a.reshape(a.shape[0], -1) if batched else a.reshape(-1)

    def compute(self, X, y):
        a = self.model1.compute(X, y)
        b = self.model2.compute(X, y)
        return torch.cat([self._flat2(a, True), self._flat2(b, True).to(a.device)], dim=-1)

    def extract(self, X):
        batched = _ndim(X) != self.sample_ndim
        a = self.model1.extract(X)
        b = self.model2.extract(X)
        return torch.cat([self._flat2(a, batched), self._flat2(b, batched).to(a.device)],
                         dim=-1)

    def _extract_batch(self, X):
        return self.extract(X)
