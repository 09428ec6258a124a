"""The ``AbstractFeature`` boundary: port of the abstract part of
``opencv_facerecognizer_tpu/models/feature.py``.

``compute(X, y)`` fits on a dataset and returns projected features;
``extract(X)`` transforms one sample or a batch with a leading N dim
(told apart by ``sample_ndim``). The classic features (PCA, LDA,
Fisherfaces, LBPH and the preprocessing plugins) wait for ROADMAP A.12.
"""

from __future__ import annotations

import torch

from opencv_facerecognizer_tpu_torch.utils.device import DEFAULT_DEVICE, DeviceLike


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
