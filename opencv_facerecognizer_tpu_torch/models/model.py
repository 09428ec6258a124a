"""Model composition: port of ``opencv_facerecognizer_tpu/models/model.py``.

``PredictableModel``: ``compute(X, y)`` is feature.compute then
classifier.compute on the projected batch; ``predict(X)`` is
classifier.predict(feature.extract(X)). ``ExtendedPredictableModel``
adds the image size and the subject names the apps use.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from opencv_facerecognizer_tpu_torch.models.classifier import AbstractClassifier
from opencv_facerecognizer_tpu_torch.models.feature import AbstractFeature
from opencv_facerecognizer_tpu_torch.utils.device import DEFAULT_DEVICE, DeviceLike


class PredictableModel:
    name = "predictable_model"

    def __init__(self, feature: AbstractFeature, classifier: AbstractClassifier):
        if not isinstance(feature, AbstractFeature):
            raise TypeError(f"feature must be an AbstractFeature, got {type(feature)}")
        if not isinstance(classifier, AbstractClassifier):
            raise TypeError(f"classifier must be an AbstractClassifier, got {type(classifier)}")
        self.feature = feature
        self.classifier = classifier

    def compute(self, X, y):
        features = self.feature.compute(X, y)
        self.classifier.compute(features, y)
        return features

    def predict(self, X):
        return self.classifier.predict(self.feature.extract(X))

    # -- serialization protocol --
    def get_config(self) -> dict:
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return {"feature": serialization.serialize_spec(self.feature),
                "classifier": serialization.serialize_spec(self.classifier)}

    @classmethod
    def from_config(cls, config: dict,
                    device: DeviceLike = DEFAULT_DEVICE) -> "PredictableModel":
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return cls(feature=serialization.deserialize_spec(config["feature"], device),
                   classifier=serialization.deserialize_spec(config["classifier"], device))

    def get_state(self) -> dict:
        return {"feature": self.feature.get_state(),
                "classifier": self.classifier.get_state()}

    def set_state(self, state: dict) -> None:
        if state:
            self.feature.set_state(state.get("feature", {}))
            self.classifier.set_state(state.get("classifier", {}))

    def __repr__(self):
        return f"{type(self).__name__}(feature={self.feature!r}, classifier={self.classifier!r})"


class ExtendedPredictableModel(PredictableModel):
    """PredictableModel + image_size + subject names."""

    name = "extended_predictable_model"

    def __init__(self, feature: AbstractFeature, classifier: AbstractClassifier,
                 image_size: Tuple[int, int] = (70, 70),
                 subject_names: Optional[List[str]] = None):
        super().__init__(feature, classifier)
        self.image_size = tuple(int(v) for v in image_size)
        self.subject_names = list(subject_names) if subject_names else []

    def subject_name(self, label: int) -> str:
        if 0 <= int(label) < len(self.subject_names):
            return self.subject_names[int(label)]
        return str(label)

    def get_config(self) -> dict:
        cfg = super().get_config()
        cfg["image_size"] = list(self.image_size)
        cfg["subject_names"] = list(self.subject_names)
        return cfg

    @classmethod
    def from_config(cls, config: dict,
                    device: DeviceLike = DEFAULT_DEVICE) -> "ExtendedPredictableModel":
        from opencv_facerecognizer_tpu_torch.utils import serialization

        return cls(feature=serialization.deserialize_spec(config["feature"], device),
                   classifier=serialization.deserialize_spec(config["classifier"], device),
                   image_size=tuple(config.get("image_size", (70, 70))),
                   subject_names=config.get("subject_names", []))
