"""Validation: port of ``opencv_facerecognizer_tpu/utils/validation.py``.

KFold, LeaveOneOut and Simple validation of a model, each fold a
``ValidationResult``. The folds are numpy index lists, equal to the
reference's for one seed; each fold refits the model (its fit and its
whole test batch's predict run on the model's device) and is marked as
the ``fit`` and ``predict`` stages of ``utils.stage_clock``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from opencv_facerecognizer_tpu_torch.utils.stage_clock import stage


@dataclass
class ValidationResult:
    true_positives: int = 0
    false_positives: int = 0
    description: str = ""

    @property
    def total(self) -> int:
        return self.true_positives + self.false_positives

    @property
    def accuracy(self) -> float:
        return self.true_positives / self.total if self.total else float("nan")

    def __repr__(self):
        return (
            f"ValidationResult(acc={self.accuracy:.4f}, "
            f"tp={self.true_positives}, fp={self.false_positives}, "
            f"desc={self.description!r})"
        )


def precision(true_positives: int, false_positives: int) -> float:
    total = true_positives + false_positives
    return true_positives / total if total else float("nan")


def accuracy(true_positives: int, false_positives: int) -> float:
    return precision(true_positives, false_positives)


@dataclass
class ValidationStrategy:
    """Base: subclasses implement ``validate(model, X, y)`` appending
    ValidationResults to ``self.results``."""

    results: List[ValidationResult] = field(default_factory=list)

    def validate(self, model, X, y):
        raise NotImplementedError

    @property
    def mean_accuracy(self) -> float:
        accs = [r.accuracy for r in self.results if r.total]
        return float(np.mean(accs)) if accs else float("nan")

    def _score_fold(self, model, X_train, y_train, X_test, y_test, desc: str):
        with stage("fit"):
            model.compute(X_train, y_train)
        with stage("predict"):
            pred, _ = model.predict(np.asarray(X_test))
            pred = np.asarray(pred)
        tp = int(np.sum(pred == np.asarray(y_test)))
        result = ValidationResult(
            true_positives=tp, false_positives=len(y_test) - tp, description=desc
        )
        self.results.append(result)
        return result


def stratified_kfold_indices(y: np.ndarray, k: int, seed: int = 0) -> List[np.ndarray]:
    """Label-stratified fold index lists."""
    rng = np.random.default_rng(seed)
    y = np.asarray(y)
    folds: List[list] = [[] for _ in range(k)]
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        rng.shuffle(idx)
        for i, j in enumerate(idx):
            folds[i % k].append(j)
    return [np.asarray(sorted(f), dtype=np.int64) for f in folds]


@dataclass
class KFoldCrossValidation(ValidationStrategy):
    k: int = 10
    seed: int = 0

    def validate(self, model, X, y):
        X = np.asarray(X)
        y = np.asarray(y)
        folds = stratified_kfold_indices(y, self.k, self.seed)
        for i, test_idx in enumerate(folds):
            if len(test_idx) == 0:
                continue
            train_mask = np.ones(len(y), dtype=bool)
            train_mask[test_idx] = False
            self._score_fold(
                model,
                X[train_mask],
                y[train_mask],
                X[test_idx],
                y[test_idx],
                desc=f"fold {i + 1}/{self.k}",
            )
        return self


@dataclass
class LeaveOneOutCrossValidation(ValidationStrategy):
    def validate(self, model, X, y):
        X = np.asarray(X)
        y = np.asarray(y)
        for i in range(len(y)):
            mask = np.ones(len(y), dtype=bool)
            mask[i] = False
            self._score_fold(
                model, X[mask], y[mask], X[i : i + 1], y[i : i + 1], desc=f"leave-out {i}"
            )
        return self


@dataclass
class SimpleValidation(ValidationStrategy):
    """Fit and score on given train/test split (or same data if no split)."""

    def validate(self, model, X, y, X_test=None, y_test=None):
        X = np.asarray(X)
        y = np.asarray(y)
        X_test = X if X_test is None else np.asarray(X_test)
        y_test = y if y_test is None else np.asarray(y_test)
        self._score_fold(model, X, y, X_test, y_test, desc="simple")
        return self
