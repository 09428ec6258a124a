"""TheTrainer, enrolment end to end: port of
``opencv_facerecognizer_tpu/runtime/trainer.py``.

Walk a folder-per-subject dataset, resize, fit a model, k-fold validate
it, checkpoint it:

- ``model="fisherfaces" | "eigenfaces" | "lbph" | "lbp_fisherfaces"``:
  the reference's classic recipes, with its comments' measured reasons
  (Tan-Triggs at sigmas 2 / 4 before Fisherfaces, radius-2 LBP for LBPH,
  raw radius-3 LBP on a 6x6 grid before Fisherfaces and a cosine NN);
- ``classifier="nn" | "svm" | "kernel_svm"`` over any of them;
- ``model="cnn"``: a ``CNNEmbedding`` trained with ArcFace for
  ``train_steps`` steps (0: its loaded or seeded weights) and a cosine
  NN; ``build_gallery`` and ``make_reembed_fn`` hand it to the serving
  side, and ``finetune_embedder`` fine-tunes a copy of it on enrolments
  (the multibatch sampler) for a rollout.

``select_model`` k-folds every candidate, the CNN among them. Every fit
and prediction runs on ``device`` (the card unless the caller names
another); checkpoints are ``utils.serialization``'s, which the JAX
package reads and writes too.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.models.classifier import (
    KernelSVM, NearestNeighbor, SVM)
from opencv_facerecognizer_tpu_torch.models._train import adam
from opencv_facerecognizer_tpu_torch.models.embedder import (
    CNNEmbedding, draw_head, make_train_step, normalize_faces)
from opencv_facerecognizer_tpu_torch.models.feature import (
    Fisherfaces, PCA, SpatialHistogram, TanTriggsPreprocessing)
from opencv_facerecognizer_tpu_torch.models.model import ExtendedPredictableModel
from opencv_facerecognizer_tpu_torch.models.operators import ChainOperator
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops import lbp as lbp_ops
from opencv_facerecognizer_tpu_torch.ops.distance import (
    ChiSquareDistance, CosineDistance, EuclideanDistance)
from opencv_facerecognizer_tpu_torch.utils import dataset as dataset_utils
from opencv_facerecognizer_tpu_torch.utils import serialization
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)
from opencv_facerecognizer_tpu_torch.utils.stage_clock import stage
from opencv_facerecognizer_tpu_torch.utils.validation import KFoldCrossValidation


@dataclass
class TrainerConfig:
    """The reference's flat config."""

    model: str = "fisherfaces"  # fisherfaces | eigenfaces | lbph | lbp_fisherfaces | cnn
    image_size: Tuple[int, int] = (70, 70)
    kfold: int = 3
    num_components: int = 0  # subspace dims (0 = auto)
    knn_k: int = 1
    tan_triggs: bool = True
    classifier: str = "nn"  # nn | svm | kernel_svm
    svm_kernel: str = "rbf"  # kernel_svm only: rbf | poly | linear
    # cnn backend knobs
    embed_dim: int = 128
    train_steps: int = 200
    cnn_kwargs: Dict[str, Any] = field(default_factory=dict)


class TheTrainer:
    """Train, validate and checkpoint a recognition model on ``device``."""

    def __init__(self, config: Optional[TrainerConfig] = None,
                 device: DeviceLike = DEFAULT_DEVICE, **overrides):
        self.config = config or TrainerConfig()
        for key, value in overrides.items():
            if not hasattr(self.config, key):
                raise TypeError(f"unknown TrainerConfig field {key!r}")
            setattr(self.config, key, value)
        self.device = resolve_device(device)
        self.model: Optional[ExtendedPredictableModel] = None
        self.validation: Optional[KFoldCrossValidation] = None
        #: previous checkpoints kept on save (``<model_path>.1..N``); 0
        #: overwrites (still atomically)
        self.keep_checkpoints = 0

    # ---- model zoo ----

    def _build_model(self, subject_names: List[str]) -> ExtendedPredictableModel:
        cfg = self.config
        dev = self.device
        if cfg.model == "fisherfaces":
            feature = Fisherfaces(cfg.num_components, device=dev)
            if cfg.tan_triggs:
                # the wider DoG band (sigmas 2, 4) removes more of the
                # smooth illumination gradient (the reference's measurement)
                feature = ChainOperator(
                    TanTriggsPreprocessing(sigma0=2.0, sigma1=4.0, device=dev), feature)
            classifier = NearestNeighbor(EuclideanDistance(), k=cfg.knn_k, device=dev)
        elif cfg.model == "eigenfaces":
            feature = PCA(cfg.num_components, device=dev)
            classifier = NearestNeighbor(EuclideanDistance(), k=cfg.knn_k, device=dev)
        elif cfg.model == "lbph":
            # radius 2: the wider ring's bilinear sampling denoises the codes
            feature = SpatialHistogram(lbp_ops.ExtendedLBP(radius=2, neighbors=8),
                                       sz=(8, 8), device=dev)
            classifier = NearestNeighbor(ChiSquareDistance(), k=cfg.knn_k, device=dev)
        elif cfg.model == "lbp_fisherfaces":
            # raw radius-3 LBP histograms on a coarse 6x6 grid, no
            # Tan-Triggs (the codes are illumination-invariant already),
            # then Fisherfaces and a cosine NN
            feature = ChainOperator(
                SpatialHistogram(lbp_ops.ExtendedLBP(radius=3, neighbors=8), sz=(6, 6),
                                 device=dev),
                Fisherfaces(cfg.num_components, device=dev))
            classifier = NearestNeighbor(CosineDistance(), k=cfg.knn_k, device=dev)
        elif cfg.model == "cnn":
            feature = CNNEmbedding(embed_dim=cfg.embed_dim, input_size=cfg.image_size,
                                   train_steps=cfg.train_steps, **cfg.cnn_kwargs, device=dev)
            classifier = NearestNeighbor(CosineDistance(), k=cfg.knn_k, device=dev)
        else:
            raise ValueError(f"unknown model type {self.config.model!r}")
        if cfg.classifier == "svm":
            classifier = SVM(device=dev)
        elif cfg.classifier == "kernel_svm":
            classifier = KernelSVM(kernel=cfg.svm_kernel, device=dev)
        elif cfg.classifier != "nn":
            raise ValueError(f"unknown classifier {cfg.classifier!r}; pick nn | svm | kernel_svm")
        return ExtendedPredictableModel(feature, classifier, image_size=cfg.image_size,
                                        subject_names=subject_names)

    def _at_size(self, images) -> np.ndarray:
        images = np.asarray(images, np.float32)
        if images.shape[1:] != tuple(self.config.image_size):
            with stage("preprocess"):
                images = image_ops.resize(torch.as_tensor(images, device=self.device),
                                          self.config.image_size).cpu().numpy()
        return images

    # ---- training flows ----

    def train_from_dir(self, dataset_path: str, model_path: Optional[str] = None):
        with stage("read"):
            images, labels, names = dataset_utils.read_images(
                dataset_path, image_size=self.config.image_size)
        return self.train(images, labels, names, model_path)

    def train(self, images: np.ndarray, labels: np.ndarray, subject_names: List[str],
              model_path: Optional[str] = None,
              validate: bool = True) -> ExtendedPredictableModel:
        images = self._at_size(images)
        labels = np.asarray(labels, np.int32)
        model = self._build_model(subject_names)
        if validate and self.config.kfold > 1:
            # each fold refits a scratch model; the final fit sees all data
            scratch = self._build_model(subject_names)
            self.validation = KFoldCrossValidation(k=self.config.kfold)
            self.validation.validate(scratch, images, labels)
        with stage("fit"):
            model.compute(images, labels)
        self.model = model
        if model_path:
            with stage("save"):
                serialization.save_model(model_path, model, keep_previous=self.keep_checkpoints)
        return model

    @property
    def mean_accuracy(self) -> float:
        return self.validation.mean_accuracy if self.validation else float("nan")

    # ---- model selection ----

    #: ``select_model``'s order: cheap classics first, the CNN last
    SELECT_CANDIDATES = ("eigenfaces", "fisherfaces", "lbph", "lbp_fisherfaces", "cnn")

    def validate_only(self, images: np.ndarray, labels: np.ndarray,
                      subject_names: List[str]) -> float:
        """K-fold this config on a scratch model without the final fit;
        returns the mean accuracy (``self.validation`` holds the folds)."""
        images = self._at_size(images)
        labels = np.asarray(labels, np.int32)
        scratch = self._build_model(subject_names)
        self.validation = KFoldCrossValidation(
            k=max(self.config.kfold, 2)).validate(scratch, images, labels)
        return self.mean_accuracy

    # ---- serving handoff (cnn backend) ----

    def build_gallery(self, images: np.ndarray, labels: np.ndarray, mesh=None,
                      capacity: int = 0, store_dtype: torch.dtype = torch.float32):
        """Embed the enrolled set with the CNN and install it into a
        ``ShardedGallery`` on ``mesh`` (or this trainer's device)."""
        from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

        if self.model is None or not isinstance(self.model.feature, CNNEmbedding):
            raise RuntimeError("build_gallery requires a trained cnn model")
        emb = self.model.feature.extract(np.asarray(images, np.float32)).float().cpu().numpy()
        capacity = capacity or max(2 * len(emb), 64)
        gallery = ShardedGallery(capacity=capacity, dim=emb.shape[1], mesh=mesh,
                                 store_dtype=store_dtype, device=self.device)
        gallery.add(emb, np.asarray(labels, np.int32))
        return gallery

    def finetune_embedder(self, images: np.ndarray, labels: np.ndarray, *,
                          steps: int = 100, identities_per_batch: int = 8,
                          samples_per_identity: int = 4, learning_rate: float = 1e-4,
                          margin: float = 0.5, scale: float = 32.0,
                          seed: int = 0) -> CNNEmbedding:
        """Multibatch metric-learning fine-tune (arxiv 1605.07270) of the
        trained CNN embedder on accumulated enrolments: each step samples
        ``identities_per_batch`` identities x ``samples_per_identity``
        crops (with replacement inside an identity that has fewer), drawn
        with numpy as the reference draws them. It starts from the serving
        model's weights and trains a copy: ``self.model``'s tensors do not
        change. Returns the fine-tuned ``CNNEmbedding`` (hand it to
        ``make_reembed_fn`` and a ``RolloutCoordinator``)."""
        if self.model is None or not isinstance(self.model.feature, CNNEmbedding):
            raise RuntimeError("finetune_embedder requires a trained cnn model "
                               "(TheTrainer(model='cnn').train first)")
        old = self.model.feature
        dev = old.device
        if dev.type == "cuda":
            disable_tf32()
        with torch.no_grad():
            x = normalize_faces(torch.as_tensor(np.asarray(images, np.float32)).to(dev),
                                old.input_size)
        classes, y = np.unique(np.asarray(labels, np.int32), return_inverse=True)
        y = y.reshape(-1)
        new_feature = CNNEmbedding(
            embed_dim=old.embed_dim, input_size=old.input_size,
            stem_features=old.stem_features, stage_features=old.stage_features,
            stage_blocks=old.stage_blocks, block=old.block,
            space_to_depth=old.space_to_depth, norm=old.norm, train_steps=0,
            seed=old.seed, tta=old.tta, device=dev)
        new_feature.net.load_state_dict(old.net.state_dict())  # a copy of each tensor
        num_classes = max(1, len(classes))
        head = (old._head.clone() if old._head.shape[0] == num_classes
                else draw_head(num_classes, old.embed_dim, seed + 1))
        head = head.to(dev, torch.float32).requires_grad_(True)
        optimizer = adam([*new_feature.net.parameters(), head], float(learning_rate))
        step = make_train_step(new_feature.net, head, optimizer, float(margin), float(scale))
        by_class = [np.flatnonzero(y == c) for c in range(num_classes)]
        k = min(int(identities_per_batch), num_classes)
        m = max(1, int(samples_per_identity))
        rng = np.random.default_rng(seed)
        batches = []
        for _ in range(int(steps)):
            ids = rng.choice(num_classes, size=k, replace=False)
            batches.append(np.concatenate([
                rng.choice(by_class[c], size=m, replace=len(by_class[c]) < m) for c in ids]))
        if batches:
            batches = torch.as_tensor(np.stack(batches), dtype=torch.long).to(dev)
        y_dev = torch.as_tensor(y, dtype=torch.long).to(dev)
        warmup = max(1, int(0.1 * steps))
        for i in range(int(steps)):
            idx = batches[i]
            step(x[idx], y_dev[idx], None, min(1.0, i / warmup))
        new_feature._head = head.detach().cpu()
        return new_feature

    @staticmethod
    def make_reembed_fn(feature, source_images: np.ndarray):
        """The ``RolloutCoordinator.reembed_fn`` of an embedder: re-extract
        each gallery row's stored source crop (``source_images[i]`` is row
        i's, in gallery order) with ``feature``."""
        def reembed(rows: np.ndarray, start: int) -> np.ndarray:
            end = start + int(np.asarray(rows).shape[0])
            crops = np.asarray(source_images[start:end], np.float32)
            out = feature.extract(crops)
            if isinstance(out, torch.Tensor):
                out = out.detach().float().cpu().numpy()
            return np.asarray(out, np.float32)

        return reembed


def select_model(images: np.ndarray, labels: np.ndarray, subject_names: List[str],
                 candidates: Optional[Tuple[str, ...]] = None,
                 model_path: Optional[str] = None, device: DeviceLike = DEFAULT_DEVICE,
                 **config_overrides) -> Tuple[TheTrainer, Dict[str, float]]:
    """K-fold every candidate model kind on the same data and fit the
    winner (ties to the earlier, cheaper one) on the whole set; returns
    (the winning trainer, {kind: mean k-fold accuracy})."""
    candidates = tuple(candidates or TheTrainer.SELECT_CANDIDATES)
    trainers = {kind: TheTrainer(TrainerConfig(model=kind), device=device,
                                 **config_overrides) for kind in candidates}
    images = trainers[candidates[0]]._at_size(images)
    scores: Dict[str, float] = {}
    for kind in candidates:
        scores[kind] = float(trainers[kind].validate_only(images, labels, subject_names))
    best = max(candidates, key=lambda k: scores[k])
    winner = trainers[best]
    winner.train(images, labels, subject_names, model_path, validate=False)
    return winner, scores
