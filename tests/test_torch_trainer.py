"""The classic trainer and ``ocvf-train-torch`` of the PyTorch port against
the JAX package's ``TheTrainer`` and ``ocvf-train``.

- The k-fold folds (numpy, equal for one seed) score the same true
  positives in both packages at the canary sizes of
  ``tests/test_accuracy.py`` for all four classic families.
- Classic checkpoints cross both ways and predict the same labels.
- The twins of ``tests/test_runtime.py``'s trainer tests and
  ``tests/test_apps.py::test_train_app_classic`` run on the port (on the
  CPU), and the two CLIs print the same per-fold results on one dataset
  directory.
- CNN training, once refused naming ROADMAP A.13, runs:
  ``model="cnn"`` with ``train_steps > 0``, ``finetune_embedder``,
  ``select_model`` over ``"cnn"``, and the CLI's ``--model auto`` and
  ``--model cnn --train-steps N`` (held to the JAX package in
  ``tests/test_torch_trainer_train.py``).
"""

import os

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.apps import train as jax_train_app
from opencv_facerecognizer_tpu.runtime import trainer as jax_trainer
from opencv_facerecognizer_tpu.utils import serialization as jax_serialization
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_faces as jax_faces
from opencv_facerecognizer_tpu_torch.apps import train as port_train_app
from opencv_facerecognizer_tpu_torch.models.classifier import KernelSVM, SVM
from opencv_facerecognizer_tpu_torch.models.embedder import CNNEmbedding
from opencv_facerecognizer_tpu_torch.runtime.trainer import (
    TheTrainer, TrainerConfig, select_model)
from opencv_facerecognizer_tpu_torch.utils import dataset as port_dataset
from opencv_facerecognizer_tpu_torch.utils import serialization
from opencv_facerecognizer_tpu_torch.utils import validation as port_validation
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces
from torch_train_support import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")

#: tests/test_accuracy.py's canaries: (model, make_synthetic_faces arguments)
CANARIES = {
    "eigenfaces": dict(num_subjects=12, per_subject=8, size=(48, 48), seed=1),
    "fisherfaces": dict(num_subjects=10, per_subject=8, size=(56, 56), seed=2,
                        illumination=0.7, noise=14.0),
    "lbp_fisherfaces": dict(num_subjects=10, per_subject=8, size=(56, 56), seed=2,
                            illumination=0.7, noise=14.0),
    "lbph": dict(num_subjects=12, per_subject=8, size=(48, 48), seed=3, noise=18.0),
}


def test_synthetic_data_and_folds_equal_the_references():
    from opencv_facerecognizer_tpu.utils import dataset as jax_dataset
    from opencv_facerecognizer_tpu.utils import validation as jax_validation

    for kw in (dict(num_subjects=5, per_subject=4, size=(24, 20), seed=9),
               dict(num_subjects=3, per_subject=3, size=(30, 30), seed=2, rotation=8.0,
                    scale_jitter=0.08, elastic=1.2, occlusion=0.25)):
        a, b = jax_faces(**kw), make_synthetic_faces(**kw)
        for x, z in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(z))
    for x, z in zip(jax_dataset.make_synthetic_scenes(6, (48, 48), seed=4),
                    port_dataset.make_synthetic_scenes(6, (48, 48), seed=4)):
        np.testing.assert_array_equal(x, z)
    X, y, _ = make_synthetic_faces(4, 5, (8, 8), seed=1)
    for x, z in zip(jax_dataset.shuffle(X, y, 3), port_dataset.shuffle(X, y, 3)):
        np.testing.assert_array_equal(x, z)
    for k in (2, 3, 10):
        for x, z in zip(jax_validation.stratified_kfold_indices(y, k, 5),
                        port_validation.stratified_kfold_indices(y, k, 5)):
            np.testing.assert_array_equal(x, z)


@pytest.mark.parametrize("model", sorted(CANARIES))
def test_fold_true_positives_equal_the_references(model):
    kw = CANARIES[model]
    X, y, names = make_synthetic_faces(**kw)
    cfg = dict(model=model, kfold=3, image_size=kw["size"])
    want = jax_trainer.TheTrainer(jax_trainer.TrainerConfig(**cfg))
    want.train(X, y, names)
    got = TheTrainer(TrainerConfig(**cfg), **CPU)
    got.train(X, y, names)
    assert [r.true_positives for r in got.validation.results] == [
        r.true_positives for r in want.validation.results]
    assert [repr(r) for r in got.validation.results] == [repr(r) for r in want.validation.results]
    assert got.mean_accuracy == want.mean_accuracy


@pytest.mark.parametrize("model", ["fisherfaces", "lbp_fisherfaces", "lbph"])
def test_trained_checkpoints_cross_both_ways(model, tmp_path):
    X, y, names = make_synthetic_faces(5, 6, (48, 48), seed=41)
    queries = X[1::2] + np.float32(3.0)
    jpath, ppath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jax_trainer.TheTrainer(model=model, image_size=(48, 48), kfold=0).train(
        X, y, names, model_path=jpath, validate=False)
    TheTrainer(model=model, image_size=(48, 48), kfold=0, **CPU).train(
        X, y, names, model_path=ppath, validate=False)
    for path in (jpath, ppath):
        jm = jax_serialization.load_model(path)
        pm = serialization.load_model(path, **CPU)
        assert pm.subject_names == jm.subject_names == names
        np.testing.assert_array_equal(pm.predict(queries)[0], np.asarray(jm.predict(queries)[0]))


# ---- twins of tests/test_runtime.py's trainer tests ----


def test_trainer_classic_flow_and_checkpoint(tmp_path):
    X, y, names = make_synthetic_faces(5, 6, (24, 24), seed=41)
    trainer = TheTrainer(model="fisherfaces", image_size=(24, 24), kfold=3, **CPU)
    path = str(tmp_path / "model.ckpt")
    trainer.train(X, y, names, model_path=path)
    assert trainer.mean_accuracy > 0.8
    restored = serialization.load_model(path, **CPU)
    pred, _ = restored.predict(X[:4])
    assert (np.asarray(pred) == y[:4]).mean() == 1.0
    assert restored.subject_names == names


def test_trainer_model_zoo():
    X, y, names = make_synthetic_faces(4, 5, (40, 40), seed=43)
    for model_type in ("eigenfaces", "lbph"):
        trainer = TheTrainer(model=model_type, image_size=(40, 40), kfold=2, **CPU)
        trainer.train(X, y, names)
        assert trainer.mean_accuracy > 0.7, model_type


def test_trainer_lbp_fisherfaces_checkpoint(tmp_path):
    X, y, names = make_synthetic_faces(5, 6, (48, 48), seed=41)
    trainer = TheTrainer(model="lbp_fisherfaces", image_size=(48, 48), kfold=3, **CPU)
    path = str(tmp_path / "model.ckpt")
    trainer.train(X, y, names, model_path=path)
    assert trainer.mean_accuracy > 0.8
    restored = serialization.load_model(path, **CPU)
    pred, _ = restored.predict(X[:4])
    assert (np.asarray(pred) == y[:4]).mean() == 1.0
    assert restored.subject_names == names


def test_trainer_cnn_gallery_handoff():
    """The twin of the reference's: the CNN trains (40 ArcFace steps),
    then hands off to a gallery where every enrolled row finds itself;
    a CNN with seeded weights (``train_steps=0``) hands off the same way."""
    X, y, names = make_synthetic_faces(4, 6, (32, 32), seed=47, noise=8.0)
    kw = dict(model="cnn", image_size=(32, 32), kfold=0, embed_dim=32,
              cnn_kwargs=dict(stem_features=8, stage_features=(8, 16), stage_blocks=(1, 1),
                              batch_size=16, learning_rate=3e-3))
    trained = TheTrainer(**kw, train_steps=40, **CPU)
    trained.train(X, y, names, validate=False)
    emb = trained.model.feature.extract(X[:8]).numpy()
    labels, _sims, _ = (np.asarray(v) for v in trained.build_gallery(X, y).match(emb, k=1))
    assert (labels[:, 0] == y[:8]).all()
    trainer = TheTrainer(**kw, train_steps=0, **CPU)
    trainer.train(X, y, names, validate=False)
    gallery = trainer.build_gallery(X, y, store_dtype=torch.bfloat16)
    assert gallery.size == len(y)
    emb = trainer.model.feature.extract(X[:8]).numpy()
    labels, _sims, _ = (np.asarray(v) for v in gallery.match(emb, k=1))
    assert (labels[:, 0] == y[:8]).all()
    reembed = TheTrainer.make_reembed_fn(trainer.model.feature, X)
    np.testing.assert_allclose(reembed(np.zeros((3, 32)), 2), emb[2:5], atol=1e-6)
    with pytest.raises(RuntimeError, match="cnn model"):
        TheTrainer(model="eigenfaces", **CPU).build_gallery(X, y)


def test_trainer_rejects_unknown_model_and_field():
    with pytest.raises(TypeError):
        TheTrainer(bogus_field=1, **CPU)
    trainer = TheTrainer(model="nope", **CPU)
    with pytest.raises(ValueError):
        trainer.train(*make_synthetic_faces(2, 2, (16, 16)))


def test_trainer_classifier_swap(tmp_path):
    X, y, names = make_synthetic_faces(5, 6, (24, 24), seed=41)
    for clf_kind, clf_type in (("svm", SVM), ("kernel_svm", KernelSVM)):
        trainer = TheTrainer(model="eigenfaces", image_size=(24, 24), kfold=0,
                             classifier=clf_kind, **CPU)
        path = str(tmp_path / f"{clf_kind}.ckpt")
        trainer.train(X, y, names, validate=False, model_path=path)
        assert isinstance(trainer.model.classifier, clf_type)
        restored = serialization.load_model(path, **CPU)
        pred, _ = restored.predict(X[:6])
        assert (np.asarray(pred) == y[:6]).mean() >= 0.8, clf_kind
        np.testing.assert_array_equal(
            np.asarray(jax_serialization.load_model(path).predict(X[:6])[0]), pred)
    with pytest.raises(ValueError):
        TheTrainer(classifier="nope", **CPU).train(X, y, names, validate=False)


def test_select_model_picks_measured_winner(tmp_path):
    X, y, names = make_synthetic_faces(5, 6, (48, 48), seed=41)
    path = str(tmp_path / "auto.ckpt")
    winner, scores = select_model(
        X, y, names, candidates=("eigenfaces", "lbp_fisherfaces"),
        model_path=path, image_size=(48, 48), kfold=3, **CPU)
    assert set(scores) == {"eigenfaces", "lbp_fisherfaces"}
    best = max(scores, key=scores.get)
    assert winner.config.model == best
    assert winner.mean_accuracy == scores[best]
    restored = serialization.load_model(path, **CPU)
    pred, _ = restored.predict(X[:4])
    assert (np.asarray(pred) == y[:4]).mean() >= 0.75
    want, want_scores = jax_trainer.select_model(
        X, y, names, candidates=("eigenfaces", "lbp_fisherfaces"), image_size=(48, 48), kfold=3)
    assert scores == want_scores and want.config.model == best


def test_cnn_training_is_refused_naming_a13():
    """Kept under its name from when training was refused: each case it refused now trains (the
    parity with the JAX package is ``tests/test_torch_trainer_train.py``'s).
    ``finetune_embedder`` without a trained CNN still raises, as the
    reference's does."""
    X, y, names = make_synthetic_faces(3, 4, (32, 32), seed=1)
    small = dict(image_size=(32, 32), embed_dim=16, train_steps=2)
    winner, scores = select_model(X, y, names, kfold=2, **small, **CPU)
    assert "cnn" in scores and winner.config.model == max(scores, key=scores.get)
    trainer = TheTrainer(model="cnn", kfold=2, **small, **CPU)
    trainer.train(X, y, names)
    assert 0.0 <= trainer.mean_accuracy <= 1.0
    assert isinstance(trainer.finetune_embedder(X, y, steps=2), CNNEmbedding)
    with pytest.raises(RuntimeError, match="trained cnn model"):
        TheTrainer(**CPU).finetune_embedder(X, y)
    emb = CNNEmbedding(input_size=(32, 32), embed_dim=16, stem_features=8,
                       stage_features=(8, 16), stage_blocks=(1, 1), train_steps=2, **CPU)
    before = emb.net.stem.weight.detach().clone()
    assert emb.compute(X, y).shape == (len(y), 16)
    assert not torch.equal(emb.net.stem.weight.detach(), before)


# ---- the CLI ----


def _write_dataset(root, images, labels, names):
    from PIL import Image

    counters = {}
    for img, label in zip(images, labels):
        subject = names[label]
        os.makedirs(os.path.join(root, subject), exist_ok=True)
        i = counters.get(subject, 0)
        counters[subject] = i + 1
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, subject, f"{i}.png"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    X, y, names = make_synthetic_faces(4, 6, (32, 32), seed=51)
    root = str(tmp_path_factory.mktemp("train_data") / "data")
    _write_dataset(root, X, y, names)
    return root, names


def test_train_app_classic(data_dir, tmp_path, capsys):
    """The twin of tests/test_apps.py::test_train_app_classic, and the
    reference's CLI on the same directory printing the same folds."""
    root, names = data_dir
    model_path = str(tmp_path / "model.ckpt")
    plot_path = str(tmp_path / "eigen.png")
    args = [root, model_path, "--model", "fisherfaces", "--image-size", "32", "32",
            "--kfold", "2", "--eigenfaces-plot", plot_path]
    assert port_train_app.main(args + ["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "mean k-fold accuracy" in captured.out
    assert "train stages: " in captured.err
    assert os.path.exists(model_path) and os.path.exists(plot_path)
    model = serialization.load_model(model_path, **CPU)
    assert model.subject_names == names
    assert jax_serialization.load_model(model_path).subject_names == names
    jax_path = str(tmp_path / "jax.ckpt")
    assert jax_train_app.main([root, jax_path] + args[2:]) == 0
    want = capsys.readouterr().out
    fold_lines = [line for line in captured.out.splitlines()
                  if line.startswith(("ValidationResult", "mean k-fold", "subjects"))]
    assert fold_lines and fold_lines == [
        line for line in want.splitlines()
        if line.startswith(("ValidationResult", "mean k-fold", "subjects"))]


@pytest.mark.parametrize("model", ["lbph", "lbp_fisherfaces"])
def test_train_app_other_families_print_the_references_folds(model, data_dir, tmp_path, capsys):
    root, _names = data_dir
    args = ["--model", model, "--image-size", "32", "32", "--kfold", "3"]
    assert port_train_app.main([root, str(tmp_path / "p.ckpt"), *args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_train_app.main([root, str(tmp_path / "j.ckpt"), *args]) == 0
    want = capsys.readouterr().out
    pick = lambda out: [line for line in out.splitlines() if line.startswith("ValidationResult")]  # noqa: E731
    assert pick(got) and pick(got) == pick(want)


def test_train_app_stage_report_and_profile(data_dir, tmp_path, capsys):
    import json

    root, _names = data_dir
    prof = str(tmp_path / "prof")
    assert port_train_app.main([root, str(tmp_path / "m.ckpt"), "--model", "eigenfaces",
                                "--image-size", "32", "32", "--device", "cpu",
                                "--profile-dir", prof, "--keep-checkpoints", "1"]) == 0
    err = capsys.readouterr().err
    line = next(x for x in err.splitlines() if x.startswith("train stages: "))
    report = json.loads(line.split("train stages: ", 1)[1])
    assert report["device"] == "cpu" and report["folds"] == 3
    assert {"read", "fit", "predict", "save"} <= set(report["seconds"])
    assert report["counts"]["predict"] == 3 and report["counts"]["fit"] == 4
    assert "profile trace written to" in err and os.listdir(prof)


def test_train_app_rejects_bad_dataset(tmp_path):
    with pytest.raises((ValueError, FileNotFoundError)):
        port_train_app.main([str(tmp_path / "nope"), str(tmp_path / "m.ckpt"), "--device", "cpu"])


@pytest.mark.parametrize("argv", [["--model", "auto"], ["--model", "cnn", "--train-steps", "5"],
                                  ["--model", "cnn", "--train-steps", "0"]])
def test_train_app_refuses_cnn_training_naming_a13(argv, data_dir, tmp_path, capsys):
    """Kept under its name from when training was refused: each run it refused now trains and
    saves (the JAX package's CLI prints the same in
    ``tests/test_torch_trainer_train.py``); ``--model auto`` still refuses
    the flags that select one artifact, as the reference's does."""
    root, names = data_dir
    path = str(tmp_path / "m.ckpt")
    small = ["--image-size", "32", "32", "--kfold", "2", "--embed-dim", "16"]
    if "--train-steps" not in argv:
        small += ["--train-steps", "2"]
    assert port_train_app.main([root, path, *argv, *small, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("selected: " if "auto" in argv else "mean k-fold accuracy: ") in out
    assert serialization.load_model(path, **CPU).subject_names == names
    if "auto" in argv:
        with pytest.raises(SystemExit) as exc:
            port_train_app.main([root, path, *argv, "--keep-checkpoints", "1", "--device", "cpu"])
        assert exc.value.code == 2


def test_train_app_flags_are_the_references_plus_device():
    def flags(parser):
        return {opt for action in parser._actions for opt in action.option_strings}

    assert flags(port_train_app.build_parser()) - flags(jax_train_app.build_parser()) == {"--device"}
    assert flags(jax_train_app.build_parser()) <= flags(port_train_app.build_parser())
    assert port_train_app.build_parser().get_default("device") == "cuda"
    for bad in (["--svm-kernel", "poly"], ["--knn-k", "3", "--classifier", "svm"]):
        with pytest.raises(SystemExit):
            port_train_app.main(["d", "m", *bad, "--device", "cpu"])
