"""The CNN half of the PyTorch port's ``TheTrainer`` and ``ocvf-train-torch``
against the JAX package's, on the CPU in float32 (both packages' nets
built in f32).

Both packages' ``CNNEmbedding`` start from flax's init at their seed
(the ``shared_init`` fixture loads the reference's ``init_embedder``
params into the port's embedder where the reference would draw them:
the port's own draws are not ``jax.random``'s, ROADMAP C.22), so they
train on the same batches from the same weights:

- ``TheTrainer(model="cnn")``: the k-fold results, fold for fold;
- ``finetune_embedder``: the fine-tuned embeddings, and the serving
  feature's tensors unchanged bit for bit;
- ``select_model`` over the default candidates (the CNN among them):
  the same scores and winner;
- ``ocvf-train-torch --model cnn`` and ``--model auto`` against
  ``ocvf-train`` on one directory: the same folds and selection.

ArcFace over a few steps in f32 is reproducible across the packages to
~1e-6 in the embeddings (``tests/test_torch_embedder_train.py``), so
cosine-NN predictions, hence fold results, are equal unless a query sits
on a tie; the data here has none.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.apps import train as jax_train_app
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.runtime import trainer as jax_trainer
from opencv_facerecognizer_tpu_torch.apps import train as port_train_app
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.runtime.trainer import TheTrainer, select_model
from opencv_facerecognizer_tpu_torch.utils import serialization
from opencv_facerecognizer_tpu_torch.utils.dataset import make_synthetic_faces
from torch_train_support import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")
TINY_CNN = dict(stem_features=8, stage_features=(8, 16), stage_blocks=(1, 1), batch_size=8,
                learning_rate=3e-3)
#: fine-tuned embeddings of the two packages: cosine per face
FINETUNE_COS = 0.9999


@pytest.fixture
def shared_init(monkeypatch):
    """f32 nets in both packages; the port's ``compute`` on an embedder
    with nothing loaded starts from the reference's ``init_embedder``."""
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
    monkeypatch.setattr(port_embedder, "FaceEmbedNet",
                        functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))
    compute = port_embedder.CNNEmbedding.compute

    def from_flax_init(self, X, y):
        if self._head is None:
            jnet = jax_embedder.FaceEmbedNet(
                embed_dim=self.embed_dim, stem_features=self.stem_features,
                stage_features=self.stage_features, stage_blocks=self.stage_blocks,
                block=self.block, space_to_depth=self.space_to_depth, norm=self.norm)
            n = max(1, len(np.unique(np.asarray(y))))
            self.load_params(jax.tree_util.tree_map(
                np.asarray, jax_embedder.init_embedder(jnet, n, self.input_size, self.seed)))
        return compute(self, X, y)

    monkeypatch.setattr(port_embedder.CNNEmbedding, "compute", from_flax_init)


def _cnn_cfg(**kw):
    return dict(model="cnn", image_size=(32, 32), embed_dim=16, train_steps=6,
                cnn_kwargs=dict(TINY_CNN), **kw)


def test_cnn_trainer_folds_equal_the_references(shared_init, tmp_path):
    X, y, names = make_synthetic_faces(4, 6, (32, 32), seed=47, noise=8.0)
    want = jax_trainer.TheTrainer(**_cnn_cfg(kfold=3))
    want.train(X, y, names)
    got = TheTrainer(**_cnn_cfg(kfold=3), **CPU)
    path = str(tmp_path / "cnn.ckpt")
    got.train(X, y, names, model_path=path)
    assert [repr(r) for r in got.validation.results] == [repr(r) for r in want.validation.results]
    assert got.mean_accuracy == want.mean_accuracy
    e_got = got.model.feature.extract(X).numpy()
    e_want = np.asarray(want.model.feature.extract(X))
    assert np.sum(e_got * e_want, axis=1).min() >= FINETUNE_COS
    # the port-trained checkpoint predicts alike in both packages
    from opencv_facerecognizer_tpu.utils import serialization as jax_serialization

    np.testing.assert_array_equal(np.asarray(jax_serialization.load_model(path).predict(X)[0]),
                                  serialization.load_model(path, **CPU).predict(X)[0])


def test_finetune_embedder_matches_jax_and_leaves_serving_untouched(shared_init):
    X, y, names = make_synthetic_faces(5, 6, (32, 32), seed=48, noise=8.0)
    want = jax_trainer.TheTrainer(**_cnn_cfg(kfold=0))
    want.train(X, y, names, validate=False)
    got = TheTrainer(**_cnn_cfg(kfold=0), **CPU)
    got.train(X, y, names, validate=False)
    serving = {k: v.clone() for k, v in got.model.feature.net.state_dict().items()}
    head = got.model.feature._head.clone()
    kw = dict(steps=5, identities_per_batch=3, samples_per_identity=2, learning_rate=1e-3,
              seed=2)
    new_want = want.finetune_embedder(X, y + 10, **kw)
    new_got = got.finetune_embedder(X, y + 10, **kw)
    for k, v in got.model.feature.net.state_dict().items():
        assert torch.equal(v, serving[k]), k
    assert torch.equal(got.model.feature._head, head)
    assert new_got.get_config() == new_want.get_config()
    e_got = new_got.extract(X).numpy()
    e_want = np.asarray(new_want.extract(X))
    assert np.sum(e_got * e_want, axis=1).min() >= FINETUNE_COS
    moved = got.model.feature.extract(X).numpy()
    assert np.abs(moved - e_got).max() > 1e-4  # it did train
    with pytest.raises(RuntimeError, match="trained cnn model"):
        TheTrainer(model="eigenfaces", **CPU).finetune_embedder(X, y)


def test_select_model_over_the_default_candidates(shared_init, tmp_path):
    X, y, names = make_synthetic_faces(4, 6, (32, 32), seed=49, noise=8.0)
    kw = dict(image_size=(32, 32), kfold=2, embed_dim=16, train_steps=6,
              cnn_kwargs=dict(TINY_CNN))
    want, want_scores = jax_trainer.select_model(X, y, names, **kw)
    path = str(tmp_path / "auto.ckpt")
    got, scores = select_model(X, y, names, model_path=path, **kw, **CPU)
    assert tuple(scores) == TheTrainer.SELECT_CANDIDATES == jax_trainer.TheTrainer.SELECT_CANDIDATES
    assert scores == want_scores
    assert got.config.model == want.config.model == max(scores, key=scores.get)
    assert serialization.load_model(path, **CPU).subject_names == names


# ---- the CLI on one directory ----


def _write_dataset(root, images, labels, names):
    from PIL import Image

    for i, (img, label) in enumerate(zip(images, labels)):
        os.makedirs(os.path.join(root, names[label]), exist_ok=True)
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, names[label], f"{i}.png"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    X, y, names = make_synthetic_faces(4, 6, (32, 32), seed=52, noise=8.0)
    root = str(tmp_path_factory.mktemp("cnn_data") / "data")
    _write_dataset(root, X, y, names)
    return root


@pytest.mark.parametrize("argv", [["--model", "cnn", "--kfold", "2"],
                                  ["--model", "auto", "--kfold", "2"]], ids=["cnn", "auto"])
def test_train_app_cnn_and_auto_print_the_references_results(argv, data_dir, shared_init,
                                                             tmp_path, capsys):
    """``ocvf-train-torch`` and ``ocvf-train`` on one directory (default
    CNN structure, 32x32, 4 ArcFace steps) print the same folds or the
    same selection; the stage report counts the ArcFace fits under
    ``fit``."""
    import json

    args = [*argv, "--image-size", "32", "32", "--embed-dim", "16", "--train-steps", "4"]
    assert port_train_app.main([data_dir, str(tmp_path / "p.ckpt"), *args, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert jax_train_app.main([data_dir, str(tmp_path / "j.ckpt"), *args]) == 0
    want = capsys.readouterr().out
    keep = ("ValidationResult", "mean k-fold", "subjects", "  ", "selected")
    pick = lambda out: [line for line in out.splitlines() if line.startswith(keep)]  # noqa: E731
    assert pick(got.out) and pick(got.out) == pick(want)
    report = json.loads(next(line for line in got.err.splitlines()
                             if line.startswith("train stages: ")).split(": ", 1)[1])
    assert report["device"] == "cpu" and report["counts"]["fit"] >= 3
    assert serialization.load_model(str(tmp_path / "p.ckpt"), **CPU).subject_names
