"""The embedder variants of the PyTorch port (ROADMAP A.9) against the JAX
package: ``space_to_depth`` 2 and 4, ``norm="light"`` and
``block="dense"``, on the same flax params.

Tolerances: in float32 the port's forward is held to flax's within
``F32_ATOL`` (1e-5); in bf16, where XLA and eager torch round at other
points, each face's embedding within cosine ``COS_MIN`` (0.9999, the
serving bar of ``tests/test_torch_embedder.py``). The fused schedule's
plain version against the JAX ``fused_forward`` in interpret mode at the
same bar. Parameter trees cross the bridge bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import classifier as jax_classifier
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.models import model as jax_model
from opencv_facerecognizer_tpu.ops import distance as jax_distance
from opencv_facerecognizer_tpu.utils import serialization as jax_serialization
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery
from opencv_facerecognizer_tpu_torch.parallel.pipeline import RecognitionPipeline
from opencv_facerecognizer_tpu_torch.utils import serialization as port_serialization
from opencv_facerecognizer_tpu_torch.utils.params import (
    embedder_params_from_flax, embedder_params_to_flax)

COS_MIN = 0.9999
F32_ATOL = 1e-5
TINY = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(2, 1))
SIZE = (32, 32)
VARIANTS = {"s2": dict(space_to_depth=2), "s4": dict(space_to_depth=4),
            "light": dict(norm="light"), "dense": dict(block="dense"),
            "dense_light_s2": dict(block="dense", norm="light", space_to_depth=2)}


def _pair(kw, dtype, cfg=TINY, size=SIZE):
    jnet = jax_embedder.FaceEmbedNet(**cfg, **kw, dtype=getattr(jnp, dtype))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, *size)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pnet = port_embedder.FaceEmbedNet(**cfg, **kw, dtype=getattr(torch, dtype), input_size=size)
    embedder_params_from_flax(params, pnet)
    return jnet, params, pnet


def _faces(n, size=SIZE, seed=4):
    return np.random.default_rng(seed).normal(size=(n, *size)).astype(np.float32)


def _cos(a, b):
    return np.sum(np.asarray(a) * np.asarray(b), axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_flax(variant, dtype):
    jnet, params, pnet = _pair(VARIANTS[variant], dtype)
    x = _faces(4)
    apply = jax.jit(jnet.apply) if dtype == "float32" else jnet.apply
    want = np.asarray(apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pnet(torch.tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (_cos(got, want) >= COS_MIN).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_params_cross_the_bridge_bit_for_bit(variant):
    """The flax tree -> port -> flax tree is the same tree, with the
    reference's module names (a light block's one norm is GroupNorm_0,
    a dense block's Conv_0 and GroupNorm_0), and the stem takes s*s
    channels."""
    _jnet, params, pnet = _pair(VARIANTS[variant], "float32")
    back = embedder_params_to_flax(pnet)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)
    s = VARIANTS[variant].get("space_to_depth", 1)
    assert params["Conv_0"]["kernel"].shape == (3, 3, s * s, TINY["stem_features"])
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in pnet.parameters())


def test_space_to_depth_folds_in_the_references_order():
    """A 3-channel input shows the (dy, dx, c) order, which
    ``F.pixel_unshuffle``'s (c, dy, dx) would not give."""
    from opencv_facerecognizer_tpu_torch.models._layers import space_to_depth_nhwc

    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    n, h, w, c = x.shape
    want = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        n, h // 2, w // 2, 4 * c)
    np.testing.assert_array_equal(space_to_depth_nhwc(torch.tensor(x), 2).numpy(), want)


@pytest.mark.parametrize("s", [2, 4])
def test_fused_forward_matches_the_pallas_schedule(s):
    """The port's fused forward (the plain version of kernel B on the
    CPU) against the JAX ``fused_forward`` in interpret mode at s = 2 and
    4 (COS_MIN), and against flax no further than the JAX schedule's own
    distance to flax (0.99984 here: bf16 rounded at other points)."""
    jnet, params, pnet = _pair(dict(space_to_depth=s), "bfloat16")
    x = _faces(4, seed=5)
    flax = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    pallas = np.asarray(jax_embedder.fused_forward(jnet, params, jnp.asarray(x),
                                                   interpret=True, block_b=2))
    with torch.no_grad():
        got = port_embedder.fused_forward(pnet, torch.tensor(x)).numpy()
    assert (_cos(got, pallas) >= COS_MIN).all()
    assert _cos(got, flax).min() >= _cos(pallas, flax).min() - 1e-6


@pytest.mark.parametrize("variant", ["light", "dense"])
def test_fused_forward_and_the_fused_pipeline_refuse_light_and_dense(variant):
    jnet, params, pnet = _pair(VARIANTS[variant], "float32")
    with pytest.raises(ValueError) as jax_err:
        jax_embedder.fused_forward(jnet, params, jnp.zeros((1, *SIZE)), interpret=True)
    with pytest.raises(ValueError) as port_err:
        port_embedder.fused_forward(pnet, torch.zeros(1, *SIZE))
    assert str(port_err.value) == str(jax_err.value)
    det = port_detector.CNNFaceDetector(features=(8, 16), head_features=16, max_faces=4,
                                        device="cpu")
    gallery = ShardedGallery(64, TINY["embed_dim"], device="cpu")
    with pytest.raises(ValueError, match="covers"):
        RecognitionPipeline(det, pnet, gallery, face_size=SIZE, fused_embedder=True,
                            device="cpu")
    RecognitionPipeline(det, pnet, gallery, face_size=SIZE, device="cpu")  # unfused serves


def test_bad_space_to_depth_raises_as_the_reference():
    with pytest.raises(ValueError, match="must divide"):
        jax_embedder.FaceEmbedNet(**TINY, space_to_depth=3).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 48, 48)))
    with pytest.raises(ValueError, match="must divide"):
        port_embedder.FaceEmbedNet(**TINY, space_to_depth=3, input_size=(48, 48))
    pnet = port_embedder.FaceEmbedNet(**TINY, space_to_depth=4, input_size=(34, 34))
    with pytest.raises(ValueError, match="not divisible"):
        pnet(torch.zeros(1, 34, 34))


@pytest.mark.parametrize("variant", ["s2", "light", "dense"])
def test_cnn_checkpoint_of_a_variant_loads_both_ways(variant, tmp_path, monkeypatch):
    """A JAX-written ``CNNEmbedding`` checkpoint of a variant loads in the
    port with the same state and embeds alike (both nets in f32), and the
    port writes flax's bytes back."""
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
    monkeypatch.setattr(port_embedder, "FaceEmbedNet",
                        functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))
    emb = dict(embed_dim=32, input_size=SIZE, stem_features=8, stage_features=(8, 16),
               stage_blocks=(2, 1), train_steps=0, **VARIANTS[variant])
    X = (np.random.default_rng(8).random((4, 40, 36)) * 255).astype(np.float32)
    y = np.array([1, 1, 2, 2])
    model = jax_model.PredictableModel(jax_embedder.CNNEmbedding(**emb),
                                       jax_classifier.NearestNeighbor(jax_distance.CosineDistance()))
    model.compute(X, y)
    path = str(tmp_path / "cnn.ckpt")
    jax_serialization.save_model(path, model)
    got = port_serialization.load_model(path, device="cpu")
    assert got.feature.get_config() == model.feature.get_config()
    np.testing.assert_allclose(got.feature.extract(X).numpy(),
                               np.asarray(model.feature.extract(X)), atol=2e-3)
    assert np.array_equal(got.predict(X)[0], np.asarray(model.predict(X)[0]))
    out = str(tmp_path / "port.ckpt")
    port_serialization.save_model(out, got)
    assert open(out, "rb").read() == open(path, "rb").read()
