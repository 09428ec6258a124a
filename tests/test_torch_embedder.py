"""Embedder and align stage of the PyTorch port against the JAX package:
``FaceEmbedNet`` and ``fused_forward`` on the same flax params,
``normalize_faces``, ``resize`` and ``batched_crop_resize``.

Tolerances: embeddings are unit vectors; the bar is cosine >= 0.9999 per
face, the one ``tests/test_pallas_sepblock.py`` sets for the fused
schedule against flax (``COS_MIN``). In f32 the port's flax-mirroring
forward agrees far closer (``F32_ATOL``). The crop and the normalization
are f32 arithmetic in another order (``CROP_ATOL`` on 0..255 pixels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.ops import image as jax_image
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.ops import image as port_image
from opencv_facerecognizer_tpu_torch.utils.params import embedder_params_from_flax

COS_MIN = 0.9999
F32_ATOL = 1e-5
CROP_ATOL = 1e-3
TINY = dict(embed_dim=32, stem_features=8, stage_features=(8, 16), stage_blocks=(2, 1))


def _pair(cfg, size, dtype):
    jnet = jax_embedder.FaceEmbedNet(**cfg, dtype=getattr(jnp, dtype))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, *size)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pnet = port_embedder.FaceEmbedNet(**cfg, dtype=getattr(torch, dtype), input_size=size)
    embedder_params_from_flax(params, pnet)
    return jnet, params, pnet


def _faces(n, size, seed=4):
    return np.random.default_rng(seed).normal(size=(n, *size)).astype(np.float32)


def _cos(a, b):
    return np.sum(np.asarray(a) * np.asarray(b), axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_net_matches_flax(dtype):
    jnet, params, pnet = _pair(TINY, (32, 32), dtype)
    x = _faces(4, (32, 32))
    # bf16 eagerly (the same rounding points as the port's eager ops)
    apply = jax.jit(jnet.apply) if dtype == "float32" else jnet.apply
    want = np.asarray(apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pnet(torch.tensor(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert (_cos(got, want) >= COS_MIN).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_forward_matches_flax_and_pallas(dtype):
    jnet, params, pnet = _pair(TINY, (32, 32), dtype)
    x = _faces(4, (32, 32), seed=5)
    flax = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    pallas = np.asarray(jax_embedder.fused_forward(jnet, params, jnp.asarray(x),
                                                   interpret=True, block_b=2))
    with torch.no_grad():
        got = port_embedder.fused_forward(pnet, torch.tensor(x)).numpy()
    assert (_cos(got, flax) >= COS_MIN).all()
    assert (_cos(got, pallas) >= COS_MIN).all()


def test_serving_config_loads_flax_params():
    """The serving embedder's flax params load into the port's module and
    run to the same embeddings (f32, two faces)."""
    cfg = dict(port_embedder.SERVING_EMBEDDER_KWARGS)
    assert cfg == jax_embedder.SERVING_EMBEDDER_KWARGS
    assert port_embedder.SERVING_FACE_SIZE == jax_embedder.SERVING_FACE_SIZE
    size = port_embedder.SERVING_FACE_SIZE
    jnet, params, pnet = _pair(cfg, size, "float32")
    x = _faces(2, size, seed=6)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pnet(torch.tensor(x)).numpy()
        fused = port_embedder.fused_forward(pnet, torch.tensor(x)).numpy()
    assert (_cos(got, want) >= COS_MIN).all() and (_cos(fused, want) >= COS_MIN).all()
    n_flax = sum(np.size(v) for v in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in pnet.parameters())


def test_uncovered_variants_raise():
    """Every variant of the reference is covered (ROADMAP A.9,
    tests/test_torch_embedder_variants.py); what the reference refuses,
    the port refuses alike: an unknown block kind, a space-to-depth that
    does not divide the net's total downsample."""
    for kw in (dict(block="dense"), dict(norm="light"), dict(space_to_depth=2)):
        port_embedder.FaceEmbedNet(**TINY, **kw)
    with pytest.raises(KeyError):
        port_embedder.FaceEmbedNet(**TINY, block="conv")
    with pytest.raises(KeyError):
        jax_embedder.FaceEmbedNet(**TINY, block="conv").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32)))
    with pytest.raises(ValueError, match="must divide"):
        port_embedder.FaceEmbedNet(**TINY, space_to_depth=3)


def test_normalize_faces_matches_reference():
    x = np.random.default_rng(1).random((3, 2, 16, 16)).astype(np.float32) * 255
    x[0, 0] = 7.0  # constant face: std clamps to 1e-6
    want = np.asarray(jax_embedder.normalize_faces(jnp.asarray(x), (16, 16)))
    got = port_embedder.normalize_faces(torch.tensor(x), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size", [(16, 16), (24, 12), (7, 9)])
def test_resize_matches_jax_image_resize(size):
    x = np.random.default_rng(2).random((2, 12, 12)).astype(np.float32) * 255
    want = np.asarray(jax_image.resize(jnp.asarray(x), size))
    got = port_image.resize(torch.tensor(x), size).numpy()
    np.testing.assert_allclose(got, want, atol=CROP_ATOL)


def test_resize_identity_is_the_input():
    x = torch.rand(2, 8, 8)
    assert port_image.resize(x, (8, 8)) is x


def test_batched_crop_resize_matches_reference():
    rng = np.random.default_rng(3)
    frames = (rng.random((2, 40, 48)) * 255).astype(np.float32)
    boxes = np.array([[[0, 0, 40, 48], [5.5, 3.2, 20.7, 30.1], [-10, -4, 12, 60],
                       [0, 0, 0, 0]],
                      [[10, 10, 11, 11], [30, 40, 45, 55], [2, 2, 38, 46],
                       [20, 20, 10, 10]]], np.float32)
    want = np.asarray(jax_image.batched_crop_resize(jnp.asarray(frames),
                                                    jnp.asarray(boxes), (16, 16)))
    got = port_image.batched_crop_resize(torch.tensor(frames), torch.tensor(boxes),
                                         (16, 16)).numpy()
    assert got.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(got, want, atol=CROP_ATOL)
