"""Checkpoints cross between the packages: the port's msgpack codec
(``utils/_msgpack.py``) against flax's ``msgpack_serialize`` /
``msgpack_restore``, the port's ``save_model`` / ``load_model`` and
``CNNFaceDetector.save`` / ``load`` against the JAX package's, and the
plugins a CNN checkpoint holds (``CNNEmbedding``, ``NearestNeighbor``,
the distances, ``PredictableModel``).

Trees and arrays are held bit for bit. Outputs computed from loaded
weights are held in float32 (``f32_nets``: a checkpoint carries no
compute dtype, and in bf16 XLA's fusions round elsewhere than the port's
eager ops): embeddings within 2e-3, detector boxes within 1e-3 px (the
tolerances of test_torch_embedder.py and test_torch_pipeline.py).
"""

import functools

import flax.serialization as flax_serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import classifier as jax_classifier
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.models import model as jax_model
from opencv_facerecognizer_tpu.ops import distance as jax_distance
from opencv_facerecognizer_tpu.utils import serialization as jax_serialization
from opencv_facerecognizer_tpu_torch.models import classifier as port_classifier
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.ops import distance as port_distance
from opencv_facerecognizer_tpu_torch.utils import _msgpack
from opencv_facerecognizer_tpu_torch.utils import serialization as port_serialization

EMB = dict(embed_dim=32, input_size=(32, 32), stem_features=8, stage_features=(8, 16),
           stage_blocks=(2, 1), train_steps=0)
DET = dict(features=(8, 16), head_features=16, max_faces=4, space_to_depth=2)


def _trees():
    rng = np.random.default_rng(3)
    return {
        "arrays": {"f32": rng.standard_normal((3, 5)).astype(np.float32),
                   "i32": rng.integers(-2**31, 2**31 - 1, (7,), dtype=np.int32),
                   "u8": rng.integers(0, 256, (2, 2, 3), dtype=np.uint8),
                   "bool": rng.random(9) > 0.5,
                   "f64": np.array([np.pi, -0.0, np.inf]),
                   "empty": np.zeros((0, 4), np.float32), "scalar": np.zeros((), np.int64),
                   "bf16": np.asarray(jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16)).reshape(3, 4)},
        "scalars": {"np": [np.float32(1.5), np.int64(-3), np.bool_(True), np.float64(2.5),
                           np.uint16(7), np.asarray(jnp.bfloat16(1.25))[()]],
                    "big": [2**64 - 1, -2**63, 2**32, 2**31, -2**31 - 1, -129, -33, -32, 127,
                            128, 255, 256, 65535, 65536],
                    "py": [True, False, None, 0.1, -1e300, 1 + 2j, "", "x" * 31, "y" * 32,
                           "é" * 200, b"", b"\x00" * 300, b"z" * 70000]},
        "nested": {"z": {"b": [[{"k": 1}], []], "a": {}}, "keys": {str(i): i for i in range(20)},
                   "long": list(range(70000))},
    }


def _as_bits(x):
    """Arrays (and bf16 tensors) as (dtype name, shape, bytes); containers
    recursively; other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return ("bfloat16", tuple(x.shape), x.view(torch.uint16).numpy().tobytes())
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        return (a.dtype.name, a.shape, a.tobytes())
    if isinstance(x, dict):
        return {k: _as_bits(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_as_bits(v) for v in x]
    return (type(x).__name__, x)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_decodes_flax_bytes_bit_for_bit(name):
    tree = _trees()[name]
    blob = flax_serialization.msgpack_serialize(tree)
    assert _as_bits(_msgpack.unpackb(blob)) == _as_bits(flax_serialization.msgpack_restore(blob))


@pytest.mark.parametrize("name", sorted(_trees()))
def test_encodes_flax_bytes(name):
    tree = _trees()[name]
    assert _msgpack.packb(tree) == flax_serialization.msgpack_serialize(tree)


def test_bf16_decodes_to_a_torch_bf16_tensor():
    arr = np.asarray(jnp.array([1.0, -2.5, 3e38], jnp.bfloat16))
    got = _msgpack.unpackb(flax_serialization.msgpack_serialize({"w": arr}))["w"]
    assert got.dtype == torch.bfloat16
    assert got.view(torch.uint16).numpy().tobytes() == arr.view(np.uint16).tobytes()
    # and a bf16 tensor encodes as flax encodes the bf16 array
    assert _msgpack.packb({"w": got}) == flax_serialization.msgpack_serialize({"w": arr})


def test_tuples_are_refused_like_flax():
    with pytest.raises(TypeError):
        flax_serialization.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(TypeError):
        _msgpack.packb({"t": (1, 2)})


@pytest.mark.parametrize("bf16", [False, True])
def test_chunked_arrays_both_ways(monkeypatch, bf16):
    """Arrays over MAX_CHUNK_SIZE split into flax's chunked form (shape and
    chunks as {"0": .., "1": ..} dicts): equal bytes, equal arrays."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    big = rng.standard_normal((7, 9)).astype(np.float32)
    if bf16:
        big = np.asarray(jnp.asarray(big, jnp.bfloat16))
    tree = {"big": big, "deep": {"also": np.arange(40, dtype=np.int16)},
            "small": np.arange(3, dtype=np.int32), "list": [np.arange(30, dtype=np.int32)]}
    blob = flax_serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert _msgpack.packb(tree) == blob
    got = _msgpack.unpackb(blob)
    assert _as_bits(got) == _as_bits(flax_serialization.msgpack_restore(blob))
    assert tuple(got["big"].shape) == (7, 9)


@pytest.fixture
def f32_nets(monkeypatch):
    """Both packages build their nets in float32 (module docstring)."""
    monkeypatch.setattr(jax_detector, "DetectorNet",
                        functools.partial(jax_detector.DetectorNet, dtype=jnp.float32))
    monkeypatch.setattr(jax_embedder, "FaceEmbedNet",
                        functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
    monkeypatch.setattr(port_embedder, "FaceEmbedNet",
                        functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))


@pytest.fixture(scope="module")
def jax_model_file(tmp_path_factory):
    """A JAX ``save_model`` CNN checkpoint from seeded init params, and the
    faces it embedded."""
    rng = np.random.default_rng(8)
    X = (rng.random((6, 40, 36)) * 255).astype(np.float32)  # resized to 32x32 on extract
    y = np.array([4, 4, 9, 9, 2, 2])
    model = jax_model.PredictableModel(jax_embedder.CNNEmbedding(**EMB),
                                       jax_classifier.NearestNeighbor(jax_distance.CosineDistance()))
    model.compute(X, y)
    path = str(tmp_path_factory.mktemp("model") / "cnn.ckpt")
    jax_serialization.save_model(path, model)
    return path, X


def test_port_reads_jax_model_checkpoint(jax_model_file, f32_nets):
    path, X = jax_model_file
    want = jax_serialization.load_model(path)
    got = port_serialization.load_model(path, device="cpu")
    assert isinstance(got.feature, port_embedder.CNNEmbedding)
    assert got.feature.get_config() == want.feature.get_config()
    assert _as_bits(got.get_state()) == _as_bits(jax.tree_util.tree_map(
        np.asarray, want.get_state()))
    np.testing.assert_allclose(got.feature.extract(X).numpy(),
                               np.asarray(want.feature.extract(X)), atol=2e-3)
    # a single sample embeds to one row
    np.testing.assert_allclose(got.feature.extract(X[0]).numpy(),
                               np.asarray(want.feature.extract(X[0])), atol=2e-3)


def test_jax_reads_port_written_checkpoint(jax_model_file, tmp_path, f32_nets):
    path, X = jax_model_file
    port_model = port_serialization.load_model(path, device="cpu")
    out = str(tmp_path / "port.ckpt")
    port_serialization.save_model(out, port_model)
    with open(path, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()  # the port writes flax's bytes
    back = jax_serialization.load_model(out)
    np.testing.assert_allclose(np.asarray(back.feature.extract(X)),
                               port_model.feature.extract(X).numpy(), atol=2e-3)


def test_tta_extract_matches_jax(jax_model_file, f32_nets):
    path, X = jax_model_file
    want = jax_serialization.load_model(path).feature
    got = port_serialization.load_model(path, device="cpu").feature
    want.tta = got.tta = True
    np.testing.assert_allclose(got.extract(X).numpy(), np.asarray(want.extract(X)), atol=2e-3)


@pytest.mark.parametrize("cut", [0, 1, 10, 0.5, -1])
def test_truncated_or_garbage_file_raises_corrupt(jax_model_file, tmp_path, cut):
    path, _X = jax_model_file
    blob = open(path, "rb").read()
    n = int(len(blob) * cut) if isinstance(cut, float) else cut % len(blob)
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(blob[:n])
    with pytest.raises(port_serialization.CheckpointCorruptError):
        port_serialization.load_model(str(bad), device="cpu")
    bad.write_bytes(b"\xc1garbage" + blob[:n])
    with pytest.raises(port_serialization.CheckpointCorruptError):
        port_serialization.load_model(str(bad), device="cpu")


def test_header_errors_match_the_reference(tmp_path):
    no_header = tmp_path / "nh.ckpt"
    no_header.write_bytes(_msgpack.packb({"state": {}}))
    for load in (jax_serialization.load_model,
                 functools.partial(port_serialization.load_model, device="cpu")):
        with pytest.raises(jax_serialization.CheckpointCorruptError if load is
                           jax_serialization.load_model
                           else port_serialization.CheckpointCorruptError, match="no header"):
            load(str(no_header))
    newer = tmp_path / "newer.ckpt"
    newer.write_bytes(_msgpack.packb({"header": {"format_version": 2, "spec_json": "{}"}}))
    with pytest.raises(ValueError, match="newer than supported"):
        port_serialization.load_model(str(newer), device="cpu")


def test_unported_plugins_are_refused_by_name(tmp_path):
    """Since ROADMAP A.12 every plugin of the reference is registered: a
    classic checkpoint (PCA, once refused by name) loads and predicts as
    the reference's; only a type neither package knows is refused."""
    from opencv_facerecognizer_tpu.models.feature import PCA

    model = jax_model.PredictableModel(PCA(num_components=2), jax_classifier.NearestNeighbor())
    X = np.random.default_rng(0).random((4, 3, 3)).astype(np.float32)
    model.compute(X, np.array([0, 0, 1, 1]))
    path = str(tmp_path / "pca.ckpt")
    jax_serialization.save_model(path, model)
    got = port_serialization.load_model(path, device="cpu")
    np.testing.assert_array_equal(got.predict(X)[0], np.asarray(model.predict(X)[0]))
    assert port_distance.distance_from_spec({"type": "chi_square", "config": {}}).name == "chi_square"
    assert sorted(port_serialization._registry()) == sorted(jax_serialization._registry())
    with pytest.raises(KeyError, match="unknown plugin type 'mystery'"):
        port_serialization.deserialize_spec({"type": "mystery", "config": {}}, device="cpu")
    with pytest.raises(KeyError, match="unknown distance 'mystery'"):
        port_distance.distance_from_spec({"type": "mystery", "config": {}})


def test_training_and_other_embedder_variants_are_refused():
    """Kept under its name from when training was refused: ``compute`` with ``train_steps > 0``
    trains every variant (A.9, A.13), and its state is the reference's
    layout; extracting before ``compute`` still raises."""
    X = np.random.default_rng(2).standard_normal((4, 32, 32)).astype(np.float32)
    for kw in ({}, dict(block="dense"), dict(norm="light"), dict(space_to_depth=2)):
        emb = port_embedder.CNNEmbedding(**dict(EMB, train_steps=2), **kw, device="cpu")
        before = emb.net.stem.weight.detach().clone()
        assert emb.compute(X, [3, 3, 8, 8]).shape[0] == 4
        assert not torch.equal(emb.net.stem.weight.detach(), before), kw
        assert emb.get_state()["head"].shape == (2, EMB["embed_dim"])
    with pytest.raises(RuntimeError, match="before compute"):
        port_embedder.CNNEmbedding(**EMB, device="cpu").extract(np.zeros((32, 32)))


def test_from_config_defaults_for_old_checkpoints():
    cfg = dict(embed_dim=16, stem_features=8, stage_features=[8, 8], stage_blocks=[1, 1],
               train_steps=0, batch_size=4, learning_rate=0.1, seed=3)
    want = jax_embedder.CNNEmbedding.from_config(cfg).get_config()
    assert port_embedder.CNNEmbedding.from_config(cfg, device="cpu").get_config() == want


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("k", [1, 3])
def test_nearest_neighbor_predict_matches_jax(dist, k):
    """Votes, ties to the lowest row and to the nearest neighbour's class,
    the reference's return shapes (gallery rows duplicated: exact ties)."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    g = np.concatenate([g, g])
    y = np.array([7, 3, 3, 5, 7, 5, 3, 7, 5, 5, 3, 7])
    q = np.concatenate([g[:4], rng.standard_normal((5, 5)).astype(np.float32)])
    jd = jax_distance.DISTANCES[dist]()
    want = jax_classifier.NearestNeighbor(jd, k=k)
    want.compute(g, y)
    got = port_classifier.NearestNeighbor(port_distance.DISTANCES[dist](), k=k, device="cpu")
    got.compute(g, y)
    wl, wi = want.predict(q)
    gl, gi = got.predict(q)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gi["labels"], wi["labels"])
    # euclidean at a duplicate row is sqrt of f32 cancellation noise (~1e-6
    # of |p|^2 + |q|^2): up to ~1e-3 either way; elsewhere both agree to f32
    np.testing.assert_allclose(gi["distances"], wi["distances"],
                               atol=2e-3 if dist == "euclidean" else 1e-5)
    w1, g1 = want.predict(q[0]), got.predict(q[0])
    assert g1[0] == w1[0] and list(g1[1]["labels"]) == list(w1[1]["labels"])
    np.testing.assert_allclose(np.asarray(port_distance.DISTANCES[dist]()(q[0], g[1])),
                               np.asarray(jd(q[0], g[1])), atol=1e-5)


@pytest.fixture(scope="module")
def jax_detector_file(tmp_path_factory):
    det = jax_detector.CNNFaceDetector(**DET)
    params = jax.tree_util.tree_map(np.asarray, det.net.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 64)))["params"])
    params["Conv_5"]["bias"] = np.zeros_like(params["Conv_5"]["bias"])  # heatmap: faces
    params["Conv_6"]["bias"] = np.full_like(params["Conv_6"]["bias"], 3.0)  # size
    det.load_params(params)
    path = str(tmp_path_factory.mktemp("det") / "det.ckpt")
    det.save(path)
    return path, params


def test_detector_checkpoint_crosses_both_ways(jax_detector_file, tmp_path, f32_nets):
    path, params = jax_detector_file
    port = port_detector.CNNFaceDetector.load(path, device="cpu")
    assert (port.max_faces, port.net.features, port.net.space_to_depth) == (4, (8, 16), 2)
    out = str(tmp_path / "port_det.ckpt")
    port.save(out)
    with open(path, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    back = jax_detector.CNNFaceDetector.load(out)
    assert _as_bits(jax.tree_util.tree_map(np.asarray, back.params)) == _as_bits(params)
    # detect_batch on frames whose size is not a multiple of the stride
    port = port_detector.CNNFaceDetector.load(path, device="cpu")
    port.net.dtype = torch.float32  # the checkpoint's f32 params, computed in f32
    images = (np.random.default_rng(6).random((3, 61, 70)) * 255).astype(np.float32)
    wb, ws, wv = (np.asarray(v) for v in back.detect_batch(images))
    gb, gs, gv = (t.numpy() for t in port.detect_batch(images))
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() >= 3
    np.testing.assert_allclose(gb, wb, atol=1e-3)
    np.testing.assert_allclose(gs, ws, atol=1e-5)


def test_bfloat16_scalar_stays_a_tensor():
    blob = flax_serialization.msgpack_serialize({"s": np.asarray(jnp.bfloat16(2.5))[()]})
    got = _msgpack.unpackb(blob)["s"]
    assert isinstance(got, torch.Tensor) and got.shape == () and float(got) == 2.5
    assert ml_dtypes.bfloat16(2.5) == flax_serialization.msgpack_restore(blob)["s"]
