"""The classic models of the PyTorch port (ROADMAP A.12) against the JAX
package: the features and preprocessing plugins, the operators, the SVMs,
and their checkpoints in both directions.

Tolerances: the subspace features by projector distance below 1e-3 on
the well-separated components (eigenvectors are defined up to sign and
rotation); the LBP histograms bit for bit; the preprocessing as in
``tests/test_torch_classic_ops.py``. The SVMs' trained parameters within
``SVM_ATOL`` of optax's after all their epochs (300, 400), and their
predictions equal. Both start from zero weights, where every wrong class
ties in the hinge's max and the subgradient is split as JAX splits it
(``test_hinge_splits_ties_as_jax``). The data has unequal class counts:
with equal counts the bias's first gradient is exactly 0 in exact
arithmetic, so both packages' first Adam step moves the bias by +-lr
times the sign of their float32 roundoff, and the two trainings part
(``test_balanced_classes_make_the_first_bias_step_roundoff``). A
checkpoint written by either package loads in the other and predicts the
same labels on the same queries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import classifier as jax_classifier
from opencv_facerecognizer_tpu.models import feature as jax_feature
from opencv_facerecognizer_tpu.models import model as jax_model
from opencv_facerecognizer_tpu.models import operators as jax_operators
from opencv_facerecognizer_tpu.ops import distance as jax_distance
from opencv_facerecognizer_tpu.ops import lbp as jax_lbp
from opencv_facerecognizer_tpu.utils import serialization as jax_serialization
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_faces
from opencv_facerecognizer_tpu_torch.models import classifier as port_classifier
from opencv_facerecognizer_tpu_torch.models import feature as port_feature
from opencv_facerecognizer_tpu_torch.models import operators as port_operators
from opencv_facerecognizer_tpu_torch.utils import serialization as port_serialization

PROJ_TOL = 1e-3
SVM_ATOL = 1e-4


def _projector(components, k):
    q, _ = np.linalg.qr(np.asarray(components)[:, :k])
    return q @ q.T


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def faces():
    X, y, _names = make_synthetic_faces(6, 5, (32, 32), seed=41)
    return X, y


def test_pca_and_lda_features_match(faces):
    X, y = faces
    for name, k in (("PCA", 4), ("LDA", 3)):
        jf = getattr(jax_feature, name)(k)
        pf = getattr(port_feature, name)(k, device="cpu")
        data = X if name == "PCA" else np.asarray(jax_feature.PCA(12).compute(X, y))
        jz, pz = np.asarray(jf.compute(data, y)), _np(pf.compute(data, y))
        assert jz.shape == pz.shape
        jc = np.asarray(jf.get_state()["components"])
        pc = pf.get_state()["components"]
        assert pc.dtype == np.float32 and pc.shape == jc.shape
        assert np.abs(_projector(pc, k) - _projector(jc, k)).max() < PROJ_TOL
        # single sample and batch extract shapes, as the reference's
        assert tuple(pf.extract(data[0]).shape) == tuple(np.shape(jf.extract(data[0])))
        assert tuple(pf.extract(data[:3]).shape) == tuple(np.shape(jf.extract(data[:3])))
    with pytest.raises(RuntimeError, match="before compute"):
        port_feature.PCA(device="cpu").extract(X[0])


def test_fisherfaces_subspace_and_projection_match(faces):
    X, y = faces
    jf, pf = jax_feature.Fisherfaces(), port_feature.Fisherfaces(device="cpu")
    jz, pz = np.asarray(jf.compute(X, y)), _np(pf.compute(X, y))
    c = len(np.unique(y))
    assert pz.shape == jz.shape == (len(y), c - 1)
    k = 2  # the well-separated leading Fisher directions
    assert np.abs(_projector(_np(pf.eigenvectors), k)
                  - _projector(np.asarray(jf.eigenvectors), k)).max() < PROJ_TOL
    np.testing.assert_allclose(_np(pf.eigenvalues)[:k], np.asarray(jf.eigenvalues)[:k],
                               rtol=1e-3)
    assert sorted(pf.get_state()) == sorted(jf.get_state())


def test_spatial_histogram_and_preprocessing_plugins_match(faces):
    X, y = faces
    cases = [
        ("SpatialHistogram", dict(lbp_operator=None, sz=(4, 4)), 0.0),
        ("TanTriggsPreprocessing", dict(sigma0=2.0, sigma1=4.0), 1e-2),
        ("HistogramEqualization", dict(num_bins=64), 0.0),
        ("Resize", dict(size=(20, 24)), 1e-3),
        ("MinMaxNormalize", dict(low=-1.0, high=1.0), 1e-6),
        ("Identity", {}, 0.0),
    ]
    for name, kw, atol in cases:
        jf = getattr(jax_feature, name)(**kw)
        pf = getattr(port_feature, name)(**kw, device="cpu")
        assert pf.get_config() == jf.get_config(), name
        assert repr(pf) == repr(jf), name
        np.testing.assert_allclose(_np(pf.compute(X, y)), np.asarray(jf.compute(X, y)),
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(_np(pf.extract(X[0])), np.asarray(jf.extract(X[0])),
                                   rtol=0, atol=atol, err_msg=name)
    var = dict(lbp_operator=jax_lbp.VarLBP(radius=2), sz=(3, 3))
    jf = jax_feature.SpatialHistogram(**var)
    pf = port_feature.SpatialHistogram.from_config(jf.get_config(), device="cpu")
    np.testing.assert_array_equal(_np(pf.compute(X, y)), np.asarray(jf.compute(X, y)))


def test_operators_match(faces):
    X, y = faces
    jpca, ppca = jax_feature.PCA(3), port_feature.PCA(3, device="cpu")
    cases = [
        (jax_operators.ChainOperator(jax_feature.TanTriggsPreprocessing(), jax_feature.Identity()),
         port_operators.ChainOperator(port_feature.TanTriggsPreprocessing(device="cpu"),
                                      port_feature.Identity(device="cpu"))),
        (jax_operators.CombineOperator(jax_feature.Identity(), jax_feature.MinMaxNormalize()),
         port_operators.CombineOperator(port_feature.Identity(device="cpu"),
                                        port_feature.MinMaxNormalize(device="cpu"))),
        (jax_operators.CombineOperatorND(jax_feature.HistogramEqualization(),
                                         jax_feature.MinMaxNormalize(), hstack_axis=0),
         port_operators.CombineOperatorND(port_feature.HistogramEqualization(device="cpu"),
                                          port_feature.MinMaxNormalize(device="cpu"),
                                          hstack_axis=0)),
        (jax_operators.CombineOperatorND(jax_feature.MinMaxNormalize(),
                                         jax_feature.MinMaxNormalize()),
         port_operators.CombineOperatorND(port_feature.MinMaxNormalize(device="cpu"),
                                          port_feature.MinMaxNormalize(device="cpu"))),
    ]
    for jop, pop in cases:
        assert repr(pop) == repr(jop)
        for fn, arg in (("compute", (X, y)), ("extract", (X[:3],)), ("extract", (X[0],))):
            want = np.asarray(getattr(jop, fn)(*arg))
            got = _np(getattr(pop, fn)(*arg))
            assert got.shape == want.shape, (type(jop).__name__, fn)
            np.testing.assert_allclose(got, want, atol=1e-2)
    chain_j = jax_operators.ChainOperator(jpca, jax_feature.LDA())
    chain_p = port_operators.ChainOperator(ppca, port_feature.LDA(device="cpu"))
    assert chain_p.compute(X, y).shape == np.shape(chain_j.compute(X, y))
    assert tuple(chain_p.extract(X[0]).shape) == np.shape(chain_j.extract(X[0]))


def _svm_data(seed=0, d=20):
    rng = np.random.default_rng(seed)
    counts = [7, 8, 9, 10, 11, 12]
    y = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
    centers = rng.normal(size=(len(counts), d))
    return (rng.normal(size=(len(y), d)) + centers[y]).astype(np.float32), y * 3 + 1


def test_svm_trains_to_optax_params():
    X, y = _svm_data()
    want, got = jax_classifier.SVM(), port_classifier.SVM(device="cpu")
    want.compute(X, y)
    got.compute(X, y)
    ws, gs = want.get_state(), got.get_state()
    assert sorted(gs) == sorted(ws)
    for key in ("w", "b", "feat_mean", "feat_scale"):
        np.testing.assert_allclose(gs[key], np.asarray(ws[key]), rtol=0, atol=SVM_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got.predict(X)[0], want.predict(X)[0])
    q = X[:5] + 0.3
    np.testing.assert_allclose(got.predict(q)[1]["logits"], want.predict(q)[1]["logits"],
                               atol=10 * SVM_ATOL)
    label, info = got.predict(X[3])
    assert label == want.predict(X[3])[0] and info["logits"].shape == (6,)


@pytest.mark.parametrize("kernel", ["rbf", "poly", "linear"])
def test_kernel_svm_trains_to_optax_params(kernel):
    X, y = _svm_data(seed=1, d=8)
    kw = dict(kernel=kernel, gamma=None if kernel != "poly" else 0.05)
    want, got = jax_classifier.KernelSVM(**kw), port_classifier.KernelSVM(**kw, device="cpu")
    want.compute(X, y)
    got.compute(X, y)
    ws, gs = want.get_state(), got.get_state()
    assert sorted(gs) == sorted(ws)
    np.testing.assert_allclose(float(gs["gamma_eff"]), float(ws["gamma_eff"]), rtol=1e-6)
    scale = max(1.0, float(np.abs(np.asarray(ws["alpha"])).max()))
    for key in ("alpha", "b"):
        np.testing.assert_allclose(gs[key], np.asarray(ws[key]), rtol=0, atol=SVM_ATOL * scale,
                                   err_msg=key)
    np.testing.assert_array_equal(got.predict(X)[0], want.predict(X)[0])


@pytest.mark.parametrize("kind", ["linear", "poly", "rbf"])
def test_kernel_matrix_matches(kind):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(4, 7)).astype(np.float32)
    want = np.asarray(jax_classifier._kernel_matrix(kind, 0.3, 1.0, 3, a, b))
    got = port_classifier._kernel_matrix(kind, 0.3, 1.0, 3, torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown kernel"):
        port_classifier._kernel_matrix("sigmoid", 0.3, 1.0, 3, torch.tensor(a), torch.tensor(b))


def test_hinge_splits_ties_as_jax():
    """Zero weights: every wrong class ties in the max. ``jnp.max`` splits
    the subgradient evenly over them (``torch.amax`` does too, where
    ``Tensor.max(dim)`` would give it all to one), and ``jnp.maximum``
    at 0 halves it (as ``torch.maximum``; ``clamp`` would pass it whole)."""
    y = np.array([0, 1, 2, 3, 1])
    onehot = np.eye(4, dtype=np.float32)[y]
    for logits in (np.zeros((5, 4), np.float32),
                   np.array([[0.0, -1.0, 0.0, 0.0]] * 5, np.float32)):
        want = np.asarray(jax.grad(lambda lg: jax_classifier._crammer_singer_hinge(
            lg, jnp.asarray(onehot)).sum())(jnp.asarray(logits)))
        t = torch.tensor(logits, requires_grad=True)
        port_classifier._crammer_singer_hinge(t, torch.tensor(onehot)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-7)
    np.testing.assert_allclose(want[0], [-1.0, 0.0, 0.5, 0.5], atol=1e-7)
    # the margin tie: logits giving 1 + wrong - correct == 0 exactly
    tied = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    t = torch.tensor(tied, requires_grad=True)
    port_classifier._crammer_singer_hinge(t, torch.tensor(np.eye(4, dtype=np.float32)[[0]])).sum(
    ).backward()
    want = np.asarray(jax.grad(lambda lg: jax_classifier._crammer_singer_hinge(
        lg, jnp.asarray(np.eye(4, dtype=np.float32)[[0]])).sum())(jnp.asarray(tied)))
    np.testing.assert_allclose(t.grad.numpy(), want, atol=1e-7)
    assert want[0, 0] == -0.5


def test_balanced_classes_make_the_first_bias_step_roundoff():
    """With equal class counts the bias's exact first gradient is 0: what
    either package computes is float32 roundoff (here below 1e-7), which
    Adam's first step scales to a move of up to lr. So the trainings are
    compared on unequal counts (module docstring)."""
    rng = np.random.default_rng(0)
    y = np.repeat(np.arange(6), 10)
    X = (rng.normal(size=(60, 20)) + rng.normal(size=(6, 20))[y]).astype(np.float32)
    xs = (X - X.mean(0)) / X.std(0)
    onehot = np.eye(6, dtype=np.float32)[y]
    p = {"w": jnp.zeros((20, 6)), "b": jnp.zeros(6)}
    g = jax.grad(lambda p: jnp.mean(jax_classifier._crammer_singer_hinge(
        jnp.asarray(xs) @ p["w"] + p["b"], jnp.asarray(onehot))))(p)
    assert np.abs(np.asarray(g["b"])).max() < 1e-7
    assert np.abs(np.asarray(g["w"])).max() > 1e-3


def test_classifiers_registry_configs_and_refusals():
    assert sorted(port_classifier.CLASSIFIERS) == sorted(jax_classifier.CLASSIFIERS)
    for name in ("svm", "kernel_svm"):
        jc = jax_classifier.CLASSIFIERS[name]()
        pc = port_classifier.CLASSIFIERS[name].from_config(jc.get_config(), device="cpu")
        assert pc.get_config() == jc.get_config()
        with pytest.raises(RuntimeError, match="before compute"):
            pc.predict(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="unknown kernel"):
        port_classifier.KernelSVM(kernel="sigmoid", device="cpu")
    with pytest.raises(TypeError, match="integers"):
        port_classifier.SVM(device="cpu").compute(np.zeros((2, 3)), np.array(["a", "b"]))


def _jax_models():
    """(name, JAX model) of every classic plugin kind and operator."""
    J, C, O, D = jax_feature, jax_classifier, jax_operators, jax_distance
    return [
        ("fisherfaces", J.Fisherfaces(), C.NearestNeighbor(D.EuclideanDistance())),
        ("tan_triggs_fisherfaces", O.ChainOperator(J.TanTriggsPreprocessing(sigma0=2.0, sigma1=4.0),
                                                   J.Fisherfaces()),
         C.NearestNeighbor(D.EuclideanDistance())),
        ("eigenfaces_k3", J.PCA(5), C.NearestNeighbor(D.EuclideanDistance(), k=3)),
        ("lbph", J.SpatialHistogram(jax_lbp.ExtendedLBP(radius=2), sz=(4, 4)),
         C.NearestNeighbor(D.ChiSquareDistance())),
        ("lbp_fisherfaces", O.ChainOperator(J.SpatialHistogram(jax_lbp.ExtendedLBP(radius=3),
                                                               sz=(3, 3)), J.Fisherfaces()),
         C.NearestNeighbor(D.CosineDistance())),
        ("lda_svm", O.ChainOperator(J.PCA(12), J.LDA()), C.SVM(epochs=40)),
        ("pca_kernel_svm", J.PCA(8), C.KernelSVM(epochs=40)),
        ("combine", O.CombineOperator(J.PCA(3), O.ChainOperator(J.Resize((8, 8)),
                                                                J.Identity())),
         C.NearestNeighbor(D.ManhattanDistance())),
        ("combine_nd", O.CombineOperatorND(J.MinMaxNormalize(), J.HistogramEqualization(),
                                           hstack_axis=0),
         C.NearestNeighbor(D.HistogramIntersection())),
        ("var_lbp", J.SpatialHistogram(jax_lbp.VarLBP(radius=1), sz=(2, 2)),
         C.NearestNeighbor(D.BinRatioDistance())),
    ]


@pytest.mark.parametrize("name", [m[0] for m in _jax_models()])
def test_classic_checkpoints_load_both_ways(name, faces, tmp_path):
    """JAX computes and saves; the port loads it (the same spec and state
    bit for bit), predicts the same labels and writes flax's bytes back.
    Then the port computes its own and saves; JAX loads that and predicts
    the port's labels."""
    X, y = faces
    _n, feat, clf = next(m for m in _jax_models() if m[0] == name)
    queries = X[::3] + np.float32(2.0)
    jm = jax_model.ExtendedPredictableModel(feat, clf, image_size=(32, 32),
                                            subject_names=[f"s{i}" for i in range(6)])
    jm.compute(X, y)
    path = str(tmp_path / "jax.ckpt")
    jax_serialization.save_model(path, jm)
    pm = port_serialization.load_model(path, device="cpu")
    assert pm.get_config() == jm.get_config()
    assert pm.subject_names == jm.subject_names
    np.testing.assert_array_equal(pm.predict(queries)[0], np.asarray(jm.predict(queries)[0]))
    back = str(tmp_path / "back.ckpt")
    port_serialization.save_model(back, pm)
    assert open(back, "rb").read() == open(path, "rb").read()
    # the port's own fit, read by JAX
    fresh = port_serialization.deserialize_spec(port_serialization.serialize_spec(pm), "cpu")
    fresh.compute(X, y)
    out = str(tmp_path / "port.ckpt")
    port_serialization.save_model(out, fresh)
    jback = jax_serialization.load_model(out)
    np.testing.assert_array_equal(np.asarray(jback.predict(queries)[0]),
                                  fresh.predict(queries)[0])
