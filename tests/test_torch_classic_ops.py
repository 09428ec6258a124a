"""The classic ops of the PyTorch port (ROADMAP A.12) against the JAX
package, on the same seeded numpy inputs:

- ``ops/lbp.py``: the codes of the three operators bit for bit (the same
  static bilinear weights, summed in the same order, compared with
  ``>=``); VAR within 1e-6 relative;
- ``ops/histogram.py``: spatial histograms bit for bit (integer counts by
  scatter-add instead of a one-hot sum);
- ``ops/distance.py``: every distance within 1e-5 relative to the block's
  largest value (float32 sums in another order), and a chunked call equal
  to an unchunked one bit for bit;
- ``ops/image.py``: equalization equal, min/max normalization within an
  ulp, ``gaussian_blur`` within 1e-4 relative, ``tan_triggs`` within 1e-3
  of its scale tau. Tan-Triggs divides by mean(|DoG|^0.1)^10 twice, so
  the float32 roundoff of the two means (summed in other orders by XLA
  and torch; XLA's ``pow`` is not torch's either) comes back tenfold,
  twice: 2.4e-4 to 5.3e-4 of the scale on face-like inputs here, in
  either package against the other (and against a float64 evaluation);
- ``ops/linalg.py``: PCA and LDA subspaces by projector distance below
  1e-3 on the well-separated components (eigenvectors are defined up to
  sign and rotation within a degenerate eigenspace), eigenvalues within
  1e-4 relative.
"""

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.ops import distance as jax_distance
from opencv_facerecognizer_tpu.ops import histogram as jax_histogram
from opencv_facerecognizer_tpu.ops import image as jax_image
from opencv_facerecognizer_tpu.ops import lbp as jax_lbp
from opencv_facerecognizer_tpu.ops import linalg as jax_linalg
from opencv_facerecognizer_tpu.utils.dataset import make_synthetic_faces
from opencv_facerecognizer_tpu_torch.ops import distance as port_distance
from opencv_facerecognizer_tpu_torch.ops import histogram as port_histogram
from opencv_facerecognizer_tpu_torch.ops import image as port_image
from opencv_facerecognizer_tpu_torch.ops import lbp as port_lbp
from opencv_facerecognizer_tpu_torch.ops import linalg as port_linalg

DIST_RTOL = 1e-5
PROJ_TOL = 1e-3


def _images(n=5, h=40, w=36, seed=0):
    return (np.random.default_rng(seed).random((n, h, w)) * 255).astype(np.float32)


def _faces():
    X, _y, _names = make_synthetic_faces(6, 3, (56, 56), seed=2, illumination=0.7, noise=14.0)
    return X


@pytest.mark.parametrize("radius, neighbors", [(1, 8), (2, 8), (3, 8), (2, 12), (1, 4)])
def test_extended_lbp_codes_equal_bit_for_bit(radius, neighbors):
    x = _images()
    want = np.asarray(jax_lbp.extended_lbp(x, radius, neighbors))
    got = port_lbp.extended_lbp(torch.tensor(x), radius, neighbors).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_lbp_operators_equal_bit_for_bit_on_faces():
    x = _faces()
    np.testing.assert_array_equal(port_lbp.original_lbp(torch.tensor(x)).numpy(),
                                  np.asarray(jax_lbp.original_lbp(x)))
    for op in ("ExtendedLBP", "VarLBP"):
        for kw in (dict(radius=2), dict(radius=3, neighbors=8)):
            want = np.asarray(getattr(jax_lbp, op)(**kw)(x))
            got = getattr(port_lbp, op)(**kw)(torch.tensor(x)).numpy()
            np.testing.assert_array_equal(got, want)
    v_want = np.asarray(jax_lbp.var_lbp(x, 2, 8))
    v_got = port_lbp.var_lbp(torch.tensor(x), 2, 8).numpy()
    np.testing.assert_allclose(v_got, v_want, rtol=1e-6, atol=1e-6 * np.abs(v_want).max())


def test_lbp_operator_registry_and_configs_match():
    assert sorted(port_lbp.LBP_OPERATORS) == sorted(jax_lbp.LBP_OPERATORS)
    for name, cls in jax_lbp.LBP_OPERATORS.items():
        op = cls()
        port_op = port_lbp.LBP_OPERATORS[name].from_config(op.get_config())
        assert port_op.get_config() == op.get_config()
        assert port_op.num_bins == op.num_bins
        assert repr(port_op) == repr(op)
    with pytest.raises(ValueError, match="31 neighbors"):
        port_lbp.extended_lbp(torch.zeros(1, 8, 8), 1, 32)


@pytest.mark.parametrize("grid, radius", [((8, 8), 2), ((6, 6), 3), ((5, 7), 1)])
@pytest.mark.parametrize("normalize", [True, False])
def test_spatial_histogram_equal_bit_for_bit(grid, radius, normalize):
    codes = np.asarray(jax_lbp.extended_lbp(_faces(), radius, 8))
    want = np.asarray(jax_histogram.spatial_histogram(codes, grid, 256, normalize))
    got = port_histogram.spatial_histogram(torch.tensor(codes), grid, 256, normalize).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_spatial_histogram_batches_and_drops_out_of_range_codes():
    codes = np.random.default_rng(1).integers(-3, 20, (2, 3, 12, 12)).astype(np.int32)
    want = np.asarray(jax_histogram.spatial_histogram(codes, (3, 3), 16))
    got = port_histogram.spatial_histogram(torch.tensor(codes), (3, 3), 16).numpy()
    assert got.shape == (2, 3, 9 * 16)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="smaller than grid"):
        port_histogram.spatial_histogram(torch.zeros(4, 4, dtype=torch.int32), (8, 8))


def _hist_pair(q=7, g=9, d=50, seed=3):
    rng = np.random.default_rng(seed)
    p = rng.random((q, d)).astype(np.float32)
    h = rng.random((g, d)).astype(np.float32)
    h[0, :5] = 0.0  # empty bins: the eps guards
    p[1, :5] = 0.0
    return p / p.sum(1, keepdims=True), h / h.sum(1, keepdims=True)


@pytest.mark.parametrize("name", sorted(jax_distance.DISTANCES))
def test_distances_match_within_1e5(name):
    p, q = _hist_pair()
    want = np.asarray(jax_distance.DISTANCES[name]()(p, q))
    got = port_distance.DISTANCES[name]()(torch.tensor(p), torch.tensor(q)).numpy()
    assert got.shape == want.shape == (7, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=DIST_RTOL * np.abs(want).max())
    # two single vectors -> a scalar, as the reference's contract
    one = port_distance.DISTANCES[name]()(torch.tensor(p[0]), torch.tensor(q[1]))
    assert one.ndim == 0
    np.testing.assert_allclose(float(one), float(want[0, 1]), atol=DIST_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["chi_square", "histogram_intersection", "bin_ratio",
                                  "l1_bin_ratio", "chi_square_bin_ratio", "manhattan"])
def test_chunked_distance_equals_unchunked(name, monkeypatch):
    p, q = _hist_pair(q=23, g=11)
    fn = getattr(port_distance, name)
    whole = fn(torch.tensor(p), torch.tensor(q))
    for rows in (1, 4, 7):
        monkeypatch.setattr(port_distance, "PAIRWISE_BYTES", rows * 11 * 50 * 4 * 7)
        assert torch.equal(fn(torch.tensor(p), torch.tensor(q)), whole)
    monkeypatch.setattr(port_distance, "PAIRWISE_BYTES", 100)
    with pytest.raises(MemoryError, match="exceeds the budget"):
        fn(torch.tensor(p), torch.tensor(q))


def test_distance_registry_matches_and_refuses_only_unknown_names():
    assert sorted(port_distance.DISTANCES) == sorted(jax_distance.DISTANCES)
    for name in jax_distance.DISTANCES:
        got = port_distance.distance_from_spec({"type": name, "config": {}})
        assert got.name == name and repr(got) == repr(jax_distance.DISTANCES[name]())
    with pytest.raises(KeyError, match="unknown distance 'mystery'"):
        port_distance.distance_from_spec({"type": "mystery", "config": {}})


def test_equalization_equal_and_minmax_within_an_ulp():
    x = _images(seed=4)
    for kw in ({}, {"num_bins": 64}):
        np.testing.assert_array_equal(port_image.histogram_equalize(torch.tensor(x), **kw).numpy(),
                                      np.asarray(jax_image.histogram_equalize(x, **kw)))
    for low, high in ((0.0, 1.0), (-1.0, 2.0)):
        want = np.asarray(jax_image.minmax_normalize(x, low, high))
        got = port_image.minmax_normalize(torch.tensor(x), low, high).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * (high - low))


@pytest.mark.parametrize("sigma", [1.0, 2.0, 4.0, 0.3])
def test_gaussian_blur_within_1e4(sigma):
    x = _faces()
    want = np.asarray(jax_image.gaussian_blur(x, sigma))
    got = port_image.gaussian_blur(torch.tensor(x), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("sigmas", [(1.0, 2.0), (2.0, 4.0)])
def test_tan_triggs_within_its_scale(sigmas):
    x = _faces()
    want = np.asarray(jax_image.tan_triggs(x, sigma0=sigmas[0], sigma1=sigmas[1]))
    got = port_image.tan_triggs(torch.tensor(x), sigma0=sigmas[0], sigma1=sigmas[1]).numpy()
    assert np.abs(want).max() <= 10.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * 10.0)


def test_grayscale_and_crop_match():
    rgb = (np.random.default_rng(5).random((3, 8, 9, 3)) * 255).astype(np.float32)
    for order in ("rgb", "bgr"):
        np.testing.assert_allclose(port_image.to_grayscale(torch.tensor(rgb), order).numpy(),
                                   np.asarray(jax_image.to_grayscale(rgb, order)), atol=1e-4)
    frame = _images(1, 50, 60)[0]
    want = np.asarray(jax_image.crop_and_resize(frame, (5, 7, 35, 47), (16, 16)))
    got = port_image.crop_and_resize(torch.tensor(frame), (5, 7, 35, 47), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def _projector(components, k):
    u = np.asarray(components)[:, :k]
    q, _ = np.linalg.qr(u)
    return q @ q.T


@pytest.mark.parametrize("n, d", [(30, 200), (40, 12)])  # Gram trick and covariance path
def test_pca_subspace_and_projection_match(n, d):
    x = np.random.default_rng(6).normal(size=(n, d)).astype(np.float32)
    x[:, :3] *= np.array([9.0, 6.0, 4.0], np.float32)  # well-separated leading components
    k = 3
    want = jax_linalg.pca_fit(x, 8)
    got = port_linalg.pca_fit(torch.tensor(x), 8)
    assert np.abs(_projector(got.components, k) - _projector(want.components, k)).max() < PROJ_TOL
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues), rtol=1e-4,
                               atol=1e-4 * float(want.eigenvalues[0]))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-5)
    z = port_linalg.pca_project(got, torch.tensor(x))
    back = port_linalg.pca_reconstruct(got, z)
    assert back.shape == (n, d)
    with pytest.raises(ValueError, match="num_components"):
        port_linalg.pca_fit(torch.tensor(x), 0)


def test_lda_subspace_matches():
    rng = np.random.default_rng(7)
    c, per, d = 4, 12, 10
    centers = rng.normal(size=(c, d)) * np.array([6.0, 4.0, 2.5] + [0.2] * (d - 3))
    y = np.repeat(np.arange(c), per)
    x = (centers[y] + rng.normal(size=(c * per, d))).astype(np.float32)
    want = jax_linalg.lda_fit(x, y, c, c - 1)
    got = port_linalg.lda_fit(torch.tensor(x), torch.tensor(y), c, c - 1)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues), rtol=1e-4)
    assert np.abs(_projector(got.components, c - 1)
                  - _projector(want.components, c - 1)).max() < PROJ_TOL
    np.testing.assert_allclose(np.abs(port_linalg.lda_project(got, torch.tensor(x)).numpy()),
                               np.abs(np.asarray(jax_linalg.lda_project(want, x))), atol=1e-3)
    with pytest.raises(ValueError, match="num_classes-1"):
        port_linalg.lda_fit(torch.tensor(x), torch.tensor(y), c, c)


def test_ops_take_numpy_arrays():
    """The port's ops take numpy arrays as well as tensors."""
    x = _images(2)
    assert torch.equal(port_lbp.extended_lbp(x, 1), port_lbp.extended_lbp(torch.tensor(x), 1))
    assert torch.equal(port_image.gaussian_blur(x, 1.0),
                       port_image.gaussian_blur(torch.tensor(x), 1.0))
