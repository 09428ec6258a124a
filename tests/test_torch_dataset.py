"""The port's gallery-directory reader (``utils/dataset.py``, on its own
ctypes binding of ``native/ocvf_loader.cpp``) against the JAX package's
``read_images``: the same tree gives equal images (bit for bit: the same
C++ loader, the same cv2/PIL calls), labels and names, with and without
``image_size``; unreadable files are skipped; an empty subject directory
shifts no label. Where cv2 and PIL are missing, the native formats still
load and any other format is skipped."""

import os
import sys

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.utils import dataset as jax_dataset
from opencv_facerecognizer_tpu_torch.ops import image as port_image
from opencv_facerecognizer_tpu_torch.utils import dataset as port_dataset
from opencv_facerecognizer_tpu_torch.utils import native as port_native


def _write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode() + img.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    layout = {"alice": ["a.pgm", "b.png", "c.pgm"], "bob": ["x.png", "y.pgm"],
              "carol_empty": [], "dave_unreadable": ["bad.png"], "erin": ["z.pgm", "w.png"]}
    for subject, files in layout.items():
        (root / subject).mkdir()
        for fn in files:
            img = rng.integers(0, 256, (rng.integers(20, 40), rng.integers(20, 40)), np.uint8)
            if fn == "bad.png":
                (root / subject / fn).write_bytes(b"not an image at all")
            elif fn.endswith(".pgm"):
                _write_pgm(root / subject / fn, img)
            else:
                cv2.imwrite(str(root / subject / fn), img)
    (root / "alice" / "notes.txt").write_text("skipped: no decoder reads it")
    (root / "stray.pgm").write_bytes(b"P5\n1 1\n255\n\x00")  # a file at the top: not a subject
    return str(root)


def test_native_library_builds_under_build_dir():
    assert port_native.available()
    assert os.path.dirname(port_native._SO).endswith(os.path.join("build", "native"))
    assert os.path.exists(port_native._SO)


@pytest.mark.parametrize("image_size", [None, (24, 20)])
def test_read_images_equals_jax(tree, image_size):
    if image_size is None:
        # without image_size the images keep their own sizes: compare per subject file
        want = _read_unstacked(jax_dataset, tree)
        got = _read_unstacked(port_dataset, tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        return
    wi, wl, wn = jax_dataset.read_images(tree, image_size=image_size)
    gi, gl, gn = port_dataset.read_images(tree, image_size=image_size)
    assert gn == wn == ["alice", "bob", "erin"]  # empty and unreadable subjects dropped
    np.testing.assert_array_equal(gl, wl)
    assert list(gl) == [0, 0, 0, 1, 1, 2, 2]  # no label shifted past them
    assert gi.dtype == wi.dtype == np.float32 and gi.shape == (7, *image_size)
    np.testing.assert_array_equal(gi, wi)


def _read_unstacked(module, root):
    """``_imread_gray`` of each file of the tree (what ``read_images``
    decodes without ``image_size``), keyed by path; None entries dropped."""
    out = {}
    for subject in sorted(os.listdir(root)):
        d = os.path.join(root, subject)
        if os.path.isdir(d):
            for fn in sorted(os.listdir(d)):
                img = module._imread_gray(os.path.join(d, fn))
                if img is not None:
                    out[(subject, fn)] = img
    return out


def test_same_sized_tree_without_image_size(tmp_path):
    rng = np.random.default_rng(1)
    for s in ("s0", "s1"):
        (tmp_path / s).mkdir()
        for i in range(2):
            _write_pgm(tmp_path / s / f"{i}.pgm", rng.integers(0, 256, (16, 12), np.uint8))
    wi, wl, wn = jax_dataset.read_images(str(tmp_path))
    gi, gl, gn = port_dataset.read_images(str(tmp_path))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert gn == wn


def test_no_readable_image_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no readable images"):
        port_dataset.read_images(str(tmp_path))


def _block(monkeypatch, *names):
    """Make ``import name`` raise ImportError (a machine without it)."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def test_without_cv2_or_pil_native_formats_still_load(tree, monkeypatch):
    _block(monkeypatch, "cv2", "PIL", "PIL.Image")
    images, labels, names = port_dataset.read_images(tree, image_size=(24, 20))
    assert names == ["alice", "bob", "erin"] and list(labels) == [0, 0, 1, 2]
    monkeypatch.undo()
    want, _, _ = jax_dataset.read_images(tree, image_size=(24, 20))
    np.testing.assert_array_equal(images, want[[0, 2, 4, 6]])  # the .pgm files


@pytest.mark.parametrize("blocked", [("cv2",), ("cv2", "PIL", "PIL.Image")])
def test_resize_fallbacks_match_jax(monkeypatch, blocked):
    """cv2 missing: both resize with PIL (equal); cv2 and PIL missing: the
    port's ``ops.image.resize`` against the JAX package's device resize."""
    img = np.random.default_rng(2).random((30, 25)).astype(np.float32) * 255
    _block(monkeypatch, *blocked)
    got = port_dataset._resize_gray(img, (17, 21))
    want = jax_dataset._resize_gray(img, (17, 21))
    assert got.shape == (17, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3 if "PIL" in blocked else 0)
    np.testing.assert_array_equal(port_dataset._resize_gray(img, (30, 25)), img)
    if "PIL" in blocked:
        np.testing.assert_array_equal(
            got, port_image.resize(torch.as_tensor(img), (17, 21)).numpy())
