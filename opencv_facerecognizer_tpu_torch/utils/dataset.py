"""Datasets: port of ``opencv_facerecognizer_tpu/utils/dataset.py``.

``read_images`` walks ``path/<subject>/<image files>`` and returns
(images [N, H, W] float32, labels [N] int32, subject names). The decoders
keep the reference's order:

- decode: the native loader (PGM/PPM/BMP, one batch per subject), then
  cv2, then PIL; a file none of them reads is skipped;
- resize: cv2, then PIL, then the port's ``ops.image.resize`` on the CPU.

cv2 and PIL are imported only when a file needs them. Where neither is
installed, PGM/PPM/BMP still load through the native loader and any
other format is skipped like an unreadable file.

``shuffle``, ``make_synthetic_faces`` and ``make_synthetic_scenes`` are
the reference's numpy code, so one seed gives equal arrays in both
packages.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils import native


def _imread_gray(path: str) -> Optional[np.ndarray]:
    """One file -> float32 [H, W] grayscale, or None when unreadable."""
    if native.handles(path):
        img = native.load_gray(path)
        if img is not None:
            return img
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        return None if img is None else img.astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.float32)
    except Exception:  # noqa: BLE001 - None is the contract: the walker skips the file
        return None


def _resize_gray(img: np.ndarray, image_size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (H, W) on the host: cv2, else PIL, else the
    port's ``resize`` (the reference's device resize) on the CPU."""
    h, w = int(image_size[0]), int(image_size[1])
    if img.shape == (h, w):
        return np.asarray(img, dtype=np.float32)
    try:
        import cv2

        return cv2.resize(img, (w, h)).astype(np.float32)
    except ImportError:
        pass
    try:
        from PIL import Image

        resized = Image.fromarray(np.asarray(img, np.float32), mode="F").resize(
            (w, h), Image.BILINEAR)
        return np.asarray(resized, dtype=np.float32)
    except ImportError:
        from opencv_facerecognizer_tpu_torch.ops import image as image_ops

        return image_ops.resize(torch.as_tensor(img, dtype=torch.float32), (h, w)).numpy()


def read_images(path: str, image_size: Optional[Tuple[int, int]] = None
                ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``path/<subject>/<files>`` -> (images, labels, names). Subjects and
    files in sorted order; unreadable files are skipped; a subject with no
    readable file gets no label, so it shifts no later subject's name."""
    images, labels, names = [], [], []
    subjects = sorted(d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))
    for subject in subjects:
        subject_dir = os.path.join(path, subject)
        paths = [os.path.join(subject_dir, fn) for fn in sorted(os.listdir(subject_dir))]
        label = len(names)
        count = 0
        native_ok = np.zeros((len(paths),), bool)
        batch = None
        if image_size is not None and native.available():
            # the subject's native-format files decoded and resized in one call
            native_paths = [p if native.handles(p) else "" for p in paths]
            if any(native_paths):
                batch, native_ok = native.load_batch(native_paths, image_size)
        for i, p in enumerate(paths):
            if native_ok[i]:
                img = batch[i]
            else:
                img = _imread_gray(p)
                if img is None:
                    continue
                if image_size is not None:
                    img = _resize_gray(img, image_size)
            images.append(img)
            labels.append(label)
            count += 1
        if count:
            names.append(subject)
    if not images:
        raise ValueError(f"no readable images under {path!r}")
    return np.stack(images), np.asarray(labels, dtype=np.int32), names


def shuffle(X: np.ndarray, y: np.ndarray, seed: int = 0):
    """Deterministic joint shuffle (the reference's shuffle util)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    if isinstance(X, list):
        return [X[i] for i in perm], np.asarray(y)[perm]
    return np.asarray(X)[perm], np.asarray(y)[perm]


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Edge-clamped bilinear sampling of ``img`` at float coords (ys, xs)."""
    h, w = img.shape
    ys = np.clip(ys, 0.0, h - 1.0)
    xs = np.clip(xs, 0.0, w - 1.0)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0).astype(np.float32)
    fx = (xs - x0).astype(np.float32)
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y1, x0] * fy * (1 - fx)
            + img[y0, x1] * (1 - fy) * fx
            + img[y1, x1] * fy * fx)


def _smooth_field(rng: np.random.Generator, shape: Tuple[int, int],
                  amplitude: float, cells: int = 8) -> np.ndarray:
    """Low-frequency random displacement field: coarse noise, kron-upsampled
    and box-blurred twice — smooth enough to read as pose/expression
    deformation rather than pixel noise."""
    h, w = shape
    coarse = rng.normal(scale=amplitude, size=(-(-h // cells), -(-w // cells)))
    field = np.kron(coarse, np.ones((cells, cells)))[:h, :w]
    for _ in range(2):  # separable 3x3 box blur, edge-padded
        field = (np.pad(field, 1, mode="edge")[:-2, 1:-1]
                 + field + np.pad(field, 1, mode="edge")[2:, 1:-1]) / 3.0
        field = (np.pad(field, 1, mode="edge")[1:-1, :-2]
                 + field + np.pad(field, 1, mode="edge")[1:-1, 2:]) / 3.0
    return field.astype(np.float32)


def make_synthetic_faces(
    num_subjects: int = 10,
    per_subject: int = 10,
    size: Tuple[int, int] = (32, 32),
    seed: int = 0,
    noise: float = 12.0,
    illumination: float = 0.35,
    rotation: float = 0.0,
    scale_jitter: float = 0.0,
    elastic: float = 0.0,
    occlusion: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Deterministic face-like dataset: per-subject smooth base pattern +
    per-sample noise, global illumination scaling, and small translations —
    the variation axes the classic pipeline (TanTriggs/PCA/LDA/LBP) exists
    to handle. Returns (images [N,H,W] in [0,255], labels, names).

    The hard-protocol axes (all off by default, so the default
    distribution stays the same):

    - ``rotation``: per-sample in-plane pose rotation, uniform in
      [-rotation, +rotation] degrees, bilinear resample around the center.
    - ``scale_jitter``: per-sample scale factor uniform in [1-s, 1+s]
      (composed into the same affine warp).
    - ``elastic``: per-sample smooth elastic deformation, displacement
      amplitude in pixels (low-frequency field — expression/3-D pose
      analog, the deformation PCA/LDA templates cannot model linearly).
    - ``occlusion``: probability of one random occluding rectangle
      (20-45% of each side, filled with flat gray + noise — sunglasses/
      scarf analog).
    """
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy0, cx0 = (h - 1) / 2.0, (w - 1) / 2.0
    images, labels = [], []
    for s in range(num_subjects):
        # Smooth "identity" structure: sum of a few random low-freq gaussians.
        base = np.zeros((h, w), dtype=np.float32)
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            sy, sx = rng.uniform(h / 8, h / 3), rng.uniform(w / 8, w / 3)
            amp = rng.uniform(-1.0, 1.0)
            base += amp * np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2))
        base = 128.0 + 90.0 * base / (np.abs(base).max() + 1e-6)
        for _ in range(per_subject):
            img = base.copy()
            # small translation (integer, wraps cropped)
            ty, tx = rng.integers(-2, 3, size=2)
            if rotation or scale_jitter or elastic:
                # One composed inverse-map warp: rotate + scale about the
                # center, translate, plus the elastic displacement field.
                ang = np.deg2rad(rng.uniform(-rotation, rotation)) if rotation else 0.0
                sc = rng.uniform(1 - scale_jitter, 1 + scale_jitter) if scale_jitter else 1.0
                cos_a, sin_a = np.cos(ang), np.sin(ang)
                y0 = yy - cy0 - ty
                x0 = xx - cx0 - tx
                ys = (cos_a * y0 + sin_a * x0) / sc + cy0
                xs = (-sin_a * y0 + cos_a * x0) / sc + cx0
                if elastic:
                    ys = ys + _smooth_field(rng, (h, w), elastic)
                    xs = xs + _smooth_field(rng, (h, w), elastic)
                img = _bilinear_sample(img, ys, xs)
            else:
                img = np.roll(img, (ty, tx), axis=(0, 1))
            if occlusion and rng.uniform() < occlusion:
                oh = int(rng.uniform(0.20, 0.45) * h)
                ow = int(rng.uniform(0.20, 0.45) * w)
                oy = int(rng.integers(0, h - oh + 1))
                ox = int(rng.integers(0, w - ow + 1))
                patch = rng.uniform(40, 200) + rng.normal(
                    scale=8.0, size=(oh, ow)).astype(np.float32)
                img[oy : oy + oh, ox : ox + ow] = patch
            # illumination scale + offset
            img = img * rng.uniform(1 - illumination, 1 + illumination) + rng.uniform(-20, 20)
            img = img + rng.normal(scale=noise, size=(h, w))
            images.append(np.clip(img, 0, 255).astype(np.float32))
            labels.append(s)
    names = [f"subject_{i:02d}" for i in range(num_subjects)]
    return np.stack(images), np.asarray(labels, dtype=np.int32), names


def make_synthetic_scenes(
    num_scenes: int = 32,
    scene_size: Tuple[int, int] = (96, 96),
    max_faces: int = 3,
    face_size_range: Tuple[int, int] = (20, 36),
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Detection-training scenes: textured background with 0..max_faces
    bright ellipse-masked "face" patches pasted in (distinct enough for a
    small detector to learn). Returns (scenes [N,H,W] in [0,255],
    boxes [N,max_faces,4] pixel yxyx zero-padded, num_faces [N])."""
    rng = np.random.default_rng(seed)
    h, w = scene_size
    scenes = np.zeros((num_scenes, h, w), dtype=np.float32)
    boxes = np.zeros((num_scenes, max_faces, 4), dtype=np.float32)
    counts = np.zeros((num_scenes,), dtype=np.int32)
    for i in range(num_scenes):
        # low-frequency background texture (kron-upsampled, cropped to size)
        bg = rng.normal(scale=1.0, size=(-(-h // 8), -(-w // 8))).astype(np.float32)
        bg = np.kron(bg, np.ones((8, 8), dtype=np.float32))[:h, :w]
        scene = 80.0 + 20.0 * bg + rng.normal(scale=6.0, size=(h, w)).astype(np.float32)
        n_faces = int(rng.integers(0, max_faces + 1))
        placed = 0
        attempts = 0
        while placed < n_faces and attempts < 20:
            attempts += 1
            fs = int(rng.integers(face_size_range[0], face_size_range[1] + 1))
            y0 = int(rng.integers(0, h - fs + 1))
            x0 = int(rng.integers(0, w - fs + 1))
            # reject overlaps with already-placed boxes
            ok = True
            for b in range(placed):
                by0, bx0, by1, bx1 = boxes[i, b]
                if not (y0 + fs < by0 or by1 < y0 or x0 + fs < bx0 or bx1 < x0):
                    ok = False
                    break
            if not ok:
                continue
            yy, xx = np.mgrid[0:fs, 0:fs].astype(np.float32)
            cy, cx = fs / 2, fs / 2
            ellipse = (((yy - cy) / (fs * 0.5)) ** 2 + ((xx - cx) / (fs * 0.42)) ** 2) <= 1.0
            face = 190.0 + 30.0 * np.cos(yy / fs * 3.1) + rng.normal(scale=8.0, size=(fs, fs))
            # darker "eyes" structure so faces are not plain blobs
            for ex in (0.32, 0.68):
                eyy, exx = int(fs * 0.38), int(fs * ex)
                rr = max(1, fs // 10)
                face[eyy - rr : eyy + rr, exx - rr : exx + rr] -= 90.0
            region = scene[y0 : y0 + fs, x0 : x0 + fs]
            region[ellipse] = face[ellipse]
            boxes[i, placed] = (y0, x0, y0 + fs, x0 + fs)
            placed += 1
        counts[i] = placed
        scenes[i] = np.clip(scene, 0, 255)
    return scenes, boxes, counts
