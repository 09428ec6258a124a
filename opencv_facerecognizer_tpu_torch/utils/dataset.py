"""Gallery image directories: port of ``read_images`` and its decoders
from ``opencv_facerecognizer_tpu/utils/dataset.py``.

``read_images`` walks ``path/<subject>/<image files>`` and returns
(images [N, H, W] float32, labels [N] int32, subject names). The decoders
keep the reference's order:

- decode: the native loader (PGM/PPM/BMP, one batch per subject), then
  cv2, then PIL; a file none of them reads is skipped;
- resize: cv2, then PIL, then the port's ``ops.image.resize`` on the CPU.

cv2 and PIL are imported only when a file needs them. Where neither is
installed, PGM/PPM/BMP still load through the native loader and any
other format is skipped like an unreadable file.
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
