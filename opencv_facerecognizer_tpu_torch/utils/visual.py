"""Plots of the classic models: port of
``opencv_facerecognizer_tpu/utils/visual.py``.

Eigenfaces / Fisherfaces components, the mean face and recognition
overlays, each rendered to a file. Matplotlib is imported only inside the
functions that draw (a serving or card machine without it imports this
module all the same); tensors on any device are read back to the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _normalize_for_display(img: np.ndarray) -> np.ndarray:
    img = np.asarray(_host(img), np.float64)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def subplot_grid(
    images: Sequence[np.ndarray],
    titles: Optional[Sequence[str]] = None,
    rows: Optional[int] = None,
    cols: int = 4,
    suptitle: str = "",
    filename: str = "plot.png",
) -> str:
    """Save a grid of grayscale images (the reference's ``subplot`` helper)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    cols = min(cols, max(n, 1))
    rows = rows or -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.4 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i, ax in enumerate(axes):
        ax.axis("off")
        if i < n:
            ax.imshow(_normalize_for_display(images[i]), cmap="gray")
            if titles and i < len(titles):
                ax.set_title(str(titles[i]), fontsize=8)
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    fig.savefig(filename, dpi=110)
    plt.close(fig)
    return filename


def plot_eigenfaces(
    feature, image_size, num: int = 8, filename: str = "eigenfaces.png"
) -> str:
    """Render the top subspace components of a fitted PCA/Fisherfaces plugin."""
    comps = _host(feature.eigenvectors)  # [D, K]
    num = min(num, comps.shape[1])
    faces = [comps[:, i].reshape(image_size) for i in range(num)]
    titles = [f"component {i}" for i in range(num)]
    return subplot_grid(faces, titles, suptitle=type(feature).__name__, filename=filename)


def plot_mean_face(feature, image_size, filename: str = "meanface.png") -> str:
    mean = _host(feature.mean).reshape(image_size)
    return subplot_grid([mean], ["mean face"], filename=filename)


def draw_detections(
    frame: np.ndarray, faces: Sequence[dict], filename: str = "detections.png"
) -> str:
    """Overlay recognition results (box + name + similarity) on one frame —
    the file-output equivalent of the reference's draw_str/rectangle overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    fig, ax = plt.subplots(figsize=(6, 6 * frame.shape[0] / max(frame.shape[1], 1)))
    frame = _host(frame)
    ax.imshow(_normalize_for_display(frame), cmap="gray")
    ax.axis("off")
    for face in faces:
        x0, y0, x1, y1 = face["box"]
        ax.add_patch(patches.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       fill=False, edgecolor="lime", linewidth=1.5))
        ax.text(x0, max(y0 - 3, 0), f"{face.get('name', '?')} {face.get('similarity', 0):.2f}",
                color="lime", fontsize=8, va="bottom")
    fig.tight_layout()
    fig.savefig(filename, dpi=110)
    plt.close(fig)
    return filename
