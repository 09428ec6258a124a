"""Local Binary Pattern operators: port of
``opencv_facerecognizer_tpu/ops/lbp.py``.

Every operator takes ``[..., H, W]`` images and returns ``[..., H-2R,
W-2R]`` maps, batched over the leading dims on the tensor's device. The
circular sampling offsets are static Python floats (radius and neighbour
count are constructor arguments), so each bilinear sample is four static
slices and a weighted sum, summed in the reference's order with the
reference's float32 weights; a zero weight drops its tap. Codes are built
with ``>=`` comparisons and static bit weights, so on the CPU they equal
the JAX package's bit for bit.
"""

from __future__ import annotations

import math

import torch


def original_lbp(x) -> torch.Tensor:
    """3x3 LBP codes: [..., H, W] -> [..., H-2, W-2] int32 in [0, 255];
    bits clockwise from the top-left neighbour, most significant first."""
    x = torch.as_tensor(x)
    c = x[..., 1:-1, 1:-1]
    neighbors = (
        x[..., 0:-2, 0:-2],  # top-left
        x[..., 0:-2, 1:-1],  # top
        x[..., 0:-2, 2:],    # top-right
        x[..., 1:-1, 2:],    # right
        x[..., 2:, 2:],      # bottom-right
        x[..., 2:, 1:-1],    # bottom
        x[..., 2:, 0:-2],    # bottom-left
        x[..., 1:-1, 0:-2],  # left
    )
    code = torch.zeros(c.shape, dtype=torch.int32, device=x.device)
    for i, n in enumerate(neighbors):
        code = code + (1 << (7 - i)) * (n >= c).to(torch.int32)
    return code


def _circular_samples(x: torch.Tensor, radius: int, neighbors: int):
    """``neighbors`` bilinear samples [..., H-2r, W-2r] on a circle of
    ``radius`` around each interior pixel, sample k at angle 2 pi k / n."""
    x = torch.as_tensor(x).to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = h - 2 * radius, w - 2 * radius
    samples = []
    for k in range(neighbors):
        theta = 2.0 * math.pi * k / neighbors
        dy = -radius * math.sin(theta)
        dx = radius * math.cos(theta)
        fy, fx = math.floor(dy), math.floor(dx)
        ty, tx = dy - fy, dx - fx
        y0 = radius + fy
        x0 = radius + fx
        s = None
        for wgt, yy, xx in (((1 - ty) * (1 - tx), y0, x0),
                            ((1 - ty) * tx, y0, x0 + 1),
                            (ty * (1 - tx), y0 + 1, x0),
                            (ty * tx, y0 + 1, x0 + 1)):
            if wgt > 1e-12:
                term = wgt * x[..., yy:yy + oh, xx:xx + ow]
                s = term if s is None else s + term
        samples.append(s)
    return samples


def extended_lbp(x, radius: int = 1, neighbors: int = 8) -> torch.Tensor:
    """Circular (extended) LBP: [..., H, W] -> [..., H-2r, W-2r] int32."""
    if neighbors > 31:
        raise ValueError("extended_lbp supports at most 31 neighbors (int32 codes)")
    x = torch.as_tensor(x).to(torch.float32)
    c = x[..., radius:-radius, radius:-radius]
    code = torch.zeros(c.shape, dtype=torch.int32, device=x.device)
    for k, s in enumerate(_circular_samples(x, radius, neighbors)):
        code = code + (1 << k) * (s >= c).to(torch.int32)
    return code


def var_lbp(x, radius: int = 1, neighbors: int = 8) -> torch.Tensor:
    """Rotation-invariant local variance of the circular samples (VAR)."""
    samples = torch.stack(_circular_samples(x, radius, neighbors), dim=0)
    mean = torch.mean(samples, dim=0)
    return torch.mean((samples - mean) ** 2, dim=0)


def lbp_num_bins(neighbors: int = 8) -> int:
    return 1 << neighbors


class LocalBinaryOperator:
    """An LBP operator: callable on [..., H, W] images, with ``num_bins``
    for ``SpatialHistogram`` and the config hooks of the checkpoints."""

    name = "abstract_lbp"

    def __call__(self, x) -> torch.Tensor:
        raise NotImplementedError

    @property
    def num_bins(self) -> int:
        raise NotImplementedError

    def get_config(self) -> dict:
        return {}

    @classmethod
    def from_config(cls, config: dict) -> "LocalBinaryOperator":
        return cls(**config)

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v}" for k, v in self.get_config().items())
        return f"{type(self).__name__}({cfg})"


class OriginalLBP(LocalBinaryOperator):
    name = "original_lbp"

    def __call__(self, x) -> torch.Tensor:
        return original_lbp(x)

    @property
    def num_bins(self) -> int:
        return 256


class ExtendedLBP(LocalBinaryOperator):
    name = "extended_lbp"

    def __init__(self, radius: int = 1, neighbors: int = 8):
        self.radius = int(radius)
        self.neighbors = int(neighbors)

    def __call__(self, x) -> torch.Tensor:
        return extended_lbp(x, self.radius, self.neighbors)

    @property
    def num_bins(self) -> int:
        return 1 << self.neighbors

    def get_config(self) -> dict:
        return {"radius": self.radius, "neighbors": self.neighbors}


class VarLBP(LocalBinaryOperator):
    """The variance operator, quantized into ``bins`` buckets over
    [0, ``max_var``) for ``SpatialHistogram``."""

    name = "var_lbp"

    def __init__(self, radius: int = 1, neighbors: int = 8, bins: int = 64,
                 max_var: float = 8192.0):
        self.radius = int(radius)
        self.neighbors = int(neighbors)
        self.bins = int(bins)
        self.max_var = float(max_var)

    def __call__(self, x) -> torch.Tensor:
        v = var_lbp(x, self.radius, self.neighbors)
        idx = torch.clamp(v / self.max_var, 0.0, 1.0 - 1e-7) * self.bins
        return idx.to(torch.int32)

    @property
    def num_bins(self) -> int:
        return self.bins

    def get_config(self) -> dict:
        return {"radius": self.radius, "neighbors": self.neighbors,
                "bins": self.bins, "max_var": self.max_var}


LBP_OPERATORS = {cls.name: cls for cls in (OriginalLBP, ExtendedLBP, VarLBP)}
