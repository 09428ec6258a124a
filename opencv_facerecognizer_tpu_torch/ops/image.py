"""Image ops: port of ``opencv_facerecognizer_tpu/ops/image.py``.

The serving path's ``resize`` and ``batched_crop_resize``, and the
classic preprocessing (``to_grayscale``, ``minmax_normalize``,
``histogram_equalize``, ``gaussian_blur``, ``tan_triggs``) with the host
convenience ``crop_and_resize``. Every function takes ``[..., H, W]``
float tensors (``[..., H, W, 3]`` for ``to_grayscale``) and broadcasts
over the leading dims; it runs on the tensor's device, in float32. On the
card the crop's contractions must stay out of TF32, so
``batched_crop_resize`` sets both TF32 switches off
(``utils.device.disable_tf32``) before it runs on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32

# BT.601 luma weights (cv2.cvtColor's, up to channel order)
_LUMA_RGB = (0.299, 0.587, 0.114)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def to_grayscale(x, channel_order: str = "rgb") -> torch.Tensor:
    """[..., H, W, 3] -> [..., H, W] luma."""
    x = _f32(x)
    w = _LUMA_RGB if channel_order == "rgb" else _LUMA_RGB[::-1]
    return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] resampling weights of ``jax.image.resize(method=
    "bilinear", antialias=True)`` along one axis: a triangle kernel,
    widened by the scale when downsampling, normalized over the in-range
    taps, zero where the sample lies outside the input."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: Tuple[int, int],
           method: str = "bilinear") -> torch.Tensor:
    """Resize the trailing [H, W] dims to ``size``; batch dims untouched.

    Identity sizes return the input unchanged (the serving path calls this
    on crops already at the face size). Otherwise bilinear with
    ``jax.image.resize``'s antialiased weights."""
    x = x.to(torch.float32)
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if method not in ("bilinear", "linear"):
        raise NotImplementedError(f"resize method {method!r}: only bilinear is ported")
    h, w = x.shape[-2:]
    oh, ow = size
    if h != oh:
        x = torch.einsum("...hw,ho->...ow", x, _linear_weights(h, oh, x.device))
    if w != ow:
        x = torch.einsum("...hw,wo->...ho", x, _linear_weights(w, ow, x.device))
    return x


def batched_crop_resize(frames: torch.Tensor, boxes: torch.Tensor,
                        size: Tuple[int, int]) -> torch.Tensor:
    """Crop+resize K boxes per frame: frames [N, H, W], boxes [N, K, 4]
    pixel (y0, x0, y1, x1) -> crops [N, K, h, w], bilinear.

    Two tent-weight contractions, as the reference: crop[k] = Ay[k] @
    frame @ Ax[k]^T, each row of Ay / Ax holding the (at most two)
    bilinear taps. Out-of-bounds samples clamp to the frame edge."""
    if frames.is_cuda:
        disable_tf32()
    frames = frames.to(torch.float32)
    boxes = boxes.to(torch.float32)
    n, h, w = frames.shape
    oh, ow = size
    dev = frames.device
    ty = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    tx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    y0, x0, y1, x1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    ys = y0[..., None] + (y1 - y0)[..., None] * ty - 0.5  # [N, K, oh]
    xs = x0[..., None] + (x1 - x0)[..., None] * tx - 0.5  # [N, K, ow]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    ay = torch.clamp(1.0 - (ys[..., None] - torch.arange(
        h, dtype=torch.float32, device=dev)).abs(), min=0.0)  # [N, K, oh, H]
    ax = torch.clamp(1.0 - (xs[..., None] - torch.arange(
        w, dtype=torch.float32, device=dev)).abs(), min=0.0)  # [N, K, ow, W]
    tmp = torch.einsum("nkih,nhw->nkiw", ay, frames)
    return torch.einsum("nkiw,nkjw->nkij", tmp, ax)


def minmax_normalize(x, low: float = 0.0, high: float = 1.0) -> torch.Tensor:
    """Per-image min/max normalization over the trailing [H, W] dims."""
    x = _f32(x)
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    scale = (high - low) / torch.clamp(mx - mn, min=1e-12)
    return low + (x - mn) * scale


def histogram_equalize(x, num_bins: int = 256) -> torch.Tensor:
    """Per-image histogram equalization: the input quantized to
    ``num_bins`` levels over [0, 255], a scatter-add histogram, its cumsum
    as the lookup table; float32 output in [0, 255]."""
    x = _f32(x)
    h, w = x.shape[-2], x.shape[-1]
    n = h * w
    idx = torch.round(torch.clamp(x, 0.0, 255.0) * ((num_bins - 1) / 255.0)).to(torch.int64)
    flat = idx.reshape(-1, n)
    hist = torch.zeros((flat.shape[0], num_bins), dtype=torch.float32, device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    cdf = torch.cumsum(hist, dim=-1)
    first = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = torch.gather(cdf, -1, first)
    denom = torch.clamp(n - cdf_min, min=1.0)
    lut = torch.clamp((cdf - cdf_min) / denom * 255.0, 0.0, 255.0)
    return torch.gather(lut, -1, flat).reshape(x.shape)


def _gaussian_kernel_1d(sigma: float, device) -> torch.Tensor:
    """Separable Gaussian taps, radius ceil(3 sigma), summing to 1."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(x, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the trailing [H, W], same size, edges
    replicated: two 1-D passes of static taps, summed tap by tap in the
    reference's order."""
    x = _f32(x)
    k = _gaussian_kernel_1d(sigma, x.device)
    r = (k.shape[0] - 1) // 2
    h, w = x.shape[-2], x.shape[-1]
    xb = x.reshape(-1, h, w)

    def conv_last(a: torch.Tensor) -> torch.Tensor:
        ap = torch.nn.functional.pad(a, (r, r), mode="replicate")
        out = torch.zeros_like(a)
        for i in range(2 * r + 1):
            out = out + k[i] * ap[:, :, i:i + a.shape[-1]]
        return out

    xb = conv_last(xb)  # along W
    xb = conv_last(xb.transpose(-1, -2)).transpose(-1, -2)  # along H
    return xb.reshape(x.shape)


def tan_triggs(x, alpha: float = 0.1, tau: float = 10.0, gamma: float = 0.2,
               sigma0: float = 1.0, sigma1: float = 2.0) -> torch.Tensor:
    """Tan-Triggs illumination normalization: gamma, difference of
    Gaussians, two-stage contrast equalization, tau-bounded by a tanh."""
    x = _f32(x)
    xg = torch.pow(x + 1.0, gamma)
    dog = gaussian_blur(xg, sigma0) - gaussian_blur(xg, sigma1)
    axes = (-2, -1)
    m1 = torch.mean(torch.abs(dog) ** alpha, dim=axes, keepdim=True)
    dog = dog / torch.clamp(m1, min=1e-12) ** (1.0 / alpha)
    m2 = torch.mean(torch.clamp(torch.abs(dog), max=tau) ** alpha, dim=axes, keepdim=True)
    dog = dog / torch.clamp(m2, min=1e-12) ** (1.0 / alpha)
    return tau * torch.tanh(dog / tau)


def crop_and_resize(frame, box: Sequence[int], size: Tuple[int, int]) -> torch.Tensor:
    """Crop [y0:y1, x0:x1] of a [..., H, W] frame and resize it to ``size``."""
    y0, x0, y1, x1 = (int(v) for v in box)
    return resize(_f32(frame)[..., y0:y1, x0:x1], size)
