"""Image ops of the serving path: resize and the batched crop.

Port of the serving part of ``opencv_facerecognizer_tpu/ops/image.py``
(``resize``, ``batched_crop_resize``). Both run in float32; on the card
the crop's contractions must stay out of TF32, so ``batched_crop_resize``
sets both TF32 switches off (``utils.device.disable_tf32``) before it
runs on a CUDA tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from opencv_facerecognizer_tpu_torch.utils.device import disable_tf32


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
