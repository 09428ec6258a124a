"""Layers shared by the port's detector and embedder, matching flax.linen
numerics: NCHW tensors, float32 parameters, compute in ``dtype``.

- ``ConvSame``: ``nn.Conv`` with SAME padding. Flax pads a stride-2 conv
  on an even input by (0, 1), not torch's symmetric (1, 1); the padding is
  computed per axis as XLA does and applied with ``F.pad``.
- ``GroupNorm``: ``nn.GroupNorm`` with flax's defaults: epsilon 1e-6,
  statistics in float32 as E[x^2] - E[x]^2 clipped at 0, the scale folded
  into the rsqrt, output cast to the compute dtype.
- ``cast_param``: a parameter in the compute dtype without a cast per
  call. The copy is made once and refreshed in place (``copy_``) when the
  parameter changes, so it keeps its address and a CUDA graph captured
  over it sees new weights; ``load_state_dict`` refreshes every copy at
  once (``track_casts``). Under autograd (a training step) the cast is a
  tracked ``param.to(dtype)`` instead, so the float32 parameter gets its
  gradient through the cast, as flax's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one axis under XLA's SAME rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def cast_param(owner: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Parameter ``name`` of ``owner`` in ``dtype``: the parameter itself
    when it has that dtype; with grad enabled on a parameter that requires
    it, ``param.to(dtype)``, which autograd tracks (nothing cached: the
    next optimizer step changes the parameter); else one cached copy. The
    copy follows the parameter (its identity and version counter), so an
    in-place change (``copy_``, ``fill_``, an optimizer step) or a
    swapped-in tensor (``functional_call``) refreshes it in place on the
    next read; a new device or shape makes a new copy."""
    param = getattr(owner, name)
    if param.dtype == dtype:
        return param
    if param.requires_grad and torch.is_grad_enabled():
        return param.to(dtype)
    casts = owner.__dict__.setdefault("_casts", {})
    entry = casts.get((name, dtype))
    if entry is None or entry[0].shape != param.shape or entry[0].device != param.device:
        entry = casts[(name, dtype)] = [param.detach().to(dtype), param._version, param]
    elif entry[2] is not param or entry[1] != param._version:
        with torch.no_grad():
            entry[0].copy_(param)
        entry[1:] = [param._version, param]
    return entry[0]


@torch.no_grad()
def refresh_casts(module: nn.Module) -> None:
    """Bring every cached cast below ``module`` up to date in place (under
    ``no_grad``, so a load with grad enabled still refreshes the copies a
    captured graph reads)."""
    for m in module.modules():
        for (name, dtype) in list(m.__dict__.get("_casts", {})):
            cast_param(m, name, dtype)


def _refresh_after_load(module: nn.Module, _incompatible_keys) -> None:
    refresh_casts(module)


def track_casts(module: nn.Module) -> None:
    """Refresh ``module``'s cached casts whenever ``load_state_dict``
    loads it, so weights installed between two graph replays reach the
    next replay."""
    module.register_load_state_dict_post_hook(_refresh_after_load)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class ConvSame(nn.Module):
    """2-D convolution with SAME (or VALID) padding; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, groups: int = 1, bias: bool = False,
                 padding: str = "SAME"):
        super().__init__()
        self.stride = int(stride)
        self.groups = int(groups)
        self.padding = padding
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """LeCun-normal weights (flax's default conv init), zero bias."""
        fan_in = self.weight[0].numel()
        normal_(self.weight, fan_in ** -0.5, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.padding == "SAME":
            kh, kw = self.weight.shape[2:]
            ph = same_padding(x.shape[2], kh, self.stride)
            pw = same_padding(x.shape[3], kw, self.stride)
            if any(ph + pw):
                x = F.pad(x, (*pw, *ph))
        bias = None if self.bias is None else cast_param(self, "bias", dtype)
        return F.conv2d(x.to(dtype), cast_param(self, "weight", dtype), bias,
                        stride=self.stride, groups=self.groups)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over NCHW."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = int(num_groups)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n, c = x.shape[:2]
        xf = x.float()
        g = xf.reshape(n, self.num_groups, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        cg = c // self.num_groups
        shape = (n, c) + (1,) * (x.ndim - 2)
        mean_c = mean.repeat_interleave(cg, dim=1).reshape(shape)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(cg, dim=1)
               * self.weight).reshape(shape)
        y = (xf - mean_c) * mul + self.bias.reshape((1, c) + (1,) * (x.ndim - 2))
        return y.to(dtype)


def space_to_depth_nhwc(x: torch.Tensor, s: int) -> torch.Tensor:
    """Fold s x s pixel blocks into channels in the reference's NHWC
    order: [N, H, W, C] -> [N, H/s, W/s, s*s*C], channel (dy*s + dx)*C + c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // s, s, w // s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // s, w // s, s * s * c)


def reset_all(module: nn.Module, generator: torch.Generator) -> None:
    """``reset_parameters(generator)`` on every ConvSame / GroupNorm /
    Linear below ``module``, in registration order."""
    for m in module.modules():
        if isinstance(m, (ConvSame, GroupNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
