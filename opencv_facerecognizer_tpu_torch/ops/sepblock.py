"""One fused depthwise-separable embedder block.

Port of ``opencv_facerecognizer_tpu/ops/pallas_sepblock.py``
``fused_sep_block``: dw3x3 -> GroupNorm -> ReLU -> pw1x1 -> GroupNorm ->
(+ residual) -> ReLU with the activation kept on chip. The CUDA kernel is
``csrc/sepblock.cu`` (persistent CTAs streaming samples; its header says
what bounds it and how the design answers); ``fused_sep_block_plain`` is
the same function in plain PyTorch.

Both compute what the Pallas kernel computes, rounding where it rounds:
depthwise operands to bf16 with f32 accumulation; the activation in f32
between the fused stages; pointwise operands to bf16 with f32
accumulation; GroupNorm statistics in f32 as E[x^2] - E[x]^2 with the
epsilon inside the rsqrt; one rounding to the output dtype at the end.
The flax block instead rounds every op's output to bf16, so the two agree
to bf16 noise, not bit for bit.

Layouts: activations are ``[B, H, W, C]`` as in the JAX function (the
port's NCHW modules hand over a ``channels_last`` tensor, whose NHWC view
is free); the weights are the port modules' conv layouts, ``w_dw
[C, 1, 3, 3]`` and ``w_pw [F, C, 1, 1]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.ops import _build
from opencv_facerecognizer_tpu_torch.utils.device import sm_count

_plans: Dict[tuple, Tuple[int, ...]] = {}


def launch_grid(b: int, ctas_per_sm: int, sms: int) -> int:
    """Persistent CTAs of one launch: as many as the SMs hold, at most one
    per sample (CTA i takes samples i, i + grid, i + 2 grid, ...)."""
    return max(1, min(b, ctas_per_sm * sms))


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _check(x, w_dw, w_pw, stride: int, residual: bool):
    b, h, w, c = x.shape
    f = w_pw.shape[0]
    if w_dw.shape != (c, 1, 3, 3) or w_pw.shape != (f, c, 1, 1):
        raise ValueError(f"w_dw [C,1,3,3] / w_pw [F,C,1,1] expected for C={c}, "
                         f"got {tuple(w_dw.shape)} / {tuple(w_pw.shape)}")
    if residual and (stride != 1 or c != f):
        raise ValueError("residual requires stride 1 and C == F")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if stride == 2 and (h % 2 or w % 2):
        # SAME stride 2 gives ceil(h/2); the (0, 1) padding below assumes
        # even dims (floor == ceil), as the reference kernel does.
        raise ValueError(f"stride-2 fused block needs even spatial dims, got {h}x{w}")
    return b, h, w, c, f


def _group_norm_nhwc(x: torch.Tensor, scale, bias, groups: int, eps: float):
    """GroupNorm over (H, W, C/G) per sample of an f32 [B, H, W, C]."""
    b, h, w, c = x.shape
    s = x.sum(dim=(1, 2)).reshape(b, groups, c // groups).sum(-1)
    ss = (x * x).sum(dim=(1, 2)).reshape(b, groups, c // groups).sum(-1)
    cnt = h * w * (c // groups)
    mean = s / cnt
    var = torch.clamp(ss / cnt - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(c // groups, dim=1)[:, None, None, :]
    inv_c = inv.repeat_interleave(c // groups, dim=1)[:, None, None, :]
    y = (x - mean_c) * inv_c
    return y * scale.float() + bias.float()


def fused_sep_block_plain(x, w_dw, g1_scale, g1_bias, w_pw, g2_scale,
                          g2_bias, *, stride: int = 1, groups: int = 4,
                          eps: float = 1e-6, residual: bool = False):
    """Plain PyTorch version of ``fused_sep_block`` (same arguments)."""
    b, h, w, c, f = _check(x, w_dw, w_pw, stride, residual)
    oh, ow = h // stride, w // stride
    pad_lo = 1 if stride == 1 else 0
    pad_hi = 2 - pad_lo
    xin = _bf16_round(x.float())
    xpad = F.pad(xin, (0, 0, pad_lo, pad_hi, pad_lo, pad_hi))
    wdw = _bf16_round(w_dw.float())[:, 0]  # [C, 3, 3]
    acc = torch.zeros((b, oh, ow, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            patch = xpad[:, dy:dy + stride * (oh - 1) + 1:stride,
                         dx:dx + stride * (ow - 1) + 1:stride, :]
            acc = acc + patch * wdw[:, dy, dx]
    h1 = torch.relu(_group_norm_nhwc(acc, g1_scale, g1_bias, groups, eps))
    wpw = _bf16_round(w_pw.float())[:, :, 0, 0]  # [F, C]
    pw = (_bf16_round(h1).reshape(-1, c) @ wpw.T).reshape(b, oh, ow, f)
    h2 = _group_norm_nhwc(pw, g2_scale, g2_bias, groups, eps)
    if residual:
        h2 = h2 + x.float()
    return torch.relu(h2).to(x.dtype)


def fused_sep_block(x, w_dw, g1_scale, g1_bias, w_pw, g2_scale, g2_bias, *,
                    stride: int = 1, groups: int = 4, eps: float = 1e-6,
                    residual: bool = False) -> torch.Tensor:
    """One ``_SepBlock`` forward, fused: x [B, H, W, C] -> [B, H/stride,
    W/stride, F] in x's dtype. ``residual`` must match the block's
    condition (stride 1 and C == F).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or f32 x; C, F and OH*OW multiples of 16, C and F of
    ``groups``; a sample's input, the pointwise operand and weights in
    shared memory; a thread's share in one instantiation's registers) or
    raise."""
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_sep_block_plain(
            x, w_dw, g1_scale, g1_bias, w_pw, g2_scale, g2_bias,
            stride=stride, groups=groups, eps=eps, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, h, w, c, f = _check(x, w_dw, w_pw, stride, residual)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bf16 or f32 activations, got {x.dtype}")
    oh, ow = h // stride, w // stride
    dev = x.device
    lib = _lib()
    nbuf, ctas_per_sm = _plan(lib, dev, h, w, c, f, stride, groups,
                              x.dtype == torch.bfloat16)[:2]
    out = torch.empty((b, oh, ow, f), dtype=x.dtype, device=dev)
    if b == 0:
        return out
    # the kernel reads the modules' own layouts (w_dw [C, 1, 3, 3], w_pw
    # [F, C, 1, 1]) in f32 and rounds to bf16 as it stages them
    x, wdw, wpw, s1, b1, s2, b2 = (
        _aligned(t) for t in (x, *(t.to(dev, torch.float32) for t in (
            w_dw, w_pw, g1_scale, g1_bias, g2_scale, g2_bias))))
    grid = launch_grid(b, ctas_per_sm, sm_count(dev))
    err = lib.sepblock_forward(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wdw.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), wpw.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b, h, w, c, f, stride, groups, eps, int(residual), grid, nbuf,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.count_launch(fused_sep_block)
    _build.check(err, "sepblock")
    return out


def launch_info(x: torch.Tensor, f: int, stride: int, groups: int = 4) -> dict:
    """How the kernel launches for CUDA input ``x`` [B, H, W, C] and ``f``
    output channels: input buffers, CTAs per SM, shared memory per CTA,
    variant, threads per CTA and the persistent grid."""
    b, h, w, c = x.shape
    plan = _plan(_lib(), x.device, h, w, c, f, stride, groups, x.dtype == torch.bfloat16)
    return dict(zip(("buffers", "ctas_per_sm", "smem_bytes", "variant", "threads"), plan),
                grid=launch_grid(b, plan[1], sm_count(x.device)))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel's vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib() -> ctypes.CDLL:
    lib = _build.load("sepblock")
    lib.sepblock_forward.restype = ctypes.c_int
    lib.sepblock_forward.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sepblock_plan.restype = ctypes.c_int
    lib.sepblock_plan.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def _plan(lib, dev, h, w, c, f, stride, groups, bf16: bool) -> Tuple[int, ...]:
    """(input buffers, CTAs per SM, shared-memory bytes, variant, threads)
    of one block shape on ``dev``, from the kernel's occupancy; cached."""
    key = (dev.index, h, w, c, f, stride, groups, bf16)
    plan = _plans.get(key)
    if plan is None:
        buf = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            err = lib.sepblock_plan(h, w, c, f, stride, groups, int(bf16), buf)
        if err:
            raise ValueError(f"kernel cannot take block {h}x{w}x{c}->{f} stride "
                             f"{stride} (cudaError {err}): it needs C, F and the "
                             "output pixels multiples of 16, C and F multiples "
                             "of groups, a thread's share within one "
                             "instantiation's registers and a sample within "
                             "shared memory")
        plan = _plans[key] = tuple(buf)
    return plan


#: kernel launches through this wrapper (the serving run reads it to show
#: the main path went through the kernel)
fused_sep_block.launches = 0
