"""CNN face embedder, inference: port of
``opencv_facerecognizer_tpu/models/embedder.py``.

``FaceEmbedNet`` is the MobileFaceNet-lite net: stem conv -> separable
stages -> global depthwise conv (GDC) -> linear embedding, L2-normalized.
``fused_forward`` runs the same parameters with each stage block fused
into one kernel launch (``ops.sepblock``, the port of the Pallas
schedule). Training (ArcFace) stays in the JAX package.

This slice covers the serving configuration: separable blocks, full norm,
no space-to-depth. Other variants raise ``NotImplementedError``.

Numerics follow flax: bf16 compute with float32 parameters, GroupNorm
statistics in float32, the embedding normalized in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.models._layers import (
    ConvSame, GroupNorm, reset_all)
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block

#: The serving-default embedder of the JAX package (its accuracy-gated
#: structure at the gated 64x64 input).
SERVING_EMBEDDER_KWARGS = dict(
    embed_dim=256,
    stem_features=32,
    stage_features=(64, 128, 256),
    stage_blocks=(2, 2, 2),
    block="separable",
    space_to_depth=1,
    norm="full",
)
#: the accuracy protocol's input resolution; serving crops to the same
SERVING_FACE_SIZE = (64, 64)


class _SepBlock(nn.Module):
    """Depthwise-separable block: dw3x3 -> GN -> ReLU -> pw1x1 -> GN ->
    (+ residual when stride 1 and C == F) -> ReLU. Parameters mirror the
    flax block's ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1``."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = int(stride)
        self.residual = stride == 1 and in_ch == features
        self.dw = ConvSame(in_ch, in_ch, (3, 3), stride=stride, groups=in_ch)
        self.gn1 = GroupNorm(4, in_ch)
        self.pw = ConvSame(in_ch, features, (1, 1))
        self.gn2 = GroupNorm(4, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.relu(self.gn1(self.dw(x, dtype), dtype))
        y = self.gn2(self.pw(y, dtype), dtype)
        if self.residual:
            y = y + x
        return torch.relu(y)

    def fused(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The same block as one ``fused_sep_block`` call, NHWC in/out."""
        return fused_sep_block(
            x_nhwc, self.dw.weight, self.gn1.weight, self.gn1.bias,
            self.pw.weight, self.gn2.weight, self.gn2.bias,
            stride=self.stride, groups=self.gn1.num_groups, eps=self.gn1.eps,
            residual=self.residual)


class FaceEmbedNet(nn.Module):
    """MobileFaceNet-lite: stem conv -> separable stages -> GDC -> linear
    embedding, L2-normalized. ``input_size`` fixes the GDC kernel (flax
    infers it from the first input)."""

    def __init__(self, embed_dim: int = 128, stem_features: int = 32,
                 stage_features: Sequence[int] = (64, 128, 128),
                 stage_blocks: Sequence[int] = (2, 2, 2),
                 block: str = "separable", space_to_depth: int = 1,
                 norm: str = "full", dtype: torch.dtype = torch.bfloat16,
                 input_size: Tuple[int, int] = SERVING_FACE_SIZE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block != "separable" or norm != "full" or int(space_to_depth) != 1:
            raise NotImplementedError(
                "the port covers block='separable', norm='full', "
                f"space_to_depth=1; got {block!r}, {norm!r}, {space_to_depth}")
        self.embed_dim = int(embed_dim)
        self.stage_features = tuple(int(f) for f in stage_features)
        self.stage_blocks = tuple(int(b) for b in stage_blocks)
        self.dtype = dtype
        self.input_size = tuple(input_size)
        total_stride = 2 ** (1 + len(self.stage_features))
        self.stem = ConvSame(1, stem_features, (3, 3), stride=2)  # Conv_0
        self.stem_norm = GroupNorm(4, stem_features)  # GroupNorm_0
        blocks = []
        in_ch, accum = stem_features, 2
        for feats, nblocks in zip(self.stage_features, self.stage_blocks):
            stride = 2 if accum < total_stride else 1
            accum *= stride
            blocks.append(_SepBlock(in_ch, feats, stride))
            blocks.extend(_SepBlock(feats, feats, 1) for _ in range(nblocks - 1))
            in_ch = feats
        self.blocks = nn.ModuleList(blocks)  # _SepBlock_i
        gh = -(-self.input_size[0] // total_stride)
        gw = -(-self.input_size[1] // total_stride)
        self.gdc = ConvSame(in_ch, in_ch, (gh, gw), groups=in_ch,
                            padding="VALID")  # Conv_1
        self.dense = nn.Linear(in_ch, self.embed_dim)  # Dense_0
        reset_all(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W] -> stem output NCHW (channels_last) in the compute dtype."""
        if x.ndim != 3:
            raise ValueError(f"faces must be [N, H, W], got {tuple(x.shape)}")
        if tuple(x.shape[1:]) != self.input_size:
            raise ValueError(f"faces must be {self.input_size}, got "
                             f"{tuple(x.shape[1:])}")
        x = x[:, None].to(self.dtype).contiguous(memory_format=torch.channels_last)
        return torch.relu(self.stem_norm(self.stem(x, self.dtype), self.dtype))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.linear(x.to(self.dtype), self.dense.weight.to(self.dtype),
                     self.dense.bias.to(self.dtype)).float()
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W] faces -> [N, embed_dim] unit-norm float32."""
        x = self._stem(x)
        for blk in self.blocks:
            x = blk(x, self.dtype)
        return self._head(self.gdc(x, self.dtype))


def fused_forward(net: FaceEmbedNet, x: torch.Tensor) -> torch.Tensor:
    """Serving forward of ``net`` with each stage block fused into one
    ``fused_sep_block`` launch: same parameters, same math, another
    schedule (port of the reference's ``fused_forward``). The stem and
    head stay framework ops; the GDC runs as a multiply-reduce."""
    x = net._stem(x).permute(0, 2, 3, 1)  # NHWC view of channels_last: free
    for blk in net.blocks:
        x = blk.fused(x)
    gdc = net.gdc.weight.to(net.dtype)[:, 0]  # [C, h, w]
    x = torch.einsum("nhwc,chw->nc", x.to(net.dtype), gdc)
    return net._head(x)


def normalize_faces(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Serving-path face normalization: resize + per-image standardize
    (population std, as ``jnp.std``)."""
    x = image_ops.resize(x.to(torch.float32), size)
    mean = x.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(x.std(dim=(-2, -1), keepdim=True, correction=0), min=1e-6)
    return (x - mean) / std
