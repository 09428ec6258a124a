"""CNN face embedder: port of ``opencv_facerecognizer_tpu/models/embedder.py``.

``FaceEmbedNet`` is the MobileFaceNet-lite net: stem conv -> separable
(or dense) stages -> global depthwise conv (GDC) -> linear embedding,
L2-normalized.
``fused_forward`` runs the same parameters with each stage block fused
into one kernel launch (``ops.sepblock``, the port of the Pallas
schedule). ``CNNEmbedding`` puts the net behind the ``AbstractFeature``
boundary, so ``PredictableModel(CNNEmbedding(...), NearestNeighbor(
CosineDistance()))`` is the JAX package's CNN model, checkpoints included.

Every variant of the reference is ported: ``block`` "separable" or
"dense", ``norm`` "full" or "light" (a light separable block drops the
norm between its depthwise and pointwise convs), and ``space_to_depth``
s > 1, which folds s x s pixel blocks into the stem's channels in the
reference's (dy, dx, c) order and drops stem and stage strides to 1 once
the fold covers them, so the net's total downsample and its GDC are the
same for every s. ``fused_forward`` (kernel B) takes separable blocks
with full norm at any s; like the reference's it refuses dense blocks
and the light norm.

Training is the reference's ArcFace recipe: ``arcface_loss`` (additive
angular margin softmax), ``augment_draws`` + ``augment_transform`` (the
reference's ``augment_batch`` split into its random draws and a pure
transform, so a test can feed the reference's own draws), the margin
ramp, Adam with optax's defaults and the optional cosine decay. The
step is eager autograd over framework ops, as the reference's is
``jax.value_and_grad`` over the flax graph: kernel B has no backward in
either package, and ``fused_forward`` serves only. The port's draws and
its init come from ``torch.Generator``s, not ``jax.random`` (ROADMAP
C.22): the same seed gives other numbers, from the same distributions.

Numerics follow flax: bf16 compute with float32 parameters (the cast
inside autograd, ``_layers.cast_param``), GroupNorm statistics in
float32, the embedding normalized in float32.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from opencv_facerecognizer_tpu_torch.models._layers import (
    ConvSame, GroupNorm, cast_param, reset_all, space_to_depth_nhwc, track_casts)
from opencv_facerecognizer_tpu_torch.models._train import adam, fixed_batches
from opencv_facerecognizer_tpu_torch.models.feature import AbstractFeature
from opencv_facerecognizer_tpu_torch.ops import image as image_ops
from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block
from opencv_facerecognizer_tpu_torch.utils.device import (
    DEFAULT_DEVICE, DeviceLike, disable_tf32, resolve_device)
from opencv_facerecognizer_tpu_torch.utils.params import (
    embedder_params_from_flax, embedder_params_to_flax)

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
    flax block's ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1``;
    any ``norm`` but "full" (the reference's "light") drops the first
    norm, and its one norm is the flax block's ``GroupNorm_0``."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, norm: str = "full"):
        super().__init__()
        self.stride = int(stride)
        self.residual = stride == 1 and in_ch == features
        self.dw = ConvSame(in_ch, in_ch, (3, 3), stride=stride, groups=in_ch)
        self.gn1 = GroupNorm(4, in_ch) if norm == "full" else None
        self.pw = ConvSame(in_ch, features, (1, 1))
        self.gn2 = GroupNorm(4, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.dw(x, dtype)
        if self.gn1 is not None:
            y = self.gn1(y, dtype)
        y = self.gn2(self.pw(torch.relu(y), dtype), dtype)
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


class _DenseBlock(nn.Module):
    """Plain 3x3 conv block: conv3x3 -> GN -> (+ residual when stride 1
    and C == F) -> ReLU; flax's ``Conv_0`` and ``GroupNorm_0``. It has one
    norm whatever ``norm`` says."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, norm: str = "full"):
        super().__init__()
        self.residual = stride == 1 and in_ch == features
        self.conv = ConvSame(in_ch, features, (3, 3), stride=stride)
        self.gn = GroupNorm(4, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = self.gn(self.conv(x, dtype), dtype)
        if self.residual:
            y = y + x
        return torch.relu(y)


_BLOCKS = {"separable": _SepBlock, "dense": _DenseBlock}


def check_fusable(net: "FaceEmbedNet") -> None:
    """Raise ``ValueError`` as the reference's ``fused_forward`` does for a
    net whose blocks the fused schedule does not cover."""
    if net.block != "separable":
        raise ValueError("fused_forward covers block='separable' only")
    if net.norm != "full":
        raise ValueError("fused_forward covers norm='full' only")


class FaceEmbedNet(nn.Module):
    """MobileFaceNet-lite: (space-to-depth) -> stem conv -> stages of
    separable or dense blocks -> GDC -> linear embedding, L2-normalized.
    ``input_size`` fixes the GDC kernel (flax infers it from the first
    input). Parameter names mirror flax's: ``Conv_0`` / ``GroupNorm_0``
    stem, ``_SepBlock_i`` or ``_DenseBlock_i`` blocks, ``Conv_1`` GDC,
    ``Dense_0``."""

    def __init__(self, embed_dim: int = 128, stem_features: int = 32,
                 stage_features: Sequence[int] = (64, 128, 128),
                 stage_blocks: Sequence[int] = (2, 2, 2),
                 block: str = "separable", space_to_depth: int = 1,
                 norm: str = "full", dtype: torch.dtype = torch.bfloat16,
                 input_size: Tuple[int, int] = SERVING_FACE_SIZE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if block not in _BLOCKS:
            raise KeyError(block)
        self.embed_dim = int(embed_dim)
        self.stage_features = tuple(int(f) for f in stage_features)
        self.stage_blocks = tuple(int(b) for b in stage_blocks)
        self.block = block
        self.norm = norm
        self.space_to_depth = s = int(space_to_depth)
        self.dtype = dtype
        self.input_size = tuple(input_size)
        total_stride = 2 ** (1 + len(self.stage_features))
        if s > 1 and total_stride % s:
            raise ValueError(f"space_to_depth={s} must divide the net's total "
                             f"downsample {total_stride}")
        remaining = total_stride // s
        accum = 1
        stem_stride = 2 if accum < remaining else 1
        accum *= stem_stride
        self.stem = ConvSame(s * s, stem_features, (3, 3), stride=stem_stride)  # Conv_0
        self.stem_norm = GroupNorm(4, stem_features)  # GroupNorm_0
        block_cls = _BLOCKS[block]
        blocks = []
        in_ch = stem_features
        for feats, nblocks in zip(self.stage_features, self.stage_blocks):
            stride = 2 if accum < remaining else 1
            accum *= stride
            blocks.append(block_cls(in_ch, feats, stride, norm))
            blocks.extend(block_cls(feats, feats, 1, norm) for _ in range(nblocks - 1))
            in_ch = feats
        self.blocks = nn.ModuleList(blocks)
        gh = -(-self.input_size[0] // total_stride)
        gw = -(-self.input_size[1] // total_stride)
        self.gdc = ConvSame(in_ch, in_ch, (gh, gw), groups=in_ch,
                            padding="VALID")  # Conv_1
        self.dense = nn.Linear(in_ch, self.embed_dim)  # Dense_0
        reset_all(self, generator if generator is not None
                  else torch.Generator().manual_seed(0))
        track_casts(self)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W] -> stem output NCHW (channels_last) in the compute dtype."""
        if x.ndim != 3:
            raise ValueError(f"faces must be [N, H, W], got {tuple(x.shape)}")
        if tuple(x.shape[1:]) != self.input_size:
            raise ValueError(f"faces must be {self.input_size}, got "
                             f"{tuple(x.shape[1:])}")
        s = self.space_to_depth
        x = x.to(self.dtype)
        if s > 1:
            h, w = x.shape[1:]
            if h % s or w % s:
                raise ValueError(f"input {h}x{w} not divisible by space_to_depth={s}")
            x = space_to_depth_nhwc(x[..., None], s).permute(0, 3, 1, 2)
        else:
            x = x[:, None]
        x = x.contiguous(memory_format=torch.channels_last)
        return torch.relu(self.stem_norm(self.stem(x, self.dtype), self.dtype))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.linear(x.to(self.dtype), cast_param(self.dense, "weight", self.dtype),
                     cast_param(self.dense, "bias", self.dtype)).float()
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
    schedule (port of the reference's ``fused_forward``, which covers
    separable blocks with full norm and raises ``ValueError`` otherwise).
    The stem and head stay framework ops; the GDC runs as a
    multiply-reduce."""
    check_fusable(net)
    x = net._stem(x).permute(0, 2, 3, 1)  # NHWC view of channels_last: free
    for blk in net.blocks:
        x = blk.fused(x)
    gdc = cast_param(net.gdc, "weight", net.dtype)[:, 0]  # [C, h, w]
    x = torch.einsum("nhwc,chw->nc", x.to(net.dtype), gdc)
    return net._head(x)


# ---------- training: ArcFace (the reference's embedder.py:276-431) ----------


def arcface_logits(embeddings: torch.Tensor, onehot: torch.Tensor, weights: torch.Tensor,
                   margin: float = 0.5, scale: float = 32.0) -> torch.Tensor:
    """The additive angular margin logits [N, C] of ``arcface_loss``: the
    class directions ``weights`` [C, E] L2-normalized, the cosine clipped
    to +-(1 - 1e-6), the angle widened by ``margin`` where ``onehot``
    [N, C] is 1, everything scaled by ``scale``. Each class's column
    needs only its own row of ``weights``, so a shard of the classes
    (``parallel.train``) gets its columns of the whole."""
    w = weights / torch.clamp(torch.linalg.vector_norm(weights, dim=-1, keepdim=True),
                              min=1e-12)
    cos = torch.clamp(embeddings @ w.T, -1.0 + 1e-6, 1.0 - 1e-6)  # [N, C]
    theta = torch.arccos(cos)
    cos_margin = torch.cos(theta + margin)
    return scale * (onehot * cos_margin + (1.0 - onehot) * cos)


def arcface_loss(embeddings: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                 margin: float = 0.5, scale: float = 32.0) -> torch.Tensor:
    """Additive angular margin softmax loss: ``arcface_logits`` with the
    labels' classes widened, then the mean softmax cross entropy."""
    onehot = F.one_hot(labels.long(), weights.shape[0]).to(
        torch.promote_types(embeddings.dtype, weights.dtype))
    return F.cross_entropy(arcface_logits(embeddings, onehot, weights, margin, scale),
                           labels.long())


def augment_draws(generator: torch.Generator, n: int, h: int, w: int, *,
                  occlusion_p: float = 0.5, max_shift: int = 3,
                  max_rotate_deg: float = 14.0,
                  scale_jitter: float = 0.1) -> Dict[str, torch.Tensor]:
    """The random draws of one augmented batch of ``n`` ``h`` x ``w``
    faces, on ``generator``'s device, with the reference's ranges
    (``randint``'s high exclusive): per sample a horizontal flip (p 0.5),
    a rotation angle in radians and a scale for the resample, the shift's
    offsets into the edge-padded face, and a cutout rectangle (its size,
    corner, and whether it applies, p ``occlusion_p``)."""
    dev = generator.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    def randint(lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, (n,), generator=generator, device=dev)

    return {
        "flip": uniform(0.0, 1.0) < 0.5,
        "angle": uniform(-max_rotate_deg, max_rotate_deg) * (math.pi / 180.0),
        "scale": uniform(1.0 - scale_jitter, 1.0 + scale_jitter),
        "oy": randint(0, 2 * max_shift + 1),
        "ox": randint(0, 2 * max_shift + 1),
        "apply": uniform(0.0, 1.0) < occlusion_p,
        "oh": randint(h // 5, h // 2),
        "ow": randint(w // 5, w // 2),
        "cy": randint(0, h),
        "cx": randint(0, w),
    }


def _bilinear_nearest(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")`` per
    sample: x [N, H, W] sampled at (ys, xs) [N, H, W]; the two integer
    neighbours of each coordinate clip to [0, size - 1] (so a coordinate
    off the edge reads the edge), weighted as the reference weights them
    and summed in its order."""
    n, h, w = x.shape
    flat = x.reshape(n, h * w)
    fy, fx = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - fy, xs - fx
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = fy.long(), fx.long()
    rows = (iy0.clamp(0, h - 1), (iy0 + 1).clamp(0, h - 1))
    cols = (ix0.clamp(0, w - 1), (ix0 + 1).clamp(0, w - 1))

    def at(iy, ix):
        return torch.gather(flat, 1, (iy * w + ix).reshape(n, -1)).reshape(n, h, w)

    return ((wy0 * wx0) * at(rows[0], cols[0]) + (wy0 * wx1) * at(rows[0], cols[1])
            + (wy1 * wx0) * at(rows[1], cols[0]) + (wy1 * wx1) * at(rows[1], cols[1]))


def augment_transform(x: torch.Tensor, draws: Dict[str, torch.Tensor],
                      max_shift: int = 3) -> torch.Tensor:
    """The reference's ``augment_batch`` given its draws, on standardized
    [N, H, W] faces: flip, the rotation + scale resample about the centre
    (bilinear, edges held), the shift (an edge-padded crop at the drawn
    offsets), then the cutout filled with 0 (the mean of a standardized
    face)."""
    n, h, w = x.shape
    dev = x.device
    x = torch.where(draws["flip"][:, None, None], x.flip(-1), x)
    cy0, cx0 = (h - 1) / 2.0, (w - 1) / 2.0
    y0 = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] - cy0
    x0 = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] - cx0
    cos_a = torch.cos(draws["angle"])[:, None, None]
    sin_a = torch.sin(draws["angle"])[:, None, None]
    s = draws["scale"][:, None, None]
    ys = (cos_a * y0 + sin_a * x0) / s + cy0
    xs = (-sin_a * y0 + cos_a * x0) / s + cx0
    x = _bilinear_nearest(x, ys, xs)
    pad = max_shift
    xp = F.pad(x[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    rows = draws["oy"][:, None] + torch.arange(h, device=dev)
    cols = draws["ox"][:, None] + torch.arange(w, device=dev)
    x = xp[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    cy, cx = draws["cy"][:, None, None], draws["cx"][:, None, None]
    box = ((yy >= cy) & (yy < cy + draws["oh"][:, None, None])
           & (xx >= cx) & (xx < cx + draws["ow"][:, None, None]))
    return torch.where(box & draws["apply"][:, None, None], torch.zeros_like(x), x)


def cosine_decay(steps: int, alpha: float = 0.01) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``'s multiplier of the initial rate at
    step ``i`` (a ``LambdaLR`` lambda): ``(1 - alpha) * (1 + cos(pi *
    min(i, steps) / steps)) / 2 + alpha``."""
    if steps <= 0:
        raise ValueError(f"cosine decay needs positive steps, got {steps}")

    def factor(i: int) -> float:
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(i, steps) / steps)) + alpha

    return factor


def make_train_step(model: FaceEmbedNet, head: torch.Tensor, optimizer,
                    margin: float = 0.5, scale: float = 32.0, augment: bool = False):
    """``step(x, y, draws, margin_scale) -> loss``: one ArcFace step that
    updates ``model``'s parameters and ``head`` [C, E] (both in
    ``optimizer``) in place. ``augment`` applies ``augment_transform``
    with ``draws`` first; ``margin_scale`` in [0, 1] ramps the angular
    margin. After the step each parameter's ``.grad`` holds its gradient."""

    def step(x: torch.Tensor, y: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]],
             margin_scale: float) -> torch.Tensor:
        if augment:
            x = augment_transform(x, draws)
        optimizer.zero_grad(set_to_none=True)
        loss = arcface_loss(model(x), y, head, margin * margin_scale, scale)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def draw_head(num_classes: int, embed_dim: int, seed: int) -> torch.Tensor:
    """A fresh ArcFace head [C, E] (standard normal from ``seed``)."""
    return torch.randn(num_classes, embed_dim, generator=torch.Generator().manual_seed(seed))


def init_embedder(model: FaceEmbedNet, num_classes: int, input_shape: Tuple[int, int],
                  seed: int = 0) -> torch.Tensor:
    """Initialize ``model``'s weights from ``seed`` in place (LeCun-normal
    convs and dense, unit GroupNorm scales, zero biases) and return a
    fresh head [num_classes, embed_dim] drawn from ``seed + 1``."""
    if tuple(input_shape) != model.input_size:
        raise ValueError(f"input_shape {tuple(input_shape)} is not the net's "
                         f"{model.input_size}")
    reset_all(model, torch.Generator().manual_seed(seed))
    return draw_head(num_classes, model.embed_dim, seed + 1)


def train_embedder(model: FaceEmbedNet, head: torch.Tensor, images, labels, *,
                   steps: int = 200, batch_size: int = 64, learning_rate: float = 1e-3,
                   margin: float = 0.5, scale: float = 32.0, seed: int = 0,
                   augment: bool = False, lr_schedule: str = "constant",
                   log_every: int = 0,
                   callback: Optional[Callable[[int, torch.Tensor], None]] = None
                   ) -> torch.Tensor:
    """ArcFace steps over shuffled fixed-size batches on ``model``'s
    device; ``model`` is trained in place and the trained head returned.

    ``images`` are standardized faces [N, H, W]; ``labels`` 0-based. The
    batches are the reference's, index for index (one numpy
    ``default_rng(seed)``, drawn up front and uploaded once); the data
    stays on the device. ``lr_schedule="cosine"`` decays to lr / 100 over
    ``steps``; the margin ramps from 0 to full over the first 10% of
    steps. ``callback(i, loss)`` runs after step ``i`` (the loss stays a
    device tensor)."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        disable_tf32()
    head = head.detach().to(dev, torch.float32).clone().requires_grad_(True)
    if steps <= 0:
        return head.detach()
    x = torch.as_tensor(images, dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.long).to(dev)
    optimizer = adam([*model.parameters(), head], learning_rate)
    schedule = (torch.optim.lr_scheduler.LambdaLR(optimizer, cosine_decay(steps))
                if lr_schedule == "cosine" else None)
    step = make_train_step(model, head, optimizer, margin, scale, augment=augment)
    n = x.shape[0]
    batch_size = min(batch_size, n)
    batches = fixed_batches(n, batch_size, steps, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    warmup = max(1, int(0.1 * steps))  # margin ramp: 0 -> full over 10%
    h, w = x.shape[1:]
    for i in range(steps):
        idx = batches[i]
        draws = augment_draws(gen, batch_size, h, w) if augment else None
        loss = step(x[idx], y[idx], draws, min(1.0, i / warmup))
        if schedule is not None:
            schedule.step()
        if callback is not None:
            callback(i, loss)
        if log_every and (i + 1) % log_every == 0:
            print(f"  arcface step {i + 1}/{steps}: loss {float(loss):.4f}")
    return head.detach()


def normalize_faces(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Serving-path face normalization: resize + per-image standardize
    (population std, as ``jnp.std``)."""
    x = image_ops.resize(x.to(torch.float32), size)
    mean = x.mean(dim=(-2, -1), keepdim=True)
    std = torch.clamp(x.std(dim=(-2, -1), keepdim=True, correction=0), min=1e-6)
    return (x - mean) / std


class CNNEmbedding(AbstractFeature):
    """The CNN embedder behind the ``AbstractFeature`` boundary: port of the
    JAX package's ``CNNEmbedding``.

    ``compute(X, y)`` trains the net with ArcFace for ``train_steps``
    steps on ``device`` (fine-tuning the weights it holds: loaded ones, or
    its seeded init) and returns the embeddings; with ``train_steps == 0``
    it embeds with the weights it holds. ``extract`` embeds faces (resize
    to ``input_size`` + standardize, the net, optional flip test-time
    augmentation). The state is the reference's: flat ``net/<flax path>``
    arrays plus the ArcFace ``head``, so a checkpoint written by either
    package loads in the other. Without loaded weights the net holds the
    port's own seeded init, which is not flax's init for the same seed
    (ROADMAP C.5, C.22). ``train_callback(i, loss)``, when set, runs after
    each training step (not part of the config).
    """

    name = "cnn_embedding"
    sample_ndim = 2

    def __init__(self, embed_dim: int = 128, input_size: Tuple[int, int] = (112, 112),
                 stem_features: int = 32,
                 stage_features: Sequence[int] = (64, 128, 128),
                 stage_blocks: Sequence[int] = (2, 2, 2), block: str = "separable",
                 space_to_depth: int = 1, norm: str = "full", train_steps: int = 200,
                 batch_size: int = 64, learning_rate: float = 1e-3, seed: int = 0,
                 augment: bool = False, lr_schedule: str = "constant",
                 tta: bool = False, device: DeviceLike = DEFAULT_DEVICE):
        self.embed_dim = int(embed_dim)
        self.input_size = tuple(int(v) for v in input_size)
        self.stem_features = int(stem_features)
        self.stage_features = tuple(int(v) for v in stage_features)
        self.stage_blocks = tuple(int(v) for v in stage_blocks)
        self.block = str(block)
        self.space_to_depth = int(space_to_depth)
        self.norm = str(norm)
        self.train_steps = int(train_steps)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.seed = int(seed)
        self.augment = bool(augment)
        self.lr_schedule = str(lr_schedule)
        self.tta = bool(tta)
        self.device = resolve_device(device)
        self.net = FaceEmbedNet(
            embed_dim=self.embed_dim, stem_features=self.stem_features,
            stage_features=self.stage_features, stage_blocks=self.stage_blocks,
            block=self.block, space_to_depth=self.space_to_depth, norm=self.norm,
            input_size=self.input_size,
            generator=torch.Generator().manual_seed(self.seed)).to(self.device).eval()
        #: the ArcFace head [classes, embed_dim] (training scaffold, kept in
        #: the state); None until weights are loaded or computed
        self._head: Optional[torch.Tensor] = None
        self.train_callback: Optional[Callable[[int, torch.Tensor], None]] = None

    # -- feature protocol --
    def compute(self, X, y):
        if isinstance(X, (list, tuple)):
            X = np.stack([np.asarray(v) for v in X])
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32)
        y = np.asarray(y, dtype=np.int32)
        # 0-based contiguous labels size the head: sparse labels ({5, 900})
        # must not allocate a 901-row head (the reference's remap)
        if len(y):
            classes, y = np.unique(y, return_inverse=True)
            y = y.reshape(-1).astype(np.int32)
            num_classes = len(classes)
        else:
            num_classes = 1
        if self._head is None or self._head.shape[0] != num_classes:
            self._head = draw_head(num_classes, self.embed_dim, self.seed + 1)
        if self.train_steps > 0:
            with torch.no_grad():
                x = normalize_faces(X.to(self.device), self.input_size)
            self._head = train_embedder(
                self.net, self._head, x, y, steps=self.train_steps,
                batch_size=self.batch_size, learning_rate=self.learning_rate,
                seed=self.seed, augment=self.augment, lr_schedule=self.lr_schedule,
                callback=self.train_callback).cpu()
        return self._extract_batch(X)

    @torch.no_grad()
    def _extract_batch(self, X: torch.Tensor) -> torch.Tensor:
        if self._head is None:
            raise RuntimeError("CNNEmbedding.extract called before compute()")
        x = normalize_faces(X.to(self.device), self.input_size)
        emb = self.net(x)
        if self.tta:
            # flip test-time augmentation: average with the mirrored view
            emb = emb + self.net(x.flip(-1))
            emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True),
                                    min=1e-12)
        return emb

    def load_params(self, params: Dict[str, Any]) -> None:
        """Install pretrained ``{"net": flax tree, "head": [C, E]}`` params
        (the JAX package's layout)."""
        embedder_params_from_flax(params["net"], self.net)
        self._head = torch.as_tensor(np.array(params["head"], np.float32))

    # -- serialization protocol --
    def get_config(self):
        return {
            "embed_dim": self.embed_dim, "input_size": list(self.input_size),
            "stem_features": self.stem_features,
            "stage_features": list(self.stage_features),
            "stage_blocks": list(self.stage_blocks), "block": self.block,
            "space_to_depth": self.space_to_depth, "norm": self.norm,
            "train_steps": self.train_steps, "batch_size": self.batch_size,
            "learning_rate": self.learning_rate, "seed": self.seed,
            "augment": self.augment, "lr_schedule": self.lr_schedule, "tta": self.tta,
        }

    @classmethod
    def from_config(cls, config, device: DeviceLike = DEFAULT_DEVICE):
        """The reference's defaults for keys that older checkpoints lack."""
        config = dict(config)
        config["input_size"] = tuple(config.get("input_size", (112, 112)))
        config["stage_features"] = tuple(config.get("stage_features", (64, 128, 128)))
        config["stage_blocks"] = tuple(config.get("stage_blocks", (2, 2, 2)))
        config.setdefault("block", "separable")
        config.setdefault("space_to_depth", 1)
        config.setdefault("norm", "full")
        config.setdefault("augment", False)
        config.setdefault("lr_schedule", "constant")
        config.setdefault("tta", False)
        return cls(**config, device=device)

    def get_state(self):
        """``{"head": [C, E], "net/<flax path>": array, ...}`` (float32)."""
        if self._head is None:
            return {}
        state = {"head": self._head.detach().float().cpu().numpy()}

        def walk(prefix: str, node) -> None:
            for key, value in node.items():
                if isinstance(value, dict):
                    walk(f"{prefix}/{key}", value)
                else:
                    state[f"{prefix}/{key}"] = value

        walk("net", embedder_params_to_flax(self.net))
        return state

    def set_state(self, state):
        if not state:
            return
        net: Dict[str, Any] = {}
        for key, leaf in state.items():
            if key == "head":
                continue
            parts = key.split("/")[1:]
            node = net
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        self.load_params({"net": net, "head": state["head"]})
