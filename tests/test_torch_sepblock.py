"""Fused separable block (kernel B) of the PyTorch port against the JAX
package: the port's plain version on the CPU against the Pallas kernel in
interpret mode, and against the flax ``_SepBlock`` it re-schedules, on
the four block shapes of ``tests/test_pallas_sepblock.py`` and four with
F = 48 or 96.

Tolerances:
- vs the Pallas kernel, f32 activations: the same rounding points, so
  agreement to f32 noise, except where an intermediate sits on a bf16
  rounding boundary (the pointwise operand is rounded to bf16) and the two
  f32 sums round it to neighbouring bf16 values; such a flip moves an
  output by about one bf16 ulp of the activation (``FLIP_ATOL``). The mean
  error stays at f32 noise (``MEAN_ATOL``).
- vs the Pallas kernel, bf16 activations: one bf16 ulp of the output
  (relative 2^-7).
- vs flax: flax rounds every op's output to bf16, the fused block only
  its operands; the JAX test's own bar (atol 3% of the output scale,
  rtol 5%, correlation > 0.9995).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.ops.pallas_sepblock import (
    fused_sep_block as jax_fused_sep_block)
from opencv_facerecognizer_tpu_torch.ops.sepblock import fused_sep_block

CASES = [
    (1, 32, 32, 16),   # residual block
    (1, 32, 64, 16),   # channel change, no residual
    (2, 64, 128, 16),  # downsampling stage head
    (2, 32, 32, 8),    # stride without channel change
    # widths whose 8-channel chunks are not a multiple of 8 (F / 8 = 6, 12)
    (1, 48, 48, 8),
    (2, 32, 48, 16),
    (2, 48, 96, 8),
    (1, 96, 96, 8),
]
FLIP_ATOL = 2e-2
MEAN_ATOL = 1e-4
BF16_RTOL = 2.0 ** -7


def _block(stride, cin, cout, hw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, hw, hw, cin)).astype(np.float32)
    blk = jax_embedder._SepBlock(features=cout, stride=stride)
    params = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x, jnp.bfloat16))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # non-trivial norm params (init is scale 1, bias 0)
    for gn in ("GroupNorm_0", "GroupNorm_1"):
        n = params[gn]["scale"].shape[0]
        params[gn] = {"scale": (0.5 + rng.random(n)).astype(np.float32),
                      "bias": (0.1 * rng.normal(size=n)).astype(np.float32)}
    return x, blk, params


def _jax_args(p):
    return (p["Conv_0"]["kernel"], p["GroupNorm_0"]["scale"], p["GroupNorm_0"]["bias"],
            p["Conv_1"]["kernel"], p["GroupNorm_1"]["scale"], p["GroupNorm_1"]["bias"])


def _port_args(p):
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    return (t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1), t(p["GroupNorm_0"]["scale"]),
            t(p["GroupNorm_0"]["bias"]), t(p["Conv_1"]["kernel"]).permute(3, 2, 0, 1),
            t(p["GroupNorm_1"]["scale"]), t(p["GroupNorm_1"]["bias"]))


@pytest.mark.parametrize("stride,cin,cout,hw", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel(stride, cin, cout, hw, dtype):
    x, _blk, params = _block(stride, cin, cout, hw)
    res = stride == 1 and cin == cout
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_fused_sep_block(
        xj, *map(jnp.asarray, _jax_args(params)), stride=stride, residual=res,
        interpret=True, block_b=2), np.float32)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = fused_sep_block(xt, *_port_args(params), stride=stride, residual=res)
    assert got.dtype == xt.dtype and got.shape == want.shape
    got = got.float().numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= FLIP_ATOL, err.max()
        assert err.mean() <= MEAN_ATOL, err.mean()
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL)


@pytest.mark.parametrize("stride,cin,cout,hw", CASES)
def test_matches_flax_block(stride, cin, cout, hw):
    x, blk, params = _block(stride, cin, cout, hw)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(blk.apply({"params": params}, xj), np.float32)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = fused_sep_block(xt, *_port_args(params), stride=stride,
                          residual=(stride == 1 and cin == cout)).float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=0.03 * scale, rtol=0.05)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9995


def test_rejects_what_the_block_cannot_be():
    x = torch.zeros(1, 9, 9, 8)
    args = (torch.zeros(8, 1, 3, 3), torch.ones(8), torch.zeros(8),
            torch.zeros(8, 8, 1, 1), torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="even"):
        fused_sep_block(x, *args, stride=2)
    with pytest.raises(ValueError, match="residual"):
        fused_sep_block(torch.zeros(1, 8, 8, 8), *args, stride=2, residual=True)

