"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on the
card's machine, which has no JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: kernel A sums the same bf16 products in f32 in another order
(sims within 1e-4, indices equal except ties within it); kernel B outputs
bf16 and may round an intermediate to a neighbouring bf16 value (two bf16
ulps of the output, relative 2^-6).
"""

import numpy as np
import pytest
import torch

from opencv_facerecognizer_tpu_torch.ops.sepblock import (
    fused_sep_block, fused_sep_block_plain)
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    streaming_match_topk, streaming_match_topk_plain)

SIM_ATOL = 1e-4
SEP_RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _normed(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
def test_match_kernel_matches_plain(cuda, gdtype):
    rng = np.random.default_rng(5)
    q = torch.tensor(_normed(rng, (77, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (70000, 256)), device=cuda)
    g[60000:60077] = q  # planted, then duplicated: exact ties
    g[65000:65077] = q
    valid = torch.tensor(rng.random(70000) > 0.1, device=cuda)
    valid[65000:65077] = True
    g = g.to(gdtype)
    for k in (1, 5):
        got_v, got_i = streaming_match_topk(q, g, valid, k=k)
        want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
        torch.cuda.synchronize()
        assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
        assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
        lowest = torch.where(valid[60000:60077], 60000, 65000) + torch.arange(77, device=cuda)
        assert torch.equal(got_i[:, 0].long(), lowest)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c,f,stride", [(32, 32, 64, 2), (16, 64, 64, 1),
                                          (4, 256, 256, 1)])
def test_sepblock_kernel_matches_plain(cuda, h, c, f, stride, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, h, h, c, generator=g).to(cuda, dtype)
    args = [torch.randn(c, 1, 3, 3, generator=g) * 0.3, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.1, torch.randn(f, c, 1, 1, generator=g) / c ** 0.5,
            torch.rand(f, generator=g) + 0.5, torch.randn(f, generator=g) * 0.1]
    args = [a.to(cuda) for a in args]
    res = stride == 1 and c == f
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs()
    assert (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all(), err.max()


@pytest.mark.gpu
def test_wrappers_count_launches(cuda):
    q = torch.randn(8, 16, device=cuda)
    g = torch.randn(64, 16, device=cuda)
    before = streaming_match_topk.launches
    streaming_match_topk(q, g, torch.ones(64, dtype=torch.bool, device=cuda))
    assert streaming_match_topk.launches == before + 1
    before = streaming_match_topk.launches
    streaming_match_topk(q.cpu(), g.cpu(), torch.ones(64, dtype=torch.bool))
    assert streaming_match_topk.launches == before  # the plain version launches nothing
