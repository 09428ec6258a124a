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
    fused_sep_block, fused_sep_block_plain, launch_info)
from opencv_facerecognizer_tpu_torch.ops.streaming_match import (
    MAX_K, NEG_INF, streaming_match_topk, streaming_match_topk_plain)
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery

SIM_ATOL = 1e-4
SEP_RTOL = 2.0 ** -6
#: the six (H, W, C, F, stride) blocks of the serving embedder at 64x64
SERVING_BLOCKS = [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1),
                  (16, 16, 64, 128, 2), (8, 8, 128, 128, 1),
                  (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
#: kernel B's streaming batch: over twice the largest grid (2 x 132 CTAs)
SEP_STREAM_B = 601
#: blocks whose F / 8 is not a multiple of 8 (F = 48, 96), stride 1 and 2
OTHER_BLOCKS = [(32, 32, 32, 48, 2), (16, 16, 48, 48, 1), (16, 16, 48, 96, 2),
                (8, 8, 96, 96, 1), (16, 16, 96, 96, 1)]


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
    for k in (1, 5, 16, 17, 64):
        got_v, got_i = streaming_match_topk(q, g, valid, k=k)
        want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
        torch.cuda.synchronize()
        assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
        assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
        lowest = torch.where(valid[60000:60077], 60000, 65000) + torch.arange(77, device=cuda)
        assert torch.equal(got_i[:, 0].long(), lowest)


def _assert_match(cuda, q, g, valid, k):
    got_v, got_i = streaming_match_topk(q, g, valid, k=k)
    want_v, want_i = streaming_match_topk_plain(q, g, valid, k=k)
    torch.cuda.synchronize()
    assert got_v.shape == (q.shape[0], k) and got_i.dtype == torch.int32
    assert torch.allclose(got_v, want_v, atol=SIM_ATOL, rtol=0)
    assert not ((got_i != want_i) & ((got_v - want_v).abs() > SIM_ATOL)).any()
    return got_v, got_i


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [100, 128, 129, 257, 4097])
@pytest.mark.parametrize("d", [64, 256, 48])
def test_match_kernel_ragged_n(cuda, gdtype, n, d):
    """N below one tile, on a tile edge and one row past it, on both
    paths (D = 48 takes the wmma path for either dtype)."""
    rng = np.random.default_rng(n + d)
    q = torch.tensor(_normed(rng, (37, d)), device=cuda)
    g = torch.tensor(_normed(rng, (n, d)), device=cuda).to(gdtype)
    valid = torch.tensor(rng.random(n) > 0.2, device=cuda)
    for k in (1, 5, 17):
        _assert_match(cuda, q, g, valid, k)


@pytest.mark.gpu
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [5, 16, 17, 64])
def test_match_kernel_sentinels(cuda, gdtype, k):
    """Fewer valid rows than k: the rows in value order, then -1e30 / -1."""
    rng = np.random.default_rng(k)
    q = torch.tensor(_normed(rng, (20, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (3000, 256)), device=cuda).to(gdtype)
    valid = torch.zeros(3000, dtype=torch.bool, device=cuda)
    rows = rng.choice(3000, size=3 if k == 5 else k - 4, replace=False)
    valid[torch.tensor(rows, device=cuda)] = True
    got_v, got_i = _assert_match(cuda, q, g, valid, k)
    m = len(rows)
    assert torch.equal(torch.sort(got_i[:, :m].long(), dim=1)[0],
                       torch.sort(torch.tensor(rows, device=cuda))[0].expand(20, -1))
    assert (got_i[:, m:] == -1).all() and (got_v[:, m:] == NEG_INF).all()


@pytest.mark.gpu
def test_match_kernel_ties_across_passes(cuda):
    """Ten copies of each query: every pass boundary (k = 17, 64) falls
    inside a run of equal sims, which must still come out lowest index
    first."""
    rng = np.random.default_rng(9)
    q = torch.tensor(_normed(rng, (8, 256)), device=cuda)
    g = torch.tensor(_normed(rng, (20000, 256)), device=cuda)
    copies = torch.tensor(np.sort(rng.choice(20000, size=(8, 10), replace=False), axis=1),
                          device=cuda)
    for i in range(8):
        g[copies[i]] = q[i]
    g = g.to(torch.bfloat16)
    valid = torch.ones(20000, dtype=torch.bool, device=cuda)
    for k in (1, 16, 17, 64):
        got_v, got_i = _assert_match(cuda, q, g, valid, k)
        m = min(k, 10)
        assert torch.equal(got_i[:, :m].long(), copies[:, :m])


@pytest.mark.gpu
def test_match_kernel_refuses_k_past_limit(cuda):
    q = torch.randn(4, 64, device=cuda)
    g = torch.randn(300, 64, device=cuda)
    with pytest.raises(ValueError, match=str(MAX_K)):
        streaming_match_topk(q, g, torch.ones(300, dtype=torch.bool, device=cuda),
                             k=MAX_K + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("store_dtype", [torch.bfloat16, torch.float32])
def test_gallery_match_k17_on_kernel(cuda, store_dtype):
    """The public gallery at capacity >= 65536 runs the kernel; k = 17
    (past the one-pass limit) answers as the plain matcher does."""
    rng = np.random.default_rng(17)
    rows = _normed(rng, (70000, 256))
    labels = np.arange(70000, dtype=np.int32)
    gal = ShardedGallery(70000, 256, store_dtype=store_dtype, device=cuda)
    gal.add(rows, labels)
    assert gal.kernel_enabled()
    q = rows[[5, 60000, 69999]]
    before = streaming_match_topk.launches
    lab, sims, idx = gal.match(q, k=17)
    torch.cuda.synchronize()
    assert streaming_match_topk.launches == before + 1
    assert lab.shape == sims.shape == idx.shape == (3, 17)
    data = gal._data
    want_v, want_i = streaming_match_topk_plain(
        torch.tensor(q, device=cuda), data.embeddings, data.valid, k=17)
    assert torch.allclose(sims, want_v, atol=SIM_ATOL, rtol=0)
    assert not ((idx != want_i) & ((sims - want_v).abs() > SIM_ATOL)).any()
    assert idx[:, 0].tolist() == [5, 60000, 69999]


def _sep_inputs(cuda, b, h, w, c, f, stride, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(cuda, dtype)
    args = [torch.randn(c, 1, 3, 3, generator=g) * 0.3, torch.rand(c, generator=g) + 0.5,
            torch.randn(c, generator=g) * 0.1, torch.randn(f, c, 1, 1, generator=g) / c ** 0.5,
            torch.rand(f, generator=g) + 0.5, torch.randn(f, generator=g) * 0.1]
    return x, [a.to(cuda) for a in args], stride == 1 and c == f


def _assert_sep(cuda, b, h, w, c, f, stride, dtype, seed):
    x, args, res = _sep_inputs(cuda, b, h, w, c, f, stride, dtype, seed)
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs()
    assert (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all(), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", SERVING_BLOCKS)
def test_sepblock_kernel_serving_shapes(cuda, h, w, c, f, stride, dtype):
    """The six serving blocks at B = 37, fewer samples than CTAs."""
    _assert_sep(cuda, 37, h, w, c, f, stride, dtype, c + f + stride)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", SERVING_BLOCKS)
def test_sepblock_kernel_streams_samples(cuda, h, w, c, f, stride, dtype):
    """B = 601, more than twice the CTAs of a full grid and not a multiple
    of it: every CTA streams two or more samples (through both buffers in
    bf16; in f32 restaging its one buffer and reading the residual of
    samples past its first). A sample's arithmetic does not depend on the
    CTA or the turn that runs it, so each output must equal, bit for bit,
    the one the sample gets as the only sample of its CTA (launches of 100
    samples); in bf16 the output is also held against the plain version."""
    x, args, res = _sep_inputs(cuda, SEP_STREAM_B, h, w, c, f, stride, dtype,
                               c + f + stride)
    got = fused_sep_block(x, *args, stride=stride, residual=res)
    alone = torch.cat([fused_sep_block(x[i:i + 100], *args, stride=stride, residual=res)
                       for i in range(0, SEP_STREAM_B, 100)])
    assert launch_info(x[:100], f, stride)["grid"] == 100
    assert launch_info(x, f, stride)["grid"] * 2 < SEP_STREAM_B
    assert torch.equal(got, alone)
    if dtype == torch.bfloat16:
        want = fused_sep_block_plain(x, *args, stride=stride, residual=res)
        err = (got.float() - want.float()).abs()
        assert (err <= SEP_RTOL * want.float().abs().clamp(min=1.0)).all(), err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c,f,stride", OTHER_BLOCKS)
def test_sepblock_kernel_other_widths(cuda, h, w, c, f, stride, dtype):
    """F = 48 and 96: rows of 6 and 12 eight-channel chunks, which the
    bf16 output staging must swizzle within the row."""
    _assert_sep(cuda, SEP_STREAM_B, h, w, c, f, stride, dtype, c + f + stride)


@pytest.mark.gpu
def test_sepblock_kernel_instantiations(cuda):
    """The library picks the instantiation whose registers hold a block
    (the two 256- and 512-thread ones at the serving shapes) and refuses
    a shape none holds."""
    variants = [launch_info(torch.empty(1, h, w, c, dtype=torch.bfloat16, device=cuda),
                            f, stride)["variant"] for h, w, c, f, stride in SERVING_BLOCKS]
    assert variants == [1, 1, 0, 1, 0, 0]
    with pytest.raises(ValueError, match="cannot take"):
        launch_info(torch.empty(1, 64, 64, 64, dtype=torch.bfloat16, device=cuda), 64, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c,f,stride", [(32, 32, 64, 2), (16, 64, 64, 1),
                                          (4, 256, 256, 1)])
def test_sepblock_kernel_matches_plain(cuda, h, c, f, stride, dtype):
    _assert_sep(cuda, 64, h, h, c, f, stride, dtype, 0)


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
