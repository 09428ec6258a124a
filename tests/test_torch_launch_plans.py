"""The launch plans the port's kernel wrappers compute in Python, on the
CPU: how kernel A splits the gallery over CTAs and passes, which path a
gallery takes, and how many persistent CTAs kernel B launches. The
kernels index exactly as these plans say, so every gallery row and every
sample must be covered exactly once, for ragged sizes too. (Kernel B's
instantiation is chosen by its library, ``sepblock_plan``; the GPU tests
check it.)"""

import pytest
import torch

from opencv_facerecognizer_tpu_torch.ops import sepblock as sb
from opencv_facerecognizer_tpu_torch.ops import streaming_match as sm


@pytest.mark.parametrize("path", ["wgmma", "wmma"])
@pytest.mark.parametrize("k", [1, 5, 17])
@pytest.mark.parametrize("qn,n", [(512, 1 << 20), (512, 70001), (37, 301),
                                  (1, 1), (77, 128), (77, 129), (5000, 4097),
                                  (40000, 1000)])
def test_match_plan_covers_every_row_once(path, k, qn, n):
    sms = 132
    splits, rows = sm.launch_plan(qn, n, path, sms, k)
    q_tiles = -(-qn // sm.block_q(path, k))
    block_n = sm.BLOCK_N[path]
    assert rows % block_n == 0 and splits >= 1
    assert q_tiles * sm.block_q(path, k) >= qn > (q_tiles - 1) * sm.block_q(path, k)
    seen = []
    for s in range(splits):
        begin, end = s * rows, min(n, (s + 1) * rows)
        assert begin < end, f"split {s} is empty"
        seen.extend(range(begin, end))
    assert seen == list(range(n))  # each row once, in split order
    if path == "wgmma" and q_tiles <= sms:
        assert q_tiles * splits <= sms  # one wave: a CTA per SM


@pytest.mark.parametrize("k", list(range(1, 40)) + [63, 64, 65, 128, 255, 256])
def test_kpad_and_passes_cover_k(k):
    kp = sm.kpad(k)
    assert kp & (kp - 1) == 0 and kp <= sm.ROUND_K
    passes = -(-k // kp)
    if k <= sm.ROUND_K:
        assert kp >= k and passes == 1
    else:
        assert kp == sm.ROUND_K and passes * kp >= k > (passes - 1) * kp
    assert k <= sm.MAX_K


def test_match_path_selection():
    assert sm.match_path(torch.bfloat16, 256) == "wgmma"
    assert sm.match_path(torch.bfloat16, 64) == "wgmma"
    assert sm.match_path(torch.bfloat16, 256, aligned=False) == "wmma"
    assert sm.match_path(torch.float32, 256) == "wmma"  # TMA cannot cast
    assert sm.match_path(torch.bfloat16, 48) == "wmma"  # not whole 64-dim boxes
    assert sm.match_path(torch.bfloat16, 320) == "wmma"  # past the shared memory
    assert sm.block_q("wgmma", 1) == 256 and sm.block_q("wgmma", 2) == 128
    assert sm.block_q("wmma", 1) == sm.block_q("wmma", 64) == 128


def test_plain_matcher_has_no_k_limit():
    """Only the kernel stops at MAX_K; the CPU's plain version takes any k
    (the reference's semantics)."""
    g = torch.randn(400, 16)
    vals, idx = sm.streaming_match_topk(torch.randn(3, 16), g,
                                        torch.ones(400, dtype=torch.bool), k=300)
    assert vals.shape == idx.shape == (3, 300) and (idx >= 0).all()


@pytest.mark.parametrize("b", [1, 37, 131, 132, 133, 512, 601, 1000])
@pytest.mark.parametrize("ctas_per_sm,sms", [(1, 132), (2, 132), (2, 7)])
def test_sepblock_samples_covered_once(b, ctas_per_sm, sms):
    """CTA i of the persistent grid takes samples i, i + grid, i + 2 grid,
    ... (the kernel's sample loop starts at blockIdx.x and steps by
    gridDim.x)."""
    grid = sb.launch_grid(b, ctas_per_sm, sms)
    assert 1 <= grid <= min(b, ctas_per_sm * sms)
    plan = [list(range(i, b, grid)) for i in range(grid)]
    assert len(plan) == grid and all(plan)  # no idle CTA
    assert sorted(s for cta in plan for s in cta) == list(range(b))
    assert max(map(len, plan)) - min(map(len, plan)) <= 1  # balanced

