"""The yardstick's counts against hand counts at the serving shapes."""

import pytest

import roofline
import run
import stepflops


def test_kernel_a_bound_at_the_serving_shapes():
    # 2 x 512 queries x 2^20 rows x 256 dims = 2.749e11 FLOP at 989e12 FLOP/s
    t, by = roofline.kernel_a_bound_s(512, 1 << 20, 256)
    assert by == "operations" and t == pytest.approx(2.7794e-4, rel=1e-4)
    # the rows alone are 512 MiB: 0.160 ms at 3.35e12 B/s, under the operations
    assert (1 << 20) * 256 * 2 / 3.35e12 < t
    t8, by8 = roofline.kernel_a_bound_s(512, 1 << 23, 256)
    assert by8 == "operations" and t8 == pytest.approx(2.2235e-3, rel=1e-4)


def test_kernel_b_bound_at_the_serving_shapes():
    blocks = roofline.sep_blocks((64, 64), 32, (64, 128, 256), (2, 2, 2))
    assert blocks == [(32, 32, 32, 64, 2), (16, 16, 64, 64, 1), (16, 16, 64, 128, 2),
                      (8, 8, 128, 128, 1), (8, 8, 128, 256, 2), (4, 4, 256, 256, 1)]
    # block 1 by hand: 512 x 32 x 32 x 32 bf16 in, 512 x 16 x 16 x 64 bf16 out,
    # (9 x 32 + 2 x 32 + 2 x 64 + 32 x 64) f32 parameters
    b1 = 512 * 32 * 32 * 32 * 2 + 512 * 16 * 16 * 64 * 2 + (9 * 32 + 64 + 128 + 2048) * 4
    t1, _ = roofline.sepblock_bound_s(512, blocks[:1])
    assert t1 == pytest.approx(b1 / 3.35e12)
    t, by = roofline.sepblock_bound_s(512, blocks)
    assert by == "bytes" and t == pytest.approx(4.3986e-5, rel=1e-3)


def _conv(out_elems, in_per_group, kh, kw):
    return 2 * out_elems * in_per_group * kh * kw


def test_step_flops_match_a_hand_count():
    cfg = run.load_json(run.HERE / "configs" / "serve_1m.json")
    n, k = 32, 16
    det = (_conv(n * 64 * 32 * 32, 16, 3, 3) + 3 * _conv(n * 64 * 32 * 32, 64, 3, 3)
           + _conv(n * 64 * 32 * 32, 64, 3, 3) + _conv(n * 5 * 32 * 32, 64, 1, 1))
    crop = 2 * n * k * 64 * 256 * 256 + 2 * n * k * 64 * 64 * 256
    m = n * k
    emb = _conv(m * 32 * 32 * 32, 1, 3, 3)
    for h, w, c, f, s in roofline.sep_blocks((64, 64), 32, (64, 128, 256), (2, 2, 2)):
        p = (h // s) * (w // s)
        emb += _conv(m * c * p, 1, 3, 3) + _conv(m * f * p, c, 1, 1)
    emb += _conv(m * 256, 1, 4, 4) + 2 * m * 256 * 256
    assert stepflops.nets_flops(cfg, n) == det + crop + emb
    assert stepflops.step_flops(cfg, n) == det + crop + emb + 2 * m * (1 << 20) * 256
