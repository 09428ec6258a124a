"""The per-layer readers on a made-up slice: each reading against a hand
count, and nothing read where the slice or the spans hold nothing."""

import numpy as np
import pytest

import readings
import roofline
import run
from devtrace import DeviceSlice

CFG = run.load_json(run.HERE / "configs" / "serve_8m.json")
A, B, C = (f"void (anonymous namespace)::{k}<1>(...)" for k in
           (roofline.KERNEL_A, roofline.KERNEL_B, roofline.KERNEL_C))


def _slice(steps=10, a_ms=4.0, b_ms=0.05, gap_ms=2.0):
    """``steps`` steps back to back, each C, A and six B launches, then an
    idle gap; the slice ends after the last gap."""
    names, start, end, t = [], [], [], 0.0
    for _ in range(steps):
        for name, ms in [(C, 0.03), (A, a_ms)] + [(B, b_ms)] * 6:
            names.append(name)
            start.append(t)
            end.append(t + ms / 1e3)
            t += ms / 1e3
        t += gap_ms / 1e3
    return DeviceSlice(names, np.asarray(start), np.asarray(end), 0.0, t)


def _ctx(sl, rungs, flops=1e12):
    spans = {"dispatch": [{"t0": sl.t0 + i * 1e-4, "dur": 1e-3, "exit": "full", "bucket": b}
                          for i, b in enumerate(rungs)]
                         + [{"t0": sl.t1 + 1.0, "dur": 9.0, "exit": "full", "bucket": 8}]}
    return readings.Context(CFG, spans, sl, lambda b: flops * b / 32)


def test_kernel_a_roofline_at_the_slice_s_rungs():
    sl = _slice(a_ms=4.0)
    ctx = _ctx(sl, [32] * 8 + [8] * 2)  # the span after the slice is not read
    rows, dim = CFG["gallery"]["rows"], CFG["gallery"]["dim"]
    full = 2 * 512 * rows * dim / 989e12  # operations bound it at 512 queries
    # at 128 queries the 4 GiB of rows take longer than the products
    part = (rows * dim * 2 + 128 * dim * 4 + rows + 128 * 8) / 3.35e12
    assert part > 2 * 128 * rows * dim / 989e12
    want = (0.8 * full + 0.2 * part) / 4e-3
    assert readings.kernel_a_roofline_pct(ctx) == pytest.approx(100 * want)


def test_kernel_b_roofline_is_a_forward_over_a_step_s_launches():
    sl = _slice(b_ms=0.05)
    blocks = roofline.sep_blocks((64, 64), 32, (64, 128, 256), (2, 2, 2))
    bound, _ = roofline.sepblock_bound_s(512, blocks)
    got = readings.kernel_b_roofline_pct(_ctx(sl, [32] * 10))
    assert got == pytest.approx(100 * bound / 0.3e-3)


def test_step_readings_and_idle_share():
    sl = _slice(steps=10, a_ms=4.0, b_ms=0.05, gap_ms=2.0)
    ctx = _ctx(sl, [32] * 10, flops=2e12)
    busy_ms = 0.03 + 4.0 + 6 * 0.05
    assert readings.step_device_ms(ctx) == pytest.approx(busy_ms)
    assert readings.idle_share_pct(ctx) == pytest.approx(100 * 2.0 / (busy_ms + 2.0))
    assert readings.step_mfu_pct(ctx) == pytest.approx(
        100 * 10 * 2e12 / (10 * busy_ms / 1e3) / 989e12)


def test_nothing_to_read_is_none():
    empty = readings.Context(CFG, {}, None, lambda b: 1.0)
    for read in (readings.step_device_ms, readings.idle_share_pct, readings.step_mfu_pct,
                 readings.kernel_a_roofline_pct, readings.kernel_b_roofline_pct,
                 readings.publish_ms):
        assert read(empty) is None
    assert readings.span_median_ms(empty, "dispatch") is None
    # a slice in which no step was dispatched reads no share of a bound
    assert readings.kernel_a_roofline_pct(_ctx(_slice(), [])) is None
