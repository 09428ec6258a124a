"""The port's latency windows (``utils.histogram``, ``utils.metrics.Metrics``)
against the JAX package's: one sequence of observations, fed to both
packages under one fake clock, gives equal quantiles, fractions, counts,
snapshots, summaries and exports. Tolerance: exact equality (the same
bucket schema and the same float arithmetic in pure Python)."""

import inspect
import math

import numpy as np
import pytest

from opencv_facerecognizer_tpu.utils import histogram as jax_hist
from opencv_facerecognizer_tpu.utils import metrics as jax_metrics
from opencv_facerecognizer_tpu_torch.utils import histogram as port_hist
from opencv_facerecognizer_tpu_torch.utils import metrics as port_metrics

HORIZONS = (None, 1.0, 29.0, 61.0, 300.0, 600.0, 1e4)
QUANTILES = (0, 1, 50, 90, 95, 99, 99.9, 100)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _observations(seed=3, n=3000):
    """(dt, value) pairs: log-normal latencies, the schema's edges (0,
    negatives, values on bucket bounds, past the last bound) and clock
    steps that cross slices and expire some of them. (NaN lands in the
    underflow bucket in both, ``test_bucket_schema_equal``; here it would
    make every sum NaN, which never compares equal.)"""
    rng = np.random.default_rng(seed)
    values = list(np.exp(rng.normal(-5.0, 2.5, n)))
    values += [0.0, -1.0, port_hist.BUCKET_LO, port_hist.BUCKET_HI, 500.0]
    values += list(port_hist.BUCKET_BOUNDS[1:40:3])
    steps = rng.exponential(0.5, len(values))
    steps[rng.random(len(values)) < 0.002] = 200.0  # a lull: slices expire
    return list(zip(steps.tolist(), values))


def test_bucket_schema_equal():
    assert port_hist.BUCKET_BOUNDS == jax_hist.BUCKET_BOUNDS
    for v in (0.0, -3.0, float("nan"), 1e-5, 2e-5, 0.5, 119.9, 120.0, 1e9,
              *jax_hist.BUCKET_BOUNDS[:-1]):
        assert port_hist.bucket_index(v) == jax_hist.bucket_index(v)


@pytest.mark.parametrize("window_s, slices", [(120.0, 8), (600.0, 20), (10.0, 1)])
def test_rolling_histogram_equal_to_reference(window_s, slices):
    clock = FakeClock()
    ref = jax_hist.RollingHistogram(window_s, slices, clock=clock)
    port = port_hist.RollingHistogram(window_s, slices, clock=clock)
    for i, (dt, v) in enumerate(_observations(seed=int(window_s))):
        clock.t += dt
        ref.observe(v)
        port.observe(v)
        if i % 97:
            continue
        for h in HORIZONS:
            for q in QUANTILES:
                a, b = port.quantile(q, h), ref.quantile(q, h)
                assert a == b or (math.isnan(a) and math.isnan(b))
            for thr in (1e-4, 0.01, 0.3, 5.0):
                assert port.fraction_above(thr, h) == ref.fraction_above(thr, h)
            assert port.count(h) == ref.count(h)
            assert port.merged(h).snapshot() == ref.merged(h).snapshot()
    assert port.memory_cells() == ref.memory_cells()
    port.clear()
    ref.clear()
    assert port.count() == ref.count() == 0


def test_metrics_signature_equal():
    assert inspect.signature(port_metrics.Metrics) == inspect.signature(jax_metrics.Metrics)
    for name in ("percentile", "fraction_above", "window_count", "export_state",
                 "reset_window", "gauge", "counters_with_prefix", "sum_counters",
                 "summary", "observe", "incr", "set_gauge", "counter", "counters", "log"):
        # as text: ``gauge``'s NaN default never equals itself
        assert (str(inspect.signature(getattr(port_metrics.Metrics, name)))
                == str(inspect.signature(getattr(jax_metrics.Metrics, name)))), name
    for name in ("window_s", "window_slice_s"):
        assert isinstance(getattr(port_metrics.Metrics, name), property)


def _clocked(metrics, hist_mod, clock):
    metrics._latencies.default_factory = lambda: hist_mod.RollingHistogram(
        metrics.window_s, int(round(metrics.window_s / metrics.window_slice_s)), clock=clock)
    return metrics


@pytest.mark.parametrize("window_s, slices", [(600.0, 20), (60.0, 6)])
def test_metrics_equal_to_reference(window_s, slices):
    clock = FakeClock()
    ref = _clocked(jax_metrics.Metrics(None, window_s, slices), jax_hist, clock)
    port = _clocked(port_metrics.Metrics(None, window_s, slices), port_hist, clock)
    names = ("dispatch", "queue_wait", "e2e_latency")
    for i, (dt, v) in enumerate(_observations(seed=11)):
        clock.t += dt
        for m in (ref, port):
            m.observe(names[i % 3], v)
            m.incr("frames_rejected_rate" if i % 5 else "frames_processed", 1.0)
            m.set_gauge("batcher_flush_deadline_ms", float(i))
        if i % 211:
            continue
        assert port.summary() == ref.summary()
        for name in (*names, "never_observed"):
            for h in HORIZONS:
                for q in (50, 95, 99):
                    a, b = port.percentile(name, q, horizon_s=h), ref.percentile(
                        name, q, horizon_s=h)
                    assert a == b or (math.isnan(a) and math.isnan(b))
                assert port.window_count(name, h) == ref.window_count(name, h)
                assert (port.fraction_above(name, 0.01, h)
                        == ref.fraction_above(name, 0.01, h))
        assert port.export_state() == ref.export_state()
    assert port.window_s == ref.window_s and port.window_slice_s == ref.window_slice_s
    assert port.gauge("batcher_flush_deadline_ms") == ref.gauge("batcher_flush_deadline_ms")
    assert math.isnan(port.gauge("nope")) and math.isnan(ref.gauge("nope"))
    assert port.counters_with_prefix("frames_") == ref.counters_with_prefix("frames_")
    assert (port.sum_counters(["frames_processed"], ["frames_rejected_rate"])
            == ref.sum_counters(["frames_processed"], ["frames_rejected_rate"]))
    for m in (ref, port):
        m.reset_window("dispatch")
    assert port.summary() == ref.summary()
    assert port.summary()["dispatch_p99_ms"] is None
    for m in (ref, port):
        m.reset_window()
    assert port.export_state() == ref.export_state()


def test_default_metrics_summary_equal_on_real_clock():
    """The constructors' defaults (a positional sink, 600 s / 20 slices,
    the monotonic clock): a quick burst reports equal percentiles."""
    ref, port = jax_metrics.Metrics(None), port_metrics.Metrics(None)
    for v in np.exp(np.random.default_rng(2).normal(-4, 1, 500)):
        ref.observe("dispatch", float(v))
        port.observe("dispatch", float(v))
    assert port.summary() == ref.summary()
    assert set(port.summary()) == {"dispatch_p50_ms", "dispatch_p95_ms", "dispatch_p99_ms"}
