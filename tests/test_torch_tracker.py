"""The port's identity tracker (``runtime/tracker.py``) against the JAX
package's: the same scripted stream of published results, lookups and
misses through both gives the same lookups (faces, track ids, stamps)
and the same ``track_*`` counters and gauges, flush reasons included."""

import numpy as np
import pytest

from opencv_facerecognizer_tpu.runtime import tracker as jax_tracker
from opencv_facerecognizer_tpu.utils.metrics import Metrics as JaxMetrics
from opencv_facerecognizer_tpu_torch.runtime import tracker as port_tracker
from opencv_facerecognizer_tpu_torch.utils.metrics import Metrics as PortMetrics

H = W = 96


def _script(seed, steps=160):
    """Per step: (op, stream, payload). Scenes of one to three faces that
    drift a pixel or two, an identity swap in place, a face that vanishes
    and returns, two tracks that cross, an embedder-version cutover, and
    frames whose content changes under a live track."""
    rng = np.random.default_rng(seed)
    base = {s: rng.integers(0, 256, (H, W)).astype(np.uint8) for s in ("cam0", "cam1")}
    faces = {"cam0": [[10, 10, 40, 40, 3], [50, 50, 80, 80, 5]], "cam1": [[20, 30, 50, 60, 7]]}
    version = 1
    ops = []
    for step in range(steps):
        stream = "cam0" if rng.random() < 0.6 else "cam1"
        frame = base[stream].copy()
        event = rng.random()
        if event < 0.05:
            version += 1  # a cutover
        elif event < 0.10:
            frame[:, :] = rng.integers(0, 256, (H, W))  # content swap under the boxes
            base[stream] = frame.copy()
        elif event < 0.15 and faces[stream]:
            faces[stream][0][4] = int(rng.integers(0, 9))  # identity swap in place
        elif event < 0.20:
            ops.append(("miss", stream, None))
            continue
        elif event < 0.25 and len(faces[stream]) >= 2:
            faces[stream][1][:4] = [v + 2 for v in faces[stream][0][:4]]  # crossing tracks
        for f in faces[stream]:
            dy, dx = rng.integers(-2, 3, 2)
            f[0] = int(np.clip(f[0] + dy, 0, H - 31))
            f[2] = f[0] + 30
            f[1] = int(np.clip(f[1] + dx, 0, W - 31))
            f[3] = f[1] + 30
        published = [{"box": [float(f[1]), float(f[0]), float(f[3]), float(f[2])],
                      "detection_score": 0.9, "label": int(f[4]) if f[4] < 8 else -1,
                      "name": f"s{f[4]}", "similarity": 0.8}
                     for f in faces[stream] if rng.random() > 0.1]  # a missed detection
        ops.append(("frame", stream, (frame, published, version)))
    return ops


def _run(module, metrics_cls, ops, reverify):
    metrics = metrics_cls()
    tracker = module.IdentityTracker(module.TrackerConfig(reverify_frames=reverify),
                                     metrics=metrics)
    trace = []
    for op, stream, payload in ops:
        if op == "miss":
            tracker.note_miss(stream)
            continue
        frame, published, version = payload
        hit = tracker.lookup(stream, frame, embedder_version=version)
        trace.append(hit)
        if hit is None:  # the full path published: it re-verifies the stream
            tracker.update(stream, published, frame, embedder_version=version)
    trace.append(tracker.stats())
    trace.append(tracker.registry())
    summary = metrics.summary()
    return trace, {k: v for k, v in summary.items() if k.startswith("track")}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("reverify", [1, 4, 8])
def test_same_script_same_lookups_and_counters(seed, reverify):
    ops = _script(seed)
    want_trace, want_counts = _run(jax_tracker, JaxMetrics, ops, reverify)
    got_trace, got_counts = _run(port_tracker, PortMetrics, ops, reverify)
    assert got_trace == want_trace
    assert got_counts == want_counts
    assert any(t is not None for t in want_trace[:-2]) or reverify == 1
    if reverify > 1:
        assert want_counts.get("track_cache_hits", 0) > 0
    assert any(k.startswith("track_flushes_") for k in want_counts)


def test_flush_all_and_stats_match():
    ops = _script(5, steps=40)
    trackers = []
    for module, metrics_cls in ((jax_tracker, JaxMetrics), (port_tracker, PortMetrics)):
        metrics = metrics_cls()
        t = module.IdentityTracker(metrics=metrics)
        for op, stream, payload in ops:
            if op == "frame":
                t.update(stream, payload[1], payload[0], embedder_version=payload[2])
        trackers.append((t.flush_all(), t.stats(), metrics.counter("track_flushes_reset")))
    assert trackers[0] == trackers[1]
    assert trackers[0][0] > 0
