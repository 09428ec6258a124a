"""Asynchronous gallery growth (``ShardedGallery(async_grow=True)``) and the
durable state around it, the port against the JAX package on the CPU.

- The same adds into both packages' galleries give equal ``pending_rows``
  while a blocking prewarm hook holds the grow worker, and equal host
  mirrors, size and capacity after ``wait_ready``; a ``reset`` during a
  grow drops the staged rows in both; a failed upload puts the popped
  rows back in order; an add that fills a tier to 0.75 warms the next one
  early; ``evict_hooks`` get the replaced tier.
- The checkpoint defers while rows are staged (``checkpoints_deferred_pending``)
  and the WAL stays whole; the supervisor skips a post-commit checkpoint
  whose ``wait_ready`` times out.

The JAX side runs on a one-device CPU mesh, the port on ``device="cpu"``.
Every wait in a test is bounded. Tolerance: bit for bit (host mirrors,
counts, WAL records).
"""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from opencv_facerecognizer_tpu.parallel import ShardedGallery as JaxGallery
from opencv_facerecognizer_tpu.parallel.mesh import DP_AXIS, TP_AXIS
from opencv_facerecognizer_tpu.runtime import resilience as jax_resilience
from opencv_facerecognizer_tpu.runtime import state_store as jax_state
from opencv_facerecognizer_tpu.utils import metrics as jax_metrics
from opencv_facerecognizer_tpu_torch.parallel.gallery import ShardedGallery as PortGallery
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_resilience
from opencv_facerecognizer_tpu_torch.runtime import state_store as port_state
from opencv_facerecognizer_tpu_torch.utils import metrics as port_metrics

DIM = 8
WAIT_S = 30.0
BOTH = pytest.mark.parametrize("pkg", ["jax", "torch"])


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), (DP_AXIS, TP_AXIS))


def _gallery(pkg, capacity=8, async_grow=True):
    if pkg == "jax":
        return JaxGallery(capacity=capacity, dim=DIM, mesh=_mesh1(), async_grow=async_grow)
    return PortGallery(capacity, DIM, device="cpu", async_grow=async_grow)


PKGS = {
    "jax": types.SimpleNamespace(state=jax_state, Metrics=jax_metrics.Metrics,
                                 resilience=jax_resilience),
    "torch": types.SimpleNamespace(state=port_state, Metrics=port_metrics.Metrics,
                                   resilience=port_resilience),
}


def _rows(rng, n):
    return rng.normal(size=(n, DIM)).astype(np.float32)


class Gate:
    """A prewarm hook that blocks the grow worker until ``open()``; takes
    either package's hook signature (``(capacity)`` or ``(capacity,
    data)``) and records each capacity."""

    def __init__(self):
        self.released = threading.Event()
        self.entered = threading.Event()
        self.capacities = []

    def __call__(self, capacity, *_data):
        self.capacities.append(capacity)
        self.entered.set()
        assert self.released.wait(WAIT_S), "gate never opened"

    def open(self):
        self.released.set()


def _wait_until(pred, what):
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def _mirrors(g):
    emb, lab, val, size = g.snapshot()
    return emb, lab, val, size, g.capacity


def _assert_same(a, b):
    for x, y in zip(_mirrors(a), _mirrors(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_staged_adds_equal_to_reference():
    """Adds past the tier stage in both packages, ``pending_rows`` agrees
    while the worker is held, and the landed galleries are equal."""
    rng = np.random.default_rng(1)
    batches = [_rows(rng, n) for n in (6, 4, 3, 9)]
    gates, galleries = {}, {}
    for pkg in ("jax", "torch"):
        g = galleries[pkg] = _gallery(pkg)
        gate = gates[pkg] = Gate()
        g.prewarm_hooks.append(gate)
        pending = []
        for i, rows in enumerate(batches):
            g.add(rows, np.full(len(rows), i, np.int32))
            pending.append(g.pending_rows)
            if i == 0:
                # 6 of 8 rows: the next tier's early warm holds the gate
                assert gate.entered.wait(WAIT_S)
        gates[pkg].pending = pending
        assert g.size == 6 and not g.wait_ready(timeout=0.05)
    assert gates["jax"].pending == gates["torch"].pending == [0, 4, 7, 16]
    for pkg, g in galleries.items():
        gates[pkg].open()
        assert g.wait_ready(timeout=WAIT_S)
        assert g.pending_rows == 0 and g.size == 22 and g.capacity == 32
        assert not g.last_grow_info.get("error"), g.last_grow_info
    _assert_same(galleries["jax"], galleries["torch"])
    assert gates["jax"].capacities == gates["torch"].capacities
    # the landed rows match on the port's device snapshot
    port = galleries["torch"]
    labels, sims, idx = port.match(torch.tensor(batches[3]), k=1)
    assert (labels[:, 0] == 3).all() and (idx[:, 0] >= 13).all()
    assert torch.equal(port.data.valid, torch.from_numpy(port.snapshot()[2]))


@BOTH
def test_reset_during_a_grow_drops_the_staged_rows(pkg):
    rng = np.random.default_rng(2)
    g = _gallery(pkg)
    gate = Gate()
    g.prewarm_hooks.append(gate)
    g.add(_rows(rng, 4), np.zeros(4, np.int32))
    g.add(_rows(rng, 6), np.ones(6, np.int32))  # overflows: staged
    assert gate.entered.wait(WAIT_S) and g.pending_rows == 6
    g.reset()
    assert g.pending_rows == 0
    gate.open()
    assert g.wait_ready(timeout=WAIT_S)
    assert g.size == 0 and g.capacity == 8 and g.pending_rows == 0
    assert not g.snapshot()[2].any()


@BOTH
def test_failed_upload_puts_the_rows_back_in_order(pkg, monkeypatch):
    rng = np.random.default_rng(3)
    g = _gallery(pkg)
    upload = "_build_snapshot" if pkg == "jax" else "_upload_grown"
    real = getattr(g, upload)
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost mid-upload")
        return real(*args, **kwargs)

    g.add(_rows(rng, 5), np.zeros(5, np.int32))
    g.add(_rows(rng, 3), np.full(3, 1, np.int32))  # 8 rows fit
    monkeypatch.setattr(g, upload, flaky)
    gate = Gate()
    g.prewarm_hooks.append(gate)
    g.add(_rows(rng, 2), np.full(2, 2, np.int32))  # overflows: staged
    gate.open()
    assert g.wait_ready(timeout=WAIT_S)
    assert "device lost" in g.last_grow_info["error"]
    assert g.pending_rows == 2 and g.size == 8
    third = _rows(rng, 1)
    g.add(third, np.full(1, 3, np.int32))  # restarts the worker: retries in order
    assert g.wait_ready(timeout=WAIT_S)
    assert g.pending_rows == 0 and g.size == 11 and g.capacity == 16
    lab = g.snapshot()[1]
    np.testing.assert_array_equal(lab[:11], [0] * 5 + [1] * 3 + [2] * 2 + [3])


@BOTH
@pytest.mark.parametrize("rows, warmed", [(5, False), (6, True)])
def test_early_warm_at_three_quarters(pkg, rows, warmed):
    rng = np.random.default_rng(4)
    g = _gallery(pkg)
    seen = []
    g.prewarm_hooks.append(lambda capacity, *_data: seen.append(capacity))
    g.add(_rows(rng, rows), np.zeros(rows, np.int32))
    if warmed:
        _wait_until(lambda: seen, "the early warm never ran")
        assert seen == [16]
    else:
        time.sleep(0.1)
        assert seen == []
    assert g.capacity == 8 and g.pending_rows == 0


@BOTH
@pytest.mark.parametrize("async_grow", [False, True])
def test_evict_hooks_get_the_replaced_tier(pkg, async_grow):
    rng = np.random.default_rng(5)
    g = _gallery(pkg, async_grow=async_grow)
    evicted = []
    g.evict_hooks.append(evicted.append)
    g.add(_rows(rng, 7), np.zeros(7, np.int32))
    g.add(_rows(rng, 5), np.ones(5, np.int32))
    assert g.wait_ready(timeout=WAIT_S)
    _wait_until(lambda: evicted, "no eviction after the grow")
    assert evicted == [8] and g.capacity == 16 and g.size == 12


def test_port_in_place_add_keeps_held_snapshots():
    """Within a tier the port writes rows into the live embeddings tensor
    and publishes new valid/labels tensors: a snapshot taken before keeps
    its own size, valid and labels."""
    rng = np.random.default_rng(6)
    g = PortGallery(16, DIM, device="cpu")
    g.add(_rows(rng, 4), np.arange(4, dtype=np.int32))
    held = g.data
    valid, labels = held.valid.clone(), held.labels.clone()
    g.add(_rows(rng, 3), np.arange(3, dtype=np.int32) + 10)
    new = g.data
    assert new.embeddings is held.embeddings
    assert held.size == 4 and torch.equal(held.valid, valid)
    assert torch.equal(held.labels, labels)
    assert new.size == 7 and int(new.valid.sum()) == 7 and new.labels[6] == 12
    np.testing.assert_array_equal(new.embeddings[:7].numpy(), g.snapshot()[0][:7])


# ---- durable state around staged rows ----

def _short_wait(g):
    """``wait_ready`` capped at 50 ms, so a deferral shows without the
    checkpoint's 30 s wait."""
    real = g.wait_ready
    g.wait_ready = lambda timeout=None: real(0.05)


@BOTH
def test_checkpoint_defers_while_rows_are_staged(pkg, tmp_path):
    p = PKGS[pkg]
    rng = np.random.default_rng(7)
    g = _gallery(pkg)
    metrics = p.Metrics()
    st = p.state.StateLifecycle(str(tmp_path), metrics=metrics, checkpoint_wal_rows=1 << 30,
                                checkpoint_every_s=1e9)
    names = ["base"]
    st.bind(g, names)
    g.add(_rows(rng, 4), np.zeros(4, np.int32))
    assert st.checkpoint_now(wait=True)
    files = sorted(st.store.checkpoint_files())
    gate = Gate()
    g.prewarm_hooks.append(gate)
    for subject, n in (("alice", 3), ("bob", 5)):  # bob overflows the tier: staged
        emb = _rows(rng, n)
        labels = np.full(n, len(names), np.int32)
        names.append(subject)
        st.append_enrollment(emb, labels, subject=subject, label=len(names) - 1,
                             apply_fn=lambda e=emb, lab=labels: g.add(e, lab))
    assert g.pending_rows == 5
    _short_wait(g)
    assert not st.checkpoint_now(wait=True)
    assert metrics.counter("checkpoints_deferred_pending") == 1
    assert sorted(st.store.checkpoint_files()) == files
    records, _ = st.wal.scan()
    assert [r["subject"] for r in records if r.get("kind") == "enroll"] == ["alice", "bob"]
    gate.open()
    assert g.wait_ready(timeout=WAIT_S) and g.pending_rows == 0
    time.sleep(0.06)
    assert st.checkpoint_now(wait=True)
    assert metrics.counter("checkpoints_deferred_pending") == 1
    st.close()
    g2 = _gallery(pkg, async_grow=False)
    rep = p.state.StateLifecycle(str(tmp_path)).recover(g2, [])
    assert rep["replayed_records"] == 0
    _assert_same(g, g2)


class _Service:
    """What the supervisor's commit path reads of a service."""

    def __init__(self, gallery, metrics):
        self.pipeline = types.SimpleNamespace(gallery=gallery)
        self.metrics = metrics
        self.subject_names = ["base"]
        self.commit_hooks = []


@BOTH
def test_supervisor_skips_the_post_commit_checkpoint_on_timeout(pkg):
    p = PKGS[pkg]
    rng = np.random.default_rng(8)
    g = _gallery(pkg)
    metrics = p.Metrics()
    sup = p.resilience.ServiceSupervisor(_Service(g, metrics), commit_wait_s=0.05)
    sup._running = True
    g.add(_rows(rng, 4), np.zeros(4, np.int32))
    sup._on_commit()
    assert metrics.counter("supervisor_checkpoints") == 1
    gate = Gate()
    g.prewarm_hooks.append(gate)
    g.add(_rows(rng, 6), np.ones(6, np.int32))  # staged behind the gate
    sup._on_commit()
    assert metrics.counter("supervisor_checkpoints") == 1  # kept the previous one
    assert sup._snapshot[3] == 4
    gate.open()
    assert g.wait_ready(timeout=WAIT_S)
    sup._on_commit()
    assert metrics.counter("supervisor_checkpoints") == 2 and sup._snapshot[3] == 10
