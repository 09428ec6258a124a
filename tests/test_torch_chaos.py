"""Twins of ``tests/test_chaos.py``: the port's serving loop under injected
faults against the JAX package's, on the same frames and the same
scripted faults.

Both services run the reference's tiny chaos stack: the JAX one from
``scripts/chaos_soak.build_stack`` (loaded by path, as the reference's
tests load it), the port's from ``apps.chaos_soak.build_stack`` with those
flax params carried across. Both are built in float32 (``f32`` below):
in bf16 XLA's fusions and eager torch round at other points.

Each twin runs one script in each package and compares between them:

- counters (``NOT_COMPARED`` drops the one a thread race sets, with its
  reason), statuses,
  ledgers and dead-lettered metas: equal;
- results: labels and valid faces equal, boxes within ``BOX_ATOL`` and
  similarities within ``SIM_ATOL``, the tolerances
  ``tests/test_torch_pipeline.py`` holds the step to.

The injector's own cases (scripted order, seeded rates, flood, disarm, a
stuck readback) are twinned in ``tests/test_torch_faults.py``; the soak
scenarios in ``tests/test_torch_chaos_scenarios_*.py``. The two
``cpu_fallback`` cases pin ROADMAP C.7: the port reports a dead card and
stays degraded, it has no CPU fallback to swap in.
"""

import functools
import importlib.util
import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencv_facerecognizer_tpu.runtime as jax_runtime
from opencv_facerecognizer_tpu.models import detector as jax_detector
from opencv_facerecognizer_tpu.models import embedder as jax_embedder
from opencv_facerecognizer_tpu.runtime import connector as jax_connector
from opencv_facerecognizer_tpu.runtime import recognizer as jax_recognizer
from opencv_facerecognizer_tpu.runtime import resilience as jax_resilience
from opencv_facerecognizer_tpu_torch.apps import chaos_soak as port_soak
from opencv_facerecognizer_tpu_torch.models import detector as port_detector
from opencv_facerecognizer_tpu_torch.models import embedder as port_embedder
from opencv_facerecognizer_tpu_torch.runtime import connector as port_connector
from opencv_facerecognizer_tpu_torch.runtime import faults as port_faults
from opencv_facerecognizer_tpu_torch.runtime import recognizer as port_recognizer
from opencv_facerecognizer_tpu_torch.runtime import resilience as port_resilience
from opencv_facerecognizer_tpu_torch.utils.debug_lock import LockOrderMonitor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chaos_soak", os.path.join(REPO_ROOT, "scripts", "chaos_soak.py"))
jax_soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_soak)

FRAME_SHAPE = (64, 64)
BOX_ATOL = 1e-3
SIM_ATOL = 2e-3
#: one frame list for both packages
FRAMES = [f for f in np.random.default_rng(11).uniform(0, 255, (48, *FRAME_SHAPE))
          .astype(np.float32)]
#: counters set by a race, not by the script: a batch reuses a pooled
#: buffer only if the readback thread recycled the last one before the
#: batch formed, in either package
NOT_COMPARED = {"batcher_buffer_reuse"}


class Pkg:
    """One package's serving classes under one set of names."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.FakeConnector = jax_connector.FakeConnector
            self.encode_frame = jax_connector.encode_frame
            self.FaultInjector = jax_runtime.FaultInjector
            self.RecognizerService = jax_recognizer.RecognizerService
            self.ResiliencePolicy = jax_resilience.ResiliencePolicy
            self.ServiceSupervisor = jax_resilience.ServiceSupervisor
            self.is_transient_error = jax_resilience.is_transient_error
            self.InjectedUnavailableError = jax_runtime.faults.InjectedUnavailableError
        else:
            self.FakeConnector = port_connector.FakeConnector
            self.encode_frame = port_connector.encode_frame
            self.FaultInjector = port_faults.FaultInjector
            self.RecognizerService = port_recognizer.RecognizerService
            self.ResiliencePolicy = port_resilience.ResiliencePolicy
            self.ServiceSupervisor = port_resilience.ServiceSupervisor
            self.is_transient_error = port_resilience.is_transient_error
            self.InjectedUnavailableError = port_faults.InjectedUnavailableError


FRAME_TOPIC = port_recognizer.FRAME_TOPIC
RESULT_TOPIC = port_recognizer.RESULT_TOPIC
STATUS_TOPIC = port_recognizer.STATUS_TOPIC
assert (FRAME_TOPIC, RESULT_TOPIC, STATUS_TOPIC) == (
    jax_recognizer.FRAME_TOPIC, jax_recognizer.RESULT_TOPIC, jax_recognizer.STATUS_TOPIC)


@pytest.fixture(scope="module")
def stacks():
    """The two tiny stacks in float32, the port's with the JAX params."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_detector, "DetectorNet",
                   functools.partial(jax_detector.DetectorNet, dtype=jnp.float32))
        mp.setattr(jax_embedder, "FaceEmbedNet",
                   functools.partial(jax_embedder.FaceEmbedNet, dtype=jnp.float32))
        jax_pipe, _mesh = jax_soak.build_stack(frame_shape=FRAME_SHAPE, seed=0)

        class F32Detector(port_detector.CNNFaceDetector):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **{**kwargs, "dtype": torch.float32})

        mp.setattr(port_detector, "CNNFaceDetector", F32Detector)
        mp.setattr(port_embedder, "FaceEmbedNet",
                   functools.partial(port_embedder.FaceEmbedNet, dtype=torch.float32))
        params = (jax_pipe.detector.params, jax_pipe.embed_params)
        port_pipe, _dev = port_soak.build_stack(frame_shape=FRAME_SHAPE, seed=0,
                                                device="cpu", params=params)
    return {"jax": jax_pipe, "torch": port_pipe}


def _wait(cond, timeout=20.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


class Run:
    """One package's service over a ``FakeConnector``: ``inject`` offers
    frame ``n`` of ``FRAMES`` with ``meta`` plus ``n``."""

    def __init__(self, pkg: Pkg, pipe, injector=None, policy=None, connector=None,
                 **kwargs):
        self.pkg = pkg
        self.connector = connector if connector is not None else pkg.FakeConnector()
        self.injector = injector
        self.service = pkg.RecognizerService(
            pipe, self.connector, batch_size=2, frame_shape=FRAME_SHAPE,
            # wide enough that two back-to-back injects land in one batch
            flush_timeout=0.08, inflight_depth=2,
            resilience=policy or pkg.ResiliencePolicy(
                dispatch_retries=3, backoff_base_s=0.01, backoff_max_s=0.05,
                readback_deadline_s=0.6, degraded_after=3),
            fault_injector=injector, **kwargs)
        self.n = 0

    def inject(self, meta):
        self.connector.inject(FRAME_TOPIC, {**self.pkg.encode_frame(FRAMES[self.n]),
                                            "meta": {**meta, "n": self.n}})
        self.n += 1

    def results(self, **match):
        return [m for m in self.connector.messages(RESULT_TOPIC)
                if all((m.get("meta") or {}).get(k) == v for k, v in match.items())]

    def statuses(self):
        return [m["status"] for m in self.connector.messages(STATUS_TOPIC)]

    def observed(self):
        """What the twin compares (module docstring)."""
        counters = {k: v for k, v in self.service.metrics.counters().items()
                    if k not in NOT_COMPARED}
        dead = [m["frame_ids"] for m in self.connector.messages(STATUS_TOPIC)
                if m["status"] == "dead_letter"]
        return {"counters": counters, "statuses": self.statuses(),
                "ledger": self.service.ledger(), "dead_lettered": dead,
                "injected": None if self.injector is None else self.injector.summary()}


def _same_results(got: Run, want: Run):
    by_n = lambda run: {m["meta"]["n"]: m["faces"] for m in run.results()}  # noqa: E731
    g, w = by_n(got), by_n(want)
    assert sorted(g) == sorted(w)
    for n in w:
        gf, wf = g[n], w[n]
        assert [f["label"] for f in gf] == [f["label"] for f in wf], n
        assert [f["name"] for f in gf] == [f["name"] for f in wf], n
        np.testing.assert_allclose([f["box"] for f in gf], [f["box"] for f in wf],
                                   atol=BOX_ATOL)
        np.testing.assert_allclose([f["similarity"] for f in gf],
                                   [f["similarity"] for f in wf], atol=SIM_ATOL)


def _twin(stacks, script, compare_results=True):
    """``script(pkg, pipe)`` -> a stopped ``Run`` (and asserts of its own),
    in both packages; the observations equal between them."""
    runs = {name: script(Pkg(name), stacks[name]) for name in ("jax", "torch")}
    want, got = runs["jax"].observed(), runs["torch"].observed()
    assert got == want
    if compare_results:
        _same_results(runs["torch"], runs["jax"])
    return runs["torch"]


# ---------- the acceptance scenario ----------


def test_chaos_acceptance_stuck_unavailable_corrupt(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=1)
        run = Run(pkg, pipe, injector)
        m = run.service.metrics
        run.service.start()
        try:
            injector.script("readback", "stuck")
            run.inject({"phase": "stuck"})
            run.inject({"phase": "stuck"})
            assert _wait(lambda: m.counter("batches_dead_lettered") >= 1)
            injector.script("dispatch", "unavailable", "unavailable", "unavailable")
            run.inject({"phase": "unavail"})
            run.inject({"phase": "unavail"})
            assert _wait(lambda: m.counter("degraded_recoveries") >= 1)
            injector.script("receive", "corrupt")
            run.inject({"phase": "corrupt"})
            assert _wait(lambda: m.counter("frames_malformed") >= 1)
            for _ in range(4):
                run.inject({"phase": "healthy"})
            assert _wait(lambda: len(run.results(phase="healthy")) >= 4)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    counters = run.service.metrics.counters()
    assert run.injector.summary() == {"readback:stuck": 1, "dispatch:unavailable": 3,
                                      "receive:corrupt": 1}
    assert counters["batches_dead_lettered"] == 1 and counters["frames_dead_lettered"] == 2
    assert counters["dispatch_failures"] == counters["dispatch_retries"] == 3
    assert counters.get("batches_failed", 0) == 0
    assert counters["frames_malformed"] == 1
    assert counters["degraded_transitions"] == counters["degraded_recoveries"] == 1
    assert len(run.results(phase="unavail")) == 2 and not run.results(phase="stuck")
    degraded = next(m for m in run.connector.messages(STATUS_TOPIC)
                    if m["status"] == "degraded")
    assert degraded["consecutive_failures"] == 3


def test_warmup_consumes_no_scripted_fault(stacks):
    """Faults scripted before ``start`` wait for serving traffic: the
    warmup (every rung prewarmed, an enrolment chunk embedded) crosses no
    boundary, in either package (the reference installs its injector only
    after the warmup)."""
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=9)
        injector.script("dispatch", "unavailable")
        injector.script("readback", "slow")
        injector.script("put", "corrupt")
        injector.script("receive", "duplicate")
        run = Run(pkg, pipe, injector)
        run.service.start()
        try:
            assert injector.summary() == {}
            run.inject({"k": "first"})
            run.inject({"k": "second"})
            assert _wait(lambda: len(run.results()) >= 2)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    assert run.injector.summary() == {"receive:duplicate": 1, "put:corrupt": 1,
                                      "dispatch:unavailable": 1, "readback:slow": 1}


def test_receive_drop_and_duplicate(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=2)
        run = Run(pkg, pipe, injector)
        run.service.start()
        try:
            injector.script("receive", "drop", "duplicate")
            run.inject({"k": "dropped"})
            run.inject({"k": "doubled"})
            assert _wait(lambda: len(run.results()) >= 2)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    assert len(run.results(k="doubled")) == 2 and not run.results(k="dropped")


def test_receive_flood_and_corrupt_settle_in_the_ledger(stacks):
    """Beyond the reference's cases: a flooded delivery is admitted
    ``flood_factor`` times and a corrupt one settles malformed, in both."""
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=2, flood_factor=3)
        run = Run(pkg, pipe, injector)
        run.service.start()
        try:
            injector.script("receive", "flood", "corrupt")
            run.inject({"k": "flooded"})
            run.inject({"k": "corrupt"})
            run.inject({"k": "fine"})
            assert _wait(lambda: len(run.results()) >= 4)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    ledger = run.service.ledger()
    assert ledger["admitted"] == 5 and ledger["in_system"] == 0
    assert ledger["drops_by_reason"] == {"frames_malformed": 1.0}
    assert len(run.results(k="flooded")) == 3


def test_poisoned_batch_put_boundary(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=3)
        run = Run(pkg, pipe, injector)
        run.service.start()
        try:
            injector.script("put", "corrupt")
            run.inject({"k": "poisoned"})
            run.inject({"k": "fine"})
            assert _wait(lambda: len(run.results()) >= 1)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    counters = run.service.metrics.counters()
    assert counters["batcher_dropped_malformed"] == counters["frames_dropped"] == 1
    assert len(run.results(k="fine")) == 1 and not run.results(k="poisoned")


def test_dispatch_exhaustion_abandons_batch(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=4)
        policy = pkg.ResiliencePolicy(dispatch_retries=1, backoff_base_s=0.01,
                                      backoff_max_s=0.02, readback_deadline_s=0.6,
                                      degraded_after=2)
        run = Run(pkg, pipe, injector, policy)
        run.service.start()
        try:
            injector.script("dispatch", "unavailable", "unavailable")
            run.inject({"k": "doomed"})
            run.inject({"k": "doomed"})
            assert _wait(lambda: run.service.metrics.counter("batches_failed") >= 1)
            run.inject({"k": "after"})
            run.inject({"k": "after"})
            assert _wait(lambda: len(run.results(k="after")) >= 2)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    counters = run.service.metrics.counters()
    assert counters["batches_failed"] == 1 and counters["dispatch_failures"] == 2
    assert counters["degraded_transitions"] == 1


def test_slow_readbacks_pipeline_through_worker(stacks):
    elapsed = {}

    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=11, slow_readback_s=0.15)
        run = Run(pkg, pipe, injector)
        run.service.start()
        try:
            injector.script("readback", "slow", "slow", "slow")
            t0 = time.monotonic()
            for _ in range(6):
                run.inject({"k": "slow"})
            assert _wait(lambda: len(run.results(k="slow")) >= 6)
            elapsed[pkg.name] = time.monotonic() - t0
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    assert run.injector.summary() == {"readback:slow": 3}
    counters = run.service.metrics.counters()
    assert counters.get("batches_dead_lettered", 0) == 0
    assert counters["batches_dispatched"] >= 3
    # serialized, three 150 ms readbacks behind 80 ms windows take >= 0.7 s
    assert elapsed["torch"] < 3 * 0.15 + 0.35, elapsed


def test_fallback_inline_path_preserves_fault_semantics(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=12)
        run = Run(pkg, pipe, injector, readback_worker=False, readback_poll_s=0.002)
        run.service.start()
        try:
            injector.script("readback", "stuck")
            run.inject({"k": "stuck"})
            run.inject({"k": "stuck"})
            assert _wait(lambda: run.service.metrics.counter("batches_dead_lettered") >= 1)
            run.inject({"k": "ok"})
            run.inject({"k": "ok"})
            assert _wait(lambda: len(run.results(k="ok")) >= 2)
        finally:
            run.service.stop()
        assert run.service._worker is None
        return run

    run = _twin(stacks, script)
    assert not run.results(k="stuck")


def test_stuck_readbacks_leak_no_thread(stacks):
    """A run of stuck readbacks: each is dead-lettered at its deadline
    through the "raised" branch (its ``wait`` raises at once), so no
    readback blocker is abandoned; the process's thread count after
    ``stop`` is the count before ``start``."""
    pipe = stacks["torch"]
    pkg = Pkg("torch")
    injector = pkg.FaultInjector(seed=13)
    policy = pkg.ResiliencePolicy(readback_deadline_s=0.15)
    run = Run(pkg, pipe, injector, policy)
    before = threading.active_count()
    # the port's blockers (the reference's keep theirs, under the same name)
    blockers = lambda: [t for t in threading.enumerate()  # noqa: E731
                        if isinstance(getattr(getattr(t, "_target", None), "__self__", None),
                                      port_recognizer._ReadbackBlocker)]
    assert not blockers()  # every earlier port service closed its own
    run.service.start()
    try:
        injector.script("readback", *["stuck"] * 8)
        for _ in range(16):
            run.inject({"k": "stuck"})
        assert _wait(lambda: run.service.metrics.counter("batches_dead_lettered") >= 8)
        during = threading.active_count()
        run.inject({"k": "ok"})
        run.inject({"k": "ok"})
        assert _wait(lambda: len(run.results(k="ok")) >= 2)
    finally:
        run.service.stop()
    # the dispatch loop, the readback worker and its one blocker
    assert during <= before + 3, (before, during)
    assert _wait(lambda: not blockers(), timeout=5.0), blockers()
    assert _wait(lambda: threading.active_count() == before, timeout=5.0), (
        before, threading.enumerate())
    assert run.service.metrics.counter("frames_dead_lettered") == 16


class HeldReadback:
    """A readback whose ``wait`` blocks until ``release`` is set and then
    takes ``linger_s`` more; never ready before that."""

    pending = True

    def __init__(self, wrapped, release: threading.Event, linger_s: float):
        self._wrapped = wrapped
        self._release = release
        self._linger_s = linger_s
        self._landed = False

    def ready(self) -> bool:
        return self._landed

    def wait(self) -> None:
        self._release.wait()
        time.sleep(self._linger_s)
        self._landed = True
        self._wrapped.wait()

    def result(self):
        self.wait()
        return self._wrapped.result()


def test_stop_joins_a_blocker_still_inside_its_wait(stacks):
    """ROADMAP C.28: a batch whose readback outlives its deadline is
    dead-lettered and its blocker retired while still inside the wait.
    That wait returns 0.3 s after ``stop`` begins, within one readback
    deadline (1 s): ``stop`` joins the retired blocker, so no blocker
    thread is left once it returns (before the repair ``stop`` closed
    blockers without joining them, and returned with this one waiting)."""
    pipe = stacks["torch"]
    pkg = Pkg("torch")
    injector = pkg.FaultInjector(seed=14)
    release = threading.Event()
    held = []
    passthrough = injector.on_readback

    def on_readback(readback):
        if held:
            return passthrough(readback)
        held.append(HeldReadback(readback, release, linger_s=0.3))
        return held[0]

    injector.on_readback = on_readback
    run = Run(pkg, pipe, injector, pkg.ResiliencePolicy(readback_deadline_s=1.0))
    blockers = lambda: [t for t in threading.enumerate()  # noqa: E731
                        if isinstance(getattr(getattr(t, "_target", None), "__self__", None),
                                      port_recognizer._ReadbackBlocker)]
    run.service.start()
    try:
        run.inject({"k": "held"})
        run.inject({"k": "held"})
        assert _wait(lambda: run.service.metrics.counter("batches_dead_lettered") >= 1)
        assert len(blockers()) == 2  # the retired one inside its wait, and its successor
    finally:
        release.set()
        run.service.stop()
    assert not blockers(), blockers()
    assert run.service.metrics.counter("frames_dead_lettered") == 2


def test_blocker_timeout_dead_letters_only_a_readback_still_pending(stacks):
    """At its deadline a readback whose blocker has not reported (a
    starved thread) is dead-lettered only if it is still not ready."""
    class LateReport:
        pending = True

        def __init__(self, lands_in):
            self.at = time.monotonic() + lands_in

        def ready(self):
            return time.monotonic() >= self.at

        def wait(self):
            time.sleep(0.4)  # the report comes long after the landing

    run = Run(Pkg("torch"), stacks["torch"])
    service = run.service
    try:
        assert service._await_ready(LateReport(0.02), time.monotonic() + 0.15) is True
        assert service._await_ready(LateReport(30.0), time.monotonic() + 0.15) is False
    finally:
        service.stop()


# ---------- supervisor ----------


def _crash_once_connector(pkg):
    class CrashOnce(pkg.FakeConnector):
        """Raises from the first result publish: an exception that escapes
        the loop through a subscriber."""

        def __init__(self):
            super().__init__()
            self.crashes_left = 1

        def publish(self, topic, message):
            if topic == RESULT_TOPIC and self.crashes_left:
                self.crashes_left -= 1
                raise RuntimeError("result consumer blew up")
            super().publish(topic, message)

        inject = publish

    return CrashOnce()


def _plain_service(pkg, pipe, connector):
    return pkg.RecognizerService(pipe, connector, batch_size=2, frame_shape=FRAME_SHAPE,
                                 flush_timeout=0.02,
                                 resilience=pkg.ResiliencePolicy(readback_deadline_s=5.0))


def test_supervisor_restarts_crashed_loop_and_restores_gallery(stacks):
    rows = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32)

    def script(pkg, pipe):
        run = Run(pkg, pipe, connector=_crash_once_connector(pkg))
        run.service = _plain_service(pkg, pipe, run.connector)
        supervisor = pkg.ServiceSupervisor(run.service, max_restarts=3, poll_interval_s=0.05)
        supervisor.start()
        size0 = pipe.gallery.size
        try:
            pipe.gallery.add(rows, np.full(3, 3, np.int32))
            assert pipe.gallery.size == size0 + 3
            run.inject({"k": "crash-bait"})
            run.inject({"k": "crash-bait"})
            assert _wait(lambda: run.service.metrics.counter("supervisor_restarts") >= 1)
            assert pipe.gallery.size == size0
            run.inject({"k": "after-restart"})
            run.inject({"k": "after-restart"})
            assert _wait(lambda: len(run.results(k="after-restart")) >= 2)
        finally:
            supervisor.stop()
        assert supervisor.restarts == 1 and not supervisor.gave_up
        return run

    run = _twin(stacks, script)
    assert run.service.metrics.counter("loop_crashes") == 1
    assert {"crashed", "supervisor_restart"} <= set(run.statuses())


def test_degraded_probe_pins_no_cpu_fallback(stacks):
    """The reference's ``test_degraded_probe_and_cpu_fallback`` with C.7
    pinned: the same dead-backend verdict in the degraded status, and
    where the reference swaps in its CPU fallback (``cpu_fallback: true``,
    ``cpu_fallbacks`` 1), the port says ``cpu_fallback: false`` and counts
    nothing; the service refuses a ``cpu_fallback`` hook."""
    runs = {}
    for name in ("jax", "torch"):
        pkg = Pkg(name)
        injector = pkg.FaultInjector(seed=5)
        policy = pkg.ResiliencePolicy(dispatch_retries=3, backoff_base_s=0.01,
                                      backoff_max_s=0.02, readback_deadline_s=0.6,
                                      degraded_after=3, probe_backend_on_degraded=True)
        kwargs = {"backend_probe_fn": lambda: (False, "injected-dead")}
        fallbacks = []
        if name == "jax":
            kwargs["cpu_fallback"] = fallbacks.append
        run = Run(pkg, stacks[name], injector, policy, **kwargs)
        run.service.start()
        try:
            injector.script("dispatch", "unavailable", "unavailable", "unavailable")
            run.inject({"k": "x"})
            run.inject({"k": "x"})
            assert _wait(lambda: run.service.metrics.counter("degraded_recoveries") >= 1)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        runs[name] = run
    degraded = {n: next(m for m in r.connector.messages(STATUS_TOPIC)
                        if m["status"] == "degraded") for n, r in runs.items()}
    for key in ("backend_usable", "backend_reason", "consecutive_failures"):
        assert degraded["torch"][key] == degraded["jax"][key]
    assert degraded["jax"]["cpu_fallback"] is True
    assert degraded["torch"]["cpu_fallback"] is False
    want, got = runs["jax"].observed(), runs["torch"].observed()
    assert want["counters"].pop("cpu_fallbacks") == 1
    assert "cpu_fallbacks" not in got["counters"]
    assert got == want
    with pytest.raises(TypeError):
        Run(Pkg("torch"), stacks["torch"], cpu_fallback=lambda svc: None)


def test_cpu_fallback_rebuild_is_not_ported(stacks):
    """The reference's ``test_cpu_fallback_rebuilds_pipeline_and_keeps_serving``
    pinned to C.7: the port has no ``rebuild_pipeline_on_cpu``; on a dead
    card its service stays degraded on its own pipeline (no swap) and
    serves again once a dispatch succeeds."""
    assert hasattr(jax_resilience, "rebuild_pipeline_on_cpu")
    assert not hasattr(port_resilience, "rebuild_pipeline_on_cpu")
    pkg = Pkg("torch")
    injector = pkg.FaultInjector(seed=8)
    policy = pkg.ResiliencePolicy(dispatch_retries=3, backoff_base_s=0.01,
                                  backoff_max_s=0.02, readback_deadline_s=0.6,
                                  degraded_after=3, probe_backend_on_degraded=True)
    run = Run(pkg, stacks["torch"], injector, policy,
              backend_probe_fn=lambda: (False, "injected-dead"))
    old_pipe = run.service.pipeline
    run.service.start()
    try:
        injector.script("dispatch", "unavailable", "unavailable", "unavailable")
        run.inject({"k": "x"})
        run.inject({"k": "x"})
        assert _wait(lambda: run.service.metrics.counter("degraded_recoveries") >= 1)
        assert run.service.pipeline is old_pipe
        run.inject({"k": "after"})
        run.inject({"k": "after"})
        assert _wait(lambda: len(run.results(k="after")) >= 2)
    finally:
        run.service.stop()
    assert run.service.metrics.counter("cpu_fallbacks") == 0
    assert run.service.metrics.counter("loop_crashes") == 0
    assert run.service.metrics.counter("recompiles_post_warmup") == 0


def test_transient_error_classification():
    for name in ("jax", "torch"):
        pkg = Pkg(name)
        assert pkg.is_transient_error(pkg.InjectedUnavailableError())
        assert pkg.is_transient_error(RuntimeError("UNAVAILABLE: socket closed"))
        assert pkg.is_transient_error(ConnectionResetError("connection reset by peer"))
        assert not pkg.is_transient_error(ValueError("shape mismatch [8, 64, 64]"))
        assert not pkg.is_transient_error(TypeError("not an array"))


def test_probe_for_recovery_injectable_and_bounded():
    from opencv_facerecognizer_tpu.utils.backend_probe import probe_for_recovery as jax_probe
    from opencv_facerecognizer_tpu_torch.utils.backend_probe import probe_for_recovery

    for probe in (jax_probe, probe_for_recovery):
        usable, reason = probe(timeout_s=30.0, probe_source="import sys; sys.exit(0)")
        assert usable and reason == "ok"
        t0 = time.monotonic()
        usable, reason = probe(timeout_s=0.5, probe_source="import time; time.sleep(30)")
        assert not usable and "hang-mode" in reason
        assert time.monotonic() - t0 < 5.0


# ---------- degraded-path edges ----------


def test_status_subscriber_raising_never_crashes_loop(stacks):
    def script(pkg, pipe):
        injector = pkg.FaultInjector(seed=6)
        run = Run(pkg, pipe, injector)

        def angry_subscriber(topic, message):
            raise RuntimeError("status consumer blew up")

        run.connector.subscribe(STATUS_TOPIC, angry_subscriber)
        m = run.service.metrics
        run.service.start()
        try:
            injector.script("dispatch", "unavailable", "unavailable", "unavailable")
            run.inject({"k": "x"})
            run.inject({"k": "x"})
            assert _wait(lambda: m.counter("degraded_recoveries") >= 1)
            # the recovery is counted before the batch crosses the readback
            # boundary (the reference's order): the stuck fault waits for
            # the "x" batch's results, or it could land on that batch
            assert _wait(lambda: len(run.results(k="x")) >= 2)
            injector.script("readback", "stuck")
            run.inject({"k": "y"})
            run.inject({"k": "y"})
            assert _wait(lambda: m.counter("batches_dead_lettered") >= 1)
            run.inject({"k": "alive"})
            run.inject({"k": "alive"})
            assert _wait(lambda: len(run.results(k="alive")) >= 2)
            assert run.service.drain(timeout=20.0)
        finally:
            run.service.stop()
        return run

    run = _twin(stacks, script)
    assert run.service.metrics.counter("loop_crashes") == 0


def test_supervisor_recheckpoints_on_committed_changes(stacks):
    rows = np.random.default_rng(6).normal(size=(2, 16)).astype(np.float32)

    def script(pkg, pipe):
        run = Run(pkg, pipe, connector=_crash_once_connector(pkg))
        run.service = _plain_service(pkg, pipe, run.connector)
        supervisor = pkg.ServiceSupervisor(run.service, max_restarts=3, poll_interval_s=0.05)
        supervisor.start()
        base = pipe.gallery.size
        seed_rows = pipe.gallery.snapshot()
        m = run.service.metrics
        try:
            checkpoints = m.counter("supervisor_checkpoints")
            pipe.gallery.add(rows, np.full(2, 3, np.int32))
            run.service._run_commit_hooks()
            assert _wait(lambda: m.counter("supervisor_checkpoints") > checkpoints)
            run.inject({"k": "crash-bait"})
            run.inject({"k": "crash-bait"})
            assert _wait(lambda: m.counter("supervisor_restarts") >= 1)
            assert pipe.gallery.size == base + 2
        finally:
            supervisor.stop()
        # the module's stacks are shared: back to the seed rows
        pipe.gallery.load_snapshot(*seed_rows)
        return run

    _twin(stacks, script)


def test_supervisor_stall_watchdog_surfaces_no_progress(stacks):
    def script(pkg, pipe):
        run = Run(pkg, pipe)
        run.service = _plain_service(pkg, pipe, run.connector)
        service = run.service
        supervisor = pkg.ServiceSupervisor(service)
        supervisor.stall_warn_s = 0.1
        # the loop never started: queued frames make no progress
        service.batcher.put(np.zeros(FRAME_SHAPE, np.float32))
        supervisor._check_stall(service, STATUS_TOPIC)
        time.sleep(0.15)
        supervisor._check_stall(service, STATUS_TOPIC)
        assert service.metrics.counter("supervisor_stalls") == 1
        stalled = [m for m in run.connector.messages(STATUS_TOPIC) if m["status"] == "stalled"]
        assert len(stalled) == 1 and stalled[0]["pending_frames"] == 1
        supervisor._check_stall(service, STATUS_TOPIC)
        assert service.metrics.counter("supervisor_stalls") == 1
        # an abandoned batch is progress
        service.metrics.incr("batches_failed")
        supervisor._check_stall(service, STATUS_TOPIC)
        time.sleep(0.15)
        service.metrics.incr("batches_failed")
        supervisor._check_stall(service, STATUS_TOPIC)
        assert service.metrics.counter("supervisor_stalls") == 1
        return run

    _twin(stacks, script)


def test_supervisor_waits_for_crashed_thread_to_exit(stacks):
    def script(pkg, pipe):
        run = Run(pkg, pipe)
        run.service = _plain_service(pkg, pipe, run.connector)
        supervisor = pkg.ServiceSupervisor(run.service, max_restarts=3, poll_interval_s=0.05)
        supervisor.start()
        try:
            run.service._crashed = True  # flag up, thread alive and healthy
            time.sleep(0.4)
            assert supervisor.restarts == 0
            assert run.service.metrics.counter("supervisor_restarts") == 0
            run.service._crashed = False
            run.inject({"k": "fine"})
            run.inject({"k": "fine"})
            assert _wait(lambda: len(run.results(k="fine")) >= 2)
        finally:
            supervisor.stop()
        return run

    _twin(stacks, script)


# ---------- dynamic lock-order backstop ----------

#: the static analyzer's ids of the port's locks lack the package prefix
#: when it is given the reference's tree; strip it from the port's
PORT_PREFIX = "opencv_facerecognizer_tpu_torch."


def test_debug_lock_backstop_no_inversions(stacks):
    """Real traffic through a port service whose locks are ``DebugLock``s
    of one monitor (``apps.chaos_soak.instrument_locks``, named with the
    static analyzer's ids): no inversion observed, and the union of the
    observed edges with ``tools/ocvf_lint``'s ``build_lock_graph`` over the
    port's package (the analyzer reads it) has no two-lock cycle."""
    pipe = stacks["torch"]
    monitor = LockOrderMonitor()
    run = Run(Pkg("torch"), pipe)
    restore = port_soak.instrument_locks(run.service, monitor)
    run.service.start()
    try:
        for i in range(10):
            run.inject({"k": f"f{i}"})
        assert _wait(lambda: len(run.results()) >= 10)
        # the one sanctioned nesting (a put on a closed batcher counts
        # under the queue lock): drive it so the cross-check is not vacuous
        run.service.stop()
        assert run.service.batcher.put(np.zeros(FRAME_SHAPE, np.float32)) is False
        assert run.service.metrics.counter("batcher_dropped_closed") >= 1
    finally:
        run.service.stop()
        restore()
    monitor.check()
    observed = monitor.edges()
    assert ("runtime.batcher.FrameBatcher._lock", "utils.metrics.Metrics._lock") in observed

    sys.path.insert(0, REPO_ROOT)
    from tools.ocvf_lint.checkers.lock_order import build_lock_graph

    static_edges = {(a.replace(PORT_PREFIX, ""), b.replace(PORT_PREFIX, "")) for a, b in
                    build_lock_graph([os.path.join(REPO_ROOT, "opencv_facerecognizer_tpu_torch")])}
    assert static_edges, "the analyzer read nothing of the port"
    alias = {"runtime.batcher.FrameBatcher._not_empty": "runtime.batcher.FrameBatcher._lock"}

    def canon(node):
        return alias.get(node, node)

    combined = ({(canon(a), canon(b)) for a, b in static_edges}
                | {(canon(a), canon(b)) for a, b in observed})
    static_nodes = {n for e in static_edges for n in e}
    observed_nodes = {canon(n) for e in observed for n in e}
    assert static_nodes & observed_nodes, (static_nodes, observed_nodes)
    inverted = sorted((a, b) for (a, b) in combined if a != b and (b, a) in combined)
    assert not inverted, inverted
