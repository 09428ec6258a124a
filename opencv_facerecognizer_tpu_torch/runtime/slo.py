"""SLO burn-rate monitor: declarative objectives, two-window burn rates
and an ok -> warn -> critical health state machine. Port of
``opencv_facerecognizer_tpu/runtime/slo.py``.

- An **objective** (``SLO``) says what good means: a latency window
  staying under a threshold for a target share of events, a counter ratio
  staying under its budget, or a gauge staying under a bound; and two
  horizons, a short one that reacts and a long one that filters blips.
- The **burn rate** is the observed error rate over the budget
  (``1 - target``): 1.0 spends the budget exactly. A severity needs the
  burn past its rate on **both** windows, and (for latency and ratio
  objectives) ``min_events`` events in both.
- Latency objectives read ``Metrics.fraction_above`` over the rolling
  histograms; ratio objectives diff the counter snapshots the monitor
  records per evaluation; gauge objectives read a callable, burn =
  value / bound on both windows.
- **Watchdog events** (``note_event``, e.g. a step captured after warmup)
  hold health at warn while inside the short window, counted
  ``slo_events_<reason>``.

The **health state** is the worst objective's severity: escalation is
immediate, de-escalation takes ``recovery_evals`` calmer evaluations per
level. Every transition is a lifecycle span; a transition into critical
also dumps the flight recorder (``slo_critical``). ``health_state`` and
``slo_burn_<objective>`` land on the shared Metrics.

The serving loop ticks the monitor (one clock read when not due); the
exposition's refresh thread and the supervisor tick it too, as backstops
for a wedged loop. Concurrent ticks are serialized by a non-blocking
claim (the loser skips), so a transition's side effects fire once.
Readers take the last verdict dict by reference. ``clock`` is injectable.

The objective constructors for rollout, registry, replication and link
health take duck-typed objects (``rollout_parity_objective`` reads a
``runtime.rollout.RolloutCoordinator``, ``registry_parity_objective`` a
``runtime.registry.RegistrySwapCoordinator``, ``replication_lag_objective``
a ``runtime.replication.ReadReplica`` and ``link_health_objective`` a
``TopicRouter.down_link_fraction``); the CLI wires the last two for a
reader and a router under ``--slo``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from opencv_facerecognizer_tpu_torch.utils import metrics as mn

#: health states in escalation order; the index is the ``health_state`` gauge
STATE_OK, STATE_WARN, STATE_CRITICAL = 0, 1, 2
STATE_NAMES = ("ok", "warn", "critical")


@dataclass
class SLO:
    """One objective. ``kind`` selects the fields that apply:

    - ``"latency"``: ``window`` (a Metrics window) under ``threshold_s``
      for ``target`` of its events;
    - ``"ratio"``: the growth of ``bad_counters`` over that of
      ``total_counters`` under ``1 - target``;
    - ``"gauge"``: ``value_fn()`` under ``bound``."""

    name: str
    kind: str  # "latency" | "ratio" | "gauge"
    window: Optional[str] = None
    threshold_s: float = 0.0
    #: latency and ratio: the target share of good events
    target: float = 0.99
    bad_counters: Tuple[str, ...] = ()
    total_counters: Tuple[str, ...] = ()
    value_fn: Optional[Callable[[], float]] = None
    bound: float = 0.0
    short_s: float = 60.0
    long_s: float = 600.0
    warn_burn: float = 1.0
    critical_burn: float = 6.0
    #: latency and ratio severities need this many events in both windows:
    #: one dropped frame on an idle replica would burn 500x a 0.001 budget
    min_events: int = 10

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "ratio", "gauge"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.target < 1.0 and self.kind != "gauge":
            raise ValueError("target must be in (0, 1)")
        if self.kind == "latency" and not self.window:
            raise ValueError("latency SLO needs a metrics window name")
        if self.kind == "gauge" and self.value_fn is None:
            raise ValueError("gauge SLO needs a value_fn")
        if self.kind == "gauge" and not self.bound > 0:
            raise ValueError("gauge SLO needs a positive bound")
        if self.short_s > self.long_s:
            raise ValueError(
                f"SLO {self.name!r}: short_s {self.short_s:g} > long_s "
                f"{self.long_s:g} — pass windows short-first")


def default_objectives(drop_counters: Sequence[str] = (), state=None,
                       e2e_p99_s: float = 0.5, queue_wait_p99_s: float = 0.25,
                       completion_target: float = 0.999, durability_rows: int = 1024,
                       short_s: float = 60.0, long_s: float = 600.0) -> List[SLO]:
    """The stock objectives: interactive e2e p99, queue-wait p99, the
    completion ratio over the ledger's drop counters (when given) and the
    durability lag of a state lifecycle (when given)."""
    objectives = [
        SLO(name="interactive_p99", kind="latency", window=mn.E2E_LATENCY_INTERACTIVE,
            threshold_s=e2e_p99_s, target=0.99, short_s=short_s, long_s=long_s),
        SLO(name="queue_wait_p99", kind="latency", window=mn.QUEUE_WAIT,
            threshold_s=queue_wait_p99_s, target=0.99, short_s=short_s, long_s=long_s),
    ]
    if drop_counters:
        objectives.append(SLO(name="completion", kind="ratio", target=completion_target,
                              bad_counters=tuple(drop_counters),
                              total_counters=(mn.FRAMES_ADMITTED,),
                              short_s=short_s, long_s=long_s))
    if state is not None:
        objectives.append(SLO(name="durability_lag", kind="gauge",
                              value_fn=lambda: float(state.rows_since_checkpoint),
                              bound=float(durability_rows), short_s=short_s, long_s=long_s))
    return objectives


def loop_liveness_objective(service, stale_s: float = 30.0, short_s: float = 60.0,
                            long_s: float = 600.0) -> SLO:
    """Gauge over ``RecognizerService.loop_staleness_s``: warn once the
    serving loop has not iterated for ``stale_s``, critical at 6x. A
    wedged loop produces no events, so only this gauge escalates it."""
    return SLO(name="loop_liveness", kind="gauge",
               value_fn=lambda: float(service.loop_staleness_s),
               bound=float(stale_s), short_s=short_s, long_s=long_s)


def replication_lag_objective(replica, rows_bound: float = 1024.0, short_s: float = 60.0,
                              long_s: float = 600.0) -> SLO:
    """Gauge over a read replica's ``lag_rows``: warn past ``rows_bound``,
    critical at 6x (a critical verdict browns the replica out)."""
    return SLO(name="replication_lag", kind="gauge",
               value_fn=lambda: float(replica.lag_rows),
               bound=float(rows_bound), short_s=short_s, long_s=long_s)


def disk_free_objective(free_bytes_fn: Callable[[], float], low_watermark_bytes: float,
                        short_s: float = 60.0, long_s: float = 600.0) -> SLO:
    """Gauge over the state volume's free bytes: burn = watermark / free,
    1.0 (warn) at the low watermark, 6.0 (critical) at a sixth of it,
    where ``DurabilityMonitor`` flips degraded. No sample reads 0."""
    watermark = float(low_watermark_bytes)
    if not watermark > 0:
        raise ValueError("disk_free_objective needs a positive low watermark (bytes)")

    def value() -> float:
        free = float(free_bytes_fn())
        if not math.isfinite(free):
            return 0.0
        return watermark / max(1.0, free)

    return SLO(name="disk_free", kind="gauge", value_fn=value, bound=1.0,
               short_s=short_s, long_s=long_s)


def link_health_objective(down_fraction_fn: Callable[[], float],
                          max_down_fraction: float = 0.5, short_s: float = 30.0,
                          long_s: float = 300.0) -> SLO:
    """Gauge over the router's failed-link fraction: burn = fraction /
    ``max_down_fraction``; critical at ``min(6, 1 / bound)`` (a fraction
    tops out at 1.0)."""
    bound = float(max_down_fraction)
    if not bound > 0:
        raise ValueError("link_health_objective needs a positive max_down_fraction")

    def value() -> float:
        return float(down_fraction_fn()) / bound

    return SLO(name="link_health", kind="gauge", value_fn=value, bound=1.0,
               short_s=short_s, long_s=long_s, critical_burn=min(6.0, 1.0 / bound))


def _parity_value(coordinator) -> Callable[[], float]:
    def value() -> float:
        parity = getattr(coordinator, "parity", None)
        return float(parity.disagreement) if parity is not None else 0.0

    return value


def rollout_parity_objective(coordinator, min_agreement: float = 0.98,
                             short_s: float = 60.0, long_s: float = 600.0) -> SLO:
    """Gauge over a rollout's dual-score disagreement (``coordinator.
    parity.disagreement``): warn past ``1 - min_agreement``, critical at
    6x; no parity window reads 0."""
    budget = 1.0 - float(min_agreement)
    if not budget > 0:
        raise ValueError("min_agreement must be < 1.0 (a zero "
                         "disagreement budget can never be scored)")
    return SLO(name="rollout_parity", kind="gauge", value_fn=_parity_value(coordinator),
               bound=budget, short_s=short_s, long_s=long_s)


def registry_parity_objective(coordinator, min_agreement: float = 0.98,
                              short_s: float = 60.0, long_s: float = 600.0) -> SLO:
    """Gauge over a registry swap's detection disagreement, as
    ``rollout_parity_objective``."""
    budget = 1.0 - float(min_agreement)
    if not budget > 0:
        raise ValueError("min_agreement must be < 1.0 (a zero "
                         "disagreement budget can never be scored)")
    return SLO(name="registry_parity", kind="gauge", value_fn=_parity_value(coordinator),
               bound=budget, short_s=short_s, long_s=long_s)


class SLOMonitor:
    """Evaluates ``SLO`` objectives every ``interval_s`` and runs the
    health state machine over them (module docstring)."""

    def __init__(self, metrics, objectives: Sequence[SLO], tracer=None,
                 interval_s: float = 5.0, recovery_evals: int = 2,
                 event_window_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.metrics = metrics
        self.objectives = list(objectives)
        self.tracer = tracer
        self.interval_s = float(interval_s)
        for obj in self.objectives:
            self._validate_objective(obj)
        self.recovery_evals = max(1, int(recovery_evals))
        #: how long a watchdog event holds warn; default the shortest
        #: short window (or the interval)
        self._event_window_explicit = bool(event_window_s)
        self.event_window_s = float(event_window_s) if event_window_s else 0.0
        self._clock = clock
        self._state = STATE_OK
        self._calm_evals = 0
        self._last_eval_t: Optional[float] = None
        #: (t, reason) of recent watchdog events (thread-safe appends)
        self._events: deque = deque(maxlen=1024)
        #: (t, counter snapshot) per evaluation, for the ratio deltas; sized
        #: to the longest long window at the evaluation cadence
        self._counter_ring: deque = deque(maxlen=8)
        self._resize_for_objectives()
        #: one evaluation at a time, claimed without blocking
        self._eval_lock = threading.Lock()
        self._verdict: Dict[str, Any] = {
            "state": STATE_NAMES[STATE_OK], "state_code": STATE_OK,
            "objectives": {}, "events": {}, "evaluations": 0, "ts": None,
        }

    def _validate_objective(self, obj: SLO) -> None:
        """Refuse a latency objective whose windows the metrics' rolling
        horizon cannot answer (longer than the horizon, or shorter than a
        slice)."""
        if obj.kind != "latency":
            return
        window_s = getattr(self.metrics, "window_s", None)
        slice_s = getattr(self.metrics, "window_slice_s", None)
        if window_s is not None and max(obj.short_s, obj.long_s) > window_s:
            raise ValueError(
                f"SLO {obj.name!r} window {max(obj.short_s, obj.long_s):g}s exceeds the "
                f"metrics rolling horizon {window_s:g}s — construct "
                f"Metrics(window_s=...) to cover the longest objective window")
        if slice_s is not None and min(obj.short_s, obj.long_s) < slice_s:
            raise ValueError(
                f"SLO {obj.name!r} window {min(obj.short_s, obj.long_s):g}s is below the "
                f"metrics ring resolution {slice_s:g}s/slice — raise the window or "
                f"construct Metrics with more window_slices")

    def _default_event_window(self) -> float:
        return max(self.interval_s,
                   min((o.short_s for o in self.objectives), default=self.interval_s))

    def _resize_for_objectives(self) -> None:
        """The event window and the counter ring's depth from the current
        objectives (constructor and ``add_objective``); ring entries kept."""
        if not self._event_window_explicit:
            self.event_window_s = self._default_event_window()
        longest_s = max((o.long_s for o in self.objectives), default=self.interval_s)
        depth = int(math.ceil(longest_s / self.interval_s)) + 2
        maxlen = max(8, min(4096, depth))
        if maxlen != self._counter_ring.maxlen:
            self._counter_ring = deque(self._counter_ring, maxlen=maxlen)

    def add_objective(self, obj: SLO) -> None:
        """One more objective after construction (the loop-liveness gauge
        closes over the service, built with the monitor)."""
        self._validate_objective(obj)
        self.objectives.append(obj)
        self._resize_for_objectives()

    # ---- readers (any thread) ----

    @property
    def state_code(self) -> int:
        return self._state

    @property
    def state(self) -> str:
        return STATE_NAMES[self._state]

    def verdict(self) -> Dict[str, Any]:
        """The last evaluation's verdict (never mutated after the swap)."""
        return self._verdict

    def note_event(self, reason: str) -> None:
        """One warn-level watchdog event (any thread)."""
        self._events.append((self._clock(), str(reason)))
        if self.metrics is not None:
            self.metrics.incr(mn.SLO_EVENTS_PREFIX + reason)

    # ---- evaluation ----

    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Evaluate when ``interval_s`` has passed since the last one."""
        now = self._clock() if now is None else now
        if self._last_eval_t is not None and now - self._last_eval_t < self.interval_s:
            return None
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One evaluation; None (nothing evaluated) while another thread
        holds the claim."""
        if not self._eval_lock.acquire(blocking=False):
            return None
        try:
            now = self._clock() if now is None else now
            self._last_eval_t = now
            counters = self.metrics.counters() if self.metrics is not None else {}
            self._counter_ring.append((now, counters))
            per_objective: Dict[str, Dict[str, Any]] = {}
            worst = STATE_OK
            for obj in self.objectives:
                result = self._evaluate_one(obj, now, counters)
                per_objective[obj.name] = result
                worst = max(worst, result["state_code"])
                if self.metrics is not None:
                    self.metrics.set_gauge(mn.SLO_BURN_PREFIX + obj.name, result["burn"])
            active_events = self._active_events(now)
            if active_events and worst < STATE_WARN:
                worst = STATE_WARN
            prev = self._state
            state = self._advance_state(worst)
            verdict = {
                "state": STATE_NAMES[state],
                "state_code": state,
                "raw_state": STATE_NAMES[worst],
                "objectives": per_objective,
                "events": active_events,
                "evaluations": self._verdict["evaluations"] + 1,
                "ts": time.time(),
            }
            self._verdict = verdict
            # inside the claim, so a stale evaluator cannot overwrite them
            if self.metrics is not None:
                self.metrics.incr(mn.SLO_EVALUATIONS)
                self.metrics.set_gauge(mn.HEALTH_STATE, state)
        finally:
            self._eval_lock.release()
        # the span and the dump (file I/O) outside the claim
        if state != prev:
            self._note_transition(prev, state, verdict)
        return verdict

    def _active_events(self, now: float) -> Dict[str, int]:
        lo = now - self.event_window_s
        active: Dict[str, int] = {}
        for t, reason in tuple(self._events):  # a copy: appends come from other threads
            if t >= lo:
                active[reason] = active.get(reason, 0) + 1
        return active

    def _evaluate_one(self, obj: SLO, now: float, counters: Dict[str, float]) -> Dict[str, Any]:
        if obj.kind == "latency":
            burns = self._latency_burns(obj)
        elif obj.kind == "ratio":
            burns = self._ratio_burns(obj, now, counters)
        else:
            burns = self._gauge_burns(obj)
        (burn_short, n_short), (burn_long, n_long) = burns
        state = STATE_OK
        enough = obj.kind == "gauge" or min(n_short, n_long) >= obj.min_events
        if enough:
            if burn_short >= obj.critical_burn and burn_long >= obj.critical_burn:
                state = STATE_CRITICAL
            elif burn_short >= obj.warn_burn and burn_long >= obj.warn_burn:
                state = STATE_WARN
        result = {
            "kind": obj.kind,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
            "burn": round(max(burn_short, burn_long), 4),
            "events_short": n_short,
            "events_long": n_long,
            "state": STATE_NAMES[state],
            "state_code": state,
        }
        if not enough:
            result["low_volume"] = True
        return result

    def _latency_burns(self, obj: SLO):
        budget = 1.0 - obj.target
        if getattr(self.metrics, "window_count", None) is None:
            return [(0.0, 0), (0.0, 0)]  # no histograms: no events
        out = []
        for horizon in (obj.short_s, obj.long_s):
            count = self.metrics.window_count(obj.window, horizon_s=horizon)
            frac = (self.metrics.fraction_above(obj.window, obj.threshold_s, horizon_s=horizon)
                    if count else 0.0)
            out.append((frac / budget, count))
        return out

    def _ratio_burns(self, obj: SLO, now: float, counters: Dict[str, float]):
        budget = 1.0 - obj.target
        out = []
        for horizon in (obj.short_s, obj.long_s):
            base = self._snapshot_at(now - horizon)
            bad = sum(counters.get(k, 0.0) - base.get(k, 0.0) for k in obj.bad_counters)
            total = sum(counters.get(k, 0.0) - base.get(k, 0.0) for k in obj.total_counters)
            frac = (bad / total) if total > 0 else 0.0
            out.append((max(0.0, frac) / budget, int(max(0.0, total))))
        return out

    def _snapshot_at(self, t: float) -> Dict[str, float]:
        """The newest counter snapshot at or before ``t`` (the delta covers
        at least the horizon); empty, i.e. since the start, when the ring
        does not reach back that far."""
        best: Dict[str, float] = {}
        for ts, snap in self._counter_ring:
            if ts <= t:
                best = snap
            else:
                break
        return best

    def _gauge_burns(self, obj: SLO):
        try:
            value = float(obj.value_fn())
        except Exception:  # noqa: BLE001 - a dead probe reads 0, counted
            if self.metrics is not None:
                self.metrics.incr(mn.SLO_PROBE_FAILURES)
            value = 0.0
        burn = (value / obj.bound) if obj.bound > 0 else 0.0
        return [(burn, 1), (burn, 1)]

    def _advance_state(self, worst: int) -> int:
        """Escalate at once; fall one level per ``recovery_evals`` calmer
        evaluations in a row."""
        prev = self._state
        if worst >= prev:
            self._calm_evals = 0
            self._state = worst
        else:
            self._calm_evals += 1
            if self._calm_evals >= self.recovery_evals:
                self._calm_evals = 0
                self._state = prev - 1
        return self._state

    def _note_transition(self, prev: int, new: int, verdict: Dict[str, Any]) -> None:
        if self.metrics is not None:
            self.metrics.incr(mn.SLO_TRANSITIONS)
        tracer = self.tracer
        if tracer is not None:
            from opencv_facerecognizer_tpu_torch.utils import tracing

            tracer.emit(tracer.new_trace(), "health", topic=tracing.LIFECYCLE_TOPIC,
                        from_state=STATE_NAMES[prev], to_state=STATE_NAMES[new])
            if new == STATE_CRITICAL:
                tracer.dump("slo_critical", extra={"verdict": {
                    k: verdict[k] for k in ("state", "objectives", "events")}})
