"""A short profiled slice of the window: device operations only, read from
``torch.profiler``'s trace and put on the host's ``time.monotonic()``
clock, so the tracer's spans can name what the host was doing in each idle
gap. No trace file is written.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class DeviceSlice:
    """Device operations of one profiled slice: names, starts and ends on
    the monotonic clock."""

    def __init__(self, names: List[str], start: np.ndarray, end: np.ndarray, t0: float,
                 t1: float):
        self.names = names
        self.start = start
        self.end = end
        self.t0 = t0
        self.t1 = t1

    @property
    def length_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, clipped to the slice."""
        order = np.argsort(self.start)
        out: List[Tuple[float, float]] = []
        for s, e in zip(np.clip(self.start[order], self.t0, self.t1),
                        np.clip(self.end[order], self.t0, self.t1)):
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self.busy_intervals()))

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals between busy ones inside the slice."""
        out, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < self.t1:
            out.append((at, self.t1))
        return out

    def select(self, needle: str) -> np.ndarray:
        """Durations (s) of the operations whose name holds ``needle``."""
        idx = [i for i, n in enumerate(self.names) if needle in n]
        return (self.end - self.start)[idx]

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, d in zip(self.names, self.end - self.start):
            out[n] = out.get(n, 0.0) + float(d)
        return out


class Profiler:
    """``start`` / ``stop`` one slice; ``warm`` once in set-up so that the
    profiler's own start-up cost falls outside the window."""

    def __init__(self):
        self._prof = None
        self._wall0 = self._mono0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._mono0 = time.monotonic()
        self._wall0 = time.time_ns()
        self._prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> DeviceSlice:
        from torch.autograd import DeviceType

        t1 = time.monotonic()
        self._prof.__exit__(None, None, None)
        names, start, end = [], [], []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = self._mono0 + (ev.start_ns() - self._wall0) / 1e9
            names.append(ev.name())
            start.append(s)
            end.append(s + ev.duration_ns() / 1e9)
        self._prof = None
        return DeviceSlice(names, np.asarray(start), np.asarray(end), self.t0, t1)

    def warm(self, fn) -> None:
        self.start()
        fn()
        self.stop()


def host_label(t: float, spans: Dict[str, np.ndarray]) -> str:
    """What the host was doing at ``t``: a batch in ``dispatch`` (the
    serving thread), in ``publish`` (the readback thread), a batch in
    flight (``in_flight``), else waiting for frames (``batch_fill``)."""
    for stage in ("dispatch", "publish", "ready_wait"):
        iv = spans.get(stage)
        if iv is not None and len(iv) and np.any((iv[:, 0] <= t) & (t < iv[:, 1])):
            return "in_flight" if stage == "ready_wait" else stage
    return "batch_fill"


def breakdown(sl: DeviceSlice, spans: Optional[Dict[str, np.ndarray]], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the host's state at their middle."""
    ops = sorted(sl.by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(sl.gaps(), key=lambda g: g[0] - g[1])[:top]
    named = [[host_label((a + b) / 2, spans or {}), b - a] for a, b in gaps]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": named}
