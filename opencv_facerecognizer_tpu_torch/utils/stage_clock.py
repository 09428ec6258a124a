"""Seconds by stage of a training run (read, preprocess, pca, lda, fit,
predict, save), for ``ocvf-train-torch``'s report.

Code marks its work with ``with stage("fit"):``. Outside a recording the
mark does nothing. Inside ``record()`` (one at a time, per process) each
stage's own time is added to its total: a stage entered inside another
pauses the outer one, so every second is counted once. The card runs
asynchronously, so at each stage boundary a recording synchronizes the
device it was given; the stages then hold the device work they queued.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


class StageClock:
    """Totals (seconds) and entry counts by stage name."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []
        self._mark = 0.0

    def _tick(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _charge(self) -> None:
        now = self._tick()
        if self._stack:
            self.seconds[self._stack[-1]] += now - self._mark
        self._mark = now

    def enter(self, name: str) -> None:
        self._charge()
        self._stack.append(name)
        self.counts[name] += 1

    def exit(self) -> None:
        self._charge()
        self._stack.pop()

    def report(self) -> dict:
        return {"seconds": dict(self.seconds), "counts": dict(self.counts)}


_active: Optional[StageClock] = None


@contextlib.contextmanager
def record(device: Optional[torch.device] = None) -> Iterator[StageClock]:
    """Record the stages of the code run inside; yields the clock."""
    global _active
    if _active is not None:
        raise RuntimeError("a stage recording is already active")
    clock = _active = StageClock(device)
    clock.enter("other")
    try:
        yield clock
    finally:
        clock.exit()
        _active = None


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Attribute the enclosed work to ``name`` while a recording is active."""
    clock = _active
    if clock is None:
        yield
        return
    clock.enter(name)
    try:
        yield
    finally:
        clock.exit()
