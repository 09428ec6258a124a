"""Open loop: a fleet of independent cameras, each sending ``fps`` frames a
second with a seeded phase and each interval jittered by up to ``jitter``
of itself, whether or not earlier frames were answered. A frame is timed
from when it was due to when its result reached the subscriber, so a
stall shows in the frames behind it.

Parameters: ``cameras``, ``fps``, ``jitter``, ``preroll_s`` (traffic
before the window opens, so the queue settles). Each camera shows the
pool in order from its own seeded offset, cycled.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class CameraFleet:
    def __init__(self, params: dict, seed: int, pool: int):
        self.cameras = int(params["cameras"])
        self.fps = float(params["fps"])
        self.jitter = float(params["jitter"])
        self.preroll_s = float(params["preroll_s"])
        self.pool = int(pool)
        self.seed = int(seed)
        self._thread = None

    def schedule(self, span_s: float):
        """(due offsets from the start [n], pool indices [n]) of every
        frame due within ``span_s``, in due order."""
        rng = np.random.default_rng(self.seed)
        period = 1.0 / self.fps
        per_cam = int(span_s * self.fps * (1 + self.jitter)) + 2
        phase = rng.uniform(0.0, period, self.cameras)
        steps = period * (1.0 + rng.uniform(-self.jitter, self.jitter,
                                            (self.cameras, per_cam - 1)))
        due = np.concatenate([phase[:, None], phase[:, None] + np.cumsum(steps, 1)], 1)
        start = rng.integers(self.pool, size=self.cameras)
        pool = (start[:, None] + np.arange(per_cam)[None, :]) % self.pool
        due, pool = due.reshape(-1), pool.reshape(-1)
        order = np.argsort(due, kind="stable")
        due, pool = due[order], pool[order]
        keep = due < span_s
        return due[keep], pool[keep].astype(np.int32)

    def frames(self, seconds: float) -> float:
        """Frames due, on average, in the pre-roll and a window of ``seconds``."""
        return self.cameras * self.fps * (seconds + self.preroll_s)

    def capacity(self, seconds: float) -> int:
        """The most frames that can be due in them (every interval at its shortest)."""
        return int(self.frames(seconds) * (1 + self.jitter)) + 16

    def start(self, conn, frames: np.ndarray, t_open: float, t_close: float) -> None:
        offsets, pool = self.schedule(t_close - t_open)
        log = conn.log
        n = min(len(offsets), log.capacity)
        log.due[:n] = t_open + offsets[:n]

        def run():
            for seq in range(n):
                due = log.due[seq]
                while True:
                    wait = due - time.monotonic()
                    if wait <= 0:
                        break
                    time.sleep(min(wait, 0.05))
                conn.send_frame(seq, int(pool[seq]), frames[pool[seq]])

        self._thread = threading.Thread(target=run, name="bench-camera-fleet", daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join(timeout=120.0)

    def measure(self, log, w0: float, w1: float) -> dict:
        """``frame_p50_ms`` and ``frame_p95_ms`` over every frame due in the
        window, due to answered (a frame never answered counts as
        infinitely late, and in ``failed``); the generator's lateness."""
        n = log.count
        due = log.due[:len(log.due)]
        mask = (due >= w0) & (due < w1)
        lat = (log.arrived - log.due)[mask]
        failed = int(np.isnan(lat).sum())
        lat = np.where(np.isnan(lat), np.inf, lat) * 1e3
        late = (log.sent[:n] - log.due[:n])
        late = late[~np.isnan(late)] * 1e3
        q = (lambda a, p: float(np.quantile(a, p, method="inverted_cdf"))) if len(lat) else None
        half = (w0 + w1) / 2
        first = lat[due[mask] < half]
        second = lat[due[mask] >= half]
        return {"frame_p50_ms": q(lat, 0.5) if q else None,
                "p50_by_half_ms": [q(first, 0.5) if len(first) else None,
                                   q(second, 0.5) if len(second) else None],
                "frame_p95_ms": q(lat, 0.95) if q else None,
                "attempted": int(mask.sum()), "failed": failed,
                "lateness_ms": {"p50": float(np.median(late)) if len(late) else None,
                                "p99": float(np.quantile(late, 0.99)) if len(late) else None,
                                "max": float(late.max()) if len(late) else None}}


def make(params: dict, seed: int, pool: int) -> CameraFleet:
    return CameraFleet(params, seed, pool)
