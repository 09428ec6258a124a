"""What the per-layer metrics read: the tracer's spans inside the window
and the profiled device slice. Each metric's own file under ``metrics/``
calls one of these; a reading with nothing to read is None, and the
metric is then left out of the result.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

import roofline


class Context:
    """One traced run as the readers see it.

    ``spans``: the service's spans by stage, each starting inside the
    measured window; ``device``: the profiled ``DeviceSlice`` (or None);
    ``step_flops(bucket)``: the operations of one step at that rung;
    ``cfg``: the configuration."""

    def __init__(self, cfg: dict, spans: Dict[str, List[dict]], device,
                 step_flops: Callable[[int], float]):
        self.cfg = cfg
        self.spans = spans
        self.device = device
        self.step_flops = step_flops


def span_median_ms(ctx: Context, stage: str) -> Optional[float]:
    durs = [s["dur"] for s in ctx.spans.get(stage, ())
            if stage != "dispatch" or s.get("exit") == "full"]
    return float(np.median(durs)) * 1e3 if durs else None


def publish_ms(ctx: Context) -> Optional[float]:
    """Median over batches of ``ready_wait`` + ``publish``."""
    ready = {s["trace"]: s["dur"] for s in ctx.spans.get("ready_wait", ())}
    both = [ready[s["trace"]] + s["dur"] for s in ctx.spans.get("publish", ())
            if s["trace"] in ready]
    return float(np.median(both)) * 1e3 if both else None


def steps_in_slice(ctx: Context) -> int:
    """Steps that ran in the slice: one NMS keep kernel a step."""
    return 0 if ctx.device is None else len(ctx.device.select(roofline.KERNEL_C))


def slice_rungs(ctx: Context) -> List[int]:
    """The rung (frames a step, padding included) of each step dispatched
    inside the profiled slice."""
    sl = ctx.device
    if sl is None:
        return []
    return [int(s["bucket"]) for s in ctx.spans.get("dispatch", ())
            if s.get("exit") == "full" and sl.t0 <= s["t0"] < sl.t1]


def step_device_ms(ctx: Context) -> Optional[float]:
    n = steps_in_slice(ctx)
    if not n:
        return None
    return float((ctx.device.end - ctx.device.start).sum()) / n * 1e3


def idle_share_pct(ctx: Context) -> Optional[float]:
    sl = ctx.device
    if sl is None or sl.length_s <= 0 or not len(sl.names):
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.length_s)


def step_mfu_pct(ctx: Context) -> Optional[float]:
    """Operations of the steps that ran in the slice (each at its rung's
    shapes) over the time the device was busy in it, as a share of the
    bf16 peak: the whole step's share while it runs."""
    n, rungs = steps_in_slice(ctx), slice_rungs(ctx)
    if not n or not rungs:
        return None
    flops = n * float(np.mean([ctx.step_flops(b) for b in rungs]))
    return 100.0 * flops / ctx.device.busy_s() / roofline.BF16_FLOPS


def kernel_a_roofline_pct(ctx: Context) -> Optional[float]:
    """Kernel A's least time at the slice's rungs (queries: a rung's face
    slots) over its mean device time a call in the slice."""
    rungs = slice_rungs(ctx)
    t = ctx.device.select(roofline.KERNEL_A) if ctx.device is not None else []
    if not rungs or not len(t):
        return None
    gal, faces = ctx.cfg["gallery"], ctx.cfg["detector"]["max_faces"]
    bound = np.mean([roofline.kernel_a_bound_s(b * faces, gal["rows"], gal["dim"])[0]
                     for b in rungs])
    return 100.0 * float(bound) / float(t.mean())


def kernel_b_roofline_pct(ctx: Context) -> Optional[float]:
    """Kernel B's least time for one forward of a step's faces at the
    slice's rungs over its device time a step in the slice (every block's
    launches)."""
    n, rungs = steps_in_slice(ctx), slice_rungs(ctx)
    t = ctx.device.select(roofline.KERNEL_B) if ctx.device is not None else []
    if not n or not rungs or not len(t):
        return None
    e, faces = ctx.cfg["embedder"], ctx.cfg["detector"]["max_faces"]
    blocks = roofline.sep_blocks(e["face_size"], e["stem_features"], e["stage_features"],
                                 e["stage_blocks"])
    bound = np.mean([roofline.sepblock_bound_s(b * faces, blocks)[0] for b in rungs])
    return 100.0 * float(bound) / (float(t.sum()) / n)
