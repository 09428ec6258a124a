"""Run one cell of the benchmark of ``opencv_facerecognizer_tpu_torch``.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``benchmark/workloads/<name>.json``)
names its configuration (``benchmark/configs/<config>.json``) and its
traffic (a kind, ``benchmark/traffic/<kind>.py``, with its parameters).
The run makes every input from ``--seed`` (weights on the card, a pool of
frames, the gallery's rows with some of the reference's own embeddings
planted among them), builds the live recognizer, captures its rungs,
freezes what set-up made against the garbage collector, drives the
recognizer through the benchmark's in-process connector for a pre-roll
and then ``--seconds`` of measured window, waits for every answer, frees
the system, and judges a seeded sample of the window's answers against the
plain reference (``check.py``). With ``--trace 1`` the service's tracer
records every span and ``torch.profiler`` records the device's operations
over a slice at the end of the window; the cell's per-layer metrics
(``benchmark/metrics/<name>.py``, as ``BENCHMARK.json`` lists them) are
read from those, and the end-to-end metrics are not reported.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), ``breakdown`` when traced, and last
``checked``, every number the check compared beside its limit. The same
numbers end standard error. Without a CUDA card, the run exits non-zero
and prints no result.
"""

from __future__ import annotations


def _process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age_s()

import time  # noqa: E402

_T0 = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

#: top-level modules that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "opencv_facerecognizer_tpu")
#: seconds past the window's close to wait for the last answers
ANSWER_WAIT_S = 60.0
#: results kept for the check, about this many a run
SAMPLE = 4096
#: seconds after which a run still going prints every thread's stack to
#: standard error (a run ends within 360 s; the dump names where one hangs)
STACKS_AFTER_S = 300.0
#: the profiled slice's length (s); it ends as the window closes, so that the
#: profiler's stop, which holds the interpreter for about a second while it
#: reads the trace, stalls the service only after the window
SLICE_S = 1.5


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark's own, found by file name."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    this cell reports."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class GCWatch:
    """Pauses of the interpreter's garbage collector while attached: the
    number, total and longest by generation (a pause stops every thread)."""

    def __init__(self):
        self.pauses: Dict[int, list] = {}
        self._t = 0.0

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.setdefault(info["generation"], []).append(time.perf_counter() - self._t)

    def summary(self) -> dict:
        return {g: {"n": len(v), "total_ms": 1e3 * sum(v), "max_ms": 1e3 * max(v)}
                for g, v in sorted(self.pauses.items())}


def unaccounted(flog, ledger: dict) -> float:
    """Frames sent that the service has neither answered nor settled: a
    frame it refused or dropped is a failure of the run (``failed``), one
    it never accounts for is lost."""
    settled = (flog.count - ledger["admitted"]) + sum(ledger["drops_by_reason"].values())
    return flog.count - flog.answered - settled


def wait_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.1))


def prepare_inputs(cfg: dict, seed: int, device) -> dict:
    """The run's inputs from ``seed``: the weights, the pool of frames (host
    and device), and the planted rows (the reference's own embeddings of
    a seeded share of the pool's valid face slots) with their positions;
    ``reference_s``, the seconds of the reference's pass that made them."""
    import numpy as np
    import torch

    import check
    import inputs

    det_cfg, emb_cfg, fr, gal = cfg["detector"], cfg["embedder"], cfg["frames"], cfg["gallery"]
    det_w, emb_w = inputs.make_weights(seed, det_cfg, emb_cfg, device)
    pool_np = inputs.make_scenes(fr["pool"], (fr["height"], fr["width"]), fr["scene_faces"],
                                 tuple(fr["scene_face_px"]), inputs.sub_seed(seed, 5))
    pool_dev = torch.from_numpy(pool_np).to(device)
    t = time.perf_counter()
    own = check.Reference(det_w, emb_w, det_cfg, emb_cfg, pool_dev, lambda: []).recognize(
        list(range(fr["pool"])))
    valid = own["valid"].reshape(-1)
    slots = torch.nonzero(valid).reshape(-1)
    rng = np.random.default_rng(inputs.sub_seed(seed, 6))
    n_plant = int(len(slots) * gal["planted_share"])
    pick = torch.as_tensor(np.sort(rng.choice(len(slots), n_plant, replace=False)),
                           device=device, dtype=torch.int64)
    planted = own["emb"].reshape(-1, own["emb"].shape[-1])[slots[pick]].contiguous()
    valid_share = float(valid.float().mean())
    reference_s = time.perf_counter() - t
    return {"det_w": det_w, "emb_w": emb_w, "pool_np": pool_np, "pool_dev": pool_dev,
            "planted": planted, "positions": inputs.plant_positions(seed, gal["rows"], n_plant),
            "valid_share": valid_share, "reference_s": reference_s}


def reference_for(cfg: dict, seed: int, prep: dict, device, quant=None):
    """The plain reference over the run's inputs; the gallery's rows drawn
    again block by block, the planted rows written over them."""
    import torch

    import check
    import inputs

    gal = cfg["gallery"]
    pos = torch.as_tensor(prep["positions"], device=device)

    def row_blocks():
        for b, start, n in inputs.blocks(gal["rows"]):
            block = inputs.row_block(seed, b, n, gal["dim"], device)
            mine = (pos >= start) & (pos < start + n)
            if bool(mine.any()):
                block[pos[mine] - start] = prep["planted"][mine]
            yield start, block

    return check.Reference(prep["det_w"], prep["emb_w"], cfg["detector"], cfg["embedder"],
                           prep["pool_dev"], row_blocks, quant=quant)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             cfg_override: Optional[dict] = None, traffic_override: Optional[dict] = None,
             fault=None) -> dict:
    """One run of ``workload``; the result object. ``cfg_override`` and
    ``traffic_override`` replace keys of the configuration and of the
    cell's traffic (the CPU tests' small sizes); ``fault``, when given, is
    called with the built pipeline before the window (the tests' broken
    paths)."""
    import numpy as np
    import torch

    import check
    import inputs
    import system
    from devtrace import Profiler, breakdown
    from readings import Context
    from stepflops import step_flops

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_json(HERE / "workloads" / f"{workload}.json")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    cell["traffic"].update(traffic_override or {})
    for key, value in (cfg_override or {}).items():
        cfg[key] = {**cfg[key], **value} if isinstance(value, dict) else value
    e2e_defs, layer_defs = cell_metrics(bench, workload)
    det_cfg, emb_cfg, fr, gal = cfg["detector"], cfg["embedder"], cfg["frames"], cfg["gallery"]
    cuda = device.type == "cuda"
    timings: Dict[str, float] = {}

    timings["imports_s"] = time.monotonic() - _T0
    if cuda:
        t = time.perf_counter()
        torch.cuda.init()
        timings["cuda_init_s"] = time.perf_counter() - t
        timings["kernel_build_s"] = system.build_kernels()
    t = time.perf_counter()
    prep = prepare_inputs(cfg, seed, device)
    # the reference's pass is the check's work: it counts in neither the
    # set-up time nor the peak of the card's memory
    timings["inputs_s"] = time.perf_counter() - t - prep["reference_s"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    det_w, emb_w, pool_np = prep["det_w"], prep["emb_w"], prep["pool_np"]
    t = time.perf_counter()
    rows = inputs.gallery_rows(seed, gal["rows"], gal["dim"], device, prep["planted"],
                               prep["positions"])
    labels = np.arange(gal["rows"], dtype=np.int32)
    timings["rows_s"] = time.perf_counter() - t
    log(f"inputs: {fr['pool']} frames, {prep['valid_share']:.4f} of the pool's face slots "
        f"valid in the reference, {len(prep['positions'])} planted among {gal['rows']} rows")

    traffic = load_module(HERE / "traffic" / f"{cell['traffic']['kind']}.py").make(
        cell["traffic"], inputs.sub_seed(seed, 7), fr["pool"])
    cap = traffic.capacity(seconds)
    from connector import BenchConnector, FrameLog

    keep = np.random.default_rng(inputs.sub_seed(seed, 8)).random(cap) < min(
        1.0, SAMPLE / max(1.0, traffic.frames(seconds)))
    flog = FrameLog(cap, keep)
    conn = BenchConnector(flog)
    tracer = system.make_tracer(cap) if trace else None
    service, pipeline, built = system.build_service(cfg, det_w, emb_w, rows, labels, conn,
                                                    device, tracer)
    timings.update(built)
    del rows
    timings["capture_s"] = system.start(service)
    if fault is not None:
        fault(pipeline)
    prof = Profiler() if trace and cuda else None
    if prof is not None:
        prof.warm(lambda: torch.cuda.synchronize(device))
    # what set-up made (torch, the port, the nets, the service) is kept for
    # the whole run: frozen, the collector's oldest generation no longer
    # rescans it, a pause of 0.14-0.22 s twice a run on an H100 host that let
    # the batcher's bound overflow in the burst of frames behind it
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    timings["gc_freeze_s"] = time.perf_counter() - t

    # the window: traffic from t_open, measured over [w0, w1)
    t_open = time.monotonic()
    w0 = t_open + traffic.preroll_s
    w1 = w0 + seconds
    gc_watch = GCWatch()
    gc.callbacks.append(gc_watch)
    traffic.start(conn, pool_np, t_open, w1)
    setup_s = _AGE0 + (w0 - _T0) - prep["reference_s"]
    dev_slice = None
    if prof is not None:
        wait_until(max(w0, w1 - SLICE_S))
        prof.start()
        wait_until(w1)
        dev_slice = prof.stop()
    wait_until(w1)
    gc.callbacks.remove(gc_watch)
    traffic.join()
    deadline = time.monotonic() + ANSWER_WAIT_S
    while unaccounted(flog, service.ledger()) > 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    service.drain(timeout=max(0.0, deadline - time.monotonic()))
    service.stop()
    gc.unfreeze()
    measured = traffic.measure(flog, w0, w1)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics: Dict[str, dict] = {}
    extra: dict = {}
    if trace:
        spans: Dict[str, list] = {}
        intervals: Dict[str, list] = {}
        for s in tracer.snapshot():
            intervals.setdefault(s["stage"], []).append((s["t0"], s["t0"] + s["dur"]))
            if w0 <= s["t0"] < w1:
                spans.setdefault(s["stage"], []).append(s)
        flops = {}

        def flops_at(bucket: int) -> float:
            if bucket not in flops:
                flops[bucket] = step_flops(cfg, bucket)
            return flops[bucket]

        ctx = Context(cfg, spans, dev_slice, flops_at)
        for m in layer_defs:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if dev_slice is not None:
            extra["busy_s"] = dev_slice.busy_s()
            extra["window_s"] = dev_slice.length_s
            iv = {k: np.asarray(v) for k, v in intervals.items()}
            extra["breakdown"] = breakdown(dev_slice, iv)
    else:
        for m in e2e_defs:
            value = setup_s if m["name"] == "setup_s" else measured.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ledger = service.ledger()
    del service, pipeline, tracer, conn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: the reference works everything out again from the inputs
    t = time.perf_counter()
    ref = reference_for(cfg, seed, prep, device)
    numbers = check.judge(flog.kept, ref, det_cfg)
    numbers["lost"] = float(unaccounted(flog, ledger))
    limits = {**cfg["limits"], "lost": 0.0}
    correct = bool(flog.kept) and all(numbers[k] <= limits[k] for k in limits)
    timings["check_s"] = time.perf_counter() - t

    found = forbidden_modules()
    return {"measured": measured, "metrics": metrics, "extra": extra, "numbers": numbers,
            "limits": limits, "correct": correct, "kept": len(flog.kept),
            "timings": timings, "setup_s": setup_s, "peak": peak, "ledger": ledger,
            "forbidden": found, "valid_share": prep["valid_share"], "sent": flog.count,
            "answered": flog.answered, "statuses": flog.statuses,
            "reference_s": prep["reference_s"], "gc": gc_watch.summary()}


def result_line(r: dict, kind: str, trace: bool) -> dict:
    """The last line's object from ``run_cell``'s result: the contract's
    keys, ``breakdown`` when the run traced the device, ``checked`` last."""
    m = r["measured"]
    device_rec = {"platform": "gpu", "kind": kind, "count": 1, "memory_peak_bytes": r["peak"]}
    out = {"correct": r["correct"], "attempted": m["attempted"], "failed": m["failed"],
           "metrics": r["metrics"], "device": device_rec}
    if trace:
        device_rec["busy_s"] = r["extra"].get("busy_s", 0.0)
        device_rec["window_s"] = r["extra"].get("window_s", 0.0)
        if "breakdown" in r["extra"]:
            out["breakdown"] = r["extra"]["breakdown"]
    out["checked"] = {k: {"value": r["numbers"][k], "limit": r["limits"][k]}
                      for k in r["limits"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    faulthandler.dump_traceback_later(STACKS_AFTER_S)
    os.environ.setdefault("USE_FLAX", "0")
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))

    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"no result: this cell needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    r = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    if r["forbidden"]:
        log(f"no result: modules {r['forbidden']} were loaded in the measured process")
        return 4
    m = r["measured"]
    t = r["timings"]
    log("set-up (s): " + ", ".join(f"{k} {v:.3f}" for k, v in t.items() if k != "check_s")
        + f"; setup_s {r['setup_s']:.3f} (process start to the window, less the "
        f"reference's pass that made the planted rows: {r['reference_s']:.3f} s)")
    log(f"sent {r['sent']}, answered {r['answered']}; ledger {r['ledger']}; "
        f"statuses {r['statuses']}")
    log(f"garbage collector's pauses from the pre-roll to the close, by generation: {r['gc']}")
    log(f"p50 of the window (ms): {m['frame_p50_ms']}, of its first and second halves: "
        f"{m['p50_by_half_ms']}; p95 of the window: {m['frame_p95_ms']}")
    log(f"generator lateness (ms): {m['lateness_ms']}")
    log(f"check: {r['kept']} answers compared in {t['check_s']:.3f} s")
    out = result_line(r, torch.cuda.get_device_name(device), bool(args.trace))
    for k, v in out["checked"].items():
        log(f"checked {k}: {v['value']:.6g} (limit {v['limit']:.6g})")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
