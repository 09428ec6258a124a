"""Readings that the check's limits are set from, for one configuration.

    python3 benchmark/calibrate.py --workload <cell> --control-seeds 1,2,3 \
        [--program-seeds 4,5,...] [--seconds 5]

``--control-seeds``: the control, the plain reference computed in float8
(e4m3, a scale a tensor) put in the system's place, answers every frame of
the pool at the configuration's own size and is judged like the system;
each seed prints its numbers. ``--program-seeds``: whole runs of the cell
(``run.run_cell``, the window at ``--seconds``) one after the other in this
process, each printing its numbers. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--traffic", default="{}",
                   help="JSON object of traffic parameters that replace the cell's")
    args = p.parse_args(argv)
    import torch

    import check

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = run.load_json(run.HERE / "workloads" / f"{args.workload}.json")
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    run.log(f"card: {run.card_line()}")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        prep = run.prepare_inputs(cfg, seed, device)
        ref = run.reference_for(cfg, seed, prep, device)
        ctl = run.reference_for(cfg, seed, prep, device, quant=check.fp8_quant)
        pool = list(range(cfg["frames"]["pool"]))
        numbers = check.judge(check.control_answers(
            ctl, pool, cfg["service"]["similarity_threshold"]), ref, cfg["detector"])
        print(json.dumps({"control": "fp8", "config": cfg["name"], "seed": seed,
                          "numbers": numbers, "s": time.perf_counter() - t}), flush=True)
        del prep, ref, ctl
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.program_seeds.split(",") if s]:
        r = run.run_cell(args.workload, seed, args.seconds, False, device,
                         traffic_override=json.loads(args.traffic))
        print(json.dumps({"program": args.workload, "seed": seed, "numbers": r["numbers"],
                          "correct": r["correct"], "kept": r["kept"],
                          "traffic": json.loads(args.traffic), "measured": r["measured"],
                          "timings": r["timings"], "ledger": r["ledger"],
                          "sent": r["sent"], "answered": r["answered"],
                          "gc": r["gc"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
