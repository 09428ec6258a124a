"""Small sizes the CPU can run the harness at: a gallery of 4096 rows, a
pool of 16 frames, batches of 8 (one rung), a short window. The cell is
``serve_1m.live`` with its own traffic, the camera fleet, cut to four
cameras (about 150 frames a run)."""

import torch

CFG = {"gallery": {"rows": 4096}, "frames": {"batch": 8, "pool": 16},
       "service": {"bucket_sizes": [8]}}
TRAFFIC = {"cameras": 4, "preroll_s": 0.5}
SECONDS = 2.0
CPU = torch.device("cpu")


def run(seed=20251018, fault=None, trace=False):
    import run as harness

    torch.set_num_threads(4)
    harness.SAMPLE = 10 ** 9  # keep every answer: the CPU sends few
    return harness.run_cell("serve_1m.live", seed, SECONDS, trace, CPU, cfg_override=CFG,
                            traffic_override=TRAFFIC, fault=fault)
