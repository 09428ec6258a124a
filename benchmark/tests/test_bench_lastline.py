"""The last line's keys, and the refusal without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import run
import small

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    r = small.run(trace=trace)
    out = run.result_line(r, "NVIDIA H100 80GB HBM3", trace)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == (dev | {"busy_s", "window_s"} if trace else dev)
    names = set(out["metrics"])
    assert names == ({"queue_wait_ms.live", "dispatch_ms.live", "publish_ms.live"} if trace
                     else {"frame_p50_ms", "setup_s"})
    assert set(out["checked"]) == {"box_px", "score", "selection", "sim", "label_gap", "lost"}
    json.dumps(out)


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "serve_1m.live", "--seed", str(2 ** 32 + 1), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=str(BENCH.parent))
    assert proc.returncode != 0 and proc.stdout == ""
