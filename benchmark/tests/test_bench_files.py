"""Every cell of BENCHMARK.json finds its configuration, traffic and
metric files by name, and the files say what the contract needs."""

import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_resolve(cell):
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"]
    assert wl["traffic"]["kind"] == cell["traffic"]
    assert (BENCH / "traffic" / f"{cell['traffic']}.py").is_file()
    conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"]
    assert set(cfg["limits"]) == {"box_px", "score", "selection", "sim", "label_gap"}


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_resolve(metric):
    import run

    mod = run.load_module(BENCH / "metrics" / f"{metric['name']}.py")
    assert callable(mod.read)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for k in ("end_to_end", "per_layer") for n in
                   (x["name"] for x in SPEC[k]))) == len(SPEC["end_to_end"]) + len(
        SPEC["per_layer"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_what_it_must(cell):
    import run

    e2e, layer = run.cell_metrics(SPEC, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
