"""Scenario twins, part one: ``soak``, ``overload``, ``recovery``,
``replication`` and ``video`` of the port's ``apps/chaos_soak.py`` against
``scripts/chaos_soak.py`` (loaded by path), each at the reference's
tier-1 seconds and seed. Both reports must be ``ok``, and the fields the
seed determines (``SEEDED``: the drawn rates, the scripted plan and what
it injected) equal. Timing fields (latencies, offered counts of
wall-clock loops) are not compared. The port's ``soak`` runs its tiny
stack on the CPU (``device="cpu"``); the others run on the fakes, as in
the reference. The long randomized variants are marked ``slow``."""

import importlib.util
import os

import pytest

from opencv_facerecognizer_tpu_torch.apps import chaos_soak as port_soak

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chaos_soak", os.path.join(REPO_ROOT, "scripts", "chaos_soak.py"))
jax_soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_soak)

#: scenario -> the report fields (``/``-paths) the seed determines
SEEDED = {
    "soak": ("seed", "seconds", "rates"),
    "overload": ("seed", "flood_p", "flood_factor", "capacity_fps", "offered_base_hz"),
    "recovery": ("seed", "counts", "acked_enrollments", "drain/sent", "drain/results",
                 "verify/ok", "verify/checkpoints"),
    "replication": ("seed", "split_brain_rc"),
    "video": ("seed", "reverify_frames", "swap_drift/frames", "swap_drift/swap_at",
              "swap_drift/stale_after_swap", "failover/version_flushes"),
}


def _field(report, path):
    for key in path.split("/"):
        report = report[key]
    return report


def _twin(scenario, seconds, seed):
    kwargs = {"device": "cpu"} if scenario == "soak" else {}
    want = getattr(jax_soak, "run_" + scenario)(seconds=seconds, seed=seed)
    got = getattr(port_soak, "run_" + scenario)(seconds=seconds, seed=seed, **kwargs)
    assert want["ok"], want["failures"]
    assert got["ok"], got["failures"]
    for path in SEEDED[scenario]:
        assert _field(got, path) == _field(want, path), path
    return got


def test_chaos_soak_fast_matches_reference():
    report = _twin("soak", 1.5, 7)
    assert report["results"] > 0
    assert report["ledger"]["in_system"] == 0
    assert report["counters"].get("loop_crashes", 0) == report["counters"].get(
        "supervisor_restarts", 0)


def test_overload_soak_fast_matches_reference():
    report = _twin("overload", 2.0, 7)
    shed = (sum(report["rejected"].values())
            + sum(report["ledger"]["drops_by_reason"].values()))
    assert shed > 0
    assert report["ledger"]["in_system"] == 0
    assert report["journal_frames"] == sum(
        report["counters"].get(k, 0) for k in (
            "frames_dead_lettered", "frames_failed", "frames_dropped_brownout",
            "batcher_dropped_stale", "batcher_dropped_overflow"))


def test_recovery_scenario_fast_matches_reference():
    report = _twin("recovery", 4.0, 1)
    counts = report["counts"]
    for key in ("wal_torn", "wal_crash", "ckpt_torn", "ckpt_crash", "ckpt_late",
                "media_corrupt", "mid_restore_kills"):
        assert counts[key] >= 1, (key, counts)
    assert counts["checkpoints_corrupt"] >= 1
    assert report["verify"]["ok"]
    assert report["drain"]["results"] == report["drain"]["sent"]


def test_replication_scenario_fast_matches_reference():
    report = _twin("replication", 3.0, 7)
    assert report["split_brain_rc"] == 3
    assert report["acked_enrollments"] > 0
    assert report["router"].get("router_failovers", 0) >= 1


def test_video_scenario_fast_matches_reference():
    report = _twin("video", 1.0, 7)
    assert report["swap_drift"]["stale_after_swap"] == 0
    assert report["swap_drift"]["cached_total"] > 0
    assert report["ambiguity"]["flushes"] >= 2
    assert report["ambiguity"]["cached_past_window"] == 0
    assert report["failover"]["version_flushes"] >= 1
    acct = report["span_accounting"]
    assert acct["completed_cached"] > 0
    assert acct["traced"] == (acct["completed"] + acct["completed_empty"]
                              + acct["completed_cached"] + sum(acct["drops"].values()))


@pytest.mark.slow
@pytest.mark.parametrize("scenario, seconds", [("soak", 30.0), ("overload", 15.0),
                                               ("recovery", 12.0), ("replication", 10.0)])
def test_scenario_long_randomized(scenario, seconds):
    kwargs = {"device": "cpu"} if scenario == "soak" else {}
    report = getattr(port_soak, "run_" + scenario)(seconds=seconds, **kwargs)
    assert report["ok"], report["failures"]
