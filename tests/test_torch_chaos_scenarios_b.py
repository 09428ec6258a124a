"""Scenario twins, part two: ``rollout``, ``registry``, ``disk`` and
``partition`` of the port's ``apps/chaos_soak.py`` against
``scripts/chaos_soak.py`` (loaded by path), at the reference's tier-1
seconds and seeds, on the fakes. Both reports must be ``ok``, and the
fields the seed determines (``SEEDED``) equal; timing fields are not
compared (``tests/test_torch_chaos_scenarios_a.py`` says more)."""

import importlib.util
import os

from opencv_facerecognizer_tpu_torch.apps import chaos_soak as port_soak

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chaos_soak", os.path.join(REPO_ROOT, "scripts", "chaos_soak.py"))
jax_soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_soak)

SEEDED = {
    "rollout": ("seed", "watermark_at_stage_kill", "stale_enroll_refused",
                "verify/embedder_version", "parity/threshold", "parity/min_samples"),
    "registry": ("seed", "retired_version_refused", "auto_rollback/role",
                 "auto_rollback/phase", "auto_rollback/from_version",
                 "auto_rollback/to_version", "verify/registry/roles"),
    "disk": ("seed", "enospc_refusals", "injected/storage:eio",
             "sink_accounting/wal_append_errors", "sink_accounting/checkpoint_failures",
             "sink_accounting/durability_degraded_transitions",
             "sink_accounting/durability_rearms"),
    "partition": ("seed", "split_brain"),
}


def _field(report, path):
    for key in path.split("/"):
        report = report[key]
    return report


#: the reference's ``disk`` scenario checks for the re-arm's status
#: between the monitor clearing its flag and announcing it, and then
#: fails alone (its own ``test_disk_chaos_fast_deterministic`` flaps so);
#: the port's waits for both. Its seed-determined fields are compared
#: all the same
REFERENCE_RACES = {"disk": ["no durability_restored announcement"]}


def _twin(scenario, seconds, seed):
    want = getattr(jax_soak, "run_" + scenario)(seconds=seconds, seed=seed)
    got = getattr(port_soak, "run_" + scenario)(seconds=seconds, seed=seed)
    assert want["ok"] or want["failures"] == REFERENCE_RACES.get(scenario), want["failures"]
    assert got["ok"], got["failures"]
    for path in SEEDED[scenario]:
        assert _field(got, path) == _field(want, path), path
    return got


def test_rollout_chaos_fast_matches_reference():
    report = _twin("rollout", 3.0, 7)
    assert report["stale_enroll_refused"]
    assert report["verify"]["embedder_version"] == 2
    assert report["cutover_window_max_gap_s"] < 2.0
    for name, stamp in report["result_stamps"].items():
        assert set(stamp["versions"]) <= {1, 2}, (name, stamp)


def test_registry_chaos_fast_matches_reference():
    report = _twin("registry", 3.0, 7)
    roles = report["verify"]["registry"]["roles"]
    assert roles["detector"] == 4 and roles["cascade"] == 1
    assert report["auto_rollback"]["phase"] == "rolled_back"
    assert report["rollback_dump"]["role"] == "detector"
    assert report["verify"]["ok"]


def test_disk_chaos_fast_matches_reference():
    report = _twin("disk", 2.0, 7)
    assert report["acked_enrollments"] >= 5
    assert report["enospc_refusals"] == {"oserror": 2, "closed": 4}
    acct = report["sink_accounting"]
    assert acct["wal_append_errors"] == 2
    assert acct["checkpoint_failures"] == 1
    assert acct["durability_degraded_transitions"] == 2
    assert acct["durability_rearms"] == 2
    assert acct["journal_shed"] >= 1
    assert acct["trace_dumps_shed"] >= 1
    assert acct["trace_spans_shed"] >= 1
    ledger = report["shutdown"]["ledger"]
    assert ledger["admitted"] == ledger["completed"] > 0
    assert report["verify"]["ok"]


def test_partition_chaos_fast_matches_reference():
    report = _twin("partition", 4.0, 7)
    assert report["failover_s"] is not None
    assert report["router"].get("router_hedges", 0) >= 1
    assert report["deduped_total"] >= 1
    assert report["split_brain"]["refused"]
    assert report["split_brain"]["rearmed"]
