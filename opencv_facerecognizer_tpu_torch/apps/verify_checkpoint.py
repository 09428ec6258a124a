"""Offline verification of durable state: port of
``scripts/verify_checkpoint.py``. It loads no model onto a card.

    python -m opencv_facerecognizer_tpu_torch.apps.verify_checkpoint STATE_DIR
    python -m opencv_facerecognizer_tpu_torch.apps.verify_checkpoint STATE_DIR --follow
    python -m opencv_facerecognizer_tpu_torch.apps.verify_checkpoint model.msgpack

- A **state directory** (``--state-dir``, or a bare checkpoints
  directory): every checkpoint's magic, header and sha256, the embedder
  version of each header, the registry manifest's checksum and versions,
  and the enrolment WAL. An unparseable WAL line is a torn remnant of an
  unacknowledged append (``torn_lines``, a warning); a parseable enroll
  record that fails its crc or base64 was acknowledged and is lost (a
  failure), and so are rows that change the embedder or a registry role's
  version without a fence record. Read-only: the WAL is read from its
  file (never through ``EnrollmentWAL``, whose constructor seals torn
  tails), nothing is quarantined, created or pruned.
- ``--follow``: the WAL tailed for ``--duration`` seconds as a read replica
  reads it (``runtime.replication.WALTailer``: complete lines only,
  compaction seen on the open fd, re-anchored at the newest checkpoint's
  ``wal_seq``), safe against a live writer.
- A **model file** (``save_model`` output): decoded and rebuilt on the
  CPU.

The report is JSON on stdout. Exit status: 0 verified, 2 corrupt (restore
from backup), 3 cannot verify: only read errors (EACCES, EIO, a vanished
file), which prove nothing about the bytes (fix the mount and re-run).
Corruption beside read errors is still 2. A path with no durable state in
it fails (2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _checkpoint_sweep(ckpt_dir: str, report: dict) -> None:
    """Every checkpoint in ``ckpt_dir`` (``CheckpointStore.verify``, which
    never mutates) and each verified header's embedder version."""
    from opencv_facerecognizer_tpu_torch.runtime.state_store import (
        CheckpointCorruptError, CheckpointStore, CheckpointVersionError,
        read_checkpoint_header, scan_checkpoint_files)

    sweep = CheckpointStore(ckpt_dir).verify()
    report["checkpoints"] = sweep["ok"]
    report["corrupt"] = [{"path": p, "reason": r} for p, r in sweep["corrupt"]]
    # intact, only newer than this binary: reported, not a failure
    report["newer_version"] = [{"path": p, "reason": r} for p, r in sweep["newer_version"]]
    report["unreadable"] = [{"path": p, "reason": r} for p, r in sweep.get("unreadable", ())]
    if sweep["corrupt"]:
        report["ok"] = False
    if report["unreadable"]:
        report["ok"] = False
        report["cannot_verify"] = True
    version_seen = None
    for _seq, ckpt_path in scan_checkpoint_files(ckpt_dir):
        if ckpt_path not in sweep["ok"]:
            continue
        try:
            meta = read_checkpoint_header(ckpt_path).get("meta", {})
            version = int(meta.get("embedder_version", 1))
            if version < 1:
                raise ValueError(f"embedder_version {version} < 1")
        except (OSError, CheckpointCorruptError, CheckpointVersionError, TypeError,
                ValueError) as exc:
            report["ok"] = False
            report.setdefault("version_errors", []).append(
                {"path": ckpt_path, "reason": f"bad embedder_version header: {exc}"})
            continue
        if version_seen is None:
            version_seen = version  # the newest verified
    report["embedder_version"] = version_seen


def _manifest_check(manifest_path: str, report: dict) -> None:
    """The registry manifest: a torn or unreadable file cannot be verified
    (3), a checksum or shape mismatch is corruption (2)."""
    from opencv_facerecognizer_tpu_torch.runtime.registry import (
        ModelRegistry, RegistryStateError)

    try:
        roles = ModelRegistry.read_manifest(manifest_path)["roles"]
    except RegistryStateError as exc:
        report["ok"] = False
        report["registry"] = {"path": manifest_path, "error": str(exc), "reason": exc.reason}
        report["cannot_verify" if exc.reason == "unreadable" else "registry_corrupt"] = True
        return
    entry = {"path": manifest_path, "roles": {r: int(v["version"]) for r, v in roles.items()}}
    bad = [r for r, v in roles.items()
           if int(v.get("version", 0)) < 1 or int(v.get("retired", 0) or 0) < 0]
    if bad:
        entry["error"] = f"non-monotonic version fields for role(s) {bad}"
        entry["reason"] = "corrupt"
        report["ok"] = False
        report["registry_corrupt"] = True
    report["registry"] = entry


class _VersionWalk:
    """The WAL's version fences, walked in file order: the embedder's
    (``cutover`` records) and each registry role's (``registry_cutover``,
    voided by ``registry_abort``), each seeded from the first row that
    names it. A row that moves a version with no fence before it is a
    violation: replaying it could mix model sets."""

    def __init__(self):
        self.violations: list = []
        self.embedder = None
        self.roles: dict = {}
        self.fence_from: dict = {}  # (role, to_version) -> from_version

    def _bad(self, record: dict, reason: str) -> None:
        self.violations.append({"seq": record.get("seq"), "reason": reason})

    def cutover(self, record: dict) -> None:
        try:
            from_v, to_v = int(record["from_version"]), int(record["to_version"])
        except (KeyError, TypeError, ValueError):
            self._bad(record, "cutover record with unreadable from/to versions")
            return
        if self.embedder is not None and from_v != self.embedder:
            self._bad(record, f"cutover claims from_version {from_v} but the stream is at "
                              f"{self.embedder}")
        self.embedder = to_v

    def registry_cutover(self, record: dict) -> None:
        try:
            role = str(record["role"])
            from_v, to_v = int(record["from_version"]), int(record["to_version"])
        except (KeyError, TypeError, ValueError):
            self._bad(record, "registry_cutover record with unreadable role/versions")
            return
        if to_v <= from_v:
            self._bad(record, f"registry_cutover {role} v{from_v} -> v{to_v} is not "
                              f"monotonic")
        if role in self.roles and from_v != self.roles[role]:
            self._bad(record, f"registry_cutover claims {role} from_version {from_v} but "
                              f"the stream is at v{self.roles[role]}")
        self.fence_from[(role, to_v)] = from_v
        self.roles[role] = to_v

    def registry_abort(self, record: dict) -> None:
        role = str(record.get("role"))
        try:
            to_v = int(record.get("to_version", -1))
        except (TypeError, ValueError):
            to_v = -1
        if (role, to_v) in self.fence_from and self.roles.get(role) == to_v:
            self.roles[role] = self.fence_from[(role, to_v)]  # back; the number stays burned

    def enroll(self, record: dict) -> None:
        try:
            version = int(record.get("embedder_version", 1))
        except (TypeError, ValueError):
            self._bad(record, f"unreadable embedder_version "
                              f"{record.get('embedder_version')!r}")
            return
        if self.embedder is None:
            self.embedder = version
        elif version != self.embedder:
            self._bad(record, f"row at embedder v{version} follows v{self.embedder} rows with "
                              f"no intervening cutover record (version fence breached)")
        stamp = record.get("registry")
        if not isinstance(stamp, dict):
            return
        for role, ver in stamp.items():
            role = str(role)
            try:
                ver = int(ver)
            except (TypeError, ValueError):
                self._bad(record, f"unreadable registry stamp for role {role!r}: "
                                  f"{stamp.get(role)!r}")
                continue
            if role not in self.roles:
                self.roles[role] = ver
            elif ver != self.roles[role]:
                self._bad(record, f"row at {role} v{ver} follows v{self.roles[role]} rows "
                                  f"with no intervening registry_cutover record (registry "
                                  f"fence breached)")


def _wal_check(wal_path: str, report: dict) -> None:
    from opencv_facerecognizer_tpu_torch.runtime.state_store import decode_enroll_record

    try:
        with open(wal_path, "r", encoding="utf-8", errors="replace") as fh:
            lines = [line.rstrip("\n") for line in fh]
    except OSError as exc:
        report["wal"] = {"path": wal_path, "unreadable": str(exc)}
        report["ok"] = False
        report["cannot_verify"] = True
        return
    counts = dict(torn_lines=0, enroll_records=0, valid_records=0, cutover_records=0,
                  registry_cutover_records=0)
    walk = _VersionWalk()
    for line in lines:
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            record = None
        if not isinstance(record, dict):
            # an acknowledged append ends as a whole fsynced line: this is
            # a torn remnant, skipped by replay
            counts["torn_lines"] += 1
            continue
        kind = record.get("kind")
        if kind == "cutover":
            counts["cutover_records"] += 1
            walk.cutover(record)
        elif kind == "registry_cutover":
            counts["registry_cutover_records"] += 1
            walk.registry_cutover(record)
        elif kind == "registry_abort":
            walk.registry_abort(record)
        elif kind == "enroll":
            counts["enroll_records"] += 1
            if decode_enroll_record(record) is not None:
                counts["valid_records"] += 1
            walk.enroll(record)
    corrupt = counts["enroll_records"] - counts["valid_records"]
    report["wal"] = {"path": wal_path, "lines": len(lines),
                     "enroll_records": counts["enroll_records"],
                     "valid_records": counts["valid_records"],
                     "torn_lines": counts["torn_lines"], "corrupt_records": corrupt,
                     "cutover_records": counts["cutover_records"],
                     "registry_cutover_records": counts["registry_cutover_records"],
                     "version_violations": walk.violations}
    if corrupt or walk.violations:
        report["ok"] = False


def verify_state_dir(path: str) -> dict:
    """Verify a ``--state-dir`` (or a checkpoints directory); the report's
    ``ok`` is the verdict (module docstring)."""
    from opencv_facerecognizer_tpu_torch.runtime.state_store import CHECKPOINT_SUFFIX

    ckpt_dir = os.path.join(path, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        ckpt_dir = (path if any(n.endswith(CHECKPOINT_SUFFIX) for n in os.listdir(path))
                    else None)
    report = {"path": path, "checkpoints": [], "corrupt": [], "newer_version": [],
              "unreadable": [], "wal": None, "ok": True}
    if ckpt_dir is not None and os.path.isdir(ckpt_dir):
        _checkpoint_sweep(ckpt_dir, report)
    manifest_path = os.path.join(path, "registry.json")
    if os.path.exists(manifest_path):
        _manifest_check(manifest_path, report)
    wal_path = os.path.join(path, "enroll.wal")
    if os.path.exists(wal_path):
        _wal_check(wal_path, report)
        if report["wal"].get("unreadable"):
            return report
    if (not report["checkpoints"] and not report["corrupt"] and not report["newer_version"]
            and report["wal"] is None):
        # an empty or mistyped directory must not pass a backup job
        report["ok"] = False
        report["reason"] = "no durable state found (no checkpoints, no WAL)"
    return report


def follow_wal(state_dir: str, duration_s: float = 10.0, poll_s: float = 0.25) -> dict:
    """``--follow``: tail the WAL for ``duration_s`` as a read replica
    would (module docstring). A parseable enroll record past the anchor
    that fails its crc or base64 is lost to every replica: ``ok`` False.
    Torn remnants, tombstoned and anchor-covered rows are counted only."""
    from opencv_facerecognizer_tpu_torch.runtime.replication import (
        WALTailer, newest_checkpoint_wal_seq)
    from opencv_facerecognizer_tpu_torch.runtime.state_store import decode_enroll_record

    wal_path = os.path.join(state_dir, "enroll.wal")
    ckpt_dir = os.path.join(state_dir, "checkpoints")
    anchor = newest_checkpoint_wal_seq(ckpt_dir)
    tailer = WALTailer(wal_path)
    applied = anchor
    report = {"path": wal_path, "mode": "follow", "duration_s": duration_s,
              "anchor_wal_seq": anchor, "polls": 0, "valid_records": 0, "valid_rows": 0,
              "corrupt_records": 0, "aborted_records": 0, "anchor_covered": 0,
              "reanchors": 0, "ok": True}
    aborted: set = set()
    deadline = time.monotonic() + duration_s
    while True:
        records, info = tailer.poll()
        report["polls"] += 1
        if info.get("reopened"):
            # a compaction: re-anchor as a replica past the truncation would
            new_anchor = newest_checkpoint_wal_seq(ckpt_dir)
            if new_anchor > applied:
                applied = new_anchor
                report["reanchors"] += 1
                report["anchor_wal_seq"] = new_anchor
        for record in records:
            seq = record.get("seq")
            if record.get("kind") == "abort" and isinstance(seq, (int, float)):
                aborted.add(int(seq))
        for record in records:
            seq = record.get("seq")
            if record.get("kind") != "enroll" or not isinstance(seq, (int, float)):
                continue
            seq = int(seq)
            if seq in aborted:
                report["aborted_records"] += 1
                applied = max(applied, seq)
                continue
            if seq <= applied:
                report["anchor_covered"] += 1
                continue
            decoded = decode_enroll_record(record)
            if decoded is None:
                report["corrupt_records"] += 1
                report["ok"] = False
            else:
                report["valid_records"] += 1
                report["valid_rows"] += int(decoded["n"])
            applied = seq
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        time.sleep(min(poll_s, remaining))
    report["torn_lines"] = tailer.malformed_lines
    report["wal_reopens"] = tailer.reopens
    report["final_seq"] = applied
    return report


def verify_model_file(path: str) -> dict:
    """Decode and rebuild a ``save_model`` file on the CPU."""
    from opencv_facerecognizer_tpu_torch.utils.serialization import (
        CheckpointCorruptError, load_model)

    report = {"path": path, "ok": True}
    try:
        load_model(path, device="cpu")
    except CheckpointCorruptError as exc:
        report["ok"] = False
        report["reason"] = str(exc)
    except (KeyError, ValueError) as exc:
        # a newer format, or a plugin the port has not ported: intact, unloadable
        report["ok"] = False
        report["reason"] = f"unloadable: {exc}"
    except OSError as exc:
        report["ok"] = False
        report["reason"] = f"unreadable: {exc}"
        report["cannot_verify"] = True
    return report


def exit_code(report: dict) -> int:
    """0 verified; 3 when read errors were the only failures; else 2."""
    if report["ok"]:
        return 0
    wal = report.get("wal") or {}
    corruption = bool(report.get("corrupt") or report.get("version_errors")
                      or report.get("registry_corrupt") or wal.get("corrupt_records")
                      or wal.get("version_violations"))
    return 3 if report.get("cannot_verify") and not corruption else 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ocvf-verify-torch",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("path", help="a state directory (--state-dir layout or a "
                                     "checkpoints dir) or a model file")
    parser.add_argument("--follow", action="store_true",
                        help="tail the state dir's WAL for --duration seconds as a read "
                             "replica reads it; read-only, safe against a live writer")
    parser.add_argument("--duration", type=float, default=10.0,
                        help="--follow window in seconds")
    parser.add_argument("--poll-ms", type=float, default=250.0,
                        help="--follow poll interval")
    args = parser.parse_args(argv)
    if args.follow:
        report = (follow_wal(args.path, duration_s=args.duration, poll_s=args.poll_ms / 1e3)
                  if os.path.isdir(args.path) else
                  {"path": args.path, "ok": False,
                   "reason": "--follow needs a state directory"})
    elif os.path.isdir(args.path):
        report = verify_state_dir(args.path)
    elif os.path.exists(args.path):
        report = verify_model_file(args.path)
    else:
        report = {"path": args.path, "ok": False, "reason": "path does not exist"}
    print(json.dumps(report, indent=2))
    return exit_code(report)


if __name__ == "__main__":
    sys.exit(main())
