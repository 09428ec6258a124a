"""The model registry's manifest: port of ``ModelRegistry`` and its
helpers from ``opencv_facerecognizer_tpu/runtime/registry.py``.

``state_dir/registry.json`` names the served version of each role of
``MODEL_ROLES`` (with its config and params path and sha256), written
atomically with a sha256 over the canonical JSON of the roles, so a torn
or flipped manifest is detected and a writer refuses to start over it.
Versions only grow per role: an abandoned swap retires its number. The
embedder's entry mirrors the gallery's ``embedder_version``
(``mirror_embedder``). Every ``--state-dir`` start creates or reads this
file, and recovery settles fenced swaps against it
(``StateLifecycle._settle_registry_locked``).

The swaps themselves (``RegistrySwapCoordinator``, ``DetectionParity``)
wait for ROADMAP A.8.5.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.serialization import atomic_write_bytes

#: every model role the registry fences
MODEL_ROLES = ("embedder", "detector", "cascade")

#: manifest filename inside ``state_dir``
MANIFEST_NAME = "registry.json"

#: state-dir subdirectory of staged candidate params
PARAMS_DIR = "registry"


class RegistryStateError(RuntimeError):
    """The manifest is torn, unreadable or inconsistent. ``reason`` is
    ``"unreadable"`` (the read or parse failed) or ``"corrupt"`` (checksum
    or shape mismatch)."""


def registry_params_path(state_dir: str, role: str, version: int) -> str:
    """``state_dir/registry/<role>-v<version>.params``: where a candidate's
    params are staged."""
    return os.path.join(str(state_dir), PARAMS_DIR, f"{role}-v{int(version)}.params")


def _file_sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def _canonical(roles: Dict[str, Any]) -> bytes:
    return json.dumps(roles, sort_keys=True).encode("utf-8")


def _state_error(message: str, reason: str) -> RegistryStateError:
    err = RegistryStateError(message)
    err.reason = reason
    return err


class ModelRegistry:
    """The manifest of served model versions (module docstring)::

        {"format_version": 1,
         "roles": {"embedder": {"version": 1, "config": null,
                                "params_path": null, "params_sha256": null},
                   "detector": {...}, "cascade": {...}},
         "updated_ts": ..., "checksum": sha256(canonical roles JSON)}

    ``readonly=True`` never writes."""

    def __init__(self, state_dir: str, metrics=None, readonly: bool = False):
        self.state_dir = str(state_dir)
        self.path = os.path.join(self.state_dir, MANIFEST_NAME)
        self.metrics = metrics
        self.readonly = bool(readonly)
        self._lock = threading.Lock()
        self._roles: Dict[str, Dict[str, Any]] = {
            role: {"version": 1, "config": None, "params_path": None, "params_sha256": None}
            for role in MODEL_ROLES}
        if os.path.exists(self.path):
            self._roles = self.read_manifest(self.path)["roles"]
        elif not self.readonly:
            os.makedirs(self.state_dir, exist_ok=True)
            self._save_locked()
        self._publish_gauges()

    @staticmethod
    def read_manifest(path: str) -> Dict[str, Any]:
        """Parse and check one manifest -> ``{"roles", "doc"}``; raises
        ``RegistryStateError``."""
        try:
            with open(path, "r", encoding="utf-8") as fh:
                doc = json.loads(fh.read())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise _state_error(f"registry manifest {path} unreadable: {exc!r}",
                               "unreadable") from exc
        try:
            roles = doc["roles"]
            checksum = doc["checksum"]
            if not isinstance(roles, dict):
                raise TypeError("roles is not an object")
        except (KeyError, TypeError) as exc:
            raise _state_error(f"registry manifest {path} malformed: {exc!r}",
                               "corrupt") from exc
        if hashlib.sha256(_canonical(roles)).hexdigest() != checksum:
            raise _state_error(f"registry manifest {path} checksum mismatch (torn or "
                               f"bit-flipped write)", "corrupt")
        out: Dict[str, Dict[str, Any]] = {}
        for role in MODEL_ROLES:
            entry = roles.get(role)
            if not isinstance(entry, dict) or "version" not in entry:
                raise _state_error(f"registry manifest {path} missing role {role!r}",
                                   "corrupt")
            out[role] = {"version": int(entry["version"]), "config": entry.get("config"),
                         "params_path": entry.get("params_path"),
                         "params_sha256": entry.get("params_sha256")}
            if "retired" in entry:
                out[role]["retired"] = int(entry["retired"])
        return {"roles": out, "doc": doc}

    def _save_locked(self) -> None:
        if self.readonly:
            raise RegistryStateError("read-only ModelRegistry cannot write the manifest")
        doc = {"format_version": 1, "roles": self._roles, "updated_ts": time.time(),
               "checksum": hashlib.sha256(_canonical(self._roles)).hexdigest()}
        atomic_write_bytes(self.path, json.dumps(doc, sort_keys=True).encode("utf-8"))

    def _publish_gauges(self) -> None:
        if self.metrics is None:
            return
        for role, entry in self._roles.items():
            self.metrics.set_gauge(mn.MODEL_VERSION_PREFIX + role, int(entry["version"]))

    # ---- reads ----

    def version(self, role: str) -> int:
        with self._lock:
            return int(self._roles[role]["version"])

    def describe(self, role: str) -> Dict[str, Any]:
        with self._lock:
            return dict(self._roles[role])

    def stamp(self) -> Dict[str, int]:
        """``{role: version}`` for every role."""
        with self._lock:
            return {role: int(entry["version"]) for role, entry in self._roles.items()}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"manifest": self.path,
                    "roles": {r: dict(e) for r, e in self._roles.items()}}

    # ---- writes ----

    def install(self, role: str, version: int, config: Any = None,
                params_path: Optional[str] = None,
                params_sha256: Optional[str] = None) -> None:
        """Durably advance ``role`` to ``version``, which must exceed both
        the served and the retired versions."""
        with self._lock:
            entry = self._roles[role]
            floor = max(int(entry["version"]), int(entry.get("retired", 0)))
            if int(version) <= floor:
                raise ValueError(
                    f"registry versions are monotonic: {role} is at v{entry['version']} "
                    f"(retired through v{entry.get('retired', 0)}), refusing install of "
                    f"v{version}")
            new_entry = {"version": int(version), "config": config,
                         "params_path": params_path, "params_sha256": params_sha256}
            if "retired" in entry:
                new_entry["retired"] = int(entry["retired"])
            self._roles[role] = new_entry
            self._save_locked()
        self._publish_gauges()

    def retire(self, role: str, version: int) -> None:
        """Burn ``version`` for ``role`` without serving it (an abandoned
        swap); later installs must exceed it."""
        with self._lock:
            entry = self._roles[role]
            if int(version) <= int(entry.get("retired", 0)):
                return
            entry["retired"] = int(version)
            if not self.readonly:
                self._save_locked()

    def mirror_embedder(self, version: int) -> None:
        """Keep the embedder entry in step with the gallery's version
        (never backward)."""
        with self._lock:
            if int(version) <= int(self._roles["embedder"]["version"]):
                return
            self._roles["embedder"]["version"] = int(version)
            if not self.readonly:
                self._save_locked()
        self._publish_gauges()
