"""The model registry: port of ``opencv_facerecognizer_tpu/runtime/
registry.py``.

``state_dir/registry.json`` names the served version of each role of
``MODEL_ROLES`` (with its config and params path and sha256), written
atomically with a sha256 over the canonical JSON of the roles, so a torn
or flipped manifest is detected and a writer refuses to start over it.
Versions only grow per role: an abandoned swap retires its number. The
embedder's entry mirrors the gallery's ``embedder_version``
(``mirror_embedder``). Every ``--state-dir`` start creates or reads this
file, and recovery settles fenced swaps against it
(``StateLifecycle._settle_registry_locked``).

A detector or cascade swap (``RegistrySwapCoordinator``) runs in phases
(``PHASE_CODES``):

- **parity**: the old and the candidate detector score live frames, which
  the service's publish path offers (``offer_live``: rate-limited, copied,
  scored on the swap's own thread by ``drain_live``). ``DetectionParity``
  counts a frame as agreeing when both fire or both pass, and when both
  fire their best boxes overlap at ``iou_threshold``; the window's
  agreement over at least ``min_samples`` frames opens the gate (``ready``).
- **cutover**: refused with ``rollout.RolloutGateError`` while the gate is
  shut (``registry_swaps_blocked``) unless forced; otherwise a
  ``gate_retrain_fn`` the caller supplies runs first (a detector swap
  moves the gate's operating point; the port trains nothing itself),
  ``StateLifecycle.perform_registry_cutover`` appends the
  ``registry_cutover`` fence, installs the manifest and runs
  ``install_fn`` under the enroll lock, ``flush_fn`` flushes the caches,
  and a checkpoint is forced.
- **watch**: the window starts again on new traffic; a full window below
  the gate rolls back at the next version (``auto_rollback``, with a
  flight-recorder dump), one at or above it ends the swap (``done``).
  ``rollback`` is the same on an operator's call. The rollback stages a
  copy of the restored version's params at its own version's path, for
  the read replicas (ROADMAP C.15).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from opencv_facerecognizer_tpu_torch.runtime.rollout import RolloutGateError
from opencv_facerecognizer_tpu_torch.utils import metrics as mn
from opencv_facerecognizer_tpu_torch.utils.serialization import atomic_write_bytes
from opencv_facerecognizer_tpu_torch.utils.tracing import LIFECYCLE_TOPIC

log = logging.getLogger(__name__)

#: every model role the registry fences
MODEL_ROLES = ("embedder", "detector", "cascade")

#: manifest filename inside ``state_dir``
MANIFEST_NAME = "registry.json"

#: state-dir subdirectory of staged candidate params
PARAMS_DIR = "registry"

#: a swap's phase as the ``registry_phase`` gauge
PHASE_CODES = {"idle": 0, "parity": 1, "ready": 2, "cutover": 3, "watch": 4, "done": 5,
               "rolled_back": 6}


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

    def reload(self) -> None:
        """Re-read the manifest (a read replica's re-anchor); raises
        ``RegistryStateError``."""
        roles = self.read_manifest(self.path)["roles"]
        with self._lock:
            self._roles = roles
        self._publish_gauges()

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

    def stamp_key(self) -> Tuple[Tuple[str, int], ...]:
        """Hashable form of ``stamp()`` (cache keys compare by equality)."""
        return tuple(sorted(self.stamp().items()))

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


def box_iou(a, b) -> float:
    """IoU of two pixel boxes in one corner order (yxyx or xyxy)."""
    ay0, ax0, ay1, ax1 = (float(v) for v in a)
    by0, bx0, by1, bx1 = (float(v) for v in b)
    iy0, ix0 = max(ay0, by0), max(ax0, bx0)
    iy1, ix1 = min(ay1, by1), min(ax1, bx1)
    inter = max(0.0, iy1 - iy0) * max(0.0, ix1 - ix0)
    if inter <= 0.0:
        return 0.0
    area_a = max(0.0, ay1 - ay0) * max(0.0, ax1 - ax0)
    area_b = max(0.0, by1 - by0) * max(0.0, bx1 - bx0)
    union = area_a + area_b - inter
    return inter / union if union > 0.0 else 0.0


class DetectionParity:
    """Old-vs-candidate detector agreement over a sliding window of frames
    (module docstring); host math, scored off the publish path. Below
    ``min_samples`` the disagreement reads 0 (no data is no breach)."""

    def __init__(self, old_detect_fn: Callable[[np.ndarray], Any],
                 new_detect_fn: Callable[[np.ndarray], Any], threshold: float = 0.98,
                 min_samples: int = 16, window: int = 256, iou_threshold: float = 0.5,
                 metrics=None):
        self.old_detect_fn = old_detect_fn
        self.new_detect_fn = new_detect_fn
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.iou_threshold = float(iou_threshold)
        self.metrics = metrics
        self._agreements: deque = deque(maxlen=int(window))
        self._lock = threading.Lock()

    @staticmethod
    def _boxes(verdict) -> List:
        """A detect fn's verdict as a box list: a list as it is, or the
        valid boxes of one frame's ``(boxes, scores, valid)``."""
        if verdict is None:
            return []
        if isinstance(verdict, tuple) and len(verdict) == 3:
            boxes, _scores, valid = verdict
            boxes = np.asarray(boxes)
            valid = np.asarray(valid, bool)
            return [boxes[i] for i in range(boxes.shape[0]) if valid[i]]
        return list(verdict)

    def _frame_agreement(self, old_boxes: List, new_boxes: List) -> float:
        if bool(old_boxes) != bool(new_boxes):
            return 0.0
        if not old_boxes:
            return 1.0
        best = max(box_iou(a, b) for a in old_boxes for b in new_boxes)
        return 1.0 if best >= self.iou_threshold else 0.0

    def score(self, frames, old_boxes_list: Optional[List[List]] = None) -> int:
        """Score frames through both detectors (or take the serving
        detector's boxes from ``old_boxes_list``); returns the samples
        recorded."""
        recorded = 0
        for i, frame in enumerate(frames):
            frame = np.asarray(frame)
            if old_boxes_list is not None:
                old_boxes = list(old_boxes_list[i])
            else:
                old_boxes = self._boxes(self.old_detect_fn(frame))
            new_boxes = self._boxes(self.new_detect_fn(frame))
            value = self._frame_agreement(old_boxes, new_boxes)
            with self._lock:
                self._agreements.append(value)
            recorded += 1
        if self.metrics is not None:
            with self._lock:
                n = len(self._agreements)
                agreement = sum(self._agreements) / n if n else 0.0
            self.metrics.set_gauge(mn.REGISTRY_PARITY_SAMPLES, n)
            self.metrics.set_gauge(mn.REGISTRY_PARITY_AGREEMENT, round(agreement, 4))
        return recorded

    def reset(self) -> None:
        """Clear the window (the watch judges new traffic only)."""
        with self._lock:
            self._agreements.clear()

    @property
    def samples(self) -> int:
        with self._lock:
            return len(self._agreements)

    @property
    def agreement(self) -> float:
        with self._lock:
            if not self._agreements:
                return 0.0
            return sum(self._agreements) / len(self._agreements)

    @property
    def disagreement(self) -> float:
        """1 - agreement from ``min_samples`` on, else 0.0."""
        with self._lock:
            n = len(self._agreements)
            if n < self.min_samples:
                return 0.0
            return 1.0 - sum(self._agreements) / n

    def ok(self) -> bool:
        with self._lock:
            n = len(self._agreements)
            return n >= self.min_samples and sum(self._agreements) / n >= self.threshold


class RegistrySwapCoordinator:
    """One detector or cascade swap, end to end (module docstring).

    ``old_detect_fn`` / ``new_detect_fn`` give a frame's verdict (a box
    list, or one frame's ``(boxes, scores, valid)``) for the parity window;
    without both the gate never opens and ``cutover`` needs ``force``.
    ``install_fn()`` publishes the new weights in memory (it runs under the
    state's enroll lock: keep it to the install); ``rollback_install_fn()``
    restores the old ones; ``flush_fn(stamp)`` flushes the caches after a
    cutover; ``gate_retrain_fn()`` returns a stage-1 gate fit to the
    candidate detector, run before the fence."""

    def __init__(self, state, registry: ModelRegistry, role: str, to_version: int, *,
                 old_detect_fn: Optional[Callable] = None,
                 new_detect_fn: Optional[Callable] = None, config: Any = None,
                 params_path: Optional[str] = None,
                 install_fn: Optional[Callable[[], None]] = None,
                 rollback_install_fn: Optional[Callable[[], None]] = None,
                 flush_fn: Optional[Callable[[Dict[str, int]], None]] = None,
                 gate_retrain_fn: Optional[Callable[[], Any]] = None,
                 parity_threshold: float = 0.98, parity_min_samples: int = 16,
                 parity_window: int = 256, parity_iou: float = 0.5,
                 watch_min_samples: int = 16, live_sample_interval_s: float = 0.05,
                 metrics=None, tracer=None):
        if role not in MODEL_ROLES or role == "embedder":
            raise ValueError(f"RegistrySwapCoordinator swaps the detector or the cascade, "
                             f"not {role!r} (the embedder rolls out through runtime.rollout)")
        self.state = state
        self.registry = registry
        self.role = str(role)
        self.to_version = int(to_version)
        self.from_version = registry.version(role)
        if self.to_version <= self.from_version:
            raise ValueError(f"to_version {to_version} must exceed the served {role} version "
                             f"{self.from_version} (versions only grow)")
        self.config = config
        self.params_path = params_path
        self.params_sha256 = (_file_sha256(params_path)
                              if params_path is not None and os.path.exists(params_path)
                              else None)
        self.install_fn = install_fn
        self.rollback_install_fn = rollback_install_fn
        self.flush_fn = flush_fn
        self.gate_retrain_fn = gate_retrain_fn
        self.gate_retrained: Any = None
        self.metrics = metrics
        self.tracer = tracer
        self.watch_min_samples = int(watch_min_samples)
        self.parity = (DetectionParity(old_detect_fn, new_detect_fn,
                                       threshold=parity_threshold,
                                       min_samples=parity_min_samples, window=parity_window,
                                       iou_threshold=parity_iou, metrics=metrics)
                       if old_detect_fn is not None and new_detect_fn is not None else None)
        self._phase = "idle"
        self._live_q: deque = deque(maxlen=64)
        self._live_lock = threading.Lock()
        self._live_interval_s = float(live_sample_interval_s)
        self._last_live_t = 0.0
        self.cutover_seq: Optional[int] = None
        self.rollback_seq: Optional[int] = None
        self._set_phase("idle" if self.parity is None else "parity")

    def _set_phase(self, phase: str) -> None:
        self._phase = phase
        if self.metrics is not None:
            self.metrics.set_gauge(mn.REGISTRY_PHASE, PHASE_CODES[phase])
        if self.tracer is not None:
            self.tracer.emit(self.tracer.new_trace(), "registry_phase", topic=LIFECYCLE_TOPIC,
                             phase=phase, role=self.role, to_version=self.to_version)

    @property
    def phase(self) -> str:
        return self._phase

    # ---- live parity ----

    def offer_live(self, frame: np.ndarray, faces: Optional[List[Dict[str, Any]]] = None) -> None:
        """The publish path's offer: at most one frame per
        ``live_sample_interval_s``, copied (its staging buffer is
        recycled), with the serving detector's boxes when given."""
        if self.parity is None or self._phase in ("done", "rolled_back"):
            return
        now = time.monotonic()
        if now - self._last_live_t < self._live_interval_s:
            return
        self._last_live_t = now
        boxes = None
        if faces is not None:
            boxes = [np.asarray(f["box"], np.float32) for f in faces if "box" in f]
        with self._live_lock:
            self._live_q.append((np.array(frame, copy=True), boxes))

    def drain_live(self) -> int:
        """Score every queued live sample (the swap's thread); returns the
        samples scored. In ``watch`` a regression rolls back."""
        with self._live_lock:
            samples = list(self._live_q)
            self._live_q.clear()
        scored = 0
        for frame, boxes in samples:
            scored += self.score_parity([frame],
                                        old_boxes_list=None if boxes is None else [boxes])
        return scored

    def score_parity(self, frames, old_boxes_list: Optional[List[List]] = None) -> int:
        """Score frames through both detectors; the gate opens in
        ``parity``, and ``watch`` is judged, as samples come."""
        if self.parity is None:
            return 0
        n = self.parity.score(frames, old_boxes_list=old_boxes_list)
        if self._phase == "parity" and self.parity.ok():
            self._set_phase("ready")
        elif self._phase == "watch":
            self.check_watch()
        return n

    def parity_ok(self) -> bool:
        return self.parity is not None and self.parity.ok()

    # ---- the cutover ----

    def cutover(self, force: bool = False) -> int:
        """Gate -> the gate retrain (a detector swap) -> fence, manifest,
        ``install_fn`` -> cache flush -> forced checkpoint -> watch (or
        done without a parity window). Returns the fence's WAL sequence;
        raises ``RolloutGateError`` while the gate is shut, unless
        ``force``."""
        if not force:
            reasons = []
            if self.parity is None:
                reasons.append("no parity window wired (old/new detect fns)")
            elif not self.parity.ok():
                reasons.append(f"parity gate not met: agreement {self.parity.agreement:.4f} "
                               f"over {self.parity.samples} samples (need >= "
                               f"{self.parity.threshold:g} over >= {self.parity.min_samples})")
            if reasons:
                if self.metrics is not None:
                    self.metrics.incr(mn.REGISTRY_SWAPS_BLOCKED)
                raise RolloutGateError(f"{self.role} swap refused: " + "; ".join(reasons))
        if self.gate_retrain_fn is not None and self.gate_retrained is None:
            self.gate_retrained = self.gate_retrain_fn()
            if self.metrics is not None:
                self.metrics.incr(mn.REGISTRY_GATE_RETRAINS)
        self._set_phase("cutover")
        seq = self.state.perform_registry_cutover(
            self.role, self.to_version, config=self.config, params_path=self.params_path,
            params_sha256=self.params_sha256, install_fn=self.install_fn)
        self.cutover_seq = seq
        if self.flush_fn is not None:
            self.flush_fn(self.registry.stamp())
        if not self.state.checkpoint_now(wait=True):
            # fence-durable already: a crash recovers into the new version
            self.state.maybe_checkpoint(force=True)
            log.warning("post-swap checkpoint did not land; the forced-checkpoint latch "
                        "retries (recovery completes the swap meanwhile)")
        if self.parity is not None:
            self.parity.reset()
            self._set_phase("watch")
        else:
            self._set_phase("done")
        return seq

    # ---- the watch and the rollback ----

    def check_watch(self) -> bool:
        """Judge the watch window: True when the swap regressed and was
        rolled back; a full window at or above the gate ends it."""
        if self._phase != "watch" or self.parity is None:
            return False
        if self.parity.samples < self.watch_min_samples:
            return False
        if self.parity.agreement >= self.parity.threshold:
            self._set_phase("done")
            return False
        self.auto_rollback()
        return True

    def auto_rollback(self) -> int:
        """Roll the role back at the next version (numbers never repeat):
        ``rollback_install_fn`` restores the old weights, a flight dump
        carries the swap's status. Unlike the reference, the restored
        version's staged params (if it has any) are copied to the new
        version's ``registry_params_path`` first, so read replicas install
        them; a version that stages none serves version 1's weights
        (ROADMAP C.15). The manifest and the fence record name no params,
        as the reference's do."""
        status = self.status()
        if self.metrics is not None:
            self.metrics.incr(mn.REGISTRY_AUTO_ROLLBACKS)
        if self.tracer is not None:
            self.tracer.dump("registry_auto_rollback", extra={"registry_swap": status},
                             force=True)
        parity = self.parity
        log.warning("registry %s swap v%d -> v%d rolling back: watch parity %.4f over %d "
                    "samples below gate %.4g", self.role, self.from_version, self.to_version,
                    parity.agreement if parity is not None else 0.0,
                    parity.samples if parity is not None else 0,
                    parity.threshold if parity is not None else 0.0)
        restored = registry_params_path(self.registry.state_dir, self.role, self.from_version)
        if os.path.exists(restored):
            with open(restored, "rb") as fh:
                atomic_write_bytes(registry_params_path(
                    self.registry.state_dir, self.role, self.to_version + 1), fh.read())
        seq = self.state.perform_registry_cutover(
            self.role, self.to_version + 1, config=None, params_path=None,
            params_sha256=None, install_fn=self.rollback_install_fn)
        self.rollback_seq = seq
        if self.flush_fn is not None:
            self.flush_fn(self.registry.stamp())
        if not self.state.checkpoint_now(wait=True):
            self.state.maybe_checkpoint(force=True)
        self._set_phase("rolled_back")
        return seq

    def rollback(self) -> int:
        """An operator's rollback: ``auto_rollback``'s mechanism."""
        return self.auto_rollback()

    def status(self) -> Dict[str, Any]:
        """For ``/registry``."""
        out = {"role": self.role, "phase": self._phase, "from_version": self.from_version,
               "to_version": self.to_version, "cutover_seq": self.cutover_seq,
               "rollback_seq": self.rollback_seq,
               "gate_retrained": self.gate_retrained is not None,
               "params_path": self.params_path, "parity": None}
        if self.parity is not None:
            out["parity"] = {"samples": self.parity.samples,
                             "agreement": round(self.parity.agreement, 4),
                             "threshold": self.parity.threshold,
                             "min_samples": self.parity.min_samples,
                             "iou_threshold": self.parity.iou_threshold,
                             "ok": self.parity.ok()}
        return out
