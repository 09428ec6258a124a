"""Pickle-free model checkpoints: port of
``opencv_facerecognizer_tpu/utils/serialization.py``.

A checkpoint is one msgpack blob ``{"header": {"format_version",
"spec_json"}, "state": {...}}``: the *spec* (JSON, ``{"type": registry
name, "config": {...}}``) says how to rebuild every plugin, the *state*
holds its arrays. The bytes are flax's (``utils._msgpack``), so the two
packages read each other's checkpoints. Writes are atomic (tmp + fsync +
rename + directory fsync).

The registry holds the types a CNN checkpoint uses (``CNNEmbedding``,
``NearestNeighbor``, ``PredictableModel``, ``ExtendedPredictableModel``);
the classic features and the SVMs are refused by name until ROADMAP A.12.
A plugin's ``from_config(config, device)`` puts its tensors on ``device``
(the card unless the caller names another).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from opencv_facerecognizer_tpu_torch.utils import _msgpack
from opencv_facerecognizer_tpu_torch.utils.device import DEFAULT_DEVICE, DeviceLike

FORMAT_VERSION = 1

#: registry names of the reference's plugins that wait for ROADMAP A.12
NOT_PORTED = ("identity", "pca", "lda", "fisherfaces", "spatial_histogram",
              "tan_triggs", "histogram_equalization", "resize",
              "minmax_normalize", "chain_operator", "combine_operator",
              "combine_operator_nd", "svm", "kernel_svm")


class CheckpointCorruptError(ValueError):
    """A checkpoint failed decode or validation: truncated, garbage, or
    without its header. A ``ValueError``, so broad handlers keep working,
    and precise enough for recovery code to fall back to an older file."""


def fsync_directory(path: str) -> None:
    """fsync a directory so a just-renamed entry survives a power cut
    (best effort: some filesystems refuse it)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(filename: str, blob, keep_previous: int = 0) -> None:
    """Crash-safe write: a pid-unique tmp in the same directory, flush,
    fsync, atomic rename, directory fsync. ``blob`` is one bytes-like
    object, or a list of them written in order (a large payload need not
    be joined first). ``keep_previous > 0`` keeps the old content at
    ``filename.1 .. N`` (``rotate_backups``), after the tmp is durable."""
    pieces = blob if isinstance(blob, (list, tuple)) else (blob,)
    filename = str(filename)
    directory = os.path.dirname(os.path.abspath(filename))
    tmp = f"{filename}.tmp.{os.getpid()}"
    fh = open(tmp, "wb")
    try:
        for piece in pieces:
            fh.write(piece)
        fh.flush()
        os.fsync(fh.fileno())
    finally:
        fh.close()
    if keep_previous > 0:
        rotate_backups(filename, keep_previous)
    os.replace(tmp, filename)
    fsync_directory(directory)


def atomic_write_text(filename: str, text: str, keep_previous: int = 0) -> None:
    atomic_write_bytes(filename, text.encode("utf-8"), keep_previous=keep_previous)


def atomic_write_json(filename: str, obj: Any, *, indent: int = 2,
                      sort_keys: bool = False, keep_previous: int = 0) -> None:
    """``json.dump`` serialized fully in memory, then one atomic install."""
    text = json.dumps(obj, indent=indent, sort_keys=sort_keys)
    atomic_write_text(filename, text + "\n", keep_previous=keep_previous)


def rotate_backups(filename: str, keep: int) -> None:
    """Shift ``filename.1 -> .2 -> ... -> .keep`` (dropping the oldest) and
    hardlink the current file to ``.1``, so ``filename`` itself never goes
    missing (a rename where hardlinks are refused)."""
    if keep <= 0 or not os.path.exists(filename):
        return
    oldest = f"{filename}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{filename}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{filename}.{i + 1}")
    try:
        os.link(filename, f"{filename}.1")
    except OSError:
        os.replace(filename, f"{filename}.1")


#: registry name -> class, filled on first use (avoids import cycles)
_REGISTRY: Dict[str, type] = {}


def _registry() -> Dict[str, type]:
    if not _REGISTRY:
        from opencv_facerecognizer_tpu_torch.models import classifier as c
        from opencv_facerecognizer_tpu_torch.models import embedder as e
        from opencv_facerecognizer_tpu_torch.models import model as m

        for cls in (c.NearestNeighbor, m.PredictableModel,
                    m.ExtendedPredictableModel, e.CNNEmbedding):
            _REGISTRY[cls.name] = cls
    return _REGISTRY


def register(cls: type) -> type:
    """Register an external plugin class (usable as a decorator)."""
    _registry()[cls.name] = cls
    return cls


def serialize_spec(obj: Any) -> dict:
    """Object -> JSON-safe reconstruction spec ``{"type", "config"}``."""
    return {"type": obj.name, "config": obj.get_config()}


def deserialize_spec(spec: dict, device: DeviceLike = DEFAULT_DEVICE) -> Any:
    """Spec -> object; every plugin's ``from_config`` takes ``device``."""
    reg = _registry()
    if spec["type"] not in reg:
        hint = " (not ported yet: ROADMAP A.12)" if spec["type"] in NOT_PORTED else ""
        raise KeyError(f"unknown plugin type {spec['type']!r}{hint}; "
                       f"registered: {sorted(reg)}")
    return reg[spec["type"]].from_config(spec["config"], device=device)


def _to_numpy_tree(state: Any) -> Any:
    """Dicts recursively; leaves as numpy arrays (bf16 tensors stay
    tensors: numpy has no bf16, and the encoder writes them as flax does)."""
    if isinstance(state, dict):
        return {k: _to_numpy_tree(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        t = state.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(state)


def save_model(filename: str, model: Any, keep_previous: int = 0) -> None:
    """Write ``{header, spec, state}`` as one msgpack blob, atomically."""
    payload = {
        "header": {"format_version": FORMAT_VERSION,
                   "spec_json": json.dumps(serialize_spec(model))},
        "state": _to_numpy_tree(model.get_state()),
    }
    atomic_write_bytes(filename, _msgpack.packb(payload), keep_previous=keep_previous)


def read_payload(filename: str) -> Any:
    """The decoded msgpack tree of ``filename``; ``CheckpointCorruptError``
    when it does not decode."""
    with open(filename, "rb") as fh:
        blob = fh.read()
    try:
        return _msgpack.unpackb(blob)
    except Exception as exc:  # noqa: BLE001 - any decode failure is a corrupt file
        raise CheckpointCorruptError(
            f"checkpoint {filename!r} failed msgpack decode (truncated or "
            f"garbage): {exc!r}") from exc


def load_model(filename: str, device: DeviceLike = DEFAULT_DEVICE) -> Any:
    """Rebuild the plugin tree of ``filename`` (tensors on ``device``) and
    restore its state."""
    payload = read_payload(filename)
    if not isinstance(payload, dict) or "header" not in payload:
        raise CheckpointCorruptError(
            f"checkpoint {filename!r} decoded but has no header — not an "
            f"ocvf model checkpoint")
    header = payload["header"]
    try:
        version = int(header["format_version"])
        spec = json.loads(header["spec_json"])
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint {filename!r} has a malformed header: {exc!r}") from exc
    if version > FORMAT_VERSION:
        raise ValueError(f"checkpoint format v{version} is newer than supported "
                         f"v{FORMAT_VERSION}")
    model = deserialize_spec(spec, device)
    model.set_state(payload.get("state", {}))
    return model
