"""ctypes binding of the native image loader (``native/ocvf_loader.cpp``):
port of ``opencv_facerecognizer_tpu/utils/native.py``.

The loader decodes the uncompressed formats the classic face datasets use
(PGM, PPM, BMP) to float32 grayscale and resizes bilinearly into a
caller-provided buffer; other formats return None and ``utils.dataset``
falls back to cv2 or PIL. The library is compiled on first use with
``g++`` into ``build/native/`` of the checkout (git-ignored), from the
C++ source as it stands in ``native/``; nothing is written next to the
source. Without a compiler, every call returns None and the fallbacks
serve.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "ocvf_loader.cpp")
_SO = os.path.join(_REPO, "build", "native", "libocvf_loader.so")

_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build() -> bool:
    """Compile to a private tmp path and rename into place, so a concurrent
    or interrupted build never leaves a truncated library under ``_SO``."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.build.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.ocvf_probe.restype = ctypes.c_int
    lib.ocvf_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, c_int_p, c_int_p]
    lib.ocvf_decode_gray.restype = ctypes.c_int
    lib.ocvf_decode_gray.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, c_float_p]
    lib.ocvf_load_gray.restype = ctypes.c_int
    lib.ocvf_load_gray.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, c_float_p]
    lib.ocvf_load_batch.restype = ctypes.c_int
    lib.ocvf_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, c_float_p, c_int_p]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    """The native library (built if missing or older than its source);
    None when it cannot be built or loaded."""
    global _lib_handle, _lib_failed
    if _lib_handle is not None or _lib_failed:
        return _lib_handle
    with _lock:
        if _lib_handle is not None or _lib_failed:
            return _lib_handle
        stale = not os.path.exists(_SO) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO))
        if stale and not (os.path.exists(_SRC) and _build()):
            _lib_failed = True
            return None
        try:
            _lib_handle = _bind(ctypes.CDLL(_SO))
        except OSError:
            _lib_failed = True
    return _lib_handle


def available() -> bool:
    return _lib() is not None


_MAGIC = (b"P2", b"P3", b"P5", b"P6", b"BM")


def handles(path_or_bytes) -> bool:
    """Magic-byte check: is this a format the native loader decodes?"""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:2])
    else:
        try:
            with open(path_or_bytes, "rb") as f:
                head = f.read(2)
        except OSError:
            return False
    return head in _MAGIC


def decode_gray(data: bytes, size: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
    """PGM/PPM/BMP bytes -> float32 [H, W] (0..255), resized to ``size``
    (H, W) when given; None when unsupported or undecodable."""
    lib = _lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(data, len(data))
    if size is None:
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.ocvf_probe(ctypes.cast(buf, ctypes.c_char_p), len(data),
                          ctypes.byref(h), ctypes.byref(w)) != 0:
            return None
        oh, ow = h.value, w.value
    else:
        oh, ow = int(size[0]), int(size[1])
    out = np.empty((oh, ow), np.float32)
    rc = lib.ocvf_decode_gray(ctypes.cast(buf, ctypes.c_char_p), len(data), oh, ow,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def load_gray(path: str, size: Optional[Tuple[int, int]] = None) -> Optional[np.ndarray]:
    """Load, decode and resize one file; None on any failure."""
    lib = _lib()
    if lib is None or not handles(path):
        return None
    if size is None:
        try:
            with open(path, "rb") as f:
                return decode_gray(f.read(), None)
        except OSError:
            return None
    out = np.empty((int(size[0]), int(size[1])), np.float32)
    rc = lib.ocvf_load_gray(path.encode(), int(size[0]), int(size[1]),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def load_batch(paths: List[str], size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Many files into one [N, H, W] float32 batch in native code:
    (batch, ok mask); rows not ok were undecodable."""
    lib = _lib()
    n = len(paths)
    oh, ow = int(size[0]), int(size[1])
    out = np.zeros((n, oh, ow), np.float32)
    if lib is None or n == 0:
        return out, np.zeros((n,), bool)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    status = np.empty((n,), np.int32)
    lib.ocvf_load_batch(arr, n, oh, ow, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, status == 0
