"""The msgpack subset that flax's checkpoints use, in pure Python.

Counterpart of ``flax.serialization``'s ``msgpack_serialize`` /
``msgpack_restore`` (and of the ``msgpack`` package under them): the
card's machine has neither, and the port reads and writes the JAX
package's checkpoints.

Types: nil, bool, int (all widths), float32/64, str, bin, array, map,
and three extension types:

- ext 1, an array: a packed ``(shape, dtype name, C-order bytes)``;
- ext 2, a Python complex: a packed ``(real, imag)``;
- ext 3, a numpy scalar: packed as a 0-d array.

``packb`` follows flax's choices byte for byte: the smallest encoding of
each int, str and container header, floats as float64, exact types only
(a tuple, or a subclass of a builtin, is refused with ``TypeError``
unless it is a numpy scalar), dict keys in sorted order (flax copies the
tree with ``jax.tree_util.tree_map``, which sorts them), and arrays over
``MAX_CHUNK_SIZE`` bytes in dicts split into the chunked form
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks":
{"0": ..}}``. ``unpackb`` reverses all of it.

An array whose dtype is ``bfloat16`` (numpy has none) decodes to a
``torch.bfloat16`` tensor through a ``uint16`` view, and a bf16 torch
tensor encodes under that name; every other array is a numpy array.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

#: flax's bound on one array leaf (msgpack's own limit is 2^31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class UnpackError(ValueError):
    """The bytes are not a complete msgpack object of the supported subset."""


# ---- encoding ----


def _int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        if v <= 0x7F:
            out.append(bytes((v,)))
        elif v <= 0xFF:
            out.append(b"\xcc" + bytes((v,)))
        elif v <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", v))
        elif v <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", v))
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(struct.pack(">b", v))
    elif v >= -0x80:
        out.append(b"\xd0" + struct.pack(">b", v))
    elif v >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif v >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif v >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes: Tuple[bytes, ...],
            out: List[bytes]) -> None:
    """Length header of a str/bin/array/map: fixed form, then 8/16/32-bit
    (``codes`` lists the 8-bit code first, or None where there is none)."""
    if fix is not None and n <= fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] is not None and n <= 0xFF:
        out.append(codes[0] + bytes((n,)))
    elif n <= 0xFFFF:
        out.append(codes[1] + struct.pack(">H", n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[2] + struct.pack(">I", n))
    else:
        raise ValueError("object too large for msgpack")


_STR = (b"\xd9", b"\xda", b"\xdb")
_BIN = (b"\xc4", b"\xc5", b"\xc6")
_ARRAY = (None, b"\xdc", b"\xdd")
_MAP = (None, b"\xde", b"\xdf")
_FIXEXT = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}


def _ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _header(n, None, 0, (b"\xc7", b"\xc8", b"\xc9"), out)
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_tuple(arr) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes("C")
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _pack_array_payload(arr) -> bytes:
    """The inner msgpack of ext 1/3: tuples as arrays, bytes as bin."""
    shape, name, buf = _array_tuple(arr)
    out: List[bytes] = []
    _header(3, 0x90, 15, _ARRAY, out)
    _header(len(shape), 0x90, 15, _ARRAY, out)
    for d in shape:
        _int(int(d), out)
    _str(name, out)
    _header(len(buf), None, 0, _BIN, out)
    out.append(buf)
    return b"".join(out)


def _str(s: str, out: List[bytes]) -> None:
    raw = s.encode("utf-8")
    _header(len(raw), 0xA0, 31, _STR, out)
    out.append(raw)


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _int(obj, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        _str(obj, out)
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _header(len(raw), None, 0, _BIN, out)
        out.append(raw)
    elif t is list:
        _header(len(obj), 0x90, 15, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _header(len(obj), 0x80, 15, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(EXT_NDARRAY, _pack_array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _ext(EXT_NPSCALAR, _pack_array_payload(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        inner: List[bytes] = [b"\x92"]
        _pack(float(obj.real), inner)
        _pack(float(obj.imag), inner)
        _ext(EXT_COMPLEX, b"".join(inner), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _sorted_tree(obj: Any) -> Any:
    """The tree as flax's ``tree_map`` copy leaves it: dicts rebuilt with
    sorted keys, lists copied, leaves as they are."""
    if type(obj) is dict:
        return {k: _sorted_tree(obj[k]) for k in sorted(obj)}
    if type(obj) is list:
        return [_sorted_tree(v) for v in obj]
    return obj


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's chunked form of one oversized array (insertion order kept)."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    chunks = [flat[i:i + size] for i in range(0, n, size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(obj: Any) -> Any:
    """Split oversized arrays that are dict values (or the root), as flax
    does; arrays inside lists stay whole."""
    if type(obj) is dict:
        for k, v in obj.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    obj[k] = _chunk(v)
            elif type(v) is dict:
                _chunk_leaves(v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)) and _nbytes(obj) > MAX_CHUNK_SIZE:
        return _chunk(obj)
    return obj


def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out: List[bytes] = []
    _pack(_chunk_leaves(_sorted_tree(tree)), out)
    return b"".join(out)


# ---- decoding ----


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise UnpackError(f"truncated: need {n} bytes at offset {self.pos}, "
                              f"have {len(self.data) - self.pos}")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _read(r: _Reader, raw: bool) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _text(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack(_LEN[1 << (b - 0xC4)])))
    if b in (0xD9, 0xDA, 0xDB):
        return _text(r.take(r.unpack(_LEN[1 << (b - 0xD9)])), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(_LEN[2 << (b - 0xDC)])
        return [_read(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(_LEN[2 << (b - 0xDE)]), raw)
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
    elif b in (0xC7, 0xC8, 0xC9):
        n = r.unpack(_LEN[1 << (b - 0xC7)])
    else:
        raise UnpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {r.pos - 1}")
    code = r.unpack(">b")
    return _ext_value(code, bytes(r.take(n)))


def _text(view: memoryview, raw: bool):
    return bytes(view) if raw else bytes(view).decode("utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        if not raw and not isinstance(k, (str, bytes)):
            raise UnpackError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _read(r, raw)
    return out


def _unpack_all(data: bytes, raw: bool) -> Any:
    r = _Reader(data)
    obj = _read(r, raw)
    if r.pos != len(r.data):
        raise UnpackError(f"{len(r.data) - r.pos} extra bytes after the object")
    return obj


def _array_from_payload(data: bytes):
    shape, name, buf = _unpack_all(data, raw=True)
    shape = tuple(int(d) for d in shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode("ascii"))).reshape(shape, order="C")


def _ext_value(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_COMPLEX:
        re, im = _unpack_all(data, raw=False)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise UnpackError(f"unsupported msgpack extension type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(obj: Any) -> Any:
    if isinstance(obj, dict):
        if CHUNKED in obj:
            return _unchunk(obj)
        for k, v in obj.items():
            if isinstance(v, dict):
                obj[k] = _unchunk(v) if CHUNKED in v else _unchunk_leaves(v)
    return obj


def unpackb(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the same tree, arrays
    as numpy arrays (bf16 as ``torch.bfloat16`` tensors). Raises
    ``UnpackError`` (a ``ValueError``) on truncated or malformed input."""
    return _unchunk_leaves(_unpack_all(bytes(data), raw=False))
