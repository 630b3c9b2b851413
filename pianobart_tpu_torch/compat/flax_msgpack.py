"""The msgpack files flax writes (``flax.serialization.to_bytes`` and
``msgpack_restore``), read and written without flax or the ``msgpack``
module: the port's own copy of the subset a merged ``.msgpack`` uses.

A file is one msgpack map of string keys whose values are maps or array
leaves.  An array is msgpack ext type 1, whose payload is itself msgpack:
the array ``(shape, dtype name, C-order bytes)``.  The scalars a map may
also hold (nil, bool, int, float, str, bin) are read and written as msgpack
defines them.  Array leaves are float32, float64 or bfloat16 and come back
as torch tensors: ``bfloat16``, which numpy lacks, is read as ``uint16`` and
viewed as ``torch.bfloat16``.

flax splits a leaf of more than 2^30 bytes into a ``__msgpack_chunked_array__``
map; no leaf of the repo's models comes near that, and such a file is
refused.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["to_bytes", "msgpack_restore", "read_msgpack", "write_msgpack"]

_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"
# the leaf types of a params tree: the port's f32, JAX's float64 merges, bf16
_NP_DTYPES = {"float32": np.float32, "float64": np.float64}
_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16"}


# ---------------------------------------------------------------- writing
def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack's uint64")
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, tags) -> None:
    """A length header: the fix form below ``fix_max``, else the smallest of
    the 8-, 16- and 32-bit forms (``tags``; None where the form is absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack object of {n} items or bytes")


def _pack_bin(b, out: bytearray) -> None:
    _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _array_payload(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    name = _TORCH_NAMES.get(t.dtype)
    if name is None:
        raise TypeError(f"cannot write a {t.dtype} tensor as a flax array leaf")
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    out = bytearray()
    out.append(0x93)
    _pack(list(t.shape), out)
    _pack(name, out)
    _pack_bin(raw, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _pack_bin(bytes(obj), out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for key, val in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"flax state dicts have string keys, not {key!r}")
            _pack(key, out)
            _pack(val, out)
    elif isinstance(obj, torch.Tensor):
        _pack_ext(_EXT_NDARRAY, _array_payload(obj), out)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a flax msgpack")


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` gives for the same nested
    dict (its insertion order kept), torch tensors standing for its arrays."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def write_msgpack(tree: Dict[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        f.write(to_bytes(tree))


# ---------------------------------------------------------------- reading
class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        tag = self.unpack(">B")
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if tag < 0x90:
            return self._map(tag & 0x0F)
        if tag < 0xA0:
            return [self.read() for _ in range(tag & 0x0F)]
        if tag < 0xC0:
            return self._str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if tag in ints:
            return self.unpack(ints[tag])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self._ext(fixext[tag])
        if tag not in lengths:
            raise ValueError(f"msgpack type byte 0x{tag:02x} is not supported")
        n = self.unpack(lengths[tag])
        if tag <= 0xC6:
            return bytes(self.take(n))
        if tag <= 0xC9:
            return self._ext(n)
        if tag <= 0xDB:
            return self._str(n)
        if tag <= 0xDD:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if _CHUNKED in out:
            raise ValueError(
                "flax's chunked-array form (a leaf above 2^30 bytes) is not "
                "supported: no leaf of the repo's models is that large")
        return out

    def _ext(self, n: int) -> torch.Tensor:
        code = self.unpack(">b")
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not a flax array leaf")
        shape, name, raw = _Reader(payload).read()
        if name == "bfloat16":
            arr = np.frombuffer(raw, dtype=np.uint16).copy()
            return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
        if name not in _NP_DTYPES:
            raise ValueError(f"array dtype {name!r} is not supported")
        return torch.from_numpy(np.frombuffer(raw, dtype=_NP_DTYPES[name]).copy()
                                ).reshape(shape)


def msgpack_restore(data) -> Dict[str, Any]:
    """The nested dict of a flax msgpack file's bytes, array leaves as torch
    tensors on the host (``flax.serialization.msgpack_restore``)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return tree


def read_msgpack(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
