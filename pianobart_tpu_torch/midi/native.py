"""ctypes loader for the native MIDI -> Octuple codec
(``pianobart_tpu/midi/native.py``).

Builds ``native/midi_codec.cpp`` with g++ on first use (~1 s) into
``build/pianobart_tpu_torch/`` beside the kernels' libraries, under a name
that carries a hash of the source, and exposes
:func:`midi_bytes_to_octuple`.  Without g++, or when the build fails, callers
take the Python path: the rows are identical (tested), the native path is
only faster.  Host code: no GPU is involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..ops.build import _BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "midi_codec.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_TASKS = {"pretrain": 0, "composer": 0, "emotion": 0, "generate": 0,
          "melody": 1, "velocity": 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libpbx_midi-{h.hexdigest()[:16]}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.pbx_midi_to_octuple.restype = ctypes.c_int
        lib.pbx_midi_to_octuple.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
        lib.pbx_free.argtypes = [ctypes.c_void_p]
        lib.pbx_free.restype = None
        lib.pbx_abi_version.argtypes = []
        lib.pbx_abi_version.restype = ctypes.c_int
        if lib.pbx_abi_version() != 1:
            raise RuntimeError(f"{lib_path}: unexpected ABI version")
        return lib
    except (OSError, RuntimeError, subprocess.SubprocessError):
        _build_failed = True
        return None


def available() -> bool:
    """True when the native library is built (or builds now) and loads."""
    return _get() is not None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def midi_bytes_to_octuple(data: bytes,
                          task: str = "pretrain") -> Optional[List[Tuple[int, ...]]]:
    """Native parse + quantize; ``None`` when the native library is
    unavailable.  Raises ``ValueError`` (or ``AssertionError``) on malformed
    input, as the Python path does."""
    lib = _get()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int32)()
    n = lib.pbx_midi_to_octuple(data, len(data), _TASKS.get(task, 0),
                                ctypes.byref(out))
    if n == -1:
        raise ValueError("not a standard MIDI file (no MThd)")
    if n == -2:
        raise ValueError("unsupported time signature")
    if n == -3:
        raise AssertionError("invalid time signature change")
    if n <= 0:
        return []
    try:
        arr = np.ctypeslib.as_array(out, shape=(n, 9)).copy()
    finally:
        lib.pbx_free(out)
    width = 9 if task in ("melody", "velocity") else 8
    return [tuple(int(x) for x in row[:width]) for row in arr]
