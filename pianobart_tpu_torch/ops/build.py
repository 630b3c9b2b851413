"""Build and load the port's CUDA kernels: one ``csrc`` source per shared
library, compiled with ``nvcc`` for sm_90a at first use (never at import)
into ``build/`` beside the package, and bound through ctypes.  Also the one
rule every kernel wrapper follows: CUDA tensors launch the kernel, CPU
tensors take its plain version (:func:`use_kernel`).

Every source of :data:`KERNELS` is compiled at once, one ``nvcc`` process
each.  A library's file name carries a hash of its source, its headers and
the flags, so a changed source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

import torch

__all__ = ["KERNELS", "build_kernel", "build_kernels", "use_kernel"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pianobart_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FLASH_BWD_TAIL = [_I] * 7 + [_L] * 12 + [_P]   # B, Sq, Skv, H, D, dtype, causal; strides; stream
# library -> (source, headers it includes, {C entry point: argtypes})
KERNELS = {
    "flash_fwd": ("flash_fwd.cu", ("flash_common.cuh", "flash_fwd_bf16.cuh", "hopper.cuh"), {
        # q, k, v, mask, o, lse; B, Sq, Skv, H, D, dtype, causal; strides; stream
        "pbt_flash_fwd": [_P] * 6 + [_I] * 7 + [_L] * 9 + [_P]}),
    "flash_bwd": ("flash_bwd.cu", ("flash_common.cuh", "hopper.cuh"), {
        # q, k, v, dout, qt, kt, ot, mask, lse, delta, then the outputs
        "pbt_flash_bwd": [_P] * 13 + _FLASH_BWD_TAIL,
        "pbt_flash_dq": [_P] * 11 + _FLASH_BWD_TAIL,
        "pbt_flash_dkv": [_P] * 12 + _FLASH_BWD_TAIL,
        # dout, out, delta; B, S, H, D, dtype; dout's and out's strides; stream
        "pbt_flash_delta": [_P] * 3 + [_I] * 5 + [_L] * 6 + [_P],
        # the operands (a SplitArgs); n, B, H, D; stream
        "pbt_tf32_split": [_P] + [_I] * 4 + [_P]}),
    "fused_ln": ("fused_ln.cu", (), {
        # h, res, gamma, beta, seed, out, mean, rstd; N, D, dtype; threshold,
        # keep scale, eps; stream
        "pbt_fused_ln_fwd": [_P] * 8 + [_I] * 3 + [ctypes.c_uint32, _F, _F, _P],
        # h, res, gamma, mean, rstd, dout, seed, dh, dres, dgamma_p, dbeta_p;
        # N, D, dtype; threshold, keep scale; stream
        "pbt_fused_ln_bwd": [_P] * 11 + [_I] * 3 + [ctypes.c_uint32, _F, _P]}),
    "flash_lab": ("flash_lab.cu", ("flash_common.cuh", "flash_fwd_bf16.cuh", "hopper.cuh"), {
        # q, kt, v, mask, o, lse; B, Sq, Skv, H, causal, upcast, exp2; strides; stream
        "pbt_kt_fwd": [_P] * 6 + [_I] * 7 + [_L] * 9 + [_P],
        # q, k, v, mask, o, lse; B, Sq, Skv, H, causal, exp2; strides; stream
        "pbt_hl_fwd": [_P] * 6 + [_I] * 6 + [_L] * 9 + [_P]}),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _so_path(name: str) -> str:
    src, headers, _ = KERNELS[name]
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in (src,) + headers:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_kernels(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, ctypes.CDLL]:
    """Compile the named ``csrc`` sources for sm_90a (once per source
    version), one ``nvcc`` process per source, all started together, and
    load them.  Each ptxas report lands beside its library as ``.log``."""
    names = list(names)
    with _lib_lock:
        todo = {n: _so_path(n) for n in names if n not in _libs}
        missing = {n: so for n, so in todo.items() if not os.path.exists(so)}
        if missing:
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the port's kernels need the "
                                   "CUDA toolkit to build")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            procs = {}
            for n, so in missing.items():
                src = os.path.join(_CSRC, KERNELS[n][0])
                tmp = f"{so}.{os.getpid()}.tmp"
                procs[n] = (subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True), tmp, src)
            failed = []
            for n, (proc, tmp, src) in procs.items():
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src}:\n{err}")
                    continue
                so = missing[n]
                with open(so + ".log", "w") as f:
                    f.write(f"nvcc {time.perf_counter() - t0:.1f} s\n{err}")
                os.replace(tmp, so)
            if failed:
                raise RuntimeError("\n".join(failed))
        for n, so in todo.items():
            lib = ctypes.CDLL(so)
            for fn_name, argtypes in KERNELS[n][2].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.path = so
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def build_kernel(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return build_kernels([name])[name]


def use_kernel(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel or raises),
    False for a CPU tensor (it takes the plain version); raises for any
    other device."""
    if x.device.type in ("cuda", "cpu"):
        return x.device.type == "cuda"
    raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
