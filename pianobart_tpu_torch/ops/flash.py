"""Flash attention forward: the Hopper kernel ``csrc/flash_fwd.cu`` and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``pianobart_tpu/ops/flash.py:
_fwd_kernel`` (launched by ``_fwd``).  Contract, held against ``_fwd``:
q, k, v are ``(B, S, H, D)`` with q pre-scaled by the caller, read through
their strides with no transposes (the role of the TPU kernel's H-in-lanes
layout); ``kv_mask`` is ``(B, Skv)``, nonzero = attend; ``causal`` keeps
``row >= col``.  Returns ``O (B, Sq, H, D)`` in the input dtype and the row
logsumexp ``lse (B, H, Sq)`` in f32.  Masked scores are the finite
``-1e30``, so fully masked rows stay finite; their values are undefined
(they depend on which kv tiles ran) and every loss mask excludes them.

Bound at the serving shape (B, 1024, 8, 128) bf16: ``4*B*H*S^2*D`` FLOPs =
4.29 GFLOP per unit of B, about 4.3 us x B at the H100's 989 TFLOP/s bf16
(bound by operations; the q/k/v/o bytes, 8.4 MB x B, take about 2.5 us x B
at 3.35 TB/s).  The first kernel is the simple design described in the
source: ``mma.sync`` tensor-core products, synchronous tile loads, no
wgmma/TMA pipeline.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  The kernel is built with ``nvcc``
from the repo's source at first use (never at import) into ``build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "build_kernel", "HEAD_DIM"]

NEG_INF = -1e30
HEAD_DIM = 128     # the one head width the kernel takes
TILE = 64          # the kernel's q/kv tile rows: Sq and Skv must divide by it

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "flash_fwd.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pianobart_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()


def flash_attention_reference(q, k, v, kv_mask=None, causal: bool = False):
    """Plain version of the kernel, computed in f32 with the same -1e30
    masking convention.  Returns ``(out, lse)`` like the kernel."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    keep = torch.ones((B, 1, 1, Skv), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        keep = (kv_mask != 0)[:, None, None, :]
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        keep = keep & (rows >= cols)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def build_kernel():
    """Compile ``csrc/flash_fwd.cu`` for sm_90a (once per source version)
    and load it.  The ptxas report lands beside the library as ``.log``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
        so = os.path.join(_BUILD_DIR, f"flash_fwd-{digest.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the flash kernel needs the "
                                   "CUDA toolkit to build")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            res = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
            with open(so + ".log", "w") as f:
                f.write(f"nvcc {time.perf_counter() - t0:.1f} s\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pbt_flash_fwd.argtypes = [P] * 6 + [I] * 6 + [L] * 9 + [P]
        lib.pbt_flash_fwd.restype = I
        lib.path = so
        _lib = lib
        return lib


def _check_cuda_inputs(q, k, v, kv_mask):
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
        if x.shape != (B, Skv, H, D):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(B, Skv, H, D)}")
    if D != HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim {HEAD_DIM}, got {D}")
    if Sq % TILE or Skv % TILE:
        raise ValueError(f"flash kernel needs Sq, Skv multiples of {TILE}, "
                         f"got {Sq}, {Skv}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head axis, strides "
                             f"in multiples of 8 and a 16-byte aligned start")
    if kv_mask is not None and (kv_mask.shape != (B, Skv)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be {(B, Skv)} on {q.device}")


def flash_attention_fwd(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward over ``(B, S, H, D)``; returns ``(out, lse)``.

    CPU tensors take :func:`flash_attention_reference`; CUDA tensors launch
    the kernel (counted in ``flash_attention_fwd.launches``) or raise.
    """
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention_fwd is forward-only (no backward kernel yet); "
            "call it under torch.no_grad() / torch.inference_mode()")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    _check_cuda_inputs(q, k, v, kv_mask)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if kv_mask is None:
        mask = torch.ones((B, Skv), dtype=torch.int32, device=q.device)
    else:
        mask = kv_mask.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pbt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Sq, Skv, H,
            1 if q.dtype == torch.bfloat16 else 0, int(bool(causal)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, kv_mask=None, causal: bool = False):
    """Flash attention over ``(B, S, H, D)``; q pre-scaled by the caller."""
    return flash_attention_fwd(q, k, v, kv_mask, causal)[0]
