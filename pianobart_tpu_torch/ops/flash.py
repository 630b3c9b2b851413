"""Flash attention: the Hopper kernels ``csrc/flash_fwd.cu`` (K1) and
``csrc/flash_bwd.cu`` (K2), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

K1 replaces the Pallas TPU kernel ``pianobart_tpu/ops/flash.py:_fwd_kernel``
(launched by ``_fwd``).  Contract, held against ``_fwd``: q, k, v are
``(B, S, H, D)`` with q pre-scaled by the caller, read through their strides
with no transposes (the role of the TPU kernel's H-in-lanes layout);
``kv_mask`` is ``(B, Skv)``, nonzero = attend; ``causal`` keeps
``row >= col``.  Returns ``O (B, Sq, H, D)`` in the input dtype and the row
logsumexp ``lse (B, H, Sq)`` in f32.  Masked scores are the finite
``-1e30``, so fully masked rows stay finite; their values are undefined
(they depend on which kv tiles ran) and every loss mask excludes them.

K2 replaces ``pianobart_tpu/ops/flash.py:_bwd_fused_kernel`` (launched by
``_bwd_fused_call``): from q, k, v, the mask, dO, the forward's lse and
``delta = rowsum(dO * O)`` (computed here in plain PyTorch, as JAX's
``_delta`` is outside Pallas) it returns dQ, dK, dV in the input dtype.

Bounds (H100, 989 TFLOP/s bf16, 3.35 TB/s), both by operations: K1 at
(B, 1024, 8, 128) bf16 ``4*B*H*S^2*D`` FLOPs, about 4.3 us x B; K2 at the
flagship train shape (32, 1024, 8, 128) bf16 ``10*B*H*S^2*D`` FLOPs, 0.347 ms
per call unmasked, about half causal.  Both kernels are the simple first
design described in their sources: ``mma.sync`` tensor-core products,
synchronous tile loads, no wgmma/TMA pipeline.

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  The kernels are built with
``nvcc`` from the repo's sources at first use (never at import) into
``build/``, one library per source, all sources compiled at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "build_kernel", "build_kernels", "HEAD_DIM"]

NEG_INF = -1e30
HEAD_DIM = 128     # the one head width the kernels take
TILE = 64          # the kernels' q/kv tile rows: Sq and Skv must divide by it

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu"}
_HEADERS = ("flash_common.cuh",)
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pianobart_tpu_torch")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {   # C entry point, argtypes
    "flash_fwd": ("pbt_flash_fwd", [_P] * 6 + [_I] * 6 + [_L] * 9 + [_P]),
    "flash_bwd": ("pbt_flash_bwd", [_P] * 10 + [_I] * 6 + [_L] * 12 + [_P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _mask_and_scores(q, k, kv_mask, causal):
    """f32 scores ``(B, H, Sq, Skv)`` with masked entries at -1e30."""
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
    return torch.where(keep, s, torch.full_like(s, NEG_INF))


def flash_attention_reference(q, k, v, kv_mask=None, causal: bool = False):
    """Plain version of K1, computed in f32 with the same -1e30 masking
    convention.  Returns ``(out, lse)`` like the kernel."""
    s = _mask_and_scores(q, k, kv_mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.float()).to(q.dtype)
    return out, (m + torch.log(l_safe))[..., 0]


def _delta(dout, out):
    """delta = rowsum(dO * O) per head: (B, S, H, D) pair -> (B, H, S) f32."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, kv_mask, causal, out, lse, dout):
    """Plain version of K2's arithmetic in f32: P from the forward's lse,
    dP = dO V^T, dS = P * (dP - delta), then dV = P^T dO, dQ = dS K,
    dK = dS^T Q.  Returns ``(dq, dk, dv)`` in the input dtypes."""
    p = torch.exp(_mask_and_scores(q, k, kv_mask, causal) - lse[..., None])
    dof = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - _delta(dout, out)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in (_SOURCES[name],) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_kernels(names: Iterable[str] = tuple(_SOURCES)) -> Dict[str, ctypes.CDLL]:
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
                raise RuntimeError("nvcc not found: the flash kernels need the "
                                   "CUDA toolkit to build")
            os.makedirs(_BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            procs = {}
            for n, so in missing.items():
                src = os.path.join(_CSRC, _SOURCES[n])
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
            fn_name, argtypes = _SIGNATURES[n]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _I
            lib.path = so
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def build_kernel(name: str = "flash_fwd") -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return build_kernels([name])[name]


def _check_cuda_inputs(q, k, v, kv_mask, dout=None):
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or f32, got {q.dtype}")
    others = [("k", k, (B, Skv, H, D)), ("v", v, (B, Skv, H, D))]
    if dout is not None:
        others.append(("dout", dout, (B, Sq, H, D)))
    for name, x, shape in others:
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
        if x.shape != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
    if D != HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim {HEAD_DIM}, got {D}")
    if Sq % TILE or Skv % TILE:
        raise ValueError(f"flash kernel needs Sq, Skv multiples of {TILE}, "
                         f"got {Sq}, {Skv}")
    for name, x, _ in [("q", q, None)] + others:
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous head axis, strides "
                             f"in multiples of 8 and a 16-byte aligned start")
    if kv_mask is not None and (kv_mask.shape != (B, Skv)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be {(B, Skv)} on {q.device}")


def _int_mask(kv_mask, B, Skv, device):
    if kv_mask is None:
        return torch.ones((B, Skv), dtype=torch.int32, device=device)
    return kv_mask.to(torch.int32).contiguous()


def _on_cuda(q) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (take the plain version); raises for any other device."""
    if q.device.type in ("cuda", "cpu"):
        return q.device.type == "cuda"
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention_fwd(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, the flash forward over ``(B, S, H, D)``; returns ``(out, lse)``.
    Forward only: :func:`flash_attention` is the differentiable entry.

    CPU tensors take :func:`flash_attention_reference`; CUDA tensors launch
    the kernel (counted in ``flash_attention_fwd.launches``) or raise.
    """
    if not _on_cuda(q):
        return flash_attention_reference(q, k, v, kv_mask, causal)
    _check_cuda_inputs(q, k, v, kv_mask)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    mask = _int_mask(kv_mask, B, Skv, q.device)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build_kernel("flash_fwd")
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


def flash_attention_bwd(q, k, v, kv_mask, causal, out, lse, dout
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2, the flash backward: ``(dq, dk, dv)`` in the input dtype from the
    forward's inputs, its ``out`` and ``lse``, and ``dout``.

    CPU tensors take :func:`flash_attention_bwd_reference`; CUDA tensors
    launch the kernel (counted in ``flash_attention_bwd.launches``) or raise.
    """
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, kv_mask, causal, out,
                                             lse, dout)
    _check_cuda_inputs(q, k, v, kv_mask, dout)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(B, H, Sq)}")
    mask = _int_mask(kv_mask, B, Skv, q.device)
    lse = lse.contiguous()
    delta = _delta(dout, out)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Skv, H, D), dtype=q.dtype, device=q.device)
    lib = build_kernel("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pbt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            mask.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H,
            1 if q.dtype == torch.bfloat16 else 0, int(bool(causal)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving O and lse), K2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, ctx.causal, out,
                                         lse, dout.contiguous())
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_mask=None, causal: bool = False):
    """Flash attention over ``(B, S, H, D)``; q pre-scaled by the caller.
    Differentiable in q, k and v through K2."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal)
    return flash_attention_fwd(q, k, v, kv_mask, causal)[0]
