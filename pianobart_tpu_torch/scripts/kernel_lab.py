"""Kernel experiment lab: flash-forward variants, measured head to head on
the card against the committed flash forward (K1, ``ops/flash.py``).

The counterpart of ``scripts/kernel_lab.py``, with its two experiments as
Hopper kernels (``csrc/flash_lab.cu``), each K1's own kernel template
(``csrc/flash_fwd_bf16.cuh``) with one option changed, so that the lab
measures the option and nothing else:

* L1, :func:`kt_fwd`: K1's forward reading K pre-transposed, with a real
  transpose of K to ``(B, H*D, Skv)`` inside every call (the lab times it as
  part of the variant).  ``upcast`` asks for f32 operands, ``exp2`` for an
  exp2-domain softmax.
* L2, :func:`hl_fwd`: K1's layout with f32 operands; ``exp2`` on by default.

"f32 operands" on Hopper: bf16 x bf16 products are exact in f32, so only
P.V changes, where the kernel splits P into two bf16 halves and issues two
products (``SPLIT_P``).  K pre-transposed is read through ``wgmma``'s
transpose bit (``KT``).  Without ``upcast``, P rounds to bf16 before P.V as
in K1, and under ``exp2`` q is scaled by log2(e) rounded to bf16
(1.4453125) in bf16, exactly as the reference lab does: that variant's
softmax is of 1.0018*s and its lse is in those units.

The kernels take bf16 CUDA tensors only, head_dim 128, Sq and Skv multiples
of 64; other CUDA inputs raise (K1's f32 kernel stays the f32 check of the
algorithm).  CPU tensors take the plain versions (:func:`kt_fwd_reference`,
:func:`hl_fwd_reference`), which make the reference's roundings in f32.
``block`` is the reference's TPU tile; the Hopper kernels keep K1's
128-row tiles (a length of 64 past a multiple of 128 makes a ragged tile),
so it is validated (a positive multiple of 64) and changes neither the
schedule nor the result.

:func:`main` runs the lab's program: each variant checked against K1
(max |diff| < 0.05), then each as a chain of 24 attentions with the
``o*0.5 + c*0.5`` blend, in two interleaved sweeps of the median of 10
reps, timed with CUDA events (the device's time: no host round trip to
subtract).  On the card::

    python -m pianobart_tpu_torch.scripts.kernel_lab            # K1 vs L2
    PBX_LAB_KT=1 python -m pianobart_tpu_torch.scripts.kernel_lab   # and L1

``main(device="cpu", B=..., S=..., H=...)`` runs the same program on the
plain versions at a small shape (host-clock times of the CPU, not of a
kernel).
"""
from __future__ import annotations

import os
import statistics
import time
from typing import Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops.build import build_kernel, use_kernel
from ..ops.flash import (HEAD_DIM, TILE, _check_cuda_inputs, _int_mask,
                         _mask_and_scores, _raise_for, _tma_ready, flash_attention)

__all__ = ["kt_fwd", "hl_fwd", "kt_fwd_lse", "hl_fwd_lse", "kt_attention",
           "kt_fwd_reference", "hl_fwd_reference", "main", "LOG2E"]

LOG2E = 1.4426950408889634
REPS = 10      # timed calls of a chain per sweep (their median is kept)
LENGTH = 24    # attentions per chain


def _check_block(block: int) -> None:
    if not isinstance(block, int) or block <= 0 or block % TILE:
        raise ValueError(f"block must be a positive multiple of {TILE}, got {block!r}")


def _lab_reference(q, k, v, kv_mask, causal, upcast, exp2):
    """The reference lab's arithmetic in f32: ``(out, lse)``, out in q's
    dtype, lse in log2 units under ``exp2``.  Without ``upcast``, q is scaled
    by log2(e) in q's dtype and P rounds to v's dtype before P.V."""
    dtype = q.dtype
    if exp2:
        q = q.float() * LOG2E if upcast else q * torch.tensor(LOG2E, dtype=dtype)
    s = _mask_and_scores(q, k, kv_mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m) if exp2 else torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if not upcast:
        p = p.to(v.dtype).float()
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(dtype)
    lse = m + (torch.log2(l_safe) if exp2 else torch.log(l_safe))
    return out, lse[..., 0]


def kt_fwd_reference(q, k, v, kv_mask=None, causal: bool = False,
                     upcast: bool = True, exp2: bool = False):
    """Plain version of L1 (the layout of K does not enter the arithmetic):
    ``(out, lse)``."""
    return _lab_reference(q, k, v, kv_mask, causal, upcast, exp2)


def hl_fwd_reference(q, k, v, kv_mask=None, causal: bool = False,
                     exp2: bool = True):
    """Plain version of L2 (f32 operands): ``(out, lse)``."""
    return _lab_reference(q, k, v, kv_mask, causal, True, exp2)


def _check_lab_inputs(q, k, v, kv_mask):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the lab's kernels take bf16 only, got {q.dtype} "
                        "(K1's f32 kernel is the f32 check of the algorithm)")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the lab's kernels take head_dim {HEAD_DIM}, got {q.shape[-1]}")
    _check_cuda_inputs(q, k, v, kv_mask)


def _launch(entry, q, k, v, kv_mask, k_strides, flags):
    B, Sq, H, D = q.shape
    Skv = v.shape[1]
    mask = _tma_ready(_int_mask(kv_mask, B, Skv, q.device))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = build_kernel("flash_lab")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Sq, Skv, H, *flags,
            *q.stride()[:3], *k_strides, *v.stride()[:3], stream)
    _raise_for(entry, rc)
    return out, lse


def kt_attention(q, kt, v, kv_mask=None, causal: bool = False, upcast: bool = True,
                 exp2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1's kernel on a K^T the caller made: ``kt (B, H*D, Skv)`` with Skv
    contiguous, q and v ``(B, S, H, D)``.  Returns ``(out, lse)``.  CUDA
    tensors launch the kernel (counted in ``kt_fwd.launches``) or raise; CPU
    tensors take :func:`kt_fwd_reference`."""
    B, Sq, H, D = q.shape
    Skv = v.shape[1]
    if not use_kernel(q, "the lab's kt_fwd"):
        k = kt.reshape(B, H, D, Skv).permute(0, 3, 1, 2)
        return kt_fwd_reference(q, k, v, kv_mask, causal, upcast, exp2)
    _check_lab_inputs(q, v, v, kv_mask)
    if kt.shape != (B, H * D, Skv) or kt.dtype != q.dtype or kt.device != q.device:
        raise ValueError(f"kt must be {q.dtype} {(B, H * D, Skv)} on {q.device}")
    if kt.stride(2) != 1 or kt.stride(0) % 8 or kt.stride(1) % 8 or kt.data_ptr() % 16:
        raise ValueError("kt needs a contiguous kv axis, strides in multiples of 8 "
                         "and a 16-byte aligned start")
    res = _launch("pbt_kt_fwd", q, kt, v, kv_mask,
                  (kt.stride(0), D * kt.stride(1), kt.stride(1)),
                  (int(bool(causal)), int(bool(upcast)), int(bool(exp2))))
    kt_fwd.launches += 1
    return res


def kt_fwd_lse(q, k, v, kv_mask=None, causal: bool = False, upcast: bool = True,
               exp2: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 over ``(B, S, H, D)``: ``(out, lse)``, lse in log2 units under
    ``exp2``.  CUDA tensors transpose K to ``(B, H*D, Skv)`` (the real
    transpose the lab times) and go to :func:`kt_attention`; CPU tensors
    take :func:`kt_fwd_reference`."""
    if not use_kernel(q, "the lab's kt_fwd"):
        return kt_fwd_reference(q, k, v, kv_mask, causal, upcast, exp2)
    _check_lab_inputs(q, k, v, kv_mask)
    B, Skv, H, D = k.shape
    kt = k.reshape(B, Skv, H * D).transpose(1, 2).contiguous()
    return kt_attention(q, kt, v, kv_mask, causal, upcast, exp2)


def hl_fwd_lse(q, k, v, kv_mask=None, causal: bool = False, exp2: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2 over ``(B, S, H, D)``: ``(out, lse)``, lse in log2 units under
    ``exp2``.  CUDA tensors launch the kernel (counted in
    ``hl_fwd.launches``) or raise; CPU tensors take
    :func:`hl_fwd_reference`."""
    if not use_kernel(q, "the lab's hl_fwd"):
        return hl_fwd_reference(q, k, v, kv_mask, causal, exp2)
    _check_lab_inputs(q, k, v, kv_mask)
    res = _launch("pbt_hl_fwd", q, k, v, kv_mask, k.stride()[:3],
                  (int(bool(causal)), int(bool(exp2))))
    hl_fwd.launches += 1
    return res


def kt_fwd(q, k, v, kv_mask, causal=False, upcast=True, exp2=False, block=1024):
    """L1 with the reference lab's signature; returns ``out (B, Sq, H, D)``."""
    _check_block(block)
    return kt_fwd_lse(q, k, v, kv_mask, causal, upcast, exp2)[0]


def hl_fwd(q, k, v, kv_mask, causal=False, exp2=True, block=1024):
    """L2 with the reference lab's signature; returns ``out (B, Sq, H, D)``."""
    _check_block(block)
    return hl_fwd_lse(q, k, v, kv_mask, causal, exp2)[0]


kt_fwd.launches = 0
hl_fwd.launches = 0


def _timer(device):
    """``measure(fn)``: ms of one call of ``fn``, by CUDA events on a card
    (the device's time), by the host clock on the CPU."""
    if device.type == "cuda":
        def measure(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end)
    else:
        def measure(fn):
            t0 = time.perf_counter()
            fn()
            return 1e3 * (time.perf_counter() - t0)
    return measure


def main(device: DeviceLike = None, kt: Optional[bool] = None, B: int = 32,
         S: int = 1024, H: int = 8) -> dict:
    """The lab's program at ``(B, S, H, 128)`` bf16 with q = k = v: each
    variant checked against K1, then timed as a chain of ``LENGTH``
    attentions, the median of ``REPS``, in two interleaved sweeps.  ``kt``
    (default: ``PBX_LAB_KT=1`` in the environment) adds the L1 variants.
    Returns ``{"device", "checks": {name: max|diff|}, "sweeps": [{name:
    ms}, {name: ms}]}``."""
    dev = resolve_device(device)
    if kt is None:
        kt = os.environ.get("PBX_LAB_KT") == "1"
    g = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn(B, S, H, HEAD_DIM, device=dev, generator=g) * 0.1
         ).to(torch.bfloat16)
    mask = torch.ones(B, S, device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"kernel lab on {where}: B={B} S={S} H={H} D={HEAD_DIM} bf16, "
          f"q = k = v, {'CUDA events' if dev.type == 'cuda' else 'host clock'}",
          flush=True)

    # correctness vs the committed kernel (bf16 tolerance)
    ref = flash_attention(q, q, q, mask, False)
    checks = {"hl_exp2": lambda: hl_fwd(q, q, q, mask, False, exp2=True)}
    if kt:
        checks.update({
            "kt_f32": lambda: kt_fwd(q, q, q, mask, False, upcast=True),
            "kt_bf16": lambda: kt_fwd(q, q, q, mask, False, upcast=False),
            "kt_bf16_exp2": lambda: kt_fwd(q, q, q, mask, False, upcast=False,
                                           exp2=True),
        })
    errs = {}
    for name, fn in checks.items():
        errs[name] = (fn().float() - ref.float()).abs().max().item()
        print(f"{name}: max|diff| vs committed = {errs[name]:.5f}", flush=True)
        if not errs[name] < 0.05:
            raise AssertionError(f"{name} disagrees with K1: {errs[name]}")

    measure = _timer(dev)

    def chain(att):
        def f():
            c = q
            for _ in range(LENGTH):
                o = att(c)
                c = (o * 0.5 + c * 0.5).to(c.dtype)
            return c.float().sum()
        return f

    variants = {
        "base":           lambda c: flash_attention(c, c, c, mask, False),
        "hl_exp2":        lambda c: hl_fwd(c, c, c, mask, False, exp2=True),
        "hl_noexp2":      lambda c: hl_fwd(c, c, c, mask, False, exp2=False),
        "base_causal":    lambda c: flash_attention(c, c, c, mask, True),
        "hl_exp2_causal": lambda c: hl_fwd(c, c, c, mask, True, exp2=True),
    }
    if kt:
        variants.update({
            "kt_f32":  lambda c: kt_fwd(c, c, c, mask, False, upcast=True),
            "kt_bf16": lambda c: kt_fwd(c, c, c, mask, False, upcast=False),
            "kt_bf16_causal_b512": lambda c: kt_fwd(c, c, c, mask, True,
                                                    upcast=False, block=512),
        })
    fns = {name: chain(att) for name, att in variants.items()}
    sweeps = []
    for sweep in range(2):                 # interleave: expose drift
        sweeps.append({})
        for name, f in fns.items():
            f()                            # warm (and build, the first time)
            t = statistics.median(measure(f) for _ in range(REPS))
            sweeps[-1][name] = t
            print(f"[{sweep}] {name:22s} {t:9.4f} ms"
                  f" ({t / LENGTH:.4f} ms/module)", flush=True)
    return {"device": where, "checks": errs, "sweeps": sweeps}


if __name__ == "__main__":
    main()
