"""Fused dropout + residual add + LayerNorm, the counterpart of
``pianobart_tpu/ops/fused_ln.py``: the Hopper kernels ``csrc/fused_ln.cu``
(K4a forward, K4b backward), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Every sublayer of the trunk ends in ``LayerNorm(residual + dropout(h))``.
Unfused, each of its 40 sites per flagship step draws a (B, S, D) mask into
device memory, keeps it for the backward, and runs the add and the
statistics as separate passes.  K4a does the tail in one pass and draws the
dropout bits inside the kernel; K4b regenerates the same bits and returns
dh, dresidual and the (dgamma, dbeta) column sums.  The numerics are the
reference's: the residual add in f32 (the unfused path adds in the compute
dtype), f32 statistics with the fast variance clamped at 0, ``out = xhat *
gamma + beta`` in h's dtype, and a keep threshold quantised to 2^-32 with
survivors scaled by the quantised keep rate, so activations stay unbiased.

The bits are Philox4x32-10 keyed by a 64-bit seed with the element index
``row * D + col`` as counter (:func:`philox_bits`), so they do not depend on
how the kernels block rows; they are not the TPU's bits, so the tests feed
the reference's own bits to the plain version through ``bits=``.

Bounds (H100, 3.35 TB/s), both by bytes: at the flagship N = 32768 rows of
D = 1024 in bf16, K4a moves 192 MiB (0.060 ms) and K4b 320 MiB (0.100 ms).

The kernels take any D that is a multiple of 128 up to ``MAX_D`` = 8192: a
row of up to 1024 per warp, a wider one split across up to 8 warps of a
CTA (each lane holds at most 32 elements of a row).  That passes what the
reference's kernel fits in its TPU's scoped VMEM (256 rows of 2048 f32).

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  The kernels are built by
:mod:`.build` at first use, never at import.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .build import build_kernel, use_kernel

__all__ = ["threshold", "keep_scale", "fused_eligible", "philox_bits",
           "dropout_add_ln", "dropout_add_ln_fwd", "dropout_add_ln_bwd",
           "dropout_add_ln_reference", "dropout_add_ln_bwd_reference"]

LN_EPS = 1e-5
MAX_D = 8192       # 8 warps of 32 lanes, 32 elements of a row each
BWD_ROWS = 64      # rows per K4b CTA: one (dgamma, dbeta) partial row each

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold(rate: float) -> int:
    """Drop threshold on 32-bit bits: ``round(rate * 2^32)``."""
    return int(round(rate * 2.0 ** 32))


def keep_scale(rate: float) -> float:
    """Survivor scale, the inverse of the quantised keep rate."""
    return 2.0 ** 32 / (2.0 ** 32 - threshold(rate))


def fused_eligible(shape) -> bool:
    """``(..., D)`` with D a multiple of 128 and a row count that is a
    nonzero multiple of 128 (the reference's rule)."""
    n = 1
    for s in shape[:-1]:
        n *= s
    return shape[-1] % 128 == 0 and n % 128 == 0 and n > 0


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``m * x`` for a 32-bit constant ``m`` and an
    int64 tensor ``x`` of 32-bit values.  The product can reach 2^64, past
    int64, so ``x`` is split into 16-bit halves: ``m*x = p_hi*2^16 + p_lo``
    with both partial products below 2^48."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox_bits(seed, n: int, d: int, device: Optional[torch.device] = None,
                row0: int = 0) -> torch.Tensor:
    """The kernels' random bits for rows ``row0 .. row0+n-1`` of a tensor of
    rows of ``d`` (``d % 4 == 0``): Philox4x32-10 keyed by ``(seed mod 2^32,
    seed >> 32)`` with counter ``(g mod 2^32, g >> 32, 0, 0)`` giving the
    elements ``4g .. 4g+3`` of the row-major order.  ``seed`` is an int in
    [0, 2^63) or a one-element int64 tensor (then the bits are made on its
    device).  Returns ``(n, d)`` int64 values in [0, 2^32)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
        s = seed.reshape(()).to(torch.int64)
    else:
        s = torch.tensor(seed, dtype=torch.int64, device=device)
    k0, k1 = s & _M32, (s >> 32) & _M32
    g = torch.arange(row0 * d // 4, (row0 + n) * d // 4, dtype=torch.int64,
                     device=device)
    c0, c1 = g & _M32, g >> 32
    c2 = c3 = torch.zeros_like(g)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return torch.stack([c0, c1, c2, c3], dim=-1).reshape(n, d)


def _dropout_add(h, residual, seed, rate, bits):
    """f32 ``y = residual + (keep ? h * ks : 0)`` over (N, D) rows, with the
    keep mask from ``bits`` (or the seed's Philox bits) and ``ks``."""
    d = h.shape[-1]
    h2 = h.reshape(-1, d).float()
    if bits is None:
        bits = philox_bits(seed, h2.shape[0], d, h2.device)
    keep = bits.to(torch.int64).reshape(h2.shape) >= threshold(rate)
    ks = torch.tensor(keep_scale(rate), dtype=torch.float32)
    y = residual.reshape(-1, d).float() + torch.where(keep, h2 * ks, 0.0)
    return y, keep, ks


def dropout_add_ln_reference(h, residual, gamma, beta, seed, rate: float,
                             eps: float = LN_EPS, bits=None):
    """Plain version of K4a.  Returns ``(out, mean, rstd)``: ``out`` in h's
    shape and dtype, the f32 row statistics ``(N,)``.  ``bits`` (N, D)
    replaces the Philox bits (the tests pass the reference's)."""
    y, _, _ = _dropout_add(h, residual, seed, rate, bits)
    mean = y.mean(-1)
    var = torch.clamp((y * y).mean(-1) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (y - mean[:, None]) * rstd[:, None]
    out = xhat * gamma.float() + beta.float()
    return out.to(h.dtype).reshape(h.shape), mean, rstd


def dropout_add_ln_bwd_reference(h, residual, gamma, mean, rstd, dout, seed,
                                 rate: float, bits=None):
    """Plain version of K4b.  Returns ``(dh, dres, dgamma, dbeta)``: dh and
    dres in the shapes and dtypes of h and residual, dgamma and dbeta f32
    ``(D,)``."""
    y, keep, ks = _dropout_add(h, residual, seed, rate, bits)
    xhat = (y - mean[:, None]) * rstd[:, None]
    do = dout.reshape(-1, h.shape[-1]).float()
    g = do * gamma.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    dy = rstd[:, None] * (g - m1 - xhat * m2)
    dh = torch.where(keep, dy * ks, 0.0)
    return (dh.to(h.dtype).reshape(h.shape), dy.to(residual.dtype).reshape(h.shape),
            (do * xhat).sum(0), do.sum(0))


def _check_cuda_inputs(rate, seed, h, residual, vectors, dout=None):
    """What the kernels take: bf16/f32 (N, D) rows, D % 128 == 0 and
    D <= MAX_D, N % 128 == 0, contiguous and 16-byte aligned; f32 (D,)
    vectors; one int64 seed on the device; a rate whose threshold fits 32
    bits."""
    d = h.shape[-1]
    n = h.numel() // d if d else 0
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused LN kernel takes bf16 or f32, got {h.dtype}")
    if d % 128 or d > MAX_D or n % 128 or n == 0:
        raise ValueError(f"fused LN kernel needs D % 128 == 0, D <= {MAX_D} and "
                         f"rows % 128 == 0, got {n} rows of {d}")
    rows = [("residual", residual)] + ([("dout", dout)] if dout is not None else [])
    for name, x in [("h", h)] + rows:
        if x.shape != h.shape or x.dtype != h.dtype or x.device != h.device:
            raise ValueError(f"{name} must match h's shape, dtype and device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, x, shape in vectors:
        if (x.shape != shape or x.dtype != torch.float32 or x.device != h.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous f32 {shape} on {h.device}")
    if (seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != h.device):
        raise ValueError(f"seed must be one int64 on {h.device}")
    if not 0.0 <= rate or threshold(rate) >= 2 ** 32:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return n, d


def dropout_add_ln_fwd(h, residual, gamma, beta, seed, rate: float,
                       eps: float = LN_EPS):
    """K4a: ``(out, mean, rstd)`` of ``LayerNorm(residual + dropout(h))``
    over the last axis, bits from ``seed`` (a one-element int64 tensor).

    CPU tensors take :func:`dropout_add_ln_reference`; CUDA tensors launch
    the kernel (counted in ``dropout_add_ln_fwd.launches``) or raise."""
    if not use_kernel(h, "dropout_add_ln"):
        return dropout_add_ln_reference(h, residual, gamma, beta, seed, rate, eps)
    d = h.shape[-1]
    n, d = _check_cuda_inputs(rate, seed, h, residual,
                              [("gamma", gamma, (d,)), ("beta", beta, (d,))])
    out = torch.empty_like(h)
    mean = torch.empty(n, dtype=torch.float32, device=h.device)
    rstd = torch.empty(n, dtype=torch.float32, device=h.device)
    lib = build_kernel("fused_ln")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.pbt_fused_ln_fwd(
            h.data_ptr(), residual.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            seed.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            n, d, 1 if h.dtype == torch.bfloat16 else 0, threshold(rate),
            keep_scale(rate), eps, stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_fwd kernel launch failed: CUDA error {rc}")
    dropout_add_ln_fwd.launches += 1
    return out, mean, rstd


dropout_add_ln_fwd.launches = 0


def dropout_add_ln_bwd(h, residual, gamma, mean, rstd, dout, seed, rate: float):
    """K4b: ``(dh, dres, dgamma, dbeta)`` from the forward's inputs, its
    ``mean`` and ``rstd``, and ``dout``.  The kernel writes one f32
    (dgamma, dbeta) partial row per 64 rows; they are summed here.

    CPU tensors take :func:`dropout_add_ln_bwd_reference`; CUDA tensors
    launch the kernel (counted in ``dropout_add_ln_bwd.launches``) or
    raise."""
    if not use_kernel(h, "dropout_add_ln"):
        return dropout_add_ln_bwd_reference(h, residual, gamma, mean, rstd, dout,
                                            seed, rate)
    d = h.shape[-1]
    n = h.numel() // d if d else 0
    n, d = _check_cuda_inputs(rate, seed, h, residual,
                              [("gamma", gamma, (d,)), ("mean", mean, (n,)),
                               ("rstd", rstd, (n,))], dout)
    dh = torch.empty_like(h)
    dres = torch.empty_like(residual)
    dgamma_p = torch.empty((n // BWD_ROWS, d), dtype=torch.float32, device=h.device)
    dbeta_p = torch.empty_like(dgamma_p)
    lib = build_kernel("fused_ln")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.pbt_fused_ln_bwd(
            h.data_ptr(), residual.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dout.data_ptr(), seed.data_ptr(), dh.data_ptr(),
            dres.data_ptr(), dgamma_p.data_ptr(), dbeta_p.data_ptr(), n, d,
            1 if h.dtype == torch.bfloat16 else 0, threshold(rate),
            keep_scale(rate), stream)
    if rc != 0:
        raise RuntimeError(f"fused_ln_bwd kernel launch failed: CUDA error {rc}")
    dropout_add_ln_bwd.launches += 1
    return dh, dres, dgamma_p.sum(0), dbeta_p.sum(0)


dropout_add_ln_bwd.launches = 0


class _DropoutAddLN(torch.autograd.Function):
    """K4a forward (saving h, residual, mean, rstd and the seed), K4b
    backward."""

    @staticmethod
    def forward(ctx, h, residual, gamma, beta, seed, rate, eps):
        out, mean, rstd = dropout_add_ln_fwd(h, residual, gamma, beta, seed,
                                             rate, eps)
        ctx.save_for_backward(h, residual, gamma, mean, rstd, seed)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        h, residual, gamma, mean, rstd, seed = ctx.saved_tensors
        dh, dres, dgamma, dbeta = dropout_add_ln_bwd(
            h, residual, gamma, mean, rstd, dout.contiguous(), seed, ctx.rate)
        return dh, dres, dgamma, dbeta, None, None, None


def dropout_add_ln(h, residual, gamma, beta, seed, rate: float,
                   eps: float = LN_EPS):
    """``LayerNorm(residual + dropout(h))`` over the last axis in one fused
    pass per direction; differentiable in h, residual, gamma and beta.

    ``seed`` is a one-element int64 tensor on h's device (draw one per call
    site); ``gamma`` and ``beta`` are ``(D,)`` and join in f32.  Returns a
    tensor of h's shape and dtype."""
    return _DropoutAddLN.apply(h.contiguous(), residual.contiguous(),
                               gamma.float(), beta.float(), seed, rate, eps)
