"""Flash attention: the Hopper kernels ``csrc/flash_fwd.cu`` (K1) and
``csrc/flash_bwd.cu`` (K2, K3a, K3b), their plain PyTorch versions, and the
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

The backward picks its kernels as the reference's ``_bwd_impl`` does, after
``delta = rowsum(dO * O)`` (JAX computes it in XLA outside Pallas; here
:func:`flash_attention_delta`, one pass of a small kernel on CUDA):

* K2 replaces ``_bwd_fused_kernel`` (launched by ``_bwd_fused_call``) where
  Sq and Skv fit the reference's single 1024-row block
  (:func:`_fused_eligible`): one C call returns dQ, dK, dV.
* K3a replaces ``_dq_kernel`` (``_dq_call``) and K3b ``_dkv_kernel``
  (``_dkv_call``) elsewhere (S > 1024): dQ, then dK and dV, each from the
  caller's lse and delta, so a caller with a merged lse (the ring backward)
  can use them alone.

K2's entry runs the same two CUDA kernels as K3b then K3a: a 1024 x 1024
block does not fit a CTA, so the port's K2 was tiled into K3's schedule from
the start.  K2 and K3 differ in entry point and contract, not in algorithm.

The kernels take every head width D that is a multiple of 128 up to their
type's :data:`MAX_HEAD_DIM` (:func:`head_dims`): 4096 in bf16, 2048 in f32,
as the reference's take any multiple of 128 (``_flash_eligible``); wider
heads are not ported yet.

Bounds (H100, 989 TFLOP/s bf16, 3.35 TB/s), all by operations: K1 at
(B, 1024, 8, 128) bf16 ``4*B*H*S^2*D`` FLOPs over the kept pairs, 0.1381 ms
at B=32 with ``chip_smoke.py``'s pad tail; K2 at the flagship train shape
(32, 1024, 8, 128) bf16 ``10*B*H*S^2*D`` FLOPs, 0.347 ms per call unmasked,
about half causal (its two kernels do seven products, not five: 0.49 ms at
best); K3a (3 products) and K3b (4) at the long-context shape
(16, 2048, 8, 128), 0.417 and 0.556 ms unmasked.  At ``--heads 4``
(D = 256, H = 4) and ``--heads 2`` (D = 512, H = 2) H*D is the same 1024,
and so is every bound; ``--hs 2048 --heads 1`` (D = 2048, H = 1) has the
same B*H*D at half the batch (B=16 for K1 and K2, B=8 for K3a and K3b), and
the same bounds there; ``--hs 4096 --heads 1`` (D = 4096) at a quarter (B=8
for K1 and K2, B=4 for K3a and K3b).

The bf16 kernels of K1, K2 and K3 are designed for Hopper (the sources
have the details), with the primitives of ``csrc/hopper.cuh``: a producer
warpgroup loads by TMA into a ring of stages signalled by mbarriers, and two
consumer warpgroups of 64 rows each run every product as ``wgmma``.  K1
loads Q once and streams K, V and the mask in tiles of 128; S = Q K^T from
shared memory, O += P V with P in registers, S of the next tile under P V of
this one.  K2/K3's dK/dV kernel owns 128 kv rows (K and V loaded once) and
streams Q, dO, lse and delta in tiles of 64; the dQ kernel owns 128 q rows
and streams K, V and the mask.  Each runs S and dP from shared memory, then
dV += P^T dO and dK += dS^T Q (or dQ += dS K) with P and dS from registers
and the swept tile read a second way, MN-major; the dQ kernel issues the
next tile's S and dP under dQ += dS K.  Left for later: ping-pong scheduling
of the consumer warpgroups, a persistent schedule, TMA multicast across a
cluster, and a one-pass K2.

At D = 256 the bf16 designs are re-tiled to fit a CTA's 227 KB and a
thread's 240 registers.  K1 keeps 128-row kv tiles and streams K and V
through a ring of four 32 KB slots, each half of the head's columns of a
tile (K lo, K hi, V lo, V hi); a warpgroup holds O and S, P takes S's
registers, and the two warpgroups take turns to issue S = Q K^T
(ping-pong), so that one's softmax runs under the other's products.  The
dK/dV kernel owns 64 kv rows a CTA: one warpgroup computes S^T and P^T once
and hands P^T to the other through shared memory, dV in the first and dK in
the second (four products a tile, dK and dV to the bit those of computing
S^T in both).  The dQ kernel owns 128 q rows a CTA, 64 a warpgroup each with
its own full-width dQ, and streams V and K through a ring of three 32 KB
slots, so every kv tile feeds both warpgroups.  In both, a tile's last
product runs in two halves, the first under the elementwise work of the
second.

The f32 kernels (the default ``PianoBartConfig``'s path) run the same
schedules on the tensor cores at f32 accuracy as 3xTF32: each operand x is
split into hi = x rounded to tf32 and lo = x - hi, and each product is
hi.hi' + hi.lo' + lo.hi' (about 2^-22 relative; one tf32 pass keeps three
decimal digits, the TPU's f32 kernels single bf16 passes).  tf32 ``wgmma``
reads its shared-memory operands K-major only, so a prep kernel
(:func:`flash_attention_split`, its own launch count) makes the hi and lo
planes once per call, and transposed planes of the operands a product
contracts over S with.  At D = 256 a CTA cannot hold a 64-row operand's
two planes beside the ring, so each f32 kernel runs as a cluster of two
CTAs, one per 128-column half of every plane, that sum the score products
(S, dP), which run over all of D, through each other's shared memory.
Bound: three tf32 products per f32 product at 495 TFLOP/s.

At D = 384 .. 4096 in bf16 and 384 .. 2048 in f32 (D = 128 n) every kernel
runs as clusters of CTAs, each on its columns of every operand: bf16 K1 and
the bf16 backward as ceil(D/256) CTAs of their D = 256 designs, 256 columns
each (TMA's zeros past D in the last one at 384, 640, .., 3968; the dK/dV
kernel streams Q and dO
through three 32 KB slots where it keeps two 64 KB stages, the dQ kernel V
and K through two slots where it keeps three, to make room for the
exchanges); the f32 forward as n CTAs of 128 columns, Q hi in registers
and a whole kv tile's planes in the ring, each consumer warpgroup summing
its own score tile; the f32 backward as n CTAs of 128 columns, each with
two consumer warpgroups on alternate swept tiles of 32 rows over the fixed
rows' planes.  The products over all of D (S in the forward; S and dP in
the backward) are summed across the cluster through distributed shared
memory (a pair in one round, four CTAs in two pairwise rounds, eight in
three, sixteen in four, else a reduce-scatter then an all-gather), so every
CTA holds the same sums to the bit and P, dS and lse agree across the
cluster; O, dQ, dK and dV stay column-local.  The card schedules a cluster
of up to 8 CTAs portably, which the bf16 clusters stay within to D = 2048;
the bf16 clusters past 2048 and the f32 ones past 1024 take 9 .. 16 CTAs,
H100's non-portable sizes, which the launches allow
(``csrc/hopper.cuh:max_active_clusters``).  16 CTAs is the card's largest
cluster, hence ``MAX_HEAD_DIM``; a kernel whose cluster the card cannot hold
raises.  The delta kernel takes a warp a row there, the prep 8 rows a CTA
(of half the columns past D = 1024).

The wrappers take the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  The kernels are built by
:mod:`.build` at first use, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .build import build_kernel, use_kernel

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_dq", "flash_attention_dkv", "flash_attention_delta",
           "flash_attention_split", "flash_attention_reference",
           "flash_attention_bwd_reference", "flash_attention_dq_reference",
           "flash_attention_dkv_reference", "flash_attention_split_reference",
           "HEAD_DIM", "HEAD_DIMS", "MAX_HEAD_DIM", "head_dims"]

NEG_INF = -1e30
# the head widths the kernels take, by type: D = 128 and 256 have designs of
# their own, wider heads run as clusters (csrc/hopper.cuh:launch_cluster) of
# ceil(D/256) CTAs in bf16 and D/128 in f32; 16 CTAs, H100's largest cluster
# (a non-portable size), reach D = 4096 in bf16 and 2048 in f32
MAX_HEAD_DIM = {torch.bfloat16: 4096, torch.float32: 2048}
HEAD_DIMS = {dtype: tuple(range(128, top + 1, 128)) for dtype, top in MAX_HEAD_DIM.items()}
HEAD_DIM = 128     # the flagship's head width, the one the kernel lab takes
TILE = 64          # the kernels' q/kv tile rows: Sq and Skv must divide by it
FUSED_BWD_MAX = 1024   # the reference's single-block backward cap (_BWD_BLOCK)


def head_dims(dtype) -> Tuple[int, ...]:
    """The head widths the kernels take in ``dtype`` (another type: f32's,
    and the kernels refuse the type itself)."""
    return HEAD_DIMS.get(dtype, HEAD_DIMS[torch.float32])


def _width_error(what, dtype, D):
    """The ValueError of a head width the kernels do not take in ``dtype``."""
    top = head_dims(dtype)[-1]
    return ValueError(f"{what} takes {str(dtype)[6:]} head_dim a multiple of 128 up to "
                      f"{top}, got {D}")


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
    """delta = rowsum(dO * O) per head: (B, S, H, D) pair -> (B, H, S) f32.
    The plain version of :func:`flash_attention_delta`."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, kv_mask, causal, lse, delta, dout):
    """The backward's f32 P = exp(s - lse) from the forward's lse and
    dS = P * (dP - delta) with dP = dO V^T, both (B, H, Sq, Skv)."""
    p = torch.exp(_mask_and_scores(q, k, kv_mask, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_attention_dq_reference(q, k, v, kv_mask, causal, lse, delta, dout):
    """Plain version of K3a in f32: dQ = dS K.  Returns dq in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, kv_mask, causal, lse, delta, dout)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, kv_mask, causal, lse, delta, dout):
    """Plain version of K3b in f32: dK = dS^T Q, dV = P^T dO.  Returns
    ``(dk, dv)`` in the input dtypes."""
    p, ds = _probs_and_ds(q, k, v, kv_mask, causal, lse, delta, dout)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, kv_mask, causal, out, lse, dout,
                                  delta=None):
    """Plain version of K2's arithmetic in f32: P from the forward's lse,
    dP = dO V^T, dS = P * (dP - delta), then dV = P^T dO, dQ = dS K,
    dK = dS^T Q.  ``delta`` is rowsum(dO * O) of ``out`` unless the caller
    gives it (the ring's global delta; ``out`` may then be None).  Returns
    ``(dq, dk, dv)`` in the input dtypes."""
    if delta is None:
        delta = _delta(dout, out)
    p, ds = _probs_and_ds(q, k, v, kv_mask, causal, lse, delta, dout)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits, ties away from zero) as
    the kernels round it (``hopper.cuh:tf32_round``): half a tf32 ulp added
    to the bits, the low 13 cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_planes(x):
    """``(2, B, H, S, D)``: hi = x rounded to tf32 and lo = x - hi (exact
    in f32)."""
    x = x.float().permute(0, 2, 1, 3)
    hi = _tf32_round(x)
    return torch.stack([hi, x - hi])


def flash_attention_split_reference(x, natural: bool = True,
                                     transposed: bool = False):
    """Plain version of :func:`flash_attention_split`: ``(nat, tr)``, each
    None where not asked for."""
    planes = _split_planes(x)
    nat = planes.contiguous() if natural else None
    tr = None
    if transposed:
        S = x.shape[1]
        order = torch.arange(S, device=x.device).view(-1, 4, 2).transpose(1, 2)
        tr = planes.transpose(3, 4)[..., order.reshape(-1)].contiguous()
    return nat, tr


def _fused_eligible(Sq: int, Skv: int) -> bool:
    """True where the reference's ``_fused_eligible(Sq, Skv, None, None)``
    is: both lengths fit its single 1024-row backward block."""
    return Sq <= FUSED_BWD_MAX and Skv <= FUSED_BWD_MAX


def _check_rows_layout(name, x):
    """A ``(B, S, H, D)`` operand as the kernels address it: a contiguous
    head axis, the other strides in multiples of 8 and a 16-byte aligned
    start."""
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous head axis, strides "
                         f"in multiples of 8 and a 16-byte aligned start")


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
    if D not in head_dims(q.dtype):
        raise _width_error("flash kernel", q.dtype, D)
    if Sq % TILE or Skv % TILE:
        raise ValueError(f"flash kernel needs Sq, Skv multiples of {TILE}, "
                         f"got {Sq}, {Skv}")
    for name, x, _ in [("q", q, None)] + others:
        _check_rows_layout(name, x)
    if kv_mask is not None and (kv_mask.shape != (B, Skv)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be {(B, Skv)} on {q.device}")


def _int_mask(kv_mask, B, Skv, device):
    if kv_mask is None:
        return torch.ones((B, Skv), dtype=torch.int32, device=device)
    return kv_mask.to(torch.int32).contiguous()


def _tma_ready(x):
    """``x`` contiguous from a 16-byte aligned start, as a TMA map reads it:
    ``x`` itself where it already is, else a copy."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _raise_for(entry, rc, D=None, dtype=None):
    """The C entries' codes: 2000 + n where the card cannot hold a cluster
    of n CTAs of the kernel (``hopper.cuh:launch_cluster``) at head width D
    in ``dtype``, 1000 + the CUresult of a refused tensor map, else a CUDA
    error."""
    if rc >= 2000:
        kind = "" if dtype is None else (
            f" in {str(dtype)[6:]} (whose kernels take head widths up to "
            f"{head_dims(dtype)[-1]})")
        raise RuntimeError(f"{entry}: the card cannot schedule a cluster of {rc - 2000} "
                           f"CTAs of this kernel (cudaOccupancyMaxActiveClusters is 0), "
                           f"which head width {D} needs{kind}")
    if rc >= 1000:
        raise RuntimeError(f"{entry}: the driver refused a TMA tensor map "
                           f"(CUresult {rc - 1000}; 0 = no encoder)")
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")


_SPLIT_MAX = 4     # operands of one prep launch (csrc/flash_bwd.cu:SPLIT_MAX)


class _SplitArgs(ctypes.Structure):
    """``csrc/flash_bwd.cu:SplitArgs``, field by field."""
    _fields_ = [("x", ctypes.c_void_p * _SPLIT_MAX), ("nat", ctypes.c_void_p * _SPLIT_MAX),
                ("tr", ctypes.c_void_p * _SPLIT_MAX), ("sb", ctypes.c_longlong * _SPLIT_MAX),
                ("ss", ctypes.c_longlong * _SPLIT_MAX), ("sh", ctypes.c_longlong * _SPLIT_MAX),
                ("S", ctypes.c_int * _SPLIT_MAX)]


def _split_launch(specs: Sequence[Tuple[torch.Tensor, bool, bool]]):
    """One launch of the prep kernel for the ``(x, natural, transposed)``
    operands of one call (CUDA tensors of one (B, *, H, D) family, D in
    ``head_dims(torch.float32)``); returns their ``(nat, tr)`` pairs."""
    B, _, H, D = specs[0][0].shape
    if D not in head_dims(torch.float32):
        raise _width_error("tf32 split", torch.float32, D)
    args, outs = _SplitArgs(), []
    for i, (x, natural, transposed) in enumerate(specs):
        S = x.shape[1]
        if (x.dtype != torch.float32 or x.dim() != 4 or x.shape[0] != B or x.shape[2] != H
                or x.shape[3] != D or S % TILE):
            raise ValueError(f"tf32 split takes f32 ({B}, S, {H}, {D}) with S a "
                             f"multiple of {TILE}, got {x.dtype} {tuple(x.shape)}")
        _check_rows_layout("x", x)
        nat = (torch.empty((2, B, H, S, D), dtype=torch.float32, device=x.device)
               if natural else None)
        tr = (torch.empty((2, B, H, D, S), dtype=torch.float32, device=x.device)
              if transposed else None)
        args.x[i] = x.data_ptr()
        args.nat[i] = None if nat is None else nat.data_ptr()
        args.tr[i] = None if tr is None else tr.data_ptr()
        args.sb[i], args.ss[i], args.sh[i] = x.stride()[:3]
        args.S[i] = S
        outs.append((nat, tr))
    x = specs[0][0]
    lib = build_kernel("flash_bwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.pbt_tf32_split(ctypes.addressof(args), len(specs), B, H, D, stream)
    _raise_for("pbt_tf32_split", rc)
    flash_attention_split.launches += 1
    return outs


def flash_attention_split(x, natural: bool = True, transposed: bool = False):
    """The f32 kernels' prep: every f32 operand x of a product is split into
    hi = x rounded to tf32 and lo = x - hi (exact in f32), so the tensor
    cores take its products as hi.hi' + hi.lo' + lo.hi' at f32 accuracy
    (3xTF32).  From ``x (B, S, H, D)`` f32 (read through its strides, D in
    ``head_dims(torch.float32)``) returns ``(nat, tr)``: ``nat (2, B, H, S, D)`` the
    natural hi and lo planes, ``tr (2, B, H, D, S)`` the transposed ones
    (the operand of a product that contracts over S, which tf32 ``wgmma``
    reads from shared memory only with S along the rows), whose S runs in
    the order 0 2 4 6 1 3 5 7 within each 8 (the k order of an A fragment
    made from an f32 accumulator); each None where not asked for.

    No Pallas kernel: the TPU kernels took their f32 dots as single bf16
    passes.  CPU tensors take :func:`flash_attention_split_reference`; CUDA
    tensors launch ``csrc/flash_bwd.cu``'s prep kernel (counted in
    ``flash_attention_split.launches``) or raise.  The f32 attention
    wrappers split all the operands of a call in one launch, at every
    width.  Bound by bytes: x read once, each plane written once.
    """
    if not use_kernel(x, "flash attention"):
        return flash_attention_split_reference(x, natural, transposed)
    return _split_launch([(x, natural, transposed)])[0]


flash_attention_split.launches = 0


def flash_attention_fwd(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, the flash forward over ``(B, S, H, D)``; returns ``(out, lse)``.
    Forward only: :func:`flash_attention` is the differentiable entry.

    CPU tensors take :func:`flash_attention_reference`; CUDA tensors launch
    the kernel (counted in ``flash_attention_fwd.launches``) or raise.
    """
    if not use_kernel(q, "flash attention"):
        return flash_attention_reference(q, k, v, kv_mask, causal)
    _check_cuda_inputs(q, k, v, kv_mask)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    mask = _tma_ready(_int_mask(kv_mask, B, Skv, q.device))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ops = (q, k, v)
    if q.dtype == torch.float32:                # Q's and K's planes, V's transposed
        (qn, _), (kn, _), (_, vt) = _split_launch(
            [(q, True, False), (k, True, False), (v, False, True)])
        ops = (qn, kn, vt)
    lib = build_kernel("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.pbt_flash_fwd(
            *(x.data_ptr() for x in ops), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Sq, Skv, H, D,
            1 if q.dtype == torch.bfloat16 else 0, int(bool(causal)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    _raise_for("flash_fwd", rc, D, q.dtype)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_delta(dout, out) -> torch.Tensor:
    """delta = rowsum(dO * O), ``(B, H, S)`` f32 from the ``(B, S, H, D)``
    pair: what the backward subtracts from dP.  The reference computes it in
    XLA outside its Pallas kernels (``_delta``); the plain PyTorch version
    (:func:`_delta`) takes five passes over memory, so CUDA tensors take one
    pass of ``csrc/flash_bwd.cu``'s delta kernel (counted in
    ``flash_attention_delta.launches``) or raise.  CPU tensors take
    :func:`_delta`."""
    if not use_kernel(dout, "flash attention"):
        return _delta(dout, out)
    B, S, H, D = dout.shape
    if dout.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"delta kernel takes bf16 or f32, got {dout.dtype}")
    if out.shape != dout.shape or out.dtype != dout.dtype or out.device != dout.device:
        raise ValueError("out must match dout's shape, dtype and device")
    if D not in head_dims(dout.dtype):
        raise _width_error("delta kernel", dout.dtype, D)
    _check_rows_layout("dout", dout)
    _check_rows_layout("out", out)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dout.device)
    lib = build_kernel("flash_bwd")
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        rc = lib.pbt_flash_delta(dout.data_ptr(), out.data_ptr(), delta.data_ptr(),
                                 B, S, H, D, 1 if dout.dtype == torch.bfloat16 else 0,
                                 *dout.stride()[:3], *out.stride()[:3], stream)
    _raise_for("pbt_flash_delta", rc)
    flash_attention_delta.launches += 1
    return delta


flash_attention_delta.launches = 0


def _check_bwd_rows(q, lse, delta=None):
    B, Sq, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (x.shape != (B, H, Sq) or x.dtype != torch.float32
                              or x.device != q.device):
            raise ValueError(f"{name} must be f32 {(B, H, Sq)} on {q.device}")


# which transposed planes (of q, k, dO) each backward entry's f32 kernels read
_TRANSPOSED = {"pbt_flash_bwd": (True, True, True), "pbt_flash_dq": (False, True, False),
               "pbt_flash_dkv": (True, False, True)}


def _launch_bwd(entry, q, k, v, kv_mask, causal, lse, delta, dout, outs):
    """Launch one backward C entry of ``flash_bwd.cu`` on the current
    stream; ``outs`` are its output tensors in the entry's order.  The
    kernels read the mask, lse and delta by TMA: each is made contiguous and
    16-byte aligned first.  f32 operands go to the kernels as the prep's
    planes (:func:`flash_attention_split`, one launch for the four)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    mask = _tma_ready(_int_mask(kv_mask, B, Skv, q.device))
    lse, delta = _tma_ready(lse), _tma_ready(delta)
    ops, trs = (q, k, v, dout), (None, None, None)
    if q.dtype == torch.float32:
        tq, tk, to = _TRANSPOSED[entry]
        (qn, qt), (kn, kt), (vn, _), (on, ot) = _split_launch(
            [(q, True, tq), (k, True, tk), (v, True, False), (dout, True, to)])
        ops, trs = (qn, kn, vn, on), (qt, kt, ot)
    lib = build_kernel("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *(x.data_ptr() for x in ops),
            *(None if x is None else x.data_ptr() for x in trs),
            mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(o.data_ptr() for o in outs), B, Sq, Skv, H, D,
            1 if q.dtype == torch.bfloat16 else 0, int(bool(causal)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3], stream)
    _raise_for(entry, rc, D, q.dtype)


def flash_attention_dq(q, k, v, kv_mask, causal, lse, delta, dout
                       ) -> torch.Tensor:
    """K3a: dQ from the forward's inputs, the caller's ``lse`` and ``delta``
    (both ``(B, H, Sq)`` f32) and ``dout``.

    CPU tensors take :func:`flash_attention_dq_reference`; CUDA tensors
    launch the kernel (counted in ``flash_attention_dq.launches``) or raise.
    """
    if not use_kernel(q, "flash attention"):
        return flash_attention_dq_reference(q, k, v, kv_mask, causal, lse,
                                            delta, dout)
    _check_cuda_inputs(q, k, v, kv_mask, dout)
    _check_bwd_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("pbt_flash_dq", q, k, v, kv_mask, causal, lse, delta, dout, [dq])
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, kv_mask, causal, lse, delta, dout
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b: ``(dk, dv)`` from the forward's inputs, the caller's ``lse`` and
    ``delta`` and ``dout``.

    CPU tensors take :func:`flash_attention_dkv_reference`; CUDA tensors
    launch the kernel (counted in ``flash_attention_dkv.launches``) or raise.
    """
    if not use_kernel(q, "flash attention"):
        return flash_attention_dkv_reference(q, k, v, kv_mask, causal, lse,
                                             delta, dout)
    _check_cuda_inputs(q, k, v, kv_mask, dout)
    _check_bwd_rows(q, lse, delta)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("pbt_flash_dkv", q, k, v, kv_mask, causal, lse, delta, dout,
                [dk, dv])
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, kv_mask, causal, out, lse, dout, delta=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward: ``(dq, dk, dv)`` in the input dtype from the
    forward's inputs, its ``out`` and ``lse``, and ``dout``.

    As the reference's ``_bwd_impl``: where :func:`_fused_eligible` holds,
    K2 (counted in ``flash_attention_bwd.launches``); elsewhere delta once,
    then K3a (:func:`flash_attention_dq`) and K3b
    (:func:`flash_attention_dkv`), each counted on its own.  CPU tensors
    take the plain versions; CUDA tensors launch the kernels or raise.

    With ``delta`` (``(B, H, Sq)`` f32) the caller's rowsum(dO * O) is used
    and ``out`` is not read (it may be None): the reference's
    ``_bwd_fused_call`` contract, as the ring backward calls it with the
    merged lse and the delta of the merged output.
    """
    if delta is None:
        delta = flash_attention_delta(dout, out)
    if not _fused_eligible(q.shape[1], k.shape[1]):
        dq = flash_attention_dq(q, k, v, kv_mask, causal, lse, delta, dout)
        dk, dv = flash_attention_dkv(q, k, v, kv_mask, causal, lse, delta, dout)
        return dq, dk, dv
    if not use_kernel(q, "flash attention"):
        return flash_attention_bwd_reference(q, k, v, kv_mask, causal, out,
                                             lse, dout, delta)
    _check_cuda_inputs(q, k, v, kv_mask, dout)
    _check_bwd_rows(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("pbt_flash_bwd", q, k, v, kv_mask, causal, lse, delta, dout,
                [dq, dk, dv])
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving O and lse); K2, or K3a and K3b, backward."""

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
    Differentiable in q, k and v through K2 (S <= 1024) or K3a + K3b."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_mask, causal)
    return flash_attention_fwd(q, k, v, kv_mask, causal)[0]
