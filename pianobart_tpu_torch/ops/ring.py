"""Ring attention over a sequence-parallel mesh axis, the counterpart of
``pianobart_tpu/ops/ring.py``.

Each rank of an ``sp`` ring holds a sequence slice of q, k and v.  K, V and
the key mask rotate around the ring (to rank r+1, from rank r-1); every step
runs the flash forward K1 on the local queries and the keys it holds, which
returns the row log-sum-exp, and the partial outputs merge in f32 by the
online-softmax identity::

    lse = logaddexp(lse_a, lse_b)
    out = out_a * exp(lse_a - lse) + out_b * exp(lse_b - lse)

The block output stays in the input dtype before the merge, as in the
reference.  Causality is block-granular: blocks of later shards are skipped
and the diagonal block takes the kernel's causal mask.  No attention dropout
applies on this path (the reference's ring branch passes no rate).

The backward computes delta = rowsum(dO * O) of the merged output once (the
delta kernel), then walks the ring again with dK and dV accumulators (f32)
travelling with their blocks, so that after n rotations each is home with
every query shard's contribution, while dQ accumulates locally.  Each block's
gradients come from the merged lse and the global delta: K2
(:func:`~.flash.flash_attention_bwd` with the caller's delta) where the local
shard fits its 1024-row block, else K3a and K3b.

Transport: ``dist.batch_isend_irecv``.  Under NCCL the device tensors go as
they are.  gloo's send and receive take host tensors only, so under gloo each
block is staged through pinned host buffers (the transport ``rotate``
reports); the kernels and all the arithmetic stay on the device.

On CUDA the local shard must be a shape the kernels take (128-row multiples
of at least 256, head width 128): another raises, it never drops to plain
attention.  On the CPU the wrappers run their plain versions, and
:func:`ring_attention_reference` runs the plain versions on any device.

``replicated_in``, ``psum_out`` and ``tp_slice`` are the explicit
forward/backward pairs that compose tensor parallelism with the ring (TP∘SP).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel.mesh import Axis, all_reduce_
from .attention import _flash_eligible
from .flash import (_delta, _fused_eligible, flash_attention_bwd,
                    flash_attention_bwd_reference, flash_attention_delta,
                    flash_attention_dkv, flash_attention_dkv_reference,
                    flash_attention_dq, flash_attention_dq_reference,
                    flash_attention_fwd, flash_attention_reference)

__all__ = ["ring_attention", "ring_attention_reference", "rotate", "transport",
           "replicated_in", "psum_out", "tp_slice"]

# the block functions of each version: the wrappers (the kernels on CUDA
# tensors, their plain versions on CPU tensors) and the plain versions
_KERNELS = SimpleNamespace(fwd=flash_attention_fwd, delta=flash_attention_delta,
                           bwd=flash_attention_bwd, dq=flash_attention_dq,
                           dkv=flash_attention_dkv)
_PLAIN = SimpleNamespace(fwd=flash_attention_reference, delta=_delta,
                         bwd=flash_attention_bwd_reference,
                         dq=flash_attention_dq_reference,
                         dkv=flash_attention_dkv_reference)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def transport(ax: Axis, device: torch.device) -> str:
    """How :func:`rotate` moves blocks of ``device`` over ``ax``."""
    if ax.size == 1:
        return "none (a ring of one)"
    if ax.backend == "gloo" and device.type == "cuda":
        return "gloo via pinned host buffers"
    return f"{ax.backend} on {device.type} tensors"


def rotate(ax: Axis, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Send each tensor to the next member of the ring and receive the
    previous member's, in one ``batch_isend_irecv``."""
    if ax.size == 1:
        return list(tensors)
    device = tensors[0].device
    staged = ax.backend == "gloo" and device.type == "cuda"
    if staged:
        # the copy into pinned memory waits for the device; the copy back is
        # queued on the stream, and the caching host allocator keeps each
        # buffer until it has run
        sends = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                 for t in tensors]
    else:
        sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty(s.shape, dtype=s.dtype, device=s.device,
                         pin_memory=staged) for s in sends]
    nxt, prv = ax.peer(1), ax.peer(-1)
    ops = ([dist.P2POp(dist.isend, s, nxt, ax.group, i) for i, s in enumerate(sends)]
           + [dist.P2POp(dist.irecv, r, prv, ax.group, i) for i, r in enumerate(recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return [r.to(device, non_blocking=True) for r in recvs]
    return recvs


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _merge(out, lse, o_i, l_i):
    """Merge a block's (out (B, S, H, D), lse (B, H, S)) into the running
    pair, in f32."""
    new = torch.logaddexp(lse, l_i)
    wa = torch.exp(lse - new).transpose(1, 2)[..., None]
    wb = torch.exp(l_i - new).transpose(1, 2)[..., None]
    return out * wa + o_i.float() * wb, new


def _ring_fwd(q, k, v, kv_mask, causal, ax, fn):
    n, my = ax.size, ax.index
    B, S, H, D = q.shape
    out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, S), float("-inf"), dtype=torch.float32, device=q.device)
    kb, vb, mb = k, v, kv_mask
    for i in range(n):
        src = (my - i) % n                  # whose keys this rank holds now
        if not causal or src <= my:
            o_i, l_i = fn.fwd(q, kb, vb, mb, causal and src == my)
            out, lse = _merge(out, lse, o_i, l_i)
        if i < n - 1:
            kb, vb, mb = rotate(ax, (kb, vb, mb))
    return out.to(q.dtype), lse


def _ring_bwd(q, k, v, kv_mask, causal, out, lse, g, ax, fn):
    n, my = ax.size, ax.index
    g = g.contiguous()
    delta = fn.delta(g, out)                # (B, H, S), of the merged output
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb, mb = k, v, kv_mask
    fused = _fused_eligible(q.shape[1], k.shape[1])
    for i in range(n):
        src = (my - i) % n
        if not causal or src <= my:
            c = causal and src == my
            if fused:
                dq_i, dk_i, dv_i = fn.bwd(q, kb, vb, mb, c, None, lse, g, delta)
            else:
                dq_i = fn.dq(q, kb, vb, mb, c, lse, delta, g)
                dk_i, dv_i = fn.dkv(q, kb, vb, mb, c, lse, delta, g)
            dq += dq_i.float()
            dkb += dk_i.float()
            dvb += dv_i.float()
        # the accumulators travel with their blocks: after n rotations home
        if i < n - 1:
            kb, vb, mb, dkb, dvb = rotate(ax, (kb, vb, mb, dkb, dvb))
        else:
            dkb, dvb = rotate(ax, (dkb, dvb))
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, ax, fn):
        out, lse = _ring_fwd(q, k, v, kv_mask, causal, ax, fn)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.ax, ctx.fn = causal, ax, fn
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, kv_mask, ctx.causal, out, lse, g,
                               ctx.ax, ctx.fn)
        return dq, dk, dv, None, None, None, None


def _ring(q, k, v, kv_mask, causal, ax, fn):
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.float32, device=k.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, kv_mask, causal, ax, fn)
    return _ring_fwd(q, k, v, kv_mask, causal, ax, fn)[0]


def ring_attention(q, k, v, kv_mask: Optional[torch.Tensor], causal: bool,
                   ax: Axis) -> torch.Tensor:
    """Flash attention with q, k, v ``(B, S_local, H, D)`` sharded on the
    sequence over the ring ``ax``; q pre-scaled by the caller; ``kv_mask``
    ``(B, S_local)``, nonzero = attend (None: every key).  Differentiable in
    q, k and v.  On CUDA every block runs the kernels (K1; delta, then K2 or
    K3a and K3b) and a local shard they do not take raises; on the CPU their
    plain versions."""
    if q.is_cuda and not _flash_eligible(q, k, None):
        raise ValueError(
            f"ring attention on CUDA needs local shards the flash kernels take "
            f"(128-row multiples of at least 256, head width 128); got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}")
    return _ring(q, k, v, kv_mask, causal, ax, _KERNELS)


def ring_attention_reference(q, k, v, kv_mask: Optional[torch.Tensor],
                             causal: bool, ax: Axis) -> torch.Tensor:
    """The plain version of :func:`ring_attention` on any device: the same
    ring, rotations and merges, every block through the plain versions of
    K1, delta, K2, K3a and K3b (f32 arithmetic)."""
    return _ring(q, k, v, kv_mask, causal, ax, _PLAIN)


# ---------------------------------------------------------------------------
# Tensor parallelism composed with the ring (TP∘SP)
# ---------------------------------------------------------------------------

class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.ax), None


class _PsumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce_(x.contiguous().clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, start, size, dim, ax):
        ctx.shape, ctx.start, ctx.size, ctx.dim, ctx.ax = w.shape, start, size, dim, ax
        return w.narrow(dim, start, size)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, ctx.size).copy_(g)
        return all_reduce_(full, ctx.ax), None, None, None, None


def replicated_in(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """A tp-replicated activation entering a head-sharded region.  Forward:
    identity.  Backward: SUM over ``ax``: each tp rank back-propagates only
    its heads' share of the cotangent."""
    return _ReplicatedIn.apply(x, ax)


def psum_out(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Merge the tp ranks' partial outputs (the row-parallel matmul's tail).
    Forward: SUM over ``ax``.  Backward: identity."""
    return _PsumOut.apply(x, ax)


def tp_slice(w: torch.Tensor, start: int, size: int, dim: int, ax: Axis
             ) -> torch.Tensor:
    """This tp rank's slice of a replicated parameter.  Forward: ``narrow``.
    Backward: the slice's cotangent scattered into zeros of the full shape,
    SUM over ``ax``: every tp rank holds the whole gradient, as for the
    parameters used replicated, so the (dp, sp) all-reduce needs no tp
    special case."""
    return _TpSlice.apply(w, start, size, dim, ax)
