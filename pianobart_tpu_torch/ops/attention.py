"""Attention compute path, the counterpart of ``pianobart_tpu/ops/attention.py``.

One entry point for every attention module (encoder self, decoder causal
self, cross), layout ``(B, S, H, Dh)``:

* **flash** — :func:`~pianobart_tpu_torch.ops.flash.flash_attention` where
  the shape is one the kernel takes (see :func:`_flash_eligible`).  On CUDA
  tensors that is the hand-written Hopper kernel; on CPU tensors its wrapper
  runs the plain version, so the CPU tests go through the same dispatch.
* **plain** — einsum + softmax with an additive -1e9 bias (decode steps
  with Sq=1, odd shapes).

Only the deterministic (eval) forward exists in this package so far:
attention dropout comes with the training path.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash import HEAD_DIM, flash_attention

__all__ = ["dot_product_attention"]

NEG_INF = -1e9


def _build_bias(kv_mask, causal, Sq, Skv, device):
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None, :] != 0, 0.0, NEG_INF)
    if causal:
        tri = torch.ones((Sq, Skv), dtype=torch.bool, device=device).tril(Skv - Sq)
        cb = torch.where(tri, 0.0, NEG_INF)[None, None]
        bias = cb if bias is None else bias + cb
    return bias


def _plain_attention(q, k, v, kv_mask, causal, bias):
    # q is pre-scaled by the caller.  The scores are taken in f32 as in the
    # reference (preferred_element_type=f32); for bf16 inputs the product
    # itself is rounded to bf16 first, a difference only bf16 runs see.
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    b = _build_bias(kv_mask, causal, q.shape[1], k.shape[1], q.device)
    if b is not None:
        logits = logits + b
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_eligible(q, k, bias) -> bool:
    # what the kernel takes: 128-row multiples of at least 256 (the
    # reference's tiling rule) and the one head width the kernel has
    return (bias is None
            and q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
            and q.shape[1] >= 256 and k.shape[1] >= 256
            and q.shape[3] == HEAD_DIM)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv), 1 = attend
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,      # extra additive (B,H,Sq,Skv)
    use_flash: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention over ``(B, S, H, Dh)`` tensors."""
    if use_flash and _flash_eligible(q, k, bias):
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal)
    return _plain_attention(q, k, v, kv_mask, causal, bias)
