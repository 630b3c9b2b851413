"""Attention compute path, the counterpart of ``pianobart_tpu/ops/attention.py``.

One entry point for every attention module (encoder self, decoder causal
self, cross), layout ``(B, S, H, Dh)``:

* **flash** — :func:`~pianobart_tpu_torch.ops.flash.flash_attention` where
  the shape is one the kernels take (see :func:`_flash_eligible`) and no
  attention dropout applies.  On CUDA tensors that is the hand-written
  Hopper forward (K1) and, under autograd, backward (K2); on CPU tensors the
  wrappers run the plain versions, so the CPU tests go through the same
  dispatch.
* **plain** — einsum + softmax with an additive -1e9 bias (decode steps
  with Sq=1, odd shapes, attention dropout).
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash import flash_attention, head_dims

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


def _plain_logits(q, k, kv_mask, causal, bias):
    """f32 scores plus masks, as the reference's
    ``einsum(..., preferred_element_type=f32)``: the operands are widened to
    f32 first, so bf16 products are exact and summed in f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    b = _build_bias(kv_mask, causal, q.shape[1], k.shape[1], q.device)
    if b is not None:
        logits = logits + b
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _plain_attention(q, k, v, kv_mask, causal, bias, dropout_rate=0.0,
                     deterministic=True, generator=None):
    # q is pre-scaled by the caller
    probs = torch.softmax(_plain_logits(q, k, kv_mask, causal, bias), dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        # Bernoulli keep mask on the probabilities, as _xla_attention does
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=generator) < 1.0 - dropout_rate
        probs = probs * keep / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _flash_eligible(q, k, bias) -> bool:
    # what the kernels take: 128-row multiples of at least 256 (the
    # reference's tiling rule) and the head widths they have in q's type (the
    # reference's any multiple of 128; past MAX_HEAD_DIM, 4096 in bf16 and
    # 2048 in f32, not ported yet, and such a width takes the plain path)
    return (bias is None
            and q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
            and q.shape[1] >= 256 and k.shape[1] >= 256
            and q.shape[3] in head_dims(q.dtype))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,   # (B, Skv), 1 = attend
    causal: bool = False,
    bias: Optional[torch.Tensor] = None,      # extra additive (B,H,Sq,Skv)
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Scaled dot-product attention over ``(B, S, H, Dh)`` tensors."""
    # deterministic (eval) passes never apply dropout, so a nonzero rate must
    # not knock them off the flash path (the reference's round-3 rule)
    if (use_flash and (dropout_rate == 0.0 or deterministic)
            and _flash_eligible(q, k, bias)):
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal)
    return _plain_attention(q, k, v, kv_mask, causal, bias, dropout_rate,
                            deterministic, generator)
