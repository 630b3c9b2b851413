"""On-device adaptive sampling (``pianobart_tpu/ops/sampling.py``).

Per-field temperature + nucleus (top-p) sampling with the reference policy

    t = [1.2, 1.2, 5, 1, 2, 5, 5, 1.2]
    p = [1,   1,   1, .9, .9, 1, 1, .9]

With ``p = 1`` the cumulative sum never strictly exceeds p (the +1e-5
renormalisation slack keeps it below 1), so p=1 fields decode greedily.
Random draws come from an explicit ``torch.Generator`` on the logits'
device; they differ from ``jax.random``'s, so tests compare distributions.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.nn import functional as F

from ..models.config import PianoBartConfig
from ..models.heads import split_fields

DEFAULT_TEMPERATURE: Tuple[float, ...] = (1.2, 1.2, 5.0, 1.0, 2.0, 5.0, 5.0, 1.2)
DEFAULT_TOP_P: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.9, 0.9, 1.0, 1.0, 0.9)


def _nucleus_core(generator: torch.Generator, logits: torch.Tensor,
                  top_p: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """Nucleus sampling over the last axis of (..., V) f32 logits;
    ``top_p``/``temperature`` broadcast against the leading axes."""
    probs = torch.softmax(logits / temperature, dim=-1)
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-5)
    # stable, like jnp.argsort: equal probabilities keep index order
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    exceeded = sorted_probs.cumsum(dim=-1) > top_p
    # last kept rank = first exceeding position + 1; if none exceeded keep top-1
    first_exceed = exceeded.int().argmax(dim=-1, keepdim=True)
    last_index = torch.where(exceeded.any(dim=-1, keepdim=True),
                             first_exceed + 1, torch.ones_like(first_exceed))
    ranks = torch.arange(logits.shape[-1], device=logits.device)
    keep = ranks < last_index
    masked = torch.where(keep, sorted_probs, torch.zeros_like(sorted_probs))
    # categorical over the renormalised candidate set (Gumbel-max on logs)
    logp = torch.log(masked.clamp_min(1e-38)) + torch.where(
        keep, 0.0, -1e9)
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    choice = (logp - torch.log(-torch.log(u))).argmax(dim=-1, keepdim=True)
    return order.gather(-1, choice)[..., 0]


def sample_octuple(
    generator: torch.Generator,
    fused_logits: torch.Tensor,                # (B, total_vocab), one position
    cfg: PianoBartConfig,
    temperature: Sequence[float] = DEFAULT_TEMPERATURE,
    top_p: Sequence[float] = DEFAULT_TOP_P,
) -> torch.Tensor:
    """Sample all 8 fields of one octuple in ONE padded (B, 8, Vmax) nucleus
    pass; returns (B, 8) int32."""
    Vmax = max(cfg.field_sizes)
    padded = torch.stack(
        [F.pad(f.float(), (0, Vmax - f.shape[-1]), value=float("-inf"))
         for f in split_fields(fused_logits, cfg)], dim=1)  # (B, 8, Vmax)
    dev = fused_logits.device
    t = torch.tensor(temperature, dtype=torch.float32, device=dev)[None, :, None]
    p = torch.tensor(top_p, dtype=torch.float32, device=dev)[None, :, None]
    return _nucleus_core(generator, padded, p, t).to(torch.int32)


def greedy_octuple(fused_logits: torch.Tensor, cfg: PianoBartConfig) -> torch.Tensor:
    """Per-field argmax."""
    return torch.stack([f.argmax(dim=-1) for f in split_fields(fused_logits, cfg)],
                       dim=-1).to(torch.int32)
