"""Output heads (``pianobart_tpu/models/heads.py``): the fused LM head."""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from .bart import Dense
from .config import PianoBartConfig


def split_fields(logits: torch.Tensor, cfg: PianoBartConfig) -> List[torch.Tensor]:
    """Slice fused (..., 1280) logits into 8 per-field tensors."""
    return list(torch.split(logits, list(cfg.field_sizes), dim=-1))


class OctupleLMHead(nn.Module):
    """The 8 per-field output layers as one ``(d_model, 1280)`` Linear."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.proj = Dense(cfg.d_model, cfg.total_vocab, cfg, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.proj(hidden)  # fused (B, S, total_vocab)
