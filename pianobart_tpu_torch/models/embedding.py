"""Octuple input embeddings (``pianobart_tpu/models/embedding.py``).

The 8 per-field tables are one ``(1280, emb_size)`` table indexed by
``ids + field_offset``: one gather, then the √emb_size scale and the
``fusion`` projection to d_model.  The gather's gradient is PyTorch's own
``index`` backward (the reference's one-hot backward is an XLA product, not
a Pallas kernel).

:class:`LabelEmbedding` is the velocity finetune's decoder input: label ids
through a ``(vocab, 64)`` table, scaled by √64, projected to d_model.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .bart import Dense
from .config import PianoBartConfig


class OctupleEmbedding(nn.Module):
    """ids (B, S, 8) -> fused embeddings (B, S, d_model)."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # the table stays in the param dtype; rows are cast after the gather
        self.table = nn.Parameter(torch.empty(
            cfg.total_vocab, cfg.emb_size, dtype=cfg.param_dtype, device=device))
        self.fusion = Dense(cfg.n_fields * cfg.emb_size, cfg.d_model, cfg, device)
        self.register_buffer(
            "offsets", torch.tensor(cfg.field_offsets, device=device),
            persistent=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.table[ids + self.offsets]                   # (B, S, 8, E)
        emb = emb.to(cfg.dtype) * math.sqrt(cfg.emb_size)
        emb = emb.reshape(*ids.shape[:-1], cfg.n_fields * cfg.emb_size)
        return self.fusion(emb)


class LabelEmbedding(nn.Module):
    """label ids (B, S) -> (B, S, d_model): the reference's swapped decoder
    embedding (``PianoBart.change_decoder_embedding``)."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        if cfg.decoder_label_vocab is None:
            raise ValueError("LabelEmbedding needs cfg.decoder_label_vocab")
        self.cfg = cfg
        self.table = nn.Parameter(torch.empty(
            cfg.decoder_label_vocab, cfg.decoder_label_dim,
            dtype=cfg.param_dtype, device=device))
        self.proj = Dense(cfg.decoder_label_dim, cfg.d_model, cfg, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        emb = self.table[ids].to(cfg.dtype) * math.sqrt(cfg.decoder_label_dim)
        return self.proj(emb)
