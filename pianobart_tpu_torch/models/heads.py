"""Output heads (``pianobart_tpu/models/heads.py``).

* :class:`OctupleLMHead`: the 8 per-field output layers fused into one
  ``(d_model, 1280)`` Linear; :func:`split_fields` slices its logits.
* :class:`AttentionPooling` and :class:`SequenceClassifierHead`: structured
  self-attention pooling (r = 4 views, da = 128) then a two-layer MLP.
* :class:`TokenClassifierHead`: the per-position MLP.
* :class:`Excitation`: the reference's squeeze-and-excitation gate, which
  no model uses.

Each module keeps the flax names (``attention.ws1``, ``dense1``, ...).  The
pooling's and the gate's layers compute in the promoted type of their input
and parameters, as a flax ``Dense`` without a ``dtype`` does; the MLPs in
``cfg.dtype``.  Dropout applies in training mode, from the ``generator``
passed down the forward.  Over a sequence-parallel mesh the sequence head
gathers the shards; the token head runs on the shard as it is.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.dropout import dropout
from ..parallel.mesh import axis, gather_shards
from .bart import Dense
from .config import PianoBartConfig

HEAD_DROPOUT = 0.1


def split_fields(logits: torch.Tensor, cfg: PianoBartConfig) -> List[torch.Tensor]:
    """Slice fused (..., 1280) logits into 8 per-field tensors."""
    return list(torch.split(logits, list(cfg.field_sizes), dim=-1))


def _promoted_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


class OctupleLMHead(nn.Module):
    """The 8 per-field output layers as one ``(d_model, 1280)`` Linear
    (under tp its weight may be this rank's vocab rows, gathered where the
    ``Dense`` uses it)."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.proj = Dense(cfg.d_model, cfg.total_vocab, cfg, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.proj(hidden)  # fused (B, S, total_vocab)


class AttentionPooling(nn.Module):
    """(B, S, D) -> (B, r, D): a softmax over the sequence axis (in f32) of
    ``ws2(tanh(ws1(h)))``.  It takes no pad mask: the reference pools over
    the pad positions too."""

    def __init__(self, d_model: int, da: int = 128, r: int = 4,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.ws1 = nn.Linear(d_model, da, bias=False, dtype=param_dtype, device=device)
        self.ws2 = nn.Linear(da, r, bias=False, dtype=param_dtype, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        scores = _promoted_linear(torch.tanh(_promoted_linear(h, self.ws1)), self.ws2)
        attn = torch.softmax(scores.float(), dim=1).to(h.dtype)
        return torch.einsum("bsr,bsd->brd", attn, h)


class SequenceClassifierHead(nn.Module):
    """Pooling, flatten, dropout 0.1, ``dense1`` (256) with ReLU, ``dense2``.

    With ``cfg.ring_axis`` the hidden state is this rank's sequence shard:
    the shards are gathered first (:func:`~..parallel.mesh.gather_shards`,
    whose backward sums the ranks' cotangents), so the pooling's softmax
    spans the whole sequence, pads included, and every rank of the ring
    computes the dense head on the whole rows."""

    def __init__(self, cfg: PianoBartConfig, class_num: int, da: int = 128,
                 r: int = 4, device=None):
        super().__init__()
        self.ring_axis = cfg.ring_axis
        self.attention = AttentionPooling(cfg.d_model, da, r, cfg.param_dtype, device)
        self.dense1 = Dense(r * cfg.d_model, 256, cfg, device)
        self.dense2 = Dense(256, class_num, cfg, device)

    def forward(self, hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.ring_axis is not None:
            hidden = gather_shards(hidden, axis(self.ring_axis))
        pooled = self.attention(hidden)
        x = dropout(pooled.reshape(pooled.shape[0], -1), HEAD_DROPOUT, generator,
                    not self.training)
        return self.dense2(torch.relu(self.dense1(x)))


class TokenClassifierHead(nn.Module):
    """Per position: dropout 0.1, ``dense1`` (256) with ReLU, ``dense2``."""

    def __init__(self, cfg: PianoBartConfig, class_num: int, device=None):
        super().__init__()
        self.dense1 = Dense(cfg.d_model, 256, cfg, device)
        self.dense2 = Dense(256, class_num, cfg, device)

    def forward(self, hidden: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(hidden, HEAD_DROPOUT, generator, not self.training)
        return self.dense2(torch.relu(self.dense1(x)))


class Excitation(nn.Module):
    """``x * sigmoid(fc2(relu(fc1(x))))`` over the last axis (reference
    ``model.py:220-232``)."""

    def __init__(self, channels: int, reduction: int = 16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, dtype=param_dtype,
                             device=device)
        self.fc2 = nn.Linear(channels // reduction, channels, dtype=param_dtype,
                             device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(_promoted_linear(torch.relu(_promoted_linear(x, self.fc1)),
                                           self.fc2))
        return x * y
