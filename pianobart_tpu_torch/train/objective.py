"""Loss and metric primitives of every trainer, the counterpart of
``pianobart_tpu/train/objective.py``.

* per-field masked cross-entropy with vocab-size weighting
  (``total = sum_i n_i * CE_i / sum_i n_i``), optionally with extra
  per-field weights (the generation finetune's
  :data:`GENERATION_FIELD_WEIGHTS`);
* per-field masked accuracy and its vocab-size-weighted mean;
* teacher-forcing ``shift_right``;
* the finetunes' pad-masked token CE and (sample-weighted) sequence CE.

Softmax in f32.  Empty masks are guarded: a field with no masked position
contributes 0 instead of dividing by zero.  Everything stays on the device:
no ``.item()``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.nn import functional as F

from ..models.config import PianoBartConfig
from ..models.heads import split_fields

__all__ = ["GENERATION_FIELD_WEIGHTS", "masked_field_ce", "masked_field_accuracy",
           "weighted_average_accuracy", "shift_right", "nll", "token_ce",
           "sequence_ce"]

#: The generation finetune's per-field loss weights: Program, TimeSig and
#: Tempo 0.3, Pitch 1.5 (reference ``finetune_generation.py:241-246``).
GENERATION_FIELD_WEIGHTS: Tuple[float, ...] = (1, 1, 0.3, 1.5, 1, 1, 0.3, 0.3)


def _field_mask(loss_mask: torch.Tensor, cfg: PianoBartConfig) -> torch.Tensor:
    if loss_mask.dim() == 2:
        return loss_mask[..., None].float().expand(*loss_mask.shape, cfg.n_fields)
    return loss_mask.float()


def _masked_mean(values: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    denom = m.sum()
    return torch.where(denom > 0, (values * m).sum() / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def masked_field_ce(
    fused_logits: torch.Tensor,          # (B, S, total_vocab)
    targets: torch.Tensor,               # (B, S, 8) int
    loss_mask: torch.Tensor,             # (B, S, 8) or (B, S)
    cfg: PianoBartConfig,
    field_weights: Optional[Sequence[float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weighted total loss, per-field losses (8,)); each field's
    mean is multiplied by its ``field_weights`` entry, when given, before
    the vocab-size weighting."""
    mask = _field_mask(loss_mask, cfg)
    fields = split_fields(fused_logits.float(), cfg)
    losses = []
    for i in range(cfg.n_fields):
        logp = F.log_softmax(fields[i], dim=-1)
        nll = -torch.gather(logp, -1, targets[..., i:i + 1].long())[..., 0]
        li = _masked_mean(nll, mask[..., i])
        losses.append(li if field_weights is None else li * field_weights[i])
    losses = torch.stack(losses)
    n_tok = torch.tensor(cfg.field_sizes, dtype=torch.float32, device=losses.device)
    return (losses * n_tok).sum() / n_tok.sum(), losses


def masked_field_accuracy(
    fused_logits: torch.Tensor,
    targets: torch.Tensor,
    loss_mask: torch.Tensor,
    cfg: PianoBartConfig,
) -> torch.Tensor:
    """Per-field accuracy on masked positions only; returns (8,)."""
    mask = _field_mask(loss_mask, cfg)
    fields = split_fields(fused_logits, cfg)
    return torch.stack([
        _masked_mean((fields[i].argmax(dim=-1) == targets[..., i]).float(),
                     mask[..., i])
        for i in range(cfg.n_fields)])


def weighted_average_accuracy(accs: torch.Tensor, cfg: PianoBartConfig) -> torch.Tensor:
    """Vocab-size-weighted mean accuracy (the model-selection metric)."""
    n_tok = torch.tensor(cfg.field_sizes, dtype=torch.float32, device=accs.device)
    return (accs * n_tok).sum() / n_tok.sum()


def shift_right(ids: torch.Tensor, sos_row: Sequence[int]) -> torch.Tensor:
    """Teacher-forcing decoder input: ``<SOS>`` + ids[:, :-1]."""
    sos = torch.tensor(sos_row, dtype=ids.dtype, device=ids.device)
    sos = sos.expand(ids.shape[0], 1, *ids.shape[2:])
    return torch.cat([sos, ids[:, :-1]], dim=1)


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood of ``targets (...)`` under
    ``logits (..., C)``, the softmax in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def token_ce(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Pad-masked token-level CE: ``logits (B, S, C)``, ``targets (B, S)``,
    ``mask (B, S)`` (reference ``finetune.py:125-130``)."""
    return (nll(logits, targets) * mask).sum() / mask.sum().clamp(min=1.0)


def sequence_ce(logits: torch.Tensor, targets: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean sequence-level CE (reference ``finetune.py:131-132``);
    ``weight (B,)`` zeroes the padded samples of a tail batch, so that every
    sample of a split counts once."""
    per_sample = nll(logits, targets)
    if weight is None:
        return per_sample.mean()
    return (per_sample * weight).sum() / weight.sum().clamp(min=1.0)
