"""The generation finetune and the no-pretrain ablation, the counterpart of
``pianobart_tpu/train/generation.py``.

* :func:`generation_step`: seq2seq finetune on (intro, continuation)
  pairs.  ``decoder_mode="intro"`` feeds the decoder the intro itself, as
  the reference's ``finetune_generation.py:155`` does; ``"shifted"`` feeds
  ``<SOS>`` + the continuation.  Per-field CE with vocab-size weighting and
  :data:`~.objective.GENERATION_FIELD_WEIGHTS`.
* :func:`ablation_step`: the second half of each sequence is padded out on
  the encoder side and the decoder learns to reconstruct it
  (``Ablation.py:105-257``), with the loss span of :func:`_ablation_prepare`.

Steps run as :func:`~.finetune.run_step` runs them (train: dropout from the
caller's generator, backward, AdamW; eval: nothing changes).  FAD is
computed on the host by the runner's eval hook (:mod:`..utils.fad`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import vocab as V
from ..ops.sampling import greedy_octuple
from .finetune import Metrics, run_step
from .objective import (GENERATION_FIELD_WEIGHTS, masked_field_accuracy,
                        masked_field_ce, shift_right)
from .state import TrainState

__all__ = ["generation_step", "ablation_step"]

_BAR_PAD = V.PAD[0]


def _bar_mask(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] != _BAR_PAD).float()


def generation_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    decoder_mode: str = "intro", train: bool = True,
                    weight: Optional[torch.Tensor] = None
                    ) -> Tuple[TrainState, Metrics]:
    """Intro ``x`` and continuation ``y``, both ``(B, S, 8)``.  Metrics
    ``loss, field_loss, field_acc, outputs`` (greedy octuples) and
    ``attn_dec`` (and ``grad_norm`` when training)."""
    model, cfg = state.model, state.model.cfg
    if decoder_mode not in ("intro", "shifted"):
        raise ValueError(f"unknown decoder_mode {decoder_mode!r}")
    attn_enc = _bar_mask(x)
    dec_ids = x if decoder_mode == "intro" else shift_right(y, V.SOS)
    attn_dec = _bar_mask(dec_ids)
    loss_mask = attn_dec if weight is None else attn_dec * weight[:, None]

    def loss_fn(gen):
        fused = model(x, dec_ids, attn_enc, attn_dec, generator=gen)
        loss, per_field = masked_field_ce(fused, y, loss_mask, cfg,
                                          GENERATION_FIELD_WEIGHTS)
        return loss, (fused, per_field)

    loss, (fused, per_field), norm = run_step(state, loss_fn, train, generator)
    metrics = {"loss": loss, "field_loss": per_field,
               "field_acc": masked_field_accuracy(fused, y, loss_mask, cfg),
               "outputs": greedy_octuple(fused, cfg), "attn_dec": attn_dec}
    if norm is not None:
        metrics["grad_norm"] = norm
    return state, metrics


def _ablation_prepare(batch: torch.Tensor):
    """Encoder ids with every row from ``length // 2`` on set to ``<PAD>``,
    the decoder's ``<SOS>``-shifted batch, the batch as the label, and the
    loss span of the reference's ``Ablation.py:137`` exactly,
    ``length//2 + 1 <= pos <= length``: the first padded-out row is left
    out and the first pad row counted (its 1-indexing, kept on purpose)."""
    S = batch.shape[1]
    dec_ids = shift_right(batch, V.SOS)
    length = (batch[..., 0] != _BAR_PAD).sum(dim=1)              # (B,)
    half = length // 2
    pos = torch.arange(S, device=batch.device)[None, :]
    pad = torch.tensor(V.PAD, dtype=batch.dtype, device=batch.device)
    enc_ids = torch.where((pos >= half[:, None])[..., None], pad, batch)
    loss_mask = ((pos >= (half + 1)[:, None])
                 & (pos <= length[:, None])).float()
    return enc_ids, dec_ids, batch, loss_mask


def ablation_step(state: TrainState, batch: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  train: bool = True, weight: Optional[torch.Tensor] = None
                  ) -> Tuple[TrainState, Metrics]:
    """Full sequences ``batch (B, S, 8)``.  Metrics ``loss, field_loss,
    field_acc, outputs, loss_mask`` (and ``grad_norm`` when training)."""
    model, cfg = state.model, state.model.cfg
    enc_ids, dec_ids, label, loss_mask = _ablation_prepare(batch)
    if weight is not None:
        loss_mask = loss_mask * weight[:, None]
    attn_enc, attn_dec = _bar_mask(enc_ids), _bar_mask(dec_ids)

    def loss_fn(gen):
        fused = model(enc_ids, dec_ids, attn_enc, attn_dec, generator=gen)
        loss, per_field = masked_field_ce(fused, label, loss_mask, cfg,
                                          GENERATION_FIELD_WEIGHTS)
        return loss, (fused, per_field)

    loss, (fused, per_field), norm = run_step(state, loss_fn, train, generator)
    metrics = {"loss": loss, "field_loss": per_field,
               "field_acc": masked_field_accuracy(fused, batch, loss_mask, cfg),
               "outputs": greedy_octuple(fused, cfg), "loss_mask": loss_mask}
    if norm is not None:
        metrics["grad_norm"] = norm
    return state, metrics
