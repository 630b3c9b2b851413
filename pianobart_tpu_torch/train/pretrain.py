"""Pretraining: BART denoising over Octuple windows, the counterpart of
``pianobart_tpu/train/pretrain.py``.

One step: corrupt the clean batch on the device
(:func:`~pianobart_tpu_torch.ops.noise.corrupt_batch`), encode the corrupted
sequence, decode the right-shifted clean sequence (``<SOS>`` first), take the
vocab-size-weighted masked cross-entropy against the clean sequence, then
clip at 3.0 and take an AdamW step (lr 2e-5, wd 0.01), or under gradient
accumulation add to the window's gradients (``train/state.py``).

The step updates ``state.model`` in place (the role of JAX's
``donate_argnums``) and returns its metrics as device tensors: nothing in a
step calls ``.item()`` or otherwise waits on the device.  Corruption and
dropout draw from one ``torch.Generator`` on the batch's device, which the
caller seeds once; JAX's per-step ``fold_in`` becomes the generator's own
advance.  Kernel launches per step at flagship width: 24 attentions, each
K1 forward and, at S <= 1024, K2 backward (24 each); at ``max_len=2048``
the backward is K3a then K3b (24 each, K2 none), as the reference's
``_bwd_impl`` picks.  With ``fused_dropout_ln`` the 40 sublayer tails (2 per
encoder layer, 3 per decoder layer) add K4a and K4b (40 each).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from .. import vocab as V
from ..ops.noise import corrupt_batch
from .objective import (masked_field_accuracy, masked_field_ce, shift_right,
                        weighted_average_accuracy)
from .state import TrainState, gradient_step

__all__ = ["pretrain_step", "pretrain_eval_step", "pretrain_multi_step",
           "batch_iterator"]

_BAR_PAD = V.PAD[0]
Metrics = Dict[str, torch.Tensor]


def _forward_loss(model, batch, corrupted, loss_mask, generator=None):
    """Forward and loss; returns ``(total, (fused_logits, per_field))``.
    Dropout applies when ``model`` is in training mode."""
    decoder_ids = shift_right(batch, V.SOS)
    enc_mask = (corrupted[..., 0] != _BAR_PAD).float()
    dec_mask = (decoder_ids[..., 0] != _BAR_PAD).float()
    fused = model(corrupted, decoder_ids, enc_mask, dec_mask, generator=generator)
    total, per_field = masked_field_ce(fused, batch, loss_mask, model.cfg)
    return total, (fused, per_field)


def _update(state: TrainState, batch, corrupted, loss_mask, generator) -> Metrics:
    """Gradient step on an already corrupted batch through
    :func:`~pianobart_tpu_torch.train.state.gradient_step` (forward,
    backward, clip, AdamW at the schedule's rate, EMA; under accumulation
    only every ``accum_steps``-th call).  Split out so that a test can feed
    the same corruption to both packages."""
    cfg = state.model.cfg
    total, (fused, per_field), norm = gradient_step(
        state, lambda gen: _forward_loss(state.model, batch, corrupted,
                                         loss_mask, gen), generator)
    with torch.no_grad():
        accs = masked_field_accuracy(fused, batch, loss_mask, cfg)
        return {"loss": total, "field_loss": per_field, "field_acc": accs,
                "weighted_acc": weighted_average_accuracy(accs, cfg),
                "grad_norm": norm,
                "tokens": torch.tensor(batch.shape[0] * batch.shape[1],
                                       device=batch.device)}


def pretrain_step(state: TrainState, batch: torch.Tensor,
                  generator: torch.Generator, mask_percent: float = 0.15
                  ) -> Tuple[TrainState, Metrics]:
    """One train step on a clean ``(B, S, 8)`` batch: corrupt -> forward ->
    loss -> grads -> clip -> AdamW.  Returns the (same, updated) state and
    the metrics ``loss, field_loss, field_acc, weighted_acc, grad_norm,
    tokens``."""
    corrupted, loss_mask = corrupt_batch(batch, generator, mask_percent)
    return state, _update(state, batch, corrupted, loss_mask, generator)


def pretrain_eval_step(state: TrainState, batch: torch.Tensor,
                       generator: torch.Generator, sample_weight: torch.Tensor,
                       mask_percent: float = 0.15) -> Metrics:
    """Validation step (no update, no dropout); ``sample_weight (B,)``
    zeroes the padded samples of a tail batch."""
    model = state.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            corrupted, loss_mask = corrupt_batch(batch, generator, mask_percent)
            loss_mask = loss_mask * sample_weight.to(loss_mask)[:, None, None]
            total, (fused, per_field) = _forward_loss(model, batch, corrupted,
                                                      loss_mask)
            accs = masked_field_accuracy(fused, batch, loss_mask, model.cfg)
    finally:
        model.train(was_training)
    return {"loss": total, "field_loss": per_field, "field_acc": accs,
            "weighted_acc": weighted_average_accuracy(accs, model.cfg)}


def pretrain_multi_step(state: TrainState, batch: torch.Tensor,
                        generator: torch.Generator, mask_percent: float = 0.15,
                        n_steps: int = 10):
    """``n_steps`` train steps with one host sync, at the end.

    ``batch`` is ``(B, S, 8)`` (reused every step, as a benchmark does) or
    ``(n_steps, B, S, 8)`` (one batch per step).  Returns ``(state, (losses
    (K,), field_accs (K, 8), grad_norms (K,)))`` as CPU tensors."""
    if batch.dim() == 3:
        batch = batch.expand(n_steps, *batch.shape)
    if batch.shape[0] != n_steps:
        raise ValueError(f"batch holds {batch.shape[0]} steps, n_steps={n_steps}")
    losses, accs, norms = [], [], []
    for b in batch:
        _, m = pretrain_step(state, b, generator, mask_percent)
        losses.append(m["loss"])
        accs.append(m["field_acc"])
        norms.append(m["grad_norm"])
    out = torch.cat([torch.stack(losses)[:, None], torch.stack(accs),
                     torch.stack(norms)[:, None]], dim=1).cpu()
    return state, (out[:, 0], out[:, 1:-1], out[:, -1])


def batch_iterator(data: np.ndarray, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True, drop_last: bool = True,
                   ) -> Iterable[Tuple[np.ndarray, np.ndarray]]:
    """Yields ``(batch, sample_weight)``; pads the trailing batch, when kept,
    with copies of its first sample at weight 0."""
    n = len(data)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = (n // batch_size) * batch_size
    for i in range(0, stop, batch_size):
        yield data[idx[i:i + batch_size]], np.ones(batch_size, dtype=np.float32)
    if not drop_last and stop < n:
        sel = idx[stop:]
        pad = batch_size - len(sel)
        batch = np.concatenate([data[sel], np.tile(data[sel[:1]], (pad, 1, 1))])
        weight = np.concatenate([np.ones(len(sel), np.float32),
                                 np.zeros(pad, np.float32)])
        yield batch, weight
