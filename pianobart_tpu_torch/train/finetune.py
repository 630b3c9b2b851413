"""Understanding finetunes, the counterpart of ``pianobart_tpu/train/finetune.py``:
composer and emotion (sequence tasks), melody and velocity (token tasks).

* sequence tasks: :class:`~..models.SequenceClassification` (its decoder is
  fed the encoder's ids and mask), mean CE, sequence accuracy;
* velocity: the decoder reads the right-shifted *label* stream through the
  label embedding, pad id ``decoder_label_vocab - 1``, with the encoder
  mask shifted alongside (reference ``finetune.py:193-198``);
* melody: the decoder reads a copy of the encoder ids;
* optional L2 regularization ``reg_weight * sum_p ||p||_2``: the reference
  sums the *unsquared* L2 norms of every parameter, here in f32;
* accuracy masked by the attention mask times the sample weight.

A train step updates ``state.model`` in place through
:func:`~.state.gradient_step` (clip, AdamW, accumulation, EMA), with
dropout drawn from the caller's ``generator`` (the runner seeds one from
(seed, step)).  An eval step runs without dropout and gradients and leaves
the parameters, the optimizer and the model's train/eval mode as it found
them.  Metrics are device tensors: nothing here waits on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import vocab as V
from ..parallel.mesh import gather_param
from .objective import sequence_ce, token_ce
from .state import TrainState, gradient_step

__all__ = ["finetune_seq_step", "finetune_token_step", "run_step"]

_BAR_PAD = V.PAD[0]
Metrics = Dict[str, Any]


def _l2_penalty(model: torch.nn.Module) -> torch.Tensor:
    """The sum of every parameter's 2-norm; a tp shard's over the whole
    parameter, gathered over the active mesh's tp axis (``gather_param``)."""
    return sum(torch.linalg.vector_norm(gather_param(p, torch.float32).reshape(-1))
               for p in model.parameters())


def run_step(state: TrainState, loss_fn: Callable, train: bool,
             generator: Optional[torch.Generator]):
    """``loss_fn(generator) -> (loss, aux)`` as a train step
    (:func:`~.state.gradient_step`: forward with dropout, backward, the
    update) or an eval step (no dropout, no gradients, the caller's
    train/eval mode kept).  Returns ``(loss, aux, grad_norm)``,
    ``grad_norm`` ``None`` for an eval step."""
    if train:
        return gradient_step(state, loss_fn, generator)
    model = state.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            loss, aux = loss_fn(None)
    finally:
        model.train(was_training)
    return loss, aux, None


def _bar_mask(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] != _BAR_PAD).float()


def finetune_seq_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      reg_weight: Optional[float] = None, train: bool = True,
                      weight: Optional[torch.Tensor] = None
                      ) -> Tuple[TrainState, Metrics]:
    """Composer / emotion: ``x (B, S, 8)``, ``y (B,)``; ``weight (B,)``
    zeroes the padded samples of a tail batch.  Metrics ``loss, acc_num,
    acc_den, pred`` (and ``grad_norm`` when training)."""
    model = state.model
    attn = _bar_mask(x)

    def loss_fn(gen):
        logits = model(x, attn, generator=gen)
        loss = sequence_ce(logits, y, weight)
        if reg_weight is not None:
            loss = loss + reg_weight * _l2_penalty(model)
        return loss, (logits,)

    loss, (logits,), norm = run_step(state, loss_fn, train, generator)
    pred = logits.argmax(dim=-1)
    w = torch.ones(y.shape[0], device=y.device) if weight is None else weight
    metrics = {"loss": loss, "acc_num": ((pred == y) * w).sum(),
               "acc_den": w.sum(), "pred": pred}
    if norm is not None:
        metrics["grad_norm"] = norm
    return state, metrics


def _token_decoder_inputs(x, y, attn, cfg, velocity: bool):
    if velocity:
        # labels shifted right behind the pad id (the vocabulary's last id),
        # the mask shifted alongside
        pad = torch.full_like(y[:, :1], cfg.decoder_label_vocab - 1)
        return (torch.cat([pad, y[:, :-1]], dim=1),
                torch.cat([attn[:, :1], attn[:, :-1]], dim=1))
    return x, attn  # melody: the decoder reads the encoder ids


def finetune_token_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        velocity: bool = False,
                        reg_weight: Optional[float] = None, train: bool = True,
                        weight: Optional[torch.Tensor] = None
                        ) -> Tuple[TrainState, Metrics]:
    """Melody / velocity: ``x (B, S, 8)``, ``y (B, S)``.  The loss and the
    accuracy are masked by the encoder's attention mask times ``weight``."""
    model = state.model
    attn = _bar_mask(x)
    dec_ids, dec_attn = _token_decoder_inputs(x, y, attn, model.cfg, velocity)
    loss_mask = attn if weight is None else attn * weight[:, None]

    def loss_fn(gen):
        logits = model(x, dec_ids, attn, dec_attn, generator=gen)
        loss = token_ce(logits, y, loss_mask)
        if reg_weight is not None:
            loss = loss + reg_weight * _l2_penalty(model)
        return loss, (logits,)

    loss, (logits,), norm = run_step(state, loss_fn, train, generator)
    pred = logits.argmax(dim=-1)
    metrics = {"loss": loss, "acc_num": ((pred == y) * loss_mask).sum(),
               "acc_den": loss_mask.sum(), "pred": pred}
    if norm is not None:
        metrics["grad_norm"] = norm
    return state, metrics
