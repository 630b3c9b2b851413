"""Pretraining over a (dp, tp, sp) mesh, the counterpart of
``pianobart_tpu/train/pretrain_sp.py`` (and of the reference's dp-only
GSPMD step: one step serves every mesh).

* Corruption and the decoder's shift run on the GLOBAL batch on every rank,
  from the same generator (the runner seeds it from (seed, step)), so every
  rank holds the same corruption; each rank then takes its block: its dp
  rows and, with ``cfg.ring_axis``, its sp columns.
* The model runs on the block: ring attention over ``sp`` (``ops/ring.py``),
  the shard's positional offset, TP∘SP heads with ``cfg.ring_tp_axis``.
* Each rank's masked CE is a local (numerator, denominator) pair per field;
  the denominators are summed over (dp, sp) without gradient first, so the
  local losses add up to the dense objective exactly.
* After the backward, ONE SUM all-reduce of the flattened gradients over the
  (dp, sp) group (``TrainState.grad_sync``, before the clip; once per window
  under accumulation), then the clip and AdamW on every rank alike.  Not
  DDP: DDP averages per-rank means, which is not the global masked mean when
  the ranks' mask counts differ.
* Dropout: each rank draws from a generator seeded from (the step's seed,
  dp rank, sp rank), as the reference folds the coordinates in; tp ranks
  of one block draw alike, as their replicated activations must.

At dropout 0 the step equals the dense ``pretrain_step``.  Kernel launches
per rank and attention at sp > 1: K1 once per visible ring block (the
diagonal and the earlier shards under causality), then delta once and K2
(local shard <= 1024 rows) or K3a and K3b per visible block.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from .. import vocab as V
from ..models.config import PianoBartConfig
from ..models.heads import split_fields
from ..ops.noise import corrupt_batch
from ..parallel.mesh import Mesh, all_reduce_, all_reduce_grads_, shard_batch, use_mesh
from .objective import shift_right, weighted_average_accuracy
from .state import TrainState, gradient_step

__all__ = ["make_sp_pretrain_step", "make_sp_eval_step", "dropout_generator"]

_BAR_PAD = V.PAD[0]
Metrics = Dict[str, torch.Tensor]


def _check(cfg: PianoBartConfig, mesh: Mesh) -> None:
    if mesh.shape["sp"] > 1 and cfg.ring_axis != "sp":
        raise ValueError("an sp > 1 mesh needs cfg.ring_axis='sp'")
    if mesh.shape["tp"] > 1 and (cfg.ring_axis is None or cfg.ring_tp_axis != "tp"
                                 or cfg.ring_tp_size != mesh.shape["tp"]):
        raise ValueError(f"a tp > 1 mesh needs cfg.ring_axis='sp', "
                         f"ring_tp_axis='tp', ring_tp_size={mesh.shape['tp']}")


def _local_ce_sums(fused, targets, loss_mask, cfg):
    """Per-field (sum nll*m, sum m, sum hit*m) on the local block."""
    fields = split_fields(fused.float(), cfg)
    nums, dens, hits = [], [], []
    for i in range(cfg.n_fields):
        logp = F.log_softmax(fields[i], dim=-1)
        nll = -torch.gather(logp, -1, targets[..., i:i + 1].long())[..., 0]
        m = loss_mask[..., i].float()
        nums.append((nll * m).sum())
        dens.append(m.sum())
        hits.append(((fields[i].argmax(-1) == targets[..., i]).float() * m).sum())
    return torch.stack(nums), torch.stack(dens), torch.stack(hits)


def _per_field(nums, dens, hits):
    per_field = torch.where(dens > 0, nums / dens.clamp(min=1.0), torch.zeros_like(nums))
    accs = torch.where(dens > 0, hits / dens.clamp(min=1.0), torch.zeros_like(hits))
    return per_field, accs


def _blocks(mesh, batch, corrupted, loss_mask):
    """The decoder's inputs and both masks from the global batch, then this
    rank's block of each of (corrupted, decoder ids, targets, loss mask,
    encoder mask, decoder mask)."""
    dec_ids = shift_right(batch, V.SOS)
    enc_mask = (corrupted[..., 0] != _BAR_PAD).float()
    dec_mask = (dec_ids[..., 0] != _BAR_PAD).float()
    return [shard_batch(mesh, x) for x in (corrupted, dec_ids, batch, loss_mask,
                                           enc_mask, dec_mask)]


def dropout_generator(generator: torch.Generator, mesh: Mesh) -> torch.Generator:
    """This rank's dropout generator: seeded from the step generator's seed
    and the rank's (dp, sp) coordinates (no host sync: the seed is the one
    the runner set)."""
    seed = np.random.SeedSequence(
        [generator.initial_seed(), mesh.coords["dp"], mesh.coords["sp"]])
    return torch.Generator(device=generator.device).manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def make_sp_pretrain_step(cfg: PianoBartConfig, mesh: Mesh, mask_percent: float = 0.15):
    """The train step of ``mesh`` for a model built with ``cfg`` (with
    ``ring_axis='sp'`` when sp > 1, and ``ring_tp_axis='tp'`` when tp > 1):
    ``step(state, batch, generator) -> (state, metrics)`` with the dense
    step's metrics, on the global ``(B, S, 8)`` batch every rank holds.
    ``step.update(state, batch, corrupted, loss_mask, dropout_gen)`` takes
    an already corrupted batch (a test feeds both packages the same)."""
    _check(cfg, mesh)
    grad_ax = mesh.axis(("dp", "sp"))
    n_tok = torch.tensor(cfg.field_sizes, dtype=torch.float32)

    def sync(grads):
        all_reduce_grads_(grads, grad_ax)

    def update(state: TrainState, batch, corrupted, loss_mask, dropout_gen) -> Metrics:
        c, d, t, m, em, dm = _blocks(mesh, batch, corrupted, loss_mask)
        w = n_tok.to(batch.device)

        def loss_fn(gen):
            fused = state.model(c, d, em, dm, generator=gen)
            nums, dens, hits = _local_ce_sums(fused, t, m, cfg)
            with torch.no_grad():
                gdens = all_reduce_(dens.clone(), grad_ax)
            loss_local = (nums / gdens.clamp(min=1.0) * w).sum() / w.sum()
            return loss_local, (nums, dens, hits)

        state.grad_sync = sync
        with use_mesh(mesh):   # the backward recomputes under remat
            loss_local, (nums, dens, hits), norm = gradient_step(
                state, loss_fn, dropout_gen)
        with torch.no_grad():
            sums = all_reduce_(torch.cat([loss_local[None], nums, dens, hits]), grad_ax)
            n = cfg.n_fields
            per_field, accs = _per_field(sums[1:1 + n], sums[1 + n:1 + 2 * n],
                                         sums[1 + 2 * n:])
        return {"loss": sums[0], "field_loss": per_field, "field_acc": accs,
                "weighted_acc": weighted_average_accuracy(accs, cfg),
                "grad_norm": norm,
                "tokens": torch.tensor(batch.shape[0] * batch.shape[1],
                                       device=batch.device)}

    def step(state: TrainState, batch: torch.Tensor, generator: torch.Generator
             ) -> Tuple[TrainState, Metrics]:
        corrupted, loss_mask = corrupt_batch(batch, generator, mask_percent)
        return state, update(state, batch, corrupted, loss_mask,
                             dropout_generator(generator, mesh))

    step.update = update
    return step


def make_sp_eval_step(cfg: PianoBartConfig, mesh: Mesh, mask_percent: float = 0.15):
    """Validation twin of :func:`make_sp_pretrain_step` (no gradients, no
    update, no dropout): ``eval_step(state, batch, generator,
    sample_weight) -> metrics``; ``sample_weight (B,)`` zeroes the padded
    tail rows, as ``pretrain_eval_step``.  ``eval_step.evaluate(state,
    batch, corrupted, loss_mask)`` takes an already corrupted batch."""
    _check(cfg, mesh)
    grad_ax = mesh.axis(("dp", "sp"))
    n_tok = torch.tensor(cfg.field_sizes, dtype=torch.float32)

    def evaluate(state: TrainState, batch, corrupted, loss_mask) -> Metrics:
        model = state.model
        c, d, t, m, em, dm = _blocks(mesh, batch, corrupted, loss_mask)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad(), use_mesh(mesh):
                fused = model(c, d, em, dm)
                sums = all_reduce_(torch.cat(_local_ce_sums(fused, t, m, cfg)), grad_ax)
        finally:
            model.train(was_training)
        n = cfg.n_fields
        per_field, accs = _per_field(sums[:n], sums[n:2 * n], sums[2 * n:])
        w = n_tok.to(batch.device)
        return {"loss": (per_field * w).sum() / w.sum(), "field_loss": per_field,
                "field_acc": accs, "weighted_acc": weighted_average_accuracy(accs, cfg)}

    def eval_step(state: TrainState, batch: torch.Tensor, generator: torch.Generator,
                  sample_weight: torch.Tensor) -> Metrics:
        with torch.no_grad():
            corrupted, loss_mask = corrupt_batch(batch, generator, mask_percent)
            loss_mask = loss_mask * sample_weight.to(loss_mask)[:, None, None]
        return evaluate(state, batch, corrupted, loss_mask)

    eval_step.evaluate = evaluate
    return eval_step
