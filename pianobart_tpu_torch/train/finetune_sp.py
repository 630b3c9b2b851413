"""The finetunes, the generation finetune and the ablation over a (dp, tp, sp)
mesh: the mesh twins of ``train/finetune.py`` and ``train/generation.py``,
built as ``train/pretrain_sp.py`` is (the JAX package runs the same commands
under ``--mesh`` as GSPMD partitions of its dense steps).

* Every step takes the GLOBAL batch on every rank (the runner's
  ``put_batch``) and runs the preprocessing that crosses positions on it:
  velocity's label shift, the generation's decoder inputs, the ablation's
  split and loss span.  Each rank then takes its block (``shard_batch``); a
  shift done per shard would be wrong at every shard boundary.
* The model runs on the block: ring attention over ``sp``, TP∘SP heads over
  ``tp`` (``cfg.ring_axis``, ``cfg.ring_tp_axis``) with the parameters as
  ``shard_params`` placed them, the shard's positions; the sequence head
  gathers the shards (``models/heads.py``).
* Each loss is a local (numerator, denominator) pair over denominators
  summed over (dp, sp) without gradient first, so the local losses add up
  to the dense objective, also where a dp rank holds only the zero-weight
  rows of a padded tail batch (its denominator 0: no local mean is taken).
  The sequence loss and accuracy, which every sp rank of a dp block
  computes alike, count on sp rank 0 alone; the L2 term (``reg_weight``) on
  the first rank of the gradient group alone, so that the summing
  all-reduce takes it once.
* ONE SUM all-reduce of the gradients over (dp, sp) before the clip
  (``TrainState.grad_sync``); the clip, over the whole gradient, and AdamW
  on every rank, each on its slices of the tp-sharded parameters.
* Dropout: the trunk's from ``dropout_generator`` (the step's seed, the
  rank's dp and sp coordinates), the sequence head's from the step's seed
  and the dp coordinate, the same on every rank of a dp block.
* An eval step gathers its predictions (``pred``, ``outputs``) into the
  global batch in sample order on every rank (``gather_batch``); a train
  step's metrics carry none.

At dropout 0 each step equals its dense twin.  The steps keep their dense
twins' signatures and metrics, so ``SupervisedRunner`` runs either.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import vocab as V
from ..models.config import PianoBartConfig
from ..ops.sampling import greedy_octuple
from ..parallel.mesh import (Mesh, all_reduce_, all_reduce_grads_, gather_batch,
                             shard_batch, use_mesh)
from .finetune import (Metrics, _bar_mask, _l2_penalty, _token_decoder_inputs,
                       run_step)
from .generation import _ablation_prepare
from .objective import GENERATION_FIELD_WEIGHTS, nll, shift_right
from .pretrain_sp import _check, _local_ce_sums, _per_field, dropout_generator
from .state import TrainState

__all__ = ["make_sp_seq_step", "make_sp_token_step", "make_sp_generation_step",
           "make_sp_ablation_step"]


class _Mesh:
    """What every mesh step shares: the gradient group, the step under it
    (``run``), the losses over global denominators, the metric sums."""

    def __init__(self, cfg: PianoBartConfig, mesh: Mesh):
        _check(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.ax = mesh.axis(("dp", "sp"))

    def blocks(self, *xs):
        return [shard_batch(self.mesh, x) for x in xs]

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over (dp, sp), outside autograd."""
        with torch.no_grad():
            return all_reduce_(t.detach().clone(), self.ax)

    def mean(self, num, den, reg_weight, model):
        """This rank's share of ``sum num / sum den`` over the mesh, plus
        the L2 term on the gradient group's first rank."""
        loss = num / self.global_sum(den).clamp(min=1.0)
        if reg_weight is not None and self.ax.index == 0:
            loss = loss + reg_weight * _l2_penalty(model)
        return loss

    def run(self, state: TrainState, loss_fn: Callable, train: bool,
            generator: Optional[torch.Generator]):
        """:func:`~.finetune.run_step` on the mesh: a train step's gradients
        summed over (dp, sp) before the clip, its dropout from this rank's
        generator."""
        gen = None
        if train:
            if generator is None:
                raise ValueError("a mesh train step needs the step's torch.Generator")
            state.grad_sync = lambda grads: all_reduce_grads_(grads, self.ax)
            gen = dropout_generator(generator, self.mesh)
        with use_mesh(self.mesh):   # the backward recomputes under remat
            return run_step(state, loss_fn, train, gen)

    def metrics(self, loss, norm, **sums) -> Metrics:
        """The loss and each local sum, summed over (dp, sp) in one
        all-reduce."""
        got = self.global_sum(torch.cat([loss.reshape(1)] + [
            v.reshape(-1).float() for v in sums.values()]))
        out, at = {"loss": got[0]}, 1
        for k, v in sums.items():
            out[k] = got[at:at + v.numel()].reshape(v.shape)
            at += v.numel()
        if norm is not None:
            out["grad_norm"] = norm
        return out


def make_sp_seq_step(cfg: PianoBartConfig, mesh: Mesh,
                     reg_weight: Optional[float] = None):
    """Composer / emotion over ``mesh``: ``step(state, x, y, generator,
    train=True, weight=None) -> (state, metrics)`` as
    :func:`~.finetune.finetune_seq_step`, on the global ``x (B, S, 8)``,
    ``y (B,)`` and ``weight (B,)``."""
    m = _Mesh(cfg, mesh)
    owner = 1.0 if mesh.coords["sp"] == 0 else 0.0

    def step(state, x, y, generator=None, train=True, weight=None
             ) -> Tuple[TrainState, Metrics]:
        model = state.model
        w = torch.ones(y.shape[0], device=y.device) if weight is None else weight
        xs, ms = m.blocks(x, _bar_mask(x))
        ys, ws = mesh.rows(y), mesh.rows(w).float() * owner
        head_gen = (dropout_generator(generator, mesh, ("dp",))
                    if train and generator is not None else None)

        def loss_fn(gen):
            logits = model(xs, ms, generator=gen, head_generator=head_gen)
            loss = m.mean((nll(logits, ys) * ws).sum(), ws.sum(), reg_weight, model)
            return loss, (logits,)

        loss, (logits,), norm = m.run(state, loss_fn, train, generator)
        pred = logits.argmax(dim=-1)
        out = m.metrics(loss, norm, acc_num=((pred == ys) * ws).sum(), acc_den=ws.sum())
        if not train:
            out["pred"] = gather_batch(mesh, pred, seq=False)
        return state, out

    return step


def make_sp_token_step(cfg: PianoBartConfig, mesh: Mesh, velocity: bool = False,
                       reg_weight: Optional[float] = None):
    """Melody / velocity over ``mesh``: ``step(state, x, y, generator,
    train=True, weight=None)`` as :func:`~.finetune.finetune_token_step`,
    on the global ``x (B, S, 8)`` and ``y (B, S)``; velocity's labels are
    shifted on the global batch."""
    m = _Mesh(cfg, mesh)

    def step(state, x, y, generator=None, train=True, weight=None
             ) -> Tuple[TrainState, Metrics]:
        model = state.model
        attn = _bar_mask(x)
        dec_ids, dec_attn = _token_decoder_inputs(x, y, attn, cfg, velocity)
        loss_mask = attn if weight is None else attn * weight[:, None]
        xs, ds, ms, dms, ys, lms = m.blocks(x, dec_ids, attn, dec_attn, y, loss_mask)

        def loss_fn(gen):
            logits = model(xs, ds, ms, dms, generator=gen)
            loss = m.mean((nll(logits, ys) * lms).sum(), lms.sum(), reg_weight, model)
            return loss, (logits,)

        loss, (logits,), norm = m.run(state, loss_fn, train, generator)
        pred = logits.argmax(dim=-1)
        out = m.metrics(loss, norm, acc_num=((pred == ys) * lms).sum(),
                        acc_den=lms.sum())
        if not train:
            out["pred"] = gather_batch(mesh, pred)
        return state, out

    return step


def _seq2seq(m: _Mesh, state, blocks, train, generator) -> Metrics:
    """The generation and ablation losses on this rank's block of (encoder
    ids, decoder ids, encoder mask, decoder mask, labels, loss mask): each
    field's masked mean over global denominators, times its
    ``GENERATION_FIELD_WEIGHTS`` entry, weighted by vocabulary size."""
    cfg, model = m.cfg, state.model
    enc, dec, em, dm, label, lm = blocks
    lm8 = lm[..., None].expand(*lm.shape, cfg.n_fields)
    n_tok = torch.tensor(cfg.field_sizes, dtype=torch.float32, device=lm.device)
    fw = torch.tensor(GENERATION_FIELD_WEIGHTS, dtype=torch.float32, device=lm.device)

    def loss_fn(gen):
        fused = model(enc, dec, em, dm, generator=gen)
        nums, dens, hits = _local_ce_sums(fused, label, lm8, cfg)
        per_field = nums / m.global_sum(dens).clamp(min=1.0) * fw
        return (per_field * n_tok).sum() / n_tok.sum(), (fused, nums, dens, hits)

    loss, (fused, nums, dens, hits), norm = m.run(state, loss_fn, train, generator)
    out = m.metrics(loss, norm, nums=nums, dens=dens, hits=hits)
    per_field, accs = _per_field(out.pop("nums"), out.pop("dens"), out.pop("hits"))
    out.update(field_loss=per_field * fw, field_acc=accs)
    if not train:
        out["outputs"] = gather_batch(m.mesh, greedy_octuple(fused, cfg))
    return out


def make_sp_generation_step(cfg: PianoBartConfig, mesh: Mesh,
                            decoder_mode: str = "intro"):
    """The generation finetune over ``mesh``: ``step(state, x, y, generator,
    train=True, weight=None)`` as :func:`~.generation.generation_step`, on
    the global intro and continuation ``(B, S, 8)``."""
    if decoder_mode not in ("intro", "shifted"):
        raise ValueError(f"unknown decoder_mode {decoder_mode!r}")
    m = _Mesh(cfg, mesh)

    def step(state, x, y, generator=None, train=True, weight=None
             ) -> Tuple[TrainState, Metrics]:
        dec_ids = x if decoder_mode == "intro" else shift_right(y, V.SOS)
        attn_dec = _bar_mask(dec_ids)
        loss_mask = attn_dec if weight is None else attn_dec * weight[:, None]
        out = _seq2seq(m, state, m.blocks(x, dec_ids, _bar_mask(x), attn_dec, y,
                                          loss_mask), train, generator)
        out["attn_dec"] = attn_dec
        return state, out

    return step


def make_sp_ablation_step(cfg: PianoBartConfig, mesh: Mesh):
    """The ablation over ``mesh``: ``step(state, batch, generator,
    train=True, weight=None)`` as :func:`~.generation.ablation_step`, with
    ``_ablation_prepare`` on the global batch."""
    m = _Mesh(cfg, mesh)

    def step(state, batch, generator=None, train=True, weight=None
             ) -> Tuple[TrainState, Metrics]:
        enc_ids, dec_ids, label, loss_mask = _ablation_prepare(batch)
        if weight is not None:
            loss_mask = loss_mask * weight[:, None]
        out = _seq2seq(m, state, m.blocks(enc_ids, dec_ids, _bar_mask(enc_ids),
                                          _bar_mask(dec_ids), label, loss_mask),
                       train, generator)
        out["loss_mask"] = loss_mask
        return state, out

    return step
