"""The pretraining epoch runner (``pianobart_tpu/train/runner.py``), the
orchestration layer behind ``cli pretrain``.

Mirrors the reference's pretrain loop (``main.py:17-100``): epochs,
vocab-weighted best-model selection, patience-based early stop, a
checkpoint every epoch with a best copy, and the append-only epoch log;
rebuilt on the port's steps, checkpoints with true resume, mid-epoch safety
saves, and ``metrics.jsonl``.

Randomness: the train batches' order comes from one numpy generator seeded
with ``seed`` (one permutation per epoch, as in the JAX runner); each
dispatch's corruption and dropout come from a torch generator seeded from
``(seed, state.step)``, and each validation batch's corruption from one
seeded from ``(seed, batch index)``: distinct across batches, identical
across epochs.  A resumed run replays the permutations of the epochs it
skips, so a run preempted between epochs and resumed takes the same steps
as one never interrupted.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.config import PianoBartConfig
from ..utils.logging import MetricsLogger
from ..utils.preemption import Preempted, PreemptionGuard
from .pretrain import batch_iterator, pretrain_eval_step, pretrain_multi_step
from .state import CheckpointManager, TrainState, ema_applied

__all__ = ["PretrainRunner"]

_TRAIN, _VALID = 0, 1


def _seed(kind: int, seed: int, index: int) -> int:
    """A 64-bit generator seed from (stream kind, run seed, index)."""
    return int(np.random.SeedSequence([kind, seed, index]).generate_state(
        1, np.uint64)[0])


class PretrainRunner:
    """Pretraining epochs (main.py:17-100).

    The hooks replace the port's steps (the JAX runner's sequence-parallel path uses them):

    * ``train_step_fn(state, batch, generator) -> (state, metrics)``
    * ``eval_step_fn(state, batch, generator, sample_weight) -> metrics``

    ``lr_fn(state.step) -> float`` mirrors the optimizer's schedule on the
    host, for the epoch log only.  ``preempt`` is polled at dispatch
    boundaries and at the top of each epoch: a pending request writes the
    safety checkpoint and raises :class:`Preempted`.
    """

    def __init__(self, state: TrainState, cfg: PianoBartConfig,
                 train_data, valid_data, save_dir: str, batch_size: int = 16,
                 mask_percent: float = 0.15, patience: int = 30,
                 seed: int = 2023,
                 steps_per_dispatch: int = 8,
                 checkpoint_every_dispatches: int = 0,
                 train_step_fn: Optional[Callable] = None,
                 eval_step_fn: Optional[Callable] = None,
                 lr_fn: Optional[Callable] = None,
                 preempt: Optional[PreemptionGuard] = None):
        self.state = state
        self.cfg = cfg
        self.device = next(state.model.parameters()).device
        self.train_data = train_data
        self.valid_data = valid_data
        self.batch_size = batch_size
        self.mask_percent = mask_percent
        self.patience = patience
        self.seed = seed
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        # mid-epoch safety checkpoints every N dispatches (0 = off)
        self.checkpoint_every_dispatches = checkpoint_every_dispatches
        self.train_step_fn = train_step_fn
        self.eval_step_fn = eval_step_fn
        self.lr_fn = lr_fn
        self.preempt = preempt
        self.logger = MetricsLogger(save_dir)
        self.ckpt = CheckpointManager(save_dir)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.best_acc = -1.0
        self.bad_epochs = 0
        self._cur_epoch = 0  # set by run(); safety saves record it
        self._safety_at = None  # (epoch, step) the safety slot holds

    def _put(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch), device=self.device)

    def _generator(self, kind: int, index: int) -> torch.Generator:
        return self.generator.manual_seed(_seed(kind, self.seed, index))

    def _save_safety(self) -> None:
        at = (self._cur_epoch, self.state.step)
        if at != self._safety_at:
            self.ckpt.save_safety(self.state, self._cur_epoch)
            self._safety_at = at

    def train_epoch(self) -> Dict[str, Any]:
        """Batches go ``steps_per_dispatch`` at a time through
        ``pretrain_multi_step``: one host sync per group, none per step."""
        losses, accs, gnorms = [], [], []
        n = tokens = dispatches = 0
        t0 = time.time()
        K = self.steps_per_dispatch
        group: list = []

        def flush(group):
            nonlocal n, tokens, dispatches
            if not group:
                return
            stacked = np.stack(group)
            if self.train_step_fn is not None:
                ls_l, ac_l, gn_l = [], [], []
                for b in group:
                    self.state, m = self.train_step_fn(
                        self.state, self._put(b),
                        self._generator(_TRAIN, self.state.step))
                    ls_l.append(m["loss"].reshape(1))
                    ac_l.append(m["field_acc"][None])
                    if "grad_norm" in m:
                        gn_l.append(m["grad_norm"].reshape(1))
                ls, ac = torch.cat(ls_l).cpu(), torch.cat(ac_l).cpu()
                gn = torch.cat(gn_l).cpu() if gn_l else None
            else:
                self.state, (ls, ac, gn) = pretrain_multi_step(
                    self.state, self._put(stacked),
                    self._generator(_TRAIN, self.state.step),
                    self.mask_percent, len(group))
            losses.append(ls)
            accs.append(ac)
            if gn is not None:
                gnorms.append(gn)
            tokens += stacked.shape[0] * stacked.shape[1] * stacked.shape[2]
            n += len(group)
            dispatches += 1
            if (self.checkpoint_every_dispatches
                    and dispatches % self.checkpoint_every_dispatches == 0):
                self._save_safety()
            self.logger.step_echo(n, {"loss": ls[-1], "weighted_acc":
                                      ac[-1].mean()})
            self._check_preempt()

        for batch, _ in batch_iterator(self.train_data, self.batch_size,
                                       self.np_rng, shuffle=True):
            group.append(batch)
            if len(group) == K:
                flush(group)
                group = []
        flush(group)
        if n == 0:
            print(f"WARNING: 0 train steps this epoch — {len(self.train_data)}"
                  f" sequences < batch_size {self.batch_size}; lower"
                  f" --batch_size to train on this dataset", file=sys.stderr)
        dt = time.time() - t0
        out = {"loss": float(torch.cat(losses).mean()) if losses else 0.0,
               "field_acc": torch.cat(accs).mean(0).numpy() if accs
               else np.zeros(8),
               "tokens_per_sec": tokens / max(dt, 1e-9), "steps": n}
        if gnorms:  # pre-clip global gradient norm
            g = torch.cat(gnorms).numpy()
            out["grad_norm_mean"] = float(g.mean())
            out["grad_norm_max"] = float(g.max())
        if self.lr_fn is not None:
            out["lr"] = float(self.lr_fn(int(self.state.step)))
        return out

    def _check_preempt(self) -> None:
        """Graceful shutdown: save the safety slot, then bail.  Resume
        restarts the interrupted epoch from it."""
        if self.preempt is not None and self.preempt.requested:
            self._save_safety()
            raise Preempted(
                f"preempted at epoch {self._cur_epoch + 1}, optimizer step "
                f"{int(self.state.step)}: safety checkpoint saved under "
                f"{self.ckpt.directory}; rerun with --resume to continue")

    def valid_epoch(self) -> Dict[str, Any]:
        """Validation over every sample (the tail batch padded at weight 0),
        with the EMA shadow when the state keeps one."""
        losses, accs = [], []
        with ema_applied(self.state) as state:
            for bi, (batch, w) in enumerate(batch_iterator(
                    self.valid_data, self.batch_size, self.np_rng, shuffle=False,
                    drop_last=False)):
                gen = self._generator(_VALID, bi)
                w = torch.as_tensor(w, device=self.device)
                if self.eval_step_fn is not None:
                    m = self.eval_step_fn(state, self._put(batch), gen, w)
                else:
                    m = pretrain_eval_step(state, self._put(batch), gen, w,
                                           self.mask_percent)
                losses.append(m["loss"])
                accs.append(m["field_acc"])
        if not losses:
            return {"loss": 0.0, "field_acc": np.zeros(8)}
        return {"loss": float(torch.stack(losses).mean()),
                "field_acc": torch.stack(accs).mean(0).cpu().numpy()}

    def run(self, epochs: int, resume: bool = False) -> TrainState:
        start_epoch = 0
        run_t0 = time.time()
        if resume:
            self.state, start_epoch = self.ckpt.restore(self.state)
            # else the first epoch after a resume always looks "best"
            self.best_acc = float(self.ckpt.meta().get("best_acc", -1.0))
            # the data order of the epochs already taken
            for _ in range(start_epoch):
                self.np_rng.permutation(len(self.train_data))
        n_tok = np.asarray(self.cfg.field_sizes, dtype=np.float64)
        for epoch in range(start_epoch, epochs):
            self._cur_epoch = epoch
            # a signal that landed during the last epoch's eval or save
            # stops here, before any work of this epoch
            self._check_preempt()
            if self.bad_epochs >= self.patience:
                self.logger.epoch_line(
                    f"valid acc not improving for {self.patience} epochs")
                # tells a completed early-stopped run from an interrupted one
                self.logger.log("early_stop", epoch=epoch,
                                patience=self.patience)
                break
            tr = self.train_epoch()
            va = self.valid_epoch()
            weighted = float((va["field_acc"] * n_tok).sum() / n_tok.sum())
            is_best = weighted > self.best_acc
            self.best_acc = max(weighted, self.best_acc)
            self.bad_epochs = 0 if is_best else self.bad_epochs + 1
            self.ckpt.save(epoch + 1, self.state,
                           {"weighted_acc": weighted, **va}, is_best)
            self._safety_at = None
            self.logger.log("epoch", epoch=epoch + 1, train=tr, valid=va,
                            weighted_acc=weighted, best=is_best)
            fmt = lambda a: [round(float(v), 3) for v in a]
            self.logger.epoch_line(
                f"Epoch {epoch + 1}: train_loss={tr['loss']:.4f}, "
                f"train_acc={fmt(tr['field_acc'])}, "
                f"valid_loss={va['loss']:.4f}, "
                f"valid_acc={fmt(va['field_acc'])}, "
                + (f"gnorm={tr['grad_norm_mean']:.3f}, "
                   if "grad_norm_mean" in tr else "")
                + (f"lr={tr['lr']:.2e}, " if "lr" in tr else "")
                + f"tok/s={tr['tokens_per_sec']:.0f}")
        # total wall-time report (main.py:94-100)
        self.logger.epoch_line(
            f"Time cost in pretrain is {time.time() - run_t0:.1f}s")
        return self.state
