"""The epoch runners (``pianobart_tpu/train/runner.py``), the orchestration
layer behind ``cli pretrain`` (:class:`PretrainRunner`) and the finetunes,
the generation finetune and the ablation (:class:`SupervisedRunner`).

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

Over a mesh of several ranks (``mesh``; parameters replicated), every rank
runs the same loop on the same global batches (``put_batch`` places them,
the mesh's steps take each rank's block); rank 0 alone writes checkpoints
and ``metrics.jsonl``, every save ends in a barrier, and the ranks agree on
preemption: at each dispatch boundary they all-reduce the SIGTERM flag, so
all of them stop at the same step (a rank that stopped alone would leave the
others blocked in a collective).
"""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import PianoBartConfig
from ..utils.logging import MetricsLogger
from ..utils.preemption import Preempted, PreemptionGuard
from .pretrain import batch_iterator, pretrain_eval_step, pretrain_multi_step
from .state import CheckpointManager, TrainState, ema_applied

__all__ = ["PretrainRunner", "SupervisedRunner"]

_TRAIN, _VALID = 0, 1


def _seed(kind: int, seed: int, index: int) -> int:
    """A 64-bit generator seed from (stream kind, run seed, index)."""
    return int(np.random.SeedSequence([kind, seed, index]).generate_state(
        1, np.uint64)[0])


class _EpochRunner:
    """What both runners share: the device, the seeded generators, the
    checkpoint manager and the log, the safety save on preemption, and the
    resume that replays the data order of the epochs it skips."""

    def __init__(self, state: TrainState, cfg: PianoBartConfig, save_dir: str,
                 seed: int, preempt: Optional[PreemptionGuard],
                 put_batch: Optional[Callable] = None, mesh=None):
        self.state = state
        self.cfg = cfg
        self.device = next(state.model.parameters()).device
        self.seed = seed
        self.preempt = preempt
        self.put_batch = put_batch
        self.mesh = mesh
        writer = mesh is None or mesh.rank == 0
        self.logger = MetricsLogger(save_dir, enabled=writer)
        self.ckpt = CheckpointManager(
            save_dir, writer=writer, barrier=None if mesh is None else mesh.barrier)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self._cur_epoch = 0  # set by run(); safety saves record it
        self._safety_at = None  # (epoch, step) the safety slot holds

    def _put(self, batch) -> torch.Tensor:
        if self.put_batch is not None:
            return self.put_batch(batch)
        return torch.as_tensor(np.asarray(batch), device=self.device)

    def _generator(self, kind: int, index: int) -> torch.Generator:
        return self.generator.manual_seed(_seed(kind, self.seed, index))

    def _save_safety(self) -> None:
        at = (self._cur_epoch, self.state.step)
        if at != self._safety_at:
            self.ckpt.save_safety(self.state, self._cur_epoch)
            self._safety_at = at

    def _check_preempt(self) -> None:
        """Graceful shutdown: save the safety slot, then bail.  Resume
        restarts the interrupted epoch from it.  Over a mesh every rank
        calls this at the same points and they agree (any rank's request
        stops all)."""
        requested = self.preempt is not None and self.preempt.requested
        if self.mesh is not None:
            requested = self.mesh.agree_any(requested)
        if requested:
            self._save_safety()
            raise Preempted(
                f"preempted at epoch {self._cur_epoch + 1}, optimizer step "
                f"{int(self.state.step)}: safety checkpoint saved under "
                f"{self.ckpt.directory}; rerun with --resume to continue")

    def _resume(self, n_train: int) -> Tuple[int, float]:
        """Restore the newest checkpoint; return the epoch to start at and
        the best score so far (else the first epoch after a resume always
        looks best), after replaying the data order of the epochs taken."""
        self.state, start = self.ckpt.restore(self.state)
        for _ in range(start):
            self.np_rng.permutation(n_train)
        return start, float(self.ckpt.meta().get("best_acc", -1.0))


class PretrainRunner(_EpochRunner):
    """Pretraining epochs (main.py:17-100).

    The hooks replace the port's steps (the mesh steps of
    ``train/pretrain_sp.py`` use them):

    * ``train_step_fn(state, batch, generator) -> (state, metrics)``
    * ``eval_step_fn(state, batch, generator, sample_weight) -> metrics``
    * ``put_batch(numpy batch) -> tensor`` places each batch
      (``parallel/mesh.py:put_batch_fn``; default: whole, on the model's
      device), with ``mesh`` the ranks' agreement and rank 0's writes.

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
                 preempt: Optional[PreemptionGuard] = None,
                 put_batch: Optional[Callable] = None, mesh=None):
        super().__init__(state, cfg, save_dir, seed, preempt, put_batch, mesh)
        self.train_data = train_data
        self.valid_data = valid_data
        self.batch_size = batch_size
        self.mask_percent = mask_percent
        self.patience = patience
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        # mid-epoch safety checkpoints every N dispatches (0 = off)
        self.checkpoint_every_dispatches = checkpoint_every_dispatches
        self.train_step_fn = train_step_fn
        self.eval_step_fn = eval_step_fn
        self.lr_fn = lr_fn
        self.best_acc = -1.0
        self.bad_epochs = 0

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
            start_epoch, self.best_acc = self._resume(len(self.train_data))
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


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SupervisedRunner(_EpochRunner):
    """The epoch loop of the finetunes, the generation finetune and the
    ablation (the reference's ``main.py:186-211, 291-321``).

    ``step_fn(state, x, y, generator, train=..., weight=...) -> (state,
    metrics)``; the metrics carry ``loss`` and either ``acc_num`` /
    ``acc_den`` or ``field_acc``.  ``data`` is ``(X_train, X_val, X_test,
    y_train, y_val, y_test)``.

    * Every sample of a split counts once: the tail batch is padded with
      copies of its first sample at sample weight 0.
    * Validation and test use the EMA shadow when the state keeps one.
    * ``eval_hook(x, y, metrics) -> {name: float}`` runs on every eval
      batch (its real samples only); the epoch reports each name's mean.
    * The test split's predictions are saved to ``test_outputs.npy`` every
      epoch.
    * ``select``: ``"scalar_acc"`` (accuracy, else minus the loss) or
      ``"weighted_field_acc"`` (the vocab-size-weighted field accuracy).  A
      score equal to the best refreshes ``best/`` (``>=``, as the
      reference); more than ``patience`` epochs without one end the run
      with an ``early_stop`` event.
    * ``preempt`` is polled after every train batch: a pending request
      writes the safety checkpoint and raises :class:`Preempted`; ``run(...,
      resume=True)`` restarts the interrupted epoch from it.

    Randomness as :class:`PretrainRunner`'s: one permutation per epoch from
    a numpy generator seeded with ``seed`` (replayed for the epochs a resume
    skips), each train step's dropout from a generator seeded from (seed,
    step).
    """

    def __init__(self, state: TrainState, cfg: PianoBartConfig, step_fn, data,
                 save_dir: str, batch_size: int = 8, patience: int = 3,
                 seed: int = 2023, select: str = "scalar_acc",
                 eval_hook: Optional[Callable] = None,
                 lr_fn: Optional[Callable] = None,
                 preempt: Optional[PreemptionGuard] = None):
        super().__init__(state, cfg, save_dir, seed, preempt)
        self.step_fn = step_fn
        (self.X_train, self.X_val, self.X_test,
         self.y_train, self.y_val, self.y_test) = data
        self.save_dir = save_dir
        self.batch_size = batch_size
        self.patience = patience
        self.select = select
        self.eval_hook = eval_hook
        self.lr_fn = lr_fn
        self.best = -1.0
        self.bad = 0

    def _epoch(self, X, y, train: bool,
               collect_outputs: bool = False) -> Dict[str, Any]:
        losses, acc_num, acc_den, field_accs, gnorms = [], [], [], [], []
        extras, outputs = [], []
        n = len(X)
        idx = self.np_rng.permutation(n) if train else np.arange(n)
        for i in range(0, n, self.batch_size):
            sel = idx[i:i + self.batch_size]
            real = len(sel)
            weight = None
            if real < self.batch_size:
                pad = self.batch_size - real
                weight = self._put(np.concatenate(
                    [np.ones(real, np.float32), np.zeros(pad, np.float32)]))
                sel = np.concatenate([sel, np.repeat(sel[:1], pad)])
            bx = self._put(np.asarray(X[sel]).astype(np.int64))
            by = self._put(np.asarray(y[sel]).astype(np.int64))
            if train:
                self.state, m = self.step_fn(
                    self.state, bx, by, self._generator(_TRAIN, self.state.step),
                    train=True, weight=weight)
                self._check_preempt()
            else:
                _, m = self.step_fn(self.state, bx, by, None, train=False,
                                    weight=weight)
            losses.append(m["loss"])
            if "acc_num" in m:
                acc_num.append(m["acc_num"])
                acc_den.append(m["acc_den"])
            if "field_acc" in m:
                field_accs.append(m["field_acc"])
            if "grad_norm" in m:
                gnorms.append(m["grad_norm"])
            if self.eval_hook is not None and not train:
                hm = dict(m)
                for k in ("outputs", "attn_dec", "pred"):
                    if k in hm:
                        hm[k] = _host(hm[k])[:real]
                extras.append(self.eval_hook(_host(bx)[:real], _host(by)[:real], hm))
            if collect_outputs:
                key = "pred" if "pred" in m else "outputs"
                if key in m:
                    outputs.append(_host(m[key])[:real])
        out: Dict[str, Any] = {
            "loss": float(torch.stack(losses).mean()) if losses else 0.0}
        # host sums in float64, batch by batch, as the JAX runner adds them
        num = den = 0.0
        for a, b in zip(torch.stack(acc_num).tolist() if acc_num else [],
                        torch.stack(acc_den).tolist() if acc_den else []):
            num += a
            den += b
        if den:
            out["acc"] = num / den
        if field_accs:
            out["field_acc"] = torch.stack(field_accs).mean(0).cpu().numpy()
        if gnorms:
            g = torch.stack(gnorms).cpu().numpy()
            out["grad_norm_mean"] = float(g.mean())
            out["grad_norm_max"] = float(g.max())
        if train and self.lr_fn is not None:
            out["lr"] = float(self.lr_fn(int(self.state.step)))
        if extras:
            out.update({k: float(np.mean([e[k] for e in extras]))
                        for k in extras[0]})
        if collect_outputs and outputs:
            out["outputs"] = np.concatenate(outputs, axis=0)
        return out

    def _eval_epoch(self, X, y, collect_outputs: bool = False) -> Dict[str, Any]:
        with ema_applied(self.state):
            return self._epoch(X, y, train=False, collect_outputs=collect_outputs)

    def _selection_score(self, va: Dict[str, Any]) -> float:
        if self.select == "weighted_field_acc":
            n_tok = np.asarray(self.cfg.field_sizes, dtype=np.float64)
            return float((va["field_acc"] * n_tok).sum() / n_tok.sum())
        return float(va.get("acc", -va["loss"]))

    def run(self, epochs: int, resume: bool = False,
            run_test_each_epoch: bool = True) -> TrainState:
        start = 0
        if resume:
            start, self.best = self._resume(len(self.X_train))
        for epoch in range(start, epochs):
            self._cur_epoch = epoch
            # a signal that landed during the last epoch's eval or save
            self._check_preempt()
            tr = self._epoch(self.X_train, self.y_train, train=True)
            va = self._eval_epoch(self.X_val, self.y_val)
            te = (self._eval_epoch(self.X_test, self.y_test, collect_outputs=True)
                  if run_test_each_epoch else {})
            test_outputs = te.pop("outputs", None)
            if test_outputs is not None:
                np.save(f"{self.save_dir}/test_outputs.npy", test_outputs)
            score = self._selection_score(va)
            is_best = score >= self.best
            self.best = max(score, self.best)
            self.bad = 0 if is_best else self.bad + 1
            self.ckpt.save(epoch + 1, self.state, {"weighted_acc": score, **va},
                           is_best)
            self._safety_at = None
            self.logger.log("epoch", epoch=epoch + 1, train=tr, valid=va,
                            test=te, score=score, best=is_best)
            self.logger.epoch_line(
                f"Epoch {epoch + 1}: train_loss={tr['loss']:.4f}, "
                f"valid_loss={va['loss']:.4f}, "
                + (f"gnorm={tr['grad_norm_mean']:.3f}, "
                   if "grad_norm_mean" in tr else "")
                + (f"lr={tr['lr']:.2e}, " if "lr" in tr else "")
                + (f"valid_acc={va.get('acc', float('nan')):.4f}, "
                   if "acc" in va else "")
                + (f"test_acc={te.get('acc', float('nan')):.4f}"
                   if "acc" in te else ""))
            if self.bad > self.patience:
                self.logger.epoch_line(
                    f"valid acc not improving for {self.patience} epochs")
                self.logger.log("early_stop", epoch=epoch + 1,
                                patience=self.patience)
                break
        return self.state
