"""Train state, optimizer and checkpoints, the counterpart of
``pianobart_tpu/train/state.py``.

The optimizer is the reference's: AdamW (lr 2e-5, betas (0.9, 0.999), eps
1e-8, weight decay 0.01 on every parameter, as optax's ``adamw`` with no
mask) after a global-norm gradient clip at 3.0 that keeps the norm it
computes.  Beyond the reference, as in the JAX package: a learning-rate
schedule (:func:`make_schedule`), gradient accumulation with
``optax.MultiSteps`` semantics and a Polyak average of the parameters (both
in :func:`apply_gradients`).

:class:`CheckpointManager` keeps the JAX manager's layout and ``meta.json``
(``step_N/``, ``best/``, the ``safety/`` slot) with a ``torch.save`` payload:
true resume of the model, the optimizer, the EMA shadow and a partial
accumulation window; and, for a finetune or a server, the weights (or the
EMA shadow) alone, grafted onto any model that shares their names.
:func:`load_merged_msgpack` reads a merge's flax ``.msgpack`` (the port's
``merge`` or the JAX package's) as the same port-named entries.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
from torch import nn

__all__ = ["TrainState", "make_schedule", "make_optimizer", "create_train_state",
           "apply_gradients", "gradient_step", "clip_by_global_norm_logged",
           "get_grad_norm",
           "get_ema_params", "ema_applied", "CheckpointManager", "graft_",
           "load_merged_msgpack"]

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """The model (updated in place), its AdamW, and what the JAX package's
    optimizer chain carries in its state:

    * ``step``: gradient calls taken (micro-steps under accumulation), as
      flax's ``TrainState.step`` counts them;
    * ``grad_norm``: pre-clip global norm of the last real update (a device
      tensor, ``None`` before the first);
    * ``schedule``: learning rate of inner update n (n from 0), or ``None``
      for the optimizer's constant rate;
    * ``accum_steps``: micro-steps per real update;
    * ``ema`` / ``ema_decay``: the Polyak shadow, one tensor per parameter
      in ``model.parameters()`` order, or ``None``;
    * ``grad_sync``: called with the gradients of each real update before
      anything else reads them (the mesh steps' SUM all-reduce over the
      (dp, sp) group), or ``None``.
    """
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None
    clip_norm: float = 3.0
    schedule: Optional[Schedule] = None
    accum_steps: int = 1
    ema_decay: Optional[float] = None
    ema: Optional[List[torch.Tensor]] = None
    grad_sync: Optional[Callable[[List[torch.Tensor]], None]] = None


# ---------------------------------------------------------------------------
# Learning-rate schedules: optax's, evaluated on the host per real update
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: a polynomial schedule of power 1."""
    if steps <= 0:
        return lambda n: init

    def f(n: int) -> float:
        frac = 1 - min(max(n, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` to 0."""
    def f(n: int) -> float:
        return init * 0.5 * (1 + math.cos(math.pi * min(n, decay_steps)
                                          / decay_steps))
    return f


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """``optax.join_schedules``: each later schedule restarts its count at
    its boundary."""
    def f(n: int) -> float:
        out = schedules[0](n)
        for b, s in zip(boundaries, schedules[1:]):
            if n >= b:
                out = s(n - b)
        return out
    return f


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: Optional[int] = None
                  ) -> Union[float, Schedule]:
    """LR schedule factory, optax's values step for step (in float64).

    ``constant`` (the reference, optionally with linear warmup from 0),
    ``cosine``/``linear`` decay to 0 over ``decay_steps`` real updates after
    ``warmup_steps`` of linear warmup.  The plain constant case returns the
    float, as the JAX package does."""
    if schedule == "constant":
        if warmup_steps <= 0:
            return learning_rate
        return _linear(0.0, learning_rate, warmup_steps)
    if decay_steps is None or decay_steps <= warmup_steps:
        raise ValueError(
            f"schedule {schedule!r} needs decay_steps > warmup_steps "
            f"(got decay_steps={decay_steps}, warmup_steps={warmup_steps}); "
            f"set --decay_steps to the planned total optimizer steps")
    if schedule == "cosine":
        return _join([_linear(0.0, learning_rate, warmup_steps),
                      _cosine(learning_rate, decay_steps - warmup_steps)],
                     [warmup_steps])
    if schedule == "linear":
        return _join([_linear(0.0, learning_rate, max(warmup_steps, 1)),
                      _linear(learning_rate, 0.0, decay_steps - warmup_steps)],
                     [warmup_steps])
    raise ValueError(f"unknown lr schedule {schedule!r}")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float = 2e-5,
                   weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """AdamW with the reference's settings.

    ``torch.optim.AdamW`` decays ``p *= 1 - lr*wd`` before its Adam step,
    which is optax's ``p -= lr * (adam + wd*p)`` written in another order."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(model: nn.Module, learning_rate: float = 2e-5,
                       weight_decay: float = 0.01, clip_norm: float = 3.0, *,
                       schedule: str = "constant", warmup_steps: int = 0,
                       decay_steps: Optional[int] = None, accum_steps: int = 1,
                       ema_decay: Optional[float] = None) -> TrainState:
    """AdamW(lr, wd 0.01) after a global-norm clip at 3.0 (the reference),
    with the JAX ``make_optimizer``'s other knobs, each defaulting to the
    reference: ``schedule``/``warmup_steps``/``decay_steps`` pick a learning
    rate schedule (:func:`make_schedule`); ``accum_steps`` > 1 averages the
    gradients of k micro-batches before each update; ``ema_decay`` keeps a
    Polyak shadow of the parameters that the runner evaluates with (it
    advances once per real update)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    lr = make_schedule(learning_rate, schedule, warmup_steps, decay_steps)
    sched = lr if callable(lr) else None
    opt = make_optimizer(model.parameters(), sched(0) if sched else lr,
                         weight_decay)
    ema = None
    if ema_decay is not None:
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        # real copies: the shadow must never share storage with a parameter
        ema = [p.detach().clone() for p in model.parameters()]
    return TrainState(model, opt, clip_norm=clip_norm, schedule=sched,
                      accum_steps=accum_steps, ema_decay=ema_decay, ema=ema)


def _grads(params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    return [p.grad for p in params if p.grad is not None]


def clip_by_global_norm_logged(params: Iterable[torch.Tensor],
                               max_norm: float = 3.0) -> torch.Tensor:
    """Clip the gradients of ``params`` in place by their global norm and
    return the pre-clip norm (f32 device tensor, no host sync).

    optax's formula: ``g if norm < max_norm else g / norm * max_norm``.
    ``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
    and is not the same function.  A few launches for all the gradients:
    one fused norm, one fused multiply by 1 or ``max_norm / norm``."""
    grads = _grads(params)
    norm = torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(grads)]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: TrainState) -> bool:
    """Count one micro-step of the gradients now in ``.grad``, as optax's
    ``MultiSteps`` over the clip, AdamW and EMA chain does; return whether
    this call took a real update.

    Every ``accum_steps``-th call hands the window's gradients (the backward
    passes summed them into ``.grad``) to ``grad_sync`` when the state has
    one (once per window), averages them, clips the mean, takes the
    AdamW step with learning rate ``schedule(n)`` for real update n (n from
    0, as optax's ``scale_by_schedule`` reads its count before it
    increments), then moves the EMA shadow toward the new parameters.  The
    other calls only count: no parameter, moment or shadow changes, and
    ``grad_norm`` keeps the last real update's value."""
    state.step += 1
    k = state.accum_steps
    if state.step % k:
        return False
    params = [p for p in state.model.parameters() if p.grad is not None]
    if state.grad_sync is not None:
        state.grad_sync(_grads(params))
    if k > 1:
        torch._foreach_div_(_grads(params), float(k))
    state.grad_norm = clip_by_global_norm_logged(params, state.clip_norm)
    if state.schedule is not None:
        lr = float(state.schedule(state.step // k - 1))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    if state.ema is not None:
        d = state.ema_decay
        with torch.no_grad():
            torch._foreach_mul_(state.ema, d)
            torch._foreach_add_(state.ema, [p.detach() for p in state.model.parameters()],
                                alpha=1.0 - d)
    return True


def gradient_step(state: TrainState, loss_fn: Callable, generator):
    """One train micro-step of every trainer: ``loss_fn(generator) -> (loss,
    aux)`` in training mode (dropout from ``generator``), backward, then
    :func:`apply_gradients`.  Returns ``(loss, aux, grad_norm)`` detached.

    The gradients are cleared when an accumulation window opens, that is
    after each real update, so the micro-steps of a window sum into
    ``.grad`` (and a window restored from a checkpoint carries on).  A
    micro-step reports the last real update's norm (0 before the first)."""
    state.model.train()
    if state.step % state.accum_steps == 0:
        state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(generator)
    loss.backward()
    apply_gradients(state)
    norm = (state.grad_norm if state.grad_norm is not None
            else torch.zeros((), device=loss.device))
    return loss.detach(), tuple(a.detach() for a in aux), norm


def get_grad_norm(state: TrainState) -> Optional[torch.Tensor]:
    """Pre-clip global gradient norm of the last real update, or ``None``."""
    return state.grad_norm


def get_ema_params(state: TrainState) -> Optional[Dict[str, torch.Tensor]]:
    """The EMA shadow by parameter name, or ``None`` without ``ema_decay``."""
    if state.ema is None:
        return None
    return dict(zip([n for n, _ in state.model.named_parameters()], state.ema))


@contextlib.contextmanager
def ema_applied(state: TrainState):
    """Within the block the model holds the EMA shadow (when the state keeps
    one), for evaluation; the training parameters come back on exit.  The
    storages are swapped, not copied, so the optimizer's references to the
    parameter objects stay valid."""
    if state.ema is None:
        yield state
        return
    params = list(state.model.parameters())

    def swap():
        for p, e in zip(params, state.ema):
            p.data, e.data = e.data, p.data

    swap()
    try:
        yield state
    finally:
        swap()


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

PAYLOAD = "state.pt"

_HINT = ("hint: the checkpoint's optimizer state does not match this run's "
         "optimizer. Resume with the SAME --accum_steps/--lr_schedule/"
         "--warmup_steps/--decay_steps/--ema_decay the checkpoint was written "
         "with (params-only loading via --ckpt <dir> without --resume ignores "
         "optimizer state and always works).")


def _structure(state: TrainState) -> Dict[str, bool]:
    """What the JAX optimizer's state tree holds beyond AdamW: a MultiSteps
    wrapper, a schedule count, an EMA shadow.  A resume whose flags change
    any of these is refused with :data:`_HINT`, as orbax refuses the tree."""
    return {"accumulation": state.accum_steps > 1,
            "schedule": state.schedule is not None,
            "ema": state.ema is not None}


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _payload(state: TrainState) -> Dict[str, Any]:
    params = list(state.model.parameters())
    partial = state.step % state.accum_steps
    return _to_cpu({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": state.ema,
        # a partial accumulation window: the gradients summed so far
        "accum": {"mini_step": partial,
                  "grads": [p.grad for p in params] if partial else None},
        "grad_norm": state.grad_norm,
        "step": state.step,
        "structure": _structure(state),
    })


def _link_or_copy(src: str, dst: str) -> None:
    """A checkpoint file is never rewritten in place (saves rename a new
    directory over the old), so ``best/`` may share it by a hard link."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _swap_in(tmp: str, path: str) -> None:
    """Rename a finished ``tmp`` directory to ``path``.  The old ``path`` is
    renamed aside first and removed last, so a process killed during the
    (slow) removal still leaves a whole payload at ``path``."""
    if os.path.exists(path):
        shutil.rmtree(path + ".old", ignore_errors=True)
        os.replace(path, path + ".old")
    os.replace(tmp, path)
    shutil.rmtree(path + ".old", ignore_errors=True)


class CheckpointManager:
    """Checkpoints with a best copy and true resume.

    Layout under ``directory``:
      ``step_N/``      — full state (model, optimizer, EMA, accumulation)
                         after epoch N
      ``best/``        — the best step (weighted-accuracy selection)
      ``safety/``      — the one rotating mid-epoch crash-safety save,
                         outside the ``step_N`` epoch namespace
      ``meta.json``    — {last_step, best_step, best_acc, history, safety?}

    Each payload directory holds ``state.pt``, written into ``<dir>.tmp``
    and renamed to ``<dir>`` once the old ``<dir>`` is renamed aside to
    ``<dir>.old``; ``*.tmp`` and ``*.old`` left by a killed save are swept.

    In a job of several ranks (replicated parameters) only the ``writer``
    (rank 0) writes; every rank's save ends in ``barrier``, so no rank reads
    or resumes from a directory another is still writing.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 writer: bool = True, barrier: Optional[Callable[[], None]] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.writer = writer
        self._barrier = barrier

    def _sync(self) -> None:
        if self._barrier is not None:
            self._barrier()

    # -- meta -------------------------------------------------------------
    @property
    def _meta_path(self) -> str:
        return os.path.join(self.directory, "meta.json")

    def _read_meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {"last_step": None, "best_step": None, "best_acc": -1.0,
                "history": []}

    def _write_meta(self, meta: Dict[str, Any]) -> None:
        with open(self._meta_path, "w") as f:
            json.dump(meta, f, indent=1)

    def meta(self) -> Dict[str, Any]:
        """Public read of meta.json (resume restores best_acc from here)."""
        return self._read_meta()

    # -- save/load ---------------------------------------------------------
    def _write_payload(self, path: str, state: TrainState) -> None:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_payload(state), os.path.join(tmp, PAYLOAD))
        _swap_in(tmp, path)

    def save(self, step: int, state: TrainState, metrics: Dict[str, Any],
             is_best: bool) -> None:
        if self.writer:
            self._save(step, state, metrics, is_best)
        self._sync()

    def _save(self, step: int, state: TrainState, metrics: Dict[str, Any],
              is_best: bool) -> None:
        path = os.path.join(self.directory, f"step_{step}")
        self._write_payload(path, state)
        meta = self._read_meta()
        meta["last_step"] = step
        meta["history"].append({"step": step, **{k: _jsonable(v)
                                                 for k, v in metrics.items()}})
        # an epoch-end save supersedes any mid-epoch safety slot
        if meta.pop("safety", None) is not None:
            shutil.rmtree(os.path.join(self.directory, "safety"),
                          ignore_errors=True)
        if is_best:
            best = os.path.join(self.directory, "best")
            shutil.rmtree(best + ".tmp", ignore_errors=True)
            shutil.copytree(path, best + ".tmp", copy_function=_link_or_copy)
            _swap_in(best + ".tmp", best)
            meta["best_step"] = step
            meta["best_acc"] = _jsonable(metrics.get("weighted_acc", -1.0))
        self._write_meta(meta)
        self._gc()

    def _gc(self) -> None:
        meta = self._read_meta()
        steps = []
        for d in os.listdir(self.directory):
            # sweep the temporary directories of a killed process
            if d.endswith((".tmp", ".old")):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
                continue
            if d.startswith("step_") and d.split("_", 1)[1].isdigit():
                steps.append(int(d.split("_", 1)[1]))
        for s in sorted(steps)[:-self.max_to_keep]:
            if s != meta.get("best_step"):
                shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                              ignore_errors=True)

    def save_safety(self, state: TrainState, epoch: int) -> None:
        """Mid-epoch crash-safety save into the single rotating ``safety``
        slot.  ``epoch`` is the 0-based epoch in progress: resume restarts
        that epoch from this state."""
        if self.writer:
            self._write_payload(os.path.join(self.directory, "safety"), state)
            meta = self._read_meta()
            meta["safety"] = {"epoch": epoch, "opt_step": int(state.step)}
            self._write_meta(meta)
        self._sync()

    def restore(self, state: TrainState, step: Optional[int] = None,
                best: bool = False) -> tuple:
        """Resume the model, optimizer, EMA shadow and accumulation window
        (the reference never reloaded its optimizer).

        Returns ``(state, start_epoch)``.  A pending mid-epoch safety save
        (newer than the last epoch-end save: those clear it) wins, and the
        interrupted epoch restarts from it."""
        meta = self._read_meta()
        if not best and step is None and meta.get("safety") is not None:
            self._restore_state(os.path.join(self.directory, "safety"), state)
            return state, int(meta["safety"]["epoch"])
        if best:
            path = os.path.join(self.directory, "best")
            step = meta.get("best_step") or 0
        else:
            step = step if step is not None else meta.get("last_step")
            if step is None:
                return state, 0
            path = os.path.join(self.directory, f"step_{step}")
        self._restore_state(path, state)
        return state, int(step)

    def _restore_state(self, path: str, state: TrainState) -> None:
        """Load a payload in place: the model's, the optimizer's and the
        shadow's tensors are the ones the state already holds, on its
        device, so the optimizer's parameter references stay valid.  The run's own
        hyperparameters (learning rate, weight decay) stay; the moments,
        counts, shadow and partial window come from the checkpoint."""
        params = list(state.model.parameters())
        device = params[0].device
        # read on the host: the copies below land in the state's own tensors
        # (AdamW's step counts must stay host tensors, or every update syncs)
        payload = torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                             weights_only=True, mmap=True)
        if payload["structure"] != _structure(state):
            raise ValueError(
                f"{path}: optimizer state {payload['structure']} != this "
                f"run's {_structure(state)}\n\n{_HINT}")
        state.model.load_state_dict(payload["model"])
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in state.optimizer.param_groups]
        try:
            state.optimizer.load_state_dict(payload["optimizer"])
        except ValueError as exc:
            raise ValueError(f"{exc}\n\n{_HINT}") from exc
        for g, h in zip(state.optimizer.param_groups, hyper):
            g.update(h)
        with torch.no_grad():
            for e, saved in zip(state.ema or [], payload["ema"] or []):
                e.copy_(saved)
            grads = payload["accum"]["grads"] or [None] * len(params)
            for p, g in zip(params, grads):
                p.grad = None if g is None else g.to(device)
        norm = payload["grad_norm"]
        state.grad_norm = None if norm is None else norm.to(device)
        state.step = int(payload["step"])

    def _payload_path(self, best: bool) -> str:
        """Resolve a manager root (or a payload directory) to a payload."""
        if os.path.exists(os.path.join(self.directory, PAYLOAD)):
            return self.directory
        meta = self._read_meta()
        if best and meta.get("best_step") is not None:
            return os.path.join(self.directory, "best")
        if meta.get("last_step") is not None:
            return os.path.join(self.directory, f"step_{meta['last_step']}")
        raise FileNotFoundError(
            f"no checkpoint found under {self.directory}: expected a manager "
            f"root (meta.json + step_N/best subdirs) or a checkpoint payload "
            f"dir ({PAYLOAD})")

    def params(self, best: bool = True) -> Dict[str, torch.Tensor]:
        """The saved model's ``state_dict``, memory-mapped on the host: the
        optimizer's moments in the same file are never read.

        Takes a manager root (``.../name`` with ``meta.json`` and
        ``step_N``/``best``) or a payload directory (``.../name/best``,
        ``.../name/step_7``); an empty directory raises
        ``FileNotFoundError``."""
        return self._load(best)["model"]

    def _load(self, best: bool) -> Dict[str, Any]:
        path = os.path.join(self._payload_path(best), PAYLOAD)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def restore_params(self, model: nn.Module, best: bool = True) -> nn.Module:
        """Graft the saved weights onto ``model`` in place and return it
        (a pretrain trunk into a classifier, a checkpoint into a serving
        model): every parameter of ``model`` that the checkpoint holds is
        loaded, its shape checked; the others keep their values, and
        checkpoint entries the model lacks are ignored.  Raises if no entry
        matches.  Paths as :meth:`params`."""
        graft_(model, self.params(best), self.directory)
        return model

    def restore_ema_params(self, model: nn.Module, best: bool = True) -> nn.Module:
        """Graft the saved EMA shadow (runs trained with ``--ema_decay``)
        onto ``model``, as :meth:`restore_params` grafts the weights."""
        payload = self._load(best)
        names = list(payload["model"])
        if not payload.get("ema"):
            raise FileNotFoundError(
                f"{self._payload_path(best)} has no EMA shadow in its optimizer "
                f"state — the run was not trained with --ema_decay")
        if len(names) != len(payload["ema"]):
            raise ValueError(f"{self._payload_path(best)}: {len(payload['ema'])} "
                             f"EMA tensors for {len(names)} parameters")
        graft_(model, dict(zip(names, payload["ema"])), self.directory)
        return model


def graft_(model: nn.Module, saved: Dict[str, torch.Tensor], source: str = "checkpoint"
           ) -> List[str]:
    """Copy every entry of ``saved`` whose name ``model`` has into the
    model's tensor, in place (a differing shape raises ``RuntimeError``
    "size mismatch"); the model's other tensors stay, entries it lacks are
    ignored.  Returns the names the model has and ``saved`` lacks; raises
    ``ValueError`` if no name matched."""
    own = model.state_dict()
    matched = {k: v for k, v in saved.items() if k in own}
    if not matched:
        raise ValueError(
            f"{source}: none of its {len(saved)} tensors matches a parameter "
            f"of the {type(model).__name__} (e.g. {next(iter(saved), None)!r} "
            f"vs {next(iter(own), None)!r})")
    model.load_state_dict(matched, strict=False)
    return [k for k in own if k not in matched]


def load_merged_msgpack(path: str, cfg, model: Optional[nn.Module] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port-named tensors (on the host) of a ``merge`` output: a flax
    msgpack of top-level subtrees (``pianobart``, ``lm_head``, ...) in flax
    layout, written by the port's ``merge`` or the JAX package's ``pbx
    merge``; its layer counts are checked against ``cfg``.  With ``model``,
    only the subtrees the model has are returned, and a file none of whose
    top-level keys the model has raises ``SystemExit``.  Shapes are checked
    where the entries are grafted (:func:`graft_`)."""
    from ..compat.flax_msgpack import read_msgpack
    from ..compat.from_jax import lm_state_dict_from_jax
    tree = read_msgpack(path)
    if model is not None:
        own = sorted({k.split(".", 1)[0] for k in model.state_dict()})
        grafted = [k for k in tree if k in own]
        if not grafted:
            raise SystemExit(
                f"{path} contains keys {sorted(tree)} but none match this "
                f"model's parameter tree {own} — wrong architecture or not a "
                f"`merge` output")
        tree = {k: tree[k] for k in grafted}
    return lm_state_dict_from_jax(tree, cfg)


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v
