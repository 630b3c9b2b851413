"""Train state and optimizer, the counterpart of
``pianobart_tpu/train/state.py``: AdamW (lr 2e-5, betas (0.9, 0.999), eps
1e-8, weight decay 0.01 on every parameter, as optax's ``adamw`` with no
mask) after a global-norm gradient clip at 3.0 that keeps the norm it
computes.

Only the constant learning rate is here; schedules, gradient accumulation,
the parameter EMA and checkpointing come with the runner.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
from torch import nn

__all__ = ["TrainState", "make_optimizer", "create_train_state",
           "clip_by_global_norm_logged", "get_grad_norm"]


@dataclasses.dataclass
class TrainState:
    """The model (updated in place by each step), its optimizer, the number
    of steps taken, and the pre-clip gradient norm of the last step (a
    device tensor, ``None`` before the first)."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None


def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float = 2e-5,
                   weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """AdamW with the reference's settings and a constant learning rate.

    ``torch.optim.AdamW`` decays ``p *= 1 - lr*wd`` before its Adam step,
    which is optax's ``p -= lr * (adam + wd*p)`` written in another order."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(model: nn.Module, learning_rate: float = 2e-5,
                       weight_decay: float = 0.01) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), learning_rate,
                                            weight_decay))


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


def get_grad_norm(state: TrainState) -> Optional[torch.Tensor]:
    """Pre-clip global gradient norm of the last step, or ``None``."""
    return state.grad_norm
