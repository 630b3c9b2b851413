"""Structured metrics logging (``pianobart_tpu/utils/logging.py``).

The reference logs per-step losses to stdout and appends epoch lines to a
plain ``result/**/log`` file (``main.py:90-92``).  That file stays, beside a
machine-readable ``metrics.jsonl`` stream (one JSON object per event) and,
when ``tensorboardX`` imports, a TensorBoard stream of the epoch events.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return np.round(v.astype(np.float64), 6).tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class MetricsLogger:
    def __init__(self, directory: str, name: str = "metrics",
                 echo: bool = True, tensorboard: bool = True,
                 enabled: bool = True):
        # ``enabled=False``: the ranks of a job other than rank 0 write and
        # print nothing
        self.enabled = enabled
        os.makedirs(directory, exist_ok=True)
        self.jsonl_path = os.path.join(directory, f"{name}.jsonl")
        self.log_path = os.path.join(directory, "log")
        self.echo = echo
        self._t0 = time.time()
        self._last_echo_q = 0
        # TensorBoard beside the jsonl when tensorboardX is importable
        self._tb = None
        if tensorboard and enabled:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(directory, "tb"))
            except Exception:
                self._tb = None

    def log(self, event: str, **fields: Any) -> None:
        if not self.enabled:
            return
        rec = {"event": event, "t": round(time.time() - self._t0, 3)}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None and event == "epoch":
            self._tb_scalars(rec)

    def _tb_scalars(self, rec: Dict[str, Any]) -> None:
        step = int(rec.get("epoch", 0))

        def emit(prefix: str, value: Any) -> None:
            if isinstance(value, dict):
                for k, v in value.items():
                    emit(f"{prefix}/{k}", v)
            elif isinstance(value, (int, float)) and not isinstance(value, bool):
                self._tb.add_scalar(prefix, value, step)
            elif isinstance(value, list) and value and all(
                    isinstance(x, (int, float)) for x in value):
                for i, x in enumerate(value):
                    self._tb.add_scalar(f"{prefix}/{i}", x, step)

        for k, v in rec.items():
            if k not in ("event", "t", "epoch"):
                emit(k, v)
        self._tb.flush()

    def epoch_line(self, text: str) -> None:
        """Reference-style append-only epoch log (main.py:90-92)."""
        if not self.enabled:
            return
        with open(self.log_path, "a") as f:
            f.write(text + "\n")
        if self.echo:
            print(text)

    def step_echo(self, step: int, metrics: Dict[str, Any],
                  every: int = 50) -> None:
        """Print loss and accuracy when ``step`` passes a multiple of
        ``every``.  Callers advance ``step`` in strides (a dispatch's steps)
        that rarely divide ``every``, hence the quotient.  A tensor value is
        read (a host sync) only when the line prints."""
        q = step // every
        if self.enabled and self.echo and q > self._last_echo_q:
            self._last_echo_q = q
            loss = float(metrics.get("loss", np.nan))
            acc = metrics.get("weighted_acc")
            acc = float(acc) if acc is not None else float("nan")
            sys.stdout.write(f"step {step}: loss {loss:.4f} acc {acc:.4f}\n")
