"""Profiling and step timing, the counterpart of
``pianobart_tpu/utils/profiling.py``.

Usage::

    with trace("/tmp/pbt_trace"):
        pretrain_step(state, batch, generator)

    timer = StepTimer()
    with timer:
        timer.observe(pretrain_step(state, batch, generator))
    print(timer.last_ms)
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import torch

__all__ = ["trace", "StepTimer", "block"]

TRACE_FILE = "trace.json"
MEMORY_FILE = "memory_snapshot.pickle"


@contextlib.contextmanager
def trace(log_dir: str, with_memory: bool = True) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the CPU and, where there is one, the CUDA
    device around the body; the Chrome trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or ``chrome://tracing``).

    ``with_memory`` also records the CUDA caching allocator's history and
    dumps a snapshot to ``log_dir/memory_snapshot.pickle`` at the end (view
    it at ``pytorch.org/memory_viz``): the counterpart of the JAX package's
    ``memory.prof``, in PyTorch's format.  It needs CUDA and raises without
    it."""
    if with_memory and not torch.cuda.is_available():
        raise RuntimeError("trace(with_memory=True) records the CUDA allocator: "
                           "no CUDA device is available")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if with_memory:
        torch.cuda.memory._record_memory_history(max_entries=100_000)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        if with_memory:
            torch.cuda.memory._dump_snapshot(os.path.join(log_dir, MEMORY_FILE))
    finally:
        if with_memory:
            torch.cuda.memory._record_memory_history(enabled=None)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (nested
    dicts, lists and tuples; other leaves are ignored)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock timer that waits for the observed result's devices on
    exit."""

    def __init__(self):
        self.last_ms: Optional[float] = None
        self.total_s: float = 0.0
        self.count: int = 0
        self._t0: Optional[float] = None
        self._result = None

    def observe(self, result):
        """Register the step output to synchronize on."""
        self._result = result
        return result

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._result is not None:
            block(self._result)
            self._result = None
        dt = time.perf_counter() - self._t0
        self.last_ms = dt * 1e3
        self.total_s += dt
        self.count += 1
        return False

    @property
    def mean_ms(self) -> float:
        return self.total_s / max(self.count, 1) * 1e3
