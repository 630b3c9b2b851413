"""Run a function on several ranks of one host: ``spawn(fn, world, args)``
starts ``world`` processes (the ``spawn`` start method), each with a process
group over a ``FileStore`` in a fresh directory, calls ``fn(rank, world,
*args)`` in each, and tears the group down.  For checks and tests of the
mesh path; a user's job is started by ``torch.distributed.run``.

``fn`` must be importable by name (a module-level function).  A failure on
any rank raises in the caller, after every process has ended.  With
``backend=None`` no process group is made (``fn`` makes its own, as the CLI
does from the environment).
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _entry(rank: int, fn: Callable, world: int, backend: Optional[str], store: str,
           args: Sequence, threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    if backend is None:
        fn(rank, world, *args)
        return
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), backend: Optional[str] = "gloo",
          threads: Optional[int] = None) -> None:
    """``fn(rank, world, *args)`` on ``world`` ranks over ``backend``; each
    process uses ``threads`` CPU threads when given."""
    tmp = tempfile.mkdtemp(prefix="pbx_spawn_")
    try:
        mp.spawn(_entry, args=(fn, world, backend, os.path.join(tmp, "store"),
                               tuple(args), threads), nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
