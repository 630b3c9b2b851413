"""Serving backend on token windows (``pianobart_tpu/serve/app.py``).

:class:`GenerationService` holds one model, loaded lazily and reused across
requests, and MICRO-BATCHES concurrent requests: a worker thread drains the
queue into one batched KV-cached decode, with batch sizes bucketed to powers
of two.  The MIDI-file entry, the HTTP routes and the demo come with the
port of the MIDI parser, writer and tokenizer.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["GenerationService"]


class _Pending:
    """One queued generation request."""

    __slots__ = ("intro", "seed", "event", "result", "error", "served_n")

    def __init__(self, intro, seed):
        self.intro = intro
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.served_n = 1  # batch size this request was served in


def _batch_seed(seeds: List[int]) -> int:
    """One seed for the batch-level sampling stream, folded from the request
    seeds in order (a batch of one keeps its request's seed)."""
    s = int(seeds[0])
    for x in seeds[1:]:
        s = (s * 1_000_003 + int(x)) % (1 << 63)
    return s


class GenerationService:
    """Holds the model, loaded lazily, reused across calls.

    ``model`` defaults to the flagship bf16 ``PianoBartLM`` with random
    weights from ``seed``; ``device`` defaults to CUDA and raises without it.
    """

    def __init__(self, model=None, cfg=None, device: DeviceLike = None,
                 seed: int = 0, max_batch: int = 8,
                 batch_window_s: float = 0.02):
        self.device = resolve_device(device)
        self.model = model
        self._cfg_arg = cfg  # None -> flagship dims in bf16
        self.seed = seed
        self._ready = model is not None
        self.cfg = None if model is None else model.cfg
        self._lock = threading.Lock()
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self._cond = threading.Condition()
        self._queue: list = []
        self._worker: Optional[threading.Thread] = None
        self.batch_sizes_served: list = []  # observability / tests

    def _ensure(self):
        if self._ready:
            return
        with self._lock:
            if self._ready:
                return
            from ..compat.from_jax import init_lm
            from ..models.config import PianoBartConfig
            # serving holds bf16 weights: the decode step then casts nothing
            self.cfg = self._cfg_arg or PianoBartConfig(
                dtype=torch.bfloat16, param_dtype=torch.bfloat16)
            self.model = init_lm(self.cfg, self.seed, self.device)
            self._ready = True

    @property
    def ready(self) -> bool:
        return self._ready

    def _bucket_of(self, n: int) -> int:
        """Decode batch-shape bucket for a drain of n requests: the next
        power of two, so at most log2(max_batch)+1 shapes ever run."""
        bucket = 1
        while bucket < n:
            bucket *= 2
        return bucket

    def warmup(self, buckets=None) -> dict:
        """Run one decode at every reachable bucket shape before the first
        live request: it builds the flash kernel and fills the CUDA caching
        allocator and the matmul heuristics at each shape.  Returns
        {bucket: seconds}."""
        self._ensure()
        if buckets is None:
            # exactly the shapes the worker's drain can produce
            buckets = sorted({self._bucket_of(n)
                              for n in range(1, self.max_batch + 1)})
        timings = {}
        for b in buckets:
            intros = np.zeros((b, self.cfg.max_len, 8), dtype=np.int64)
            t0 = time.time()
            self._decode_batch(intros, list(range(b)))
            timings[int(b)] = round(time.time() - t0, 3)
        return timings

    # -- micro-batching queue -------------------------------------------------

    def submit(self, intro_window, seed: int = 0):
        """Enqueue one (S, 8) intro; blocks until its continuation is ready.

        Thread-safe; concurrent submitters are served by ONE batched decode.
        Outputs are sampled from a batch-level stream, so per-request seed
        reproducibility holds only for a batch of one.
        """
        return self._submit_req(intro_window, seed).result

    def _submit_req(self, intro_window, seed: int = 0) -> _Pending:
        req = _Pending(intro_window, seed)
        with self._cond:
            self._queue.append(req)
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._worker_loop,
                                                daemon=True)
                self._worker.start()
            self._cond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req

    def _decode_batch(self, intros, seeds):
        """(B, S, 8) intros -> (B, S, 8) continuations as numpy."""
        self._ensure()
        from ..decode import generate
        gen = torch.Generator(device=self.device).manual_seed(_batch_seed(seeds))
        out = generate(self.model, intros, generator=gen, device=self.device)
        return out.cpu().numpy()

    def _worker_loop(self):
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
            # small gathering window lets concurrent requests coalesce
            time.sleep(self.batch_window_s)
            with self._cond:
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
            if not batch:
                continue
            try:
                n = len(batch)
                bucket = self._bucket_of(n)  # bounded set of batch shapes
                intros = np.stack([r.intro for r in batch]
                                  + [batch[-1].intro] * (bucket - n))
                seeds = [r.seed for r in batch]
                outs = self._decode_batch(intros, seeds)
                self.batch_sizes_served.append(n)
                for r, o in zip(batch, outs[:n]):
                    r.result = o
                    r.served_n = n
            except BaseException as exc:  # deliver, don't kill the worker
                for r in batch:
                    r.error = exc
            finally:
                for r in batch:
                    r.event.set()
