"""BART denoising corruptions on the device, the counterpart of
``pianobart_tpu/ops/noise.py``.

Each sample of a pretrain batch receives one of five corruptions chosen
uniformly (the shipped configuration: octuple-level deletion, 80/10/10
masking, bar permutation, Poisson span infilling, rotation).  Every function
here is a batched tensor program over ``(B, S, 8)`` id grids: no host loop
over samples and no host sync, so a train step enqueues its corruption
without waiting on the device.  Each corruption returns ``(corrupted (B, S,
8), loss (B, S) bool)``.

The random draws come from an explicit ``torch.Generator`` on the batch's
device.  They are not the JAX package's draws (different generators), so the
two agree by distribution, which ``tests/test_torch_noise.py`` checks.

Span infilling is a sequential walk in the reference (a ``lax.scan`` over S
with a skip counter, inside up to 10 retries).  Here the positions the walk
visits are found by pointer doubling over the jump map ``i -> next(i)``
(log2 S rounds of a gather and a scatter), and all 10 attempts run at once
as a ``(B, 10, S)`` batch, the first one that fits being kept.

The bar-level and element-level variants are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import vocab as V

__all__ = ["token_deletion", "token_mask", "sentence_permutation",
           "token_infilling", "document_rotation", "corrupt", "corrupt_batch"]

Corruption = Tuple[torch.Tensor, torch.Tensor]
N_CORRUPTIONS = 5
MAX_ATTEMPTS = 10


def _row(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _rand_rows(shape, like: torch.Tensor, generator) -> torch.Tensor:
    """Random octuples, each field uniform over its vocabulary."""
    u = torch.rand(tuple(shape) + (8,), device=like.device, generator=generator)
    sizes = torch.tensor(V.FIELD_SIZES, dtype=torch.float32, device=like.device)
    return (u * sizes).to(like.dtype)


def _ranks(B: int, S: int, device, generator) -> torch.Tensor:
    """(B, S): each row a uniform random permutation of 0..S-1."""
    u = torch.rand((B, S), device=device, generator=generator)
    return u.argsort(dim=1).argsort(dim=1)


def _take_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (B, S, 8) rows gathered by order (B, S)."""
    return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))


# ---------------------------------------------------------------------- 1
def token_deletion(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """Delete ``int(S*p)`` random octuples, compact the rest in order and
    re-pad; the loss covers every position from the first deletion on."""
    B, S, _ = x.shape
    length = int(S * p)
    delete = _ranks(B, S, x.device, generator) < length
    order = torch.sort(delete.to(torch.uint8), dim=1, stable=True).indices
    rows = torch.arange(S, device=x.device)
    out = torch.where((rows >= S - length)[None, :, None], _row(V.PAD, x),
                      _take_rows(x, order))
    first_del = torch.where(delete, rows, S).amin(dim=1, keepdim=True)
    return out, (rows >= first_del) & (first_del < S)


# ---------------------------------------------------------------------- 2
def token_mask(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """BERT-style 80/10/10 masking at octuple level: of ``round(S*p)``
    chosen rows, 80% become ``<MASK>``, 10% random octuples, 10% stay."""
    B, S, _ = x.shape
    k = round(S * p)
    n80 = round(k * 0.8)
    n10 = round(k * 0.1)
    rank = _ranks(B, S, x.device, generator)
    rand_rows = _rand_rows((B, S), x, generator)
    out = torch.where((rank < n80)[..., None], _row(V.MASK, x), x)
    out = torch.where(((rank >= n80) & (rank < n80 + n10))[..., None], rand_rows, out)
    return out, rank < k


# ---------------------------------------------------------------------- 3
def sentence_permutation(x: torch.Tensor, generator=None) -> Corruption:
    """Shuffle the bars (rows sharing a Bar id), keeping the order inside
    each bar: iid uniform priorities per bar id, stable sort."""
    B = x.shape[0]
    prio = torch.rand((B, V.FIELD_SIZES[0]), device=x.device, generator=generator)
    order = torch.sort(torch.gather(prio, 1, x[..., 0].long()), dim=1,
                       stable=True).indices
    out = _take_rows(x, order)
    return out, (out != x).any(dim=-1)


# ---------------------------------------------------------------------- 4
def token_infilling(x: torch.Tensor, p: float, generator=None,
                    lam: float = 3.0, max_attempts: int = MAX_ATTEMPTS
                    ) -> Corruption:
    """Poisson span infilling at octuple level.

    Walk the sequence; with probability ``p/lam`` draw span ~ Poisson(lam):
    span 0 inserts a ``<MASK>`` after the current octuple, span > 0 replaces
    the next ``span`` octuples (the current one included) with one
    ``<MASK>``.  An attempt whose output is longer than S is retried, up to
    ``max_attempts`` in all; if none fits the sample stays uncorrupted.
    """
    B, S, F = x.shape
    A = max_attempts
    dev = x.device
    fire = torch.rand((B, A, S), device=dev, generator=generator) < p / max(1.0, lam)
    spans = torch.poisson(torch.full((B, A, S), float(lam), device=dev),
                          generator=generator).long()
    span_del = fire & (spans > 0)
    ins_after = fire & (spans == 0)

    # Positions the walk visits: 0, next(0), next(next(0)), ... with
    # next(i) = i + span (span deletion) or i + 1, capped at the sink S.
    pos = torch.arange(S, device=dev)
    nxt = torch.where(span_del, pos + spans, pos + 1).clamp(max=S)
    jump = torch.cat([nxt, torch.full((B, A, 1), S, device=dev)], dim=-1)
    seen = torch.zeros((B, A, S + 1), dtype=torch.int32, device=dev)
    seen[..., 0] = 1
    hop = 1
    while hop < S:      # after the round with jump = next^hop, seen covers 2*hop steps
        seen = seen.scatter_add(-1, jump, seen).clamp_(max=1)
        jump = torch.gather(jump, -1, jump)
        hop *= 2
    visited = seen[..., :S].bool()

    w = torch.where(visited, torch.where(ins_after, 2, 1), 0)
    offs = torch.cumsum(w, dim=-1) - w              # write offset of each position
    total = w.sum(dim=-1)                           # (B, A)
    ok = total <= S

    # Scatter the emitted rows into a (2S + 2)-row buffer: rows >= S and the
    # two sink rows (positions that emit nothing) are cut away.
    xa = x[:, None].expand(B, A, S, F)
    mask_row = _row(V.MASK, x)
    row1 = torch.where(span_del[..., None], mask_row, xa)
    idx1 = torch.where(w >= 1, offs, 2 * S)
    idx2 = torch.where(w == 2, offs + 1, 2 * S + 1)
    buf = torch.zeros((B, A, 2 * S + 2, F), dtype=x.dtype, device=dev)
    buf.scatter_(2, idx1[..., None].expand(-1, -1, -1, F), row1)
    buf.scatter_(2, idx2[..., None].expand(-1, -1, -1, F),
                 mask_row.expand(B, A, S, F))
    out = torch.where((pos[None, None, :] < total[..., None])[..., None],
                      buf[:, :, :S], _row(V.PAD, x))

    # the first attempt that fits, else the sample unchanged
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    pick = torch.gather(out, 1, first[:, None, None, None].expand(B, 1, S, F))[:, 0]
    out = torch.where(ok.any(dim=1)[:, None, None], pick, x)
    return out, (out != x).any(dim=-1)


# ---------------------------------------------------------------------- 5
def document_rotation(x: torch.Tensor, generator=None) -> Corruption:
    """Rotate by r ~ U{0..S-1}; the loss covers everything unless r == 0."""
    B, S, _ = x.shape
    r = torch.randint(0, S, (B, 1), device=x.device, generator=generator)
    order = (torch.arange(S, device=x.device)[None, :] + r) % S
    return _take_rows(x, order), (r != 0).expand(B, S)


# ----------------------------------------------------------------------
def corrupt_batch(batch: torch.Tensor, generator=None, p: float = 0.15
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corrupt a ``(B, S, 8)`` batch, each sample by one corruption chosen
    uniformly; returns ``(corrupted, loss_mask (B, S, 8) float32)``.

    All five corruptions are computed for the whole batch and each sample
    keeps its choice's: a few cheap tensor programs, and no host sync."""
    B = batch.shape[0]
    choice = torch.randint(0, N_CORRUPTIONS, (B,), device=batch.device,
                           generator=generator)
    results = (token_deletion(batch, p, generator),
               token_mask(batch, p, generator),
               sentence_permutation(batch, generator),
               token_infilling(batch, p, generator),
               document_rotation(batch, generator))
    out = torch.stack([r[0] for r in results])      # (5, B, S, 8)
    loss = torch.stack([r[1] for r in results])     # (5, B, S)
    sel = choice[None, :, None]
    out = torch.gather(out, 0, sel[..., None].expand(1, *batch.shape))[0]
    loss = torch.gather(loss, 0, sel.expand(1, *loss.shape[1:]))[0]
    return out, loss[..., None].float().expand(*loss.shape, 8).contiguous()


def corrupt(x: torch.Tensor, generator=None, p: float = 0.15) -> Corruption:
    """One uniformly chosen corruption of one ``(S, 8)`` sample; returns
    ``(corrupted (S, 8), loss (S,) bool)``."""
    out, loss = corrupt_batch(x[None], generator, p)
    return out[0], loss[0, :, 0].bool()
