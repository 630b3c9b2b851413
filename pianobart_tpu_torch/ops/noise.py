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

The bar-level and element-level variants (``bar_deletion``,
``token_mask_element``, ``bar_mask``, ``bar_mask_element``,
``bar_infilling``) are defined as in the JAX package, which defines them
behind the reference's flags; the shipped ``corrupt_batch`` never picks
them.  The element-level ones return a ``(B, S, 8)`` loss mask.  Bar
infilling's walk over the bars has a token budget that makes each step
depend on the ones before, so it is a loop of ``FIELD_SIZES[0]`` steps over
a ``(B, 10)`` state on the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import vocab as V

__all__ = ["token_deletion", "bar_deletion", "token_mask", "token_mask_element",
           "bar_mask", "bar_mask_element", "sentence_permutation",
           "token_infilling", "bar_infilling", "document_rotation", "corrupt",
           "corrupt_batch"]

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


def bar_deletion(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """Bar-level deletion: every octuple of ``int(bar_max * p)`` bars chosen
    uniformly among ``0..bar_max-1`` (``bar_max`` the last row's bar id, as
    the reference reads it from a packed window) is deleted, the rest
    compacted in order and re-padded.  The reference's loss mask over bars
    cannot broadcast to positions; as in the JAX package the loss covers
    every position from the first deletion on."""
    B, S, _ = x.shape
    NB = V.FIELD_SIZES[0]
    bars = x[..., 0].long()
    bar_max = bars[:, -1:]                                     # (B, 1)
    u = torch.rand((B, NB), device=x.device, generator=generator)
    in_range = torch.arange(NB, device=x.device)[None, :] < bar_max
    k = (bar_max.float() * p).long()
    ranks = torch.where(in_range, u, 2.0).argsort(dim=1).argsort(dim=1)
    delete = torch.gather((ranks < k) & in_range, 1, bars)
    order = torch.sort(delete.to(torch.uint8), dim=1, stable=True).indices
    rows = torch.arange(S, device=x.device)
    n_del = delete.sum(dim=1, keepdim=True)
    out = torch.where((rows >= S - n_del)[..., None], _row(V.PAD, x),
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


def token_mask_element(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """Element-level 80/10/10 masking: of ``round(S*p*8)`` chosen elements,
    80% take their field's ``<MASK>`` id, 10% a random id of the field, 10%
    stay; the loss mask is per element, ``(B, S, 8)``."""
    B, S, F = x.shape
    n = S * F
    k = round(S * p * 8)
    n80 = round(k * 0.8)
    n10 = round(k * 0.1)
    rank = _ranks(B, n, x.device, generator).view(B, S, F)
    rand_rows = _rand_rows((B, S), x, generator)
    out = torch.where(rank < n80, _row(V.MASK, x), x)
    out = torch.where((rank >= n80) & (rank < n80 + n10), rand_rows, out)
    return out, rank < k


def _bar_class_mask(shape, p: float, device, generator) -> torch.Tensor:
    """The reference's ``generate_mask``: class 3 ("random") with
    probability 0.1*p, class 1 ("[mask]") with 0.9*p, else 0.  Its
    "original" class 2 is unreachable (a duplicated condition), and stays
    so."""
    u = torch.rand(shape, device=device, generator=generator)
    return torch.where(u < p * 0.1, 3, torch.where(u < p, 1, 0))


def _exempt_ends(role: torch.Tensor) -> torch.Tensor:
    """Rows 0 and S-1 take no role."""
    S = role.shape[1]
    ends = torch.zeros(S, dtype=torch.bool, device=role.device)
    ends[[0, S - 1]] = True
    return role.masked_fill(ends.view(1, S, *([1] * (role.dim() - 2))), 0)


def bar_mask(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """Bar-level masking: every octuple of a bar of class 1 becomes
    ``<MASK>``, of class 3 a random octuple (:func:`_bar_class_mask` per
    bar id); rows 0 and S-1 are exempt."""
    B, S, _ = x.shape
    classes = _bar_class_mask((B, V.FIELD_SIZES[0]), p, x.device, generator)
    role = _exempt_ends(torch.gather(classes, 1, x[..., 0].long()))
    rand_rows = _rand_rows((B, S), x, generator)
    out = torch.where((role == 1)[..., None], _row(V.MASK, x), x)
    out = torch.where((role == 3)[..., None], rand_rows, out)
    return out, role > 0


def bar_mask_element(x: torch.Tensor, p: float, generator=None) -> Corruption:
    """Bar x instrument element-level masking: each (bar, instrument, field)
    draws a class (:func:`_bar_class_mask`) shared by that field of every
    octuple of the group; the loss mask is per element, ``(B, S, 8)``; rows
    0 and S-1 are exempt."""
    B, S, F = x.shape
    n_groups = V.FIELD_SIZES[0] * V.FIELD_SIZES[2]
    classes = _bar_class_mask((B, n_groups, F), p, x.device, generator)
    group = (x[..., 0] * V.FIELD_SIZES[2] + x[..., 2]).long()
    role = _exempt_ends(torch.gather(classes, 1, group[..., None].expand(B, S, F)))
    rand_rows = _rand_rows((B, S), x, generator)
    out = torch.where(role == 1, _row(V.MASK, x), x)
    out = torch.where(role == 3, rand_rows, out)
    return out, role > 0


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
    row1 = torch.where(span_del[..., None], _row(V.MASK, x), x[:, None].expand(B, A, S, F))
    return _first_fit(x, offs, w, row1)


def _first_fit(x: torch.Tensor, offs: torch.Tensor, w: torch.Tensor,
               row1: torch.Tensor) -> Corruption:
    """Emit each attempt's rows (position i writes ``w`` rows from offset
    ``offs``: ``row1``, then a ``<MASK>`` where ``w`` is 2) and keep the
    first attempt of at most S rows, else the sample unchanged."""
    B, A, S = w.shape
    F = x.shape[-1]
    total = w.sum(dim=-1)                           # (B, A)
    ok = total <= S
    # Scatter the emitted rows into a (2S + 2)-row buffer: rows >= S and the
    # two sink rows (positions that emit nothing) are cut away.
    mask_row = _row(V.MASK, x)
    idx1 = torch.where(w >= 1, offs, 2 * S)
    idx2 = torch.where(w == 2, offs + 1, 2 * S + 1)
    buf = torch.zeros((B, A, 2 * S + 2, F), dtype=x.dtype, device=x.device)
    buf.scatter_(2, idx1[..., None].expand(-1, -1, -1, F), row1)
    buf.scatter_(2, idx2[..., None].expand(-1, -1, -1, F),
                 mask_row.expand(B, A, S, F))
    pos = torch.arange(S, device=x.device)
    out = torch.where((pos[None, None, :] < total[..., None])[..., None],
                      buf[:, :, :S], _row(V.PAD, x))
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    pick = torch.gather(out, 1, first[:, None, None, None].expand(B, 1, S, F))[:, 0]
    out = torch.where(ok.any(dim=1)[:, None, None], pick, x)
    return out, (out != x).any(dim=-1)


def bar_infilling(x: torch.Tensor, p: float, generator=None,
                  lam: float = 3.0, max_attempts: int = MAX_ATTEMPTS
                  ) -> Corruption:
    """Poisson span infilling at bar level.

    Walk the bars 0..FIELD_SIZES[0]-1; with probability ``p/lam`` draw span
    ~ Poisson(lam): span 0 appends a ``<MASK>`` after the bar's last octuple
    (a bar with octuples only); span > 0 deletes the octuples of bars
    ``i..i+span-1`` and puts one ``<MASK>`` in place of the first octuple
    of the first non-empty one, if those octuples keep the total deleted
    within ``round(S*p)``, and the walk skips the span.  Retried as
    :func:`token_infilling` is."""
    B, S, F = x.shape
    A = max_attempts
    NB = V.FIELD_SIZES[0]
    dev = x.device
    num_mask = round(S * p)
    bars = x[..., 0].long()                                   # (B, S)
    rows = torch.arange(S, device=dev).expand(B, S)
    counts = torch.zeros((B, NB), dtype=torch.long, device=dev).scatter_add_(
        1, bars, torch.ones_like(bars))
    first_of_bar = torch.full((B, NB), S, dtype=torch.long, device=dev).scatter_reduce_(
        1, bars, rows, "amin").masked_fill_(counts == 0, 0)
    last_of_bar = torch.zeros((B, NB), dtype=torch.long, device=dev).scatter_reduce_(
        1, bars, rows, "amax")
    cum = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                     counts.cumsum(dim=1)], dim=1)            # (B, NB + 1)
    # the first non-empty bar at or after each bar (NB where none)
    idx = torch.where(counts > 0, torch.arange(NB, device=dev), NB)
    next_nonempty = idx.flip(1).cummin(dim=1).values.flip(1)

    fire = torch.rand((B, A, NB), device=dev, generator=generator) < p / max(1.0, lam)
    spans = torch.poisson(torch.full((B, A, NB), float(lam), device=dev),
                          generator=generator).long()

    # the walk: which bars start a span deletion, with the budget it spends
    skip = torch.zeros((B, A), dtype=torch.long, device=dev)
    budget = torch.zeros((B, A), dtype=torch.long, device=dev)
    do_span = torch.zeros((B, A, NB), dtype=torch.bool, device=dev)
    his = torch.zeros((B, A, NB), dtype=torch.long, device=dev)
    for i in range(NB):
        span = spans[..., i]
        hi = (span + i).clamp(max=NB)
        cur = torch.gather(cum, 1, hi) - cum[:, i:i + 1]
        free = skip == 0
        start = free & fire[..., i] & (span > 0) & (budget + cur <= num_mask)
        skip = torch.where(free, torch.where(start, span - 1, 0), skip - 1)
        budget = budget + torch.where(start, cur, 0)
        do_span[..., i] = start
        his[..., i] = hi
    # the bars each started span covers; one inside a span but not its
    # start was skipped by the walk, so it appends nothing
    starts = do_span.long()
    diff = torch.zeros((B, A, NB + 1), dtype=torch.long, device=dev)
    diff[..., :NB] += starts
    diff.scatter_add_(2, his, -starts)
    covered = diff.cumsum(dim=-1)[..., :NB] > 0             # bars in a span
    covered_before = covered & ~do_span                      # skipped by the walk
    do_append = (fire & (spans == 0) & (counts > 0)[:, None, :] & ~covered_before)

    # op per position: 0 keep, 1 append a <MASK> after, 2 delete, 3 <MASK>
    bars_a = bars[:, None, :].expand(B, A, S)
    op = torch.where(torch.gather(covered, 2, bars_a), 2, 0)
    op = torch.cat([op, torch.zeros((B, A, 1), dtype=op.dtype, device=dev)], dim=-1)
    first_ne = next_nonempty[:, None, :].expand(B, A, NB)
    masks = do_span & (first_ne < his)
    first_pos = torch.gather(first_of_bar[:, None, :].expand(B, A, NB), 2,
                             first_ne.clamp(max=NB - 1))
    op.scatter_(2, torch.where(masks, first_pos, S), 3)
    append_pos = torch.where(do_append, last_of_bar[:, None, :].expand(B, A, NB), S)
    op.scatter_(2, append_pos, 1)
    op = op[..., :S]

    w = torch.where(op == 2, 0, torch.where(op == 1, 2, 1))
    offs = torch.cumsum(w, dim=-1) - w
    row1 = torch.where((op == 3)[..., None], _row(V.MASK, x), x[:, None].expand(B, A, S, F))
    return _first_fit(x, offs, w, row1)


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
