"""Fréchet shape-similarity ("FAD") generation metrics, the counterpart of
``pianobart_tpu/utils/fad.py``.

The reference scores generation with the ``shapesimilarity`` package
(nelsonwenner/shape-similarity) on the pitch track
(``finetune_generation.py:180-225``): the similarity of 10-token windows
(FAD) and of per-bar segments (FAD-BAR), each curve ``[(0, y0), (1, y1),
...]``.  Each pair is procrustes-normalized (resampled to 50 points of
equal arc length, centred, RMS-scaled), rotations are searched (the
procrustes angle and 10 probes over ±π), the least discrete Fréchet
distance is taken and mapped to a score with the repo's patched
denominator::

    max(0, 1 - minF / (1e-8 + geo_avg_len / sqrt(2)))

The numpy half is a copy of the JAX package's (it imports no JAX), held to
``tests/vendored_shapesimilarity.py``, a per-pair reconstruction of the
upstream package, except that the windows and bar groups are scored in one
Fréchet pass (a batch's at once in :func:`generation_fad`), with the same
numbers (the per-sample loop over bars took about 100 s an eval batch of 8
windows of 1024 rows on a CPU).  :func:`shape_similarity_batch_torch` computes the
window FAD of a whole batch in one batched call on a torch device (the
``--fad_jit`` path): the Fréchet recursion runs along the anti-diagonals,
every window and rotation at once, in float64.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

ESTIMATION_POINTS = 50
ROTATION_ROUNDS = 10
RESTRICT_ROTATION = math.pi


def _rebalance(curves: np.ndarray, n: int = ESTIMATION_POINTS) -> np.ndarray:
    """Resample (B, P, 2) polylines to n points at equal arc length."""
    B, P, _ = curves.shape
    seg = np.linalg.norm(np.diff(curves, axis=1), axis=-1)      # (B, P-1)
    cum = np.concatenate([np.zeros((B, 1)), np.cumsum(seg, axis=1)], axis=1)
    total = cum[:, -1:]
    total = np.where(total == 0, 1.0, total)
    t = cum / total                                             # (B, P) in [0,1]
    targets = np.linspace(0.0, 1.0, n)[None, :]                 # (1, n)
    # For each target, find the segment it falls in.
    idx = np.clip(
        np.apply_along_axis(np.searchsorted, 1, t, targets[0], side="right") - 1,
        0, P - 2)                                               # (B, n)
    b = np.arange(B)[:, None]
    t0 = t[b, idx]
    t1 = t[b, idx + 1]
    denom = np.where(t1 - t0 == 0, 1.0, t1 - t0)
    w = np.clip((targets - t0) / denom, 0.0, 1.0)[..., None]
    return curves[b, idx] * (1 - w) + curves[b, idx + 1] * w


def _procrustes_normalize(curves: np.ndarray) -> np.ndarray:
    c = _rebalance(curves)
    c = c - c.mean(axis=1, keepdims=True)
    scale = np.sqrt((c ** 2).sum(axis=(1, 2)) / c.shape[1])
    scale = np.where(scale == 0, 1.0, scale)[:, None, None]
    return c / scale


def _curve_length(c: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.diff(c, axis=1), axis=-1).sum(axis=1)


def _procrustes_angle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    num = (a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]).sum(axis=1)
    den = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]).sum(axis=1)
    return np.arctan2(num, den)


def _rotate(c: np.ndarray, theta: np.ndarray) -> np.ndarray:
    cos, sin = np.cos(theta)[:, None], np.sin(theta)[:, None]
    x, y = c[..., 0], c[..., 1]
    return np.stack([x * cos - y * sin, x * sin + y * cos], axis=-1)


def _frechet(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batched discrete Fréchet distance over (B, n, 2) curves."""
    B, n, _ = a.shape
    d = np.linalg.norm(a[:, :, None, :] - b[:, None, :, :], axis=-1)  # (B,n,n)
    ca = np.empty_like(d)
    ca[:, 0, 0] = d[:, 0, 0]
    for j in range(1, n):
        ca[:, 0, j] = np.maximum(ca[:, 0, j - 1], d[:, 0, j])
    for i in range(1, n):
        ca[:, i, 0] = np.maximum(ca[:, i - 1, 0], d[:, i, 0])
        # row-sequential within the batch (the column recurrence depends on
        # ca[i, j-1]); keep the inner loop but vectorize over B.
        for j in range(1, n):
            ca[:, i, j] = np.maximum(
                np.minimum(np.minimum(ca[:, i - 1, j - 1], ca[:, i - 1, j]),
                           ca[:, i, j - 1]), d[:, i, j])
    return ca[:, -1, -1]


def _normalized_pairs(y1: np.ndarray, y2: np.ndarray):
    """Procrustes-normalized curves of (B, P) value tracks (x coords
    0..P-1), each (B, 50, 2) whatever P, and their geometric mean length."""
    B, P = y1.shape
    x = np.broadcast_to(np.arange(P, dtype=np.float64), (B, P))
    c1 = np.stack([x, y1.astype(np.float64)], axis=-1)
    c2 = np.stack([x, y2.astype(np.float64)], axis=-1)
    n1 = _procrustes_normalize(c1)
    n2 = _procrustes_normalize(c2)
    return n1, n2, np.sqrt(_curve_length(n1) * _curve_length(n2))


def _similarity(n1: np.ndarray, n2: np.ndarray, geo: np.ndarray) -> np.ndarray:
    B = n1.shape[0]
    thetas = [np.zeros(B)]
    pt = _procrustes_angle(n1, n2)
    pt = np.where(pt > math.pi, pt - 2 * math.pi, pt)
    thetas.append(np.where(np.abs(pt) < RESTRICT_ROTATION, pt, 0.0))
    for i in range(ROTATION_ROUNDS):
        t = -RESTRICT_ROTATION + (2 * i * RESTRICT_ROTATION) / (ROTATION_ROUNDS - 1)
        thetas.append(np.full(B, t))

    best = np.full(B, np.inf)
    for th in thetas:
        best = np.minimum(best, _frechet(_rotate(n1, th), n2))
    score = np.maximum(1 - best / (1e-8 + geo / math.sqrt(2)), 0.0)
    return np.round(score, 4)


def shape_similarity_batch(y1: np.ndarray, y2: np.ndarray) -> np.ndarray:
    """Similarity of (B, P) value tracks; x coords are 0..P-1.

    Returns (B,) scores in [0, 1] rounded to 4 decimals like the package.
    """
    return _similarity(*_normalized_pairs(y1, y2))


def _pair_similarities(pairs) -> np.ndarray:
    """:func:`shape_similarity_batch` of every ``(y1, y2)`` pair of 1-D
    tracks of any lengths, in one Fréchet pass: the pairs are normalized a
    length at a time (every normalized curve has 50 points), then scored
    together.  Each pair's score is the one a call of its own gives (every
    step works row by row)."""
    out = np.zeros(len(pairs))
    if not pairs:
        return out
    by_len = {}
    for i, (a, _) in enumerate(pairs):
        by_len.setdefault(len(a), []).append(i)
    parts, order = [], []
    for idx in by_len.values():
        parts.append(_normalized_pairs(np.stack([pairs[i][0] for i in idx]),
                                       np.stack([pairs[i][1] for i in idx])))
        order.extend(idx)
    n1, n2, geo = (np.concatenate(p) for p in zip(*parts))
    out[np.asarray(order)] = _similarity(n1, n2, geo)
    return out


def _windows(y_true: np.ndarray, y_pred: np.ndarray, gap: int = 10):
    """The ``(true, pred)`` pairs of consecutive ``gap``-token windows, each
    without its last element (``y[k*gap:(k+1)*gap-1]``,
    finetune_generation.py:208-214)."""
    return [(y_true[i * gap:(i + 1) * gap - 1], y_pred[i * gap:(i + 1) * gap - 1])
            for i in range(len(y_true) // gap)]


def _bar_groups(y_true: np.ndarray, y_pred: np.ndarray, bars: np.ndarray):
    """The ``(true, pred)`` pairs of bars ``0 .. bars[-2]-1`` that hold more
    than one note, as the reference iterates them
    (finetune_generation.py:196-205)."""
    if len(bars) < 2:
        return []
    groups = []
    for k in range(int(bars[-2])):
        sel = bars == k
        if sel.sum() > 1:
            groups.append((y_true[sel], y_pred[sel]))
    return groups


def _window_score(sims: np.ndarray) -> float:
    return float(sims.sum() / len(sims)) if len(sims) else 0.0


def _bar_score(sims: np.ndarray, groups) -> float:
    """Each bar's similarity weighted by its note count
    (finetune_generation.py:216-217)."""
    total, index = 0.0, 0
    for s, (c1, _) in zip(sims, groups):
        total += float(s) * len(c1)
        index += len(c1)
    return total / index if index else 0.0


def fad_windows(y_true: np.ndarray, y_pred: np.ndarray,
                gap: int = 10) -> float:
    """FAD over consecutive ``gap``-token windows of one sample's pitch
    track."""
    return _window_score(_pair_similarities(_windows(y_true, y_pred, gap)))


def fad_bars(y_true: np.ndarray, y_pred: np.ndarray,
             bars: np.ndarray) -> float:
    """Length-weighted per-bar FAD of one sample's pitch track."""
    groups = _bar_groups(y_true, y_pred, bars)
    return _bar_score(_pair_similarities(groups), groups)


def generation_fad(y: np.ndarray, outputs: np.ndarray,
                   attn: np.ndarray,
                   jit_windows: bool = False, device=None) -> Tuple[float, float]:
    """Batch (FAD, FAD_BAR) for (B, S, 8) targets/predictions + (B, S) mask:
    the mean over the samples of :func:`fad_windows` and :func:`fad_bars`
    (finetune_generation.py:186-225).

    Every window and bar group of the batch is scored in one Fréchet pass
    (:func:`_pair_similarities`): the numbers of the per-sample calls, at a
    fraction of their time.  ``jit_windows=True`` (the JAX package's name
    for it) computes the fixed-length window FAD of the whole batch in one
    batched call on ``device`` (:func:`shape_similarity_batch_torch`);
    FAD_BAR stays on the host.
    """
    B = y.shape[0]
    samples, pairs = [], []          # per sample: (first pair, windows, bars)
    for j in range(B):
        sel = attn[j] == 1
        y1, y2, bars = y[j, sel, 3], outputs[j, sel, 3], y[j, sel, 0]
        win, groups = _windows(y1, y2), _bar_groups(y1, y2, bars)
        samples.append((len(pairs), win, groups))
        pairs += win + groups
    if jit_windows:
        win = [first + i for first, w, _ in samples for i in range(len(w))]
        bar = [first + len(w) + i for first, w, g in samples for i in range(len(g))]
        sims = np.zeros(len(pairs))
        if win:
            # rounded as the package rounds, so both paths report alike
            sims[win] = np.round(shape_similarity_batch_torch(
                np.stack([pairs[i][0] for i in win]),
                np.stack([pairs[i][1] for i in win]), device).cpu().numpy(), 4)
        sims[bar] = _pair_similarities([pairs[i] for i in bar])
    else:
        sims = _pair_similarities(pairs)
    fad = fad_bar = 0.0
    for first, win, groups in samples:
        fad += _window_score(sims[first:first + len(win)])
        fad_bar += _bar_score(sims[first + len(win):first + len(win) + len(groups)],
                              groups)
    return fad / B, fad_bar / B


# ---------------------------------------------------------------------------
# The batched torch variant: fixed-length windows only (the --fad_jit path)
# ---------------------------------------------------------------------------

def _rebalance_t(curves, n: int = ESTIMATION_POINTS):
    import torch
    B, P, _ = curves.shape
    seg = torch.linalg.vector_norm(curves[:, 1:] - curves[:, :-1], dim=-1)
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)], dim=1)
    total = cum[:, -1:]
    t = cum / torch.where(total == 0, torch.ones_like(total), total)
    targets = torch.linspace(0.0, 1.0, n, dtype=t.dtype, device=t.device)
    targets = targets.expand(B, n).contiguous()
    idx = (torch.searchsorted(t.contiguous(), targets, right=True) - 1).clamp(0, P - 2)
    t0, t1 = torch.gather(t, 1, idx), torch.gather(t, 1, idx + 1)
    denom = torch.where(t1 - t0 == 0, torch.ones_like(t0), t1 - t0)
    w = ((targets - t0) / denom).clamp(0.0, 1.0)[..., None]
    pick = lambda j: torch.gather(curves, 1, j[..., None].expand(B, n, 2))
    return pick(idx) * (1 - w) + pick(idx + 1) * w


def _normalize_t(curves):
    import torch
    c = _rebalance_t(curves)
    c = c - c.mean(dim=1, keepdim=True)
    scale = torch.sqrt((c ** 2).sum(dim=(1, 2)) / c.shape[1])
    return c / torch.where(scale == 0, torch.ones_like(scale), scale)[:, None, None]


def _frechet_t(a, b):
    """Batched discrete Fréchet distance of (N, n, 2) curves, one
    anti-diagonal of the recursion at a time over a table padded with a
    row and a column of +inf (its corner -inf)."""
    import torch
    N, n, _ = a.shape
    d = torch.cdist(a, b)                                        # (N, n, n)
    ca = torch.full((N, n + 1, n + 1), math.inf, dtype=d.dtype, device=d.device)
    ca[:, 0, 0] = -math.inf
    for k in range(2 * n - 1):
        i = torch.arange(max(0, k - n + 1), min(k, n - 1) + 1, device=d.device)
        j = k - i
        prev = torch.minimum(torch.minimum(ca[:, i, j], ca[:, i, j + 1]),
                             ca[:, i + 1, j])
        ca[:, i + 1, j + 1] = torch.maximum(prev, d[:, i, j])
    return ca[:, n, n]


def shape_similarity_batch_torch(y1, y2, device=None):
    """Unrounded similarity of (B, P) value tracks in one batched call on
    ``device`` (float64): :func:`shape_similarity_batch`'s algorithm."""
    import torch
    y1 = torch.as_tensor(np.asarray(y1), dtype=torch.float64, device=device)
    y2 = torch.as_tensor(np.asarray(y2), dtype=torch.float64, device=device)
    B, P = y1.shape
    x = torch.arange(P, dtype=torch.float64, device=y1.device).expand(B, P)
    n1 = _normalize_t(torch.stack([x, y1], dim=-1))
    n2 = _normalize_t(torch.stack([x, y2], dim=-1))
    length = lambda c: torch.linalg.vector_norm(c[:, 1:] - c[:, :-1], dim=-1).sum(1)
    geo = torch.sqrt(length(n1) * length(n2))
    num = (n1[..., 1] * n2[..., 0] - n1[..., 0] * n2[..., 1]).sum(1)
    den = (n1[..., 0] * n2[..., 0] + n1[..., 1] * n2[..., 1]).sum(1)
    pt = torch.atan2(num, den)
    pt = torch.where(pt > math.pi, pt - 2 * math.pi, pt)
    pt = torch.where(pt.abs() < RESTRICT_ROTATION, pt, torch.zeros_like(pt))
    probes = torch.tensor([-RESTRICT_ROTATION + 2 * i * RESTRICT_ROTATION
                           / (ROTATION_ROUNDS - 1) for i in range(ROTATION_ROUNDS)],
                          dtype=torch.float64, device=y1.device)
    thetas = torch.cat([torch.zeros_like(pt)[:, None], pt[:, None],
                        probes.expand(B, ROTATION_ROUNDS)], dim=1)   # (B, R)
    R = thetas.shape[1]
    cs, sn = torch.cos(thetas)[..., None], torch.sin(thetas)[..., None]
    cx, cy = n1[:, None, :, 0], n1[:, None, :, 1]
    rot = torch.stack([cx * cs - cy * sn, cx * sn + cy * cs], dim=-1)  # (B,R,n,2)
    n = rot.shape[2]
    best = _frechet_t(rot.reshape(B * R, n, 2),
                      n2[:, None].expand(B, R, n, 2).reshape(B * R, n, 2))
    best = best.reshape(B, R).min(dim=1).values
    return torch.clamp(1 - best / (1e-8 + geo / math.sqrt(2)), min=0.0)
