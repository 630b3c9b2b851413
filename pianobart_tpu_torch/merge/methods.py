"""Model merging on the port's ``state_dict``s, the counterpart of
``pianobart_tpu/merge/methods.py``.

Task-vector arithmetic, DARE weight-drop masks with the 1/(1-p) rescale,
average / task arithmetic / TIES, and the data-aware Fisher and RegMean
merges (the reference's ``model_merging_methods``).  Every function takes
flat ``{name: tensor}`` dicts of one model each (the port's names, every
tensor on one device) and computes there; ``exclude_regex`` matches the
dotted names.

The selections equal numpy's: a k-th smallest magnitude is the element
``np.partition(...)[k - 1]`` picks (:func:`_kth_smallest`), and each rule
keeps or drops by the same comparison as the JAX package.  Sums over models
and divisions by a count or a rate follow numpy's order and rounding, so a
merge on the card equals the same merge on the host entry for entry.  The merged
tensors keep their inputs' type (float32 for the port's checkpoints); the
JAX package's TIES and Fisher outputs come out float64 by numpy's type
promotion.  The Fisher sums and the RegMean Grams and solves are float64.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

__all__ = ["task_vector", "combine", "average_merging", "task_arithmetic",
           "mask_tensor", "mask_model_weights", "ties_merging",
           "compute_fisher_weights", "fisher_merging", "regmean_merging",
           "collect_dense_grams"]

StateDict = Dict[str, torch.Tensor]


def _excluded(name: str, exclude_regex: Optional[Sequence[str]]) -> bool:
    return bool(exclude_regex) and any(re.search(r, name) for r in exclude_regex)


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th smallest (1-based) element of ``x`` flattened, the element
    ``np.partition(x, k - 1)[k - 1]`` picks.  On CUDA by a sort: over one
    slice ``kthvalue`` runs in a single thread block (1.24 s for a
    flagship trunk's 172.5M entries on an H100, the sort 8 ms); on the
    host by ``kthvalue``'s selection, which needs no sorted copy (2.3-3.1
    s over the same entries in float64, a sort 22-25 s, on the H100
    machine's 8-thread host; ``chip_smoke.py``'s ``[merge]`` times both)."""
    flat = x.reshape(-1)
    if flat.is_cuda:
        return torch.sort(flat).values[k - 1]
    return torch.kthvalue(flat, k).values


def _div(x: torch.Tensor, n: float) -> torch.Tensor:
    """``x / n`` as numpy divides: CUDA divides a tensor by a host scalar as
    a product with its reciprocal, which can differ in the last bit."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def _sum(xs) -> torch.Tensor:
    """The tensors of ``xs`` added in order, as numpy sums a stack over its
    first axis (a device reduction may add them in another order)."""
    return sum(xs[1:], xs[0])


def task_vector(pretrained: StateDict, finetuned: StateDict,
                exclude_regex: Optional[Sequence[str]] = None) -> StateDict:
    """delta = finetuned - pretrained (excluded entries -> zeros)."""
    return {k: torch.zeros_like(p) if _excluded(k, exclude_regex)
            else finetuned[k] - p for k, p in pretrained.items()}


def combine(pretrained: StateDict, delta: StateDict, scaling: float = 1.0) -> StateDict:
    return {k: p + scaling * delta[k] for k, p in pretrained.items()}


def average_merging(models: Sequence[StateDict],
                    exclude_regex: Optional[Sequence[str]] = None) -> StateDict:
    return {k: v if _excluded(k, exclude_regex)
            else _div(_sum([m[k] for m in models]), len(models))
            for k, v in models[0].items()}


def task_arithmetic(pretrained: StateDict, models: Sequence[StateDict],
                    scaling: float = 1.0,
                    exclude_regex: Optional[Sequence[str]] = None) -> StateDict:
    deltas = [task_vector(pretrained, m, exclude_regex) for m in models]
    total = {k: sum(d[k] for d in deltas) for k in pretrained}
    return combine(pretrained, total, scaling)


# ---------------------------------------------------------------------------
# DARE weight-drop masks (mask_weights_utils.py)
# ---------------------------------------------------------------------------

def mask_tensor(x: torch.Tensor, mask_rate: float, use_rescale: bool,
                strategy: str, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Drop ``mask_rate`` of the entries: each independently with that
    probability (``random``, drawn from ``generator`` on ``x``'s device),
    or every entry whose magnitude is at most the k-th smallest, k =
    ``int(numel * mask_rate)`` (``magnitude``); optionally rescale the
    survivors by 1/(1-p)."""
    if strategy == "random":
        drop = torch.rand(x.shape, device=x.device, generator=generator) < mask_rate
        out = x.masked_fill(drop, 0.0)
    elif strategy == "magnitude":
        k = int(x.numel() * mask_rate)
        if k > 0:
            mag = x.abs()
            out = x.masked_fill(mag <= _kth_smallest(mag, k), 0.0)
        else:
            out = x.clone()
    else:
        raise ValueError(f"unknown mask strategy {strategy}")
    if use_rescale and mask_rate != 1.0:
        out = _div(out, 1.0 - mask_rate)
    return out.to(x.dtype)


def mask_model_weights(finetuned: StateDict, pretrained: Optional[StateDict],
                       weight_format: str = "delta_weight",
                       weight_mask_rate: float = 0.8,
                       use_weight_rescale: bool = True,
                       mask_strategy: str = "random",
                       exclude_regex: Optional[Sequence[str]] = None,
                       seed: int = 0) -> StateDict:
    """DARE on one model: mask its weights (``finetuned_weight``) or its
    delta from ``pretrained`` (``delta_weight``, added back after), every
    entry in order from one generator seeded with ``seed``."""
    device = next(iter(finetuned.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)

    def mask(k: str, v: torch.Tensor) -> torch.Tensor:
        if _excluded(k, exclude_regex):
            return v
        return mask_tensor(v, weight_mask_rate, use_weight_rescale,
                           mask_strategy, gen)

    if weight_format == "finetuned_weight":
        return {k: mask(k, v) for k, v in finetuned.items()}
    if weight_format != "delta_weight":
        raise ValueError(f"unknown weight format {weight_format}")
    if pretrained is None:
        raise ValueError("the delta_weight format needs the pretrained weights")
    delta = task_vector(pretrained, finetuned, exclude_regex)
    return combine(pretrained, {k: mask(k, v) for k, v in delta.items()}, 1.0)


# ---------------------------------------------------------------------------
# TIES (merging_methods.py:418-527)
# ---------------------------------------------------------------------------

def ties_merging(pretrained: StateDict, models: Sequence[StateDict],
                 param_value_mask_rate: float = 0.8,
                 scaling: float = 1.0,
                 exclude_regex: Optional[Sequence[str]] = None) -> StateDict:
    """Trim each model's delta to its largest magnitudes over all entries
    at once (keep ``|x| >= kth``, k = ``int(total * rate)``), elect each
    entry's sign (the sign of the sum; a tie takes the sign of the sum of
    the signs), then average the kept deltas that agree with it."""
    deltas = [task_vector(pretrained, m, exclude_regex) for m in models]
    flat = torch.stack([torch.cat([d[k].reshape(-1) for k in pretrained])
                        for d in deltas])                       # (M, total)
    del deltas
    k = int(flat.shape[1] * param_value_mask_rate)
    if k > 0:
        mag = flat.abs()
        kth = torch.stack([_kth_smallest(row, k) for row in mag])[:, None]
        flat = torch.where(mag >= kth, flat, 0.0)
        del mag
    signs = torch.sign(_sum(flat))
    signs = torch.where(signs == 0, torch.sign(signs.sum()), signs)
    keep = ((signs > 0) & (flat > 0)) | ((signs < 0) & (flat < 0))
    kept = flat * keep
    count = (kept != 0).sum(dim=0).clamp(min=1).to(flat.dtype)
    merged_flat = _sum(kept) / count
    merged, off = {}, 0
    for key, p in pretrained.items():
        merged[key] = merged_flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return combine(pretrained, merged, scaling)


# ---------------------------------------------------------------------------
# Fisher merging (merging_methods.py:82-264)
# ---------------------------------------------------------------------------

def compute_fisher_weights(grad_fn: Callable[[StateDict, object], StateDict],
                           params: StateDict, batches: Sequence,
                           min_weight: float = 1e-6) -> StateDict:
    """Empirical diagonal Fisher: the mean over ``batches`` of the squared
    gradients ``grad_fn(params, batch)``, in float64, at least
    ``min_weight``."""
    acc = {k: torch.zeros_like(p, dtype=torch.float64) for k, p in params.items()}
    for b in batches:
        grads = grad_fn(params, b)
        for k, a in acc.items():
            g = grads[k].double()
            a.addcmul_(g, g)
        del grads
    n = max(len(batches), 1)
    return {k: _div(a, n).clamp_(min=min_weight) for k, a in acc.items()}


def fisher_merging(models: Sequence[StateDict], fishers: Sequence[StateDict],
                   coefficients: Optional[Sequence[float]] = None,
                   normalize: bool = True,
                   min_weight: float = 1e-6) -> StateDict:
    """theta* = sum_i c_i F_i theta_i / sum_i c_i F_i per entry, each
    model's Fisher first divided by its global norm (``normalize``)."""
    M = len(models)
    if coefficients is None:
        coefficients = [1.0 / M] * M
    norms = [1.0] * M
    if normalize:
        norms = [torch.sqrt(sum(f.square().sum() for f in fi.values())).clamp(min=1e-12)
                 for fi in fishers]
    out = {}
    for k, theta in models[0].items():
        fs = [f[k] / n for f, n in zip(fishers, norms)]
        num = sum(c * f * m[k] for c, f, m in zip(coefficients, fs, models))
        den = sum(c * f for c, f in zip(coefficients, fs))
        out[k] = (num / den.clamp(min=min_weight)).to(theta.dtype)
    return out


# ---------------------------------------------------------------------------
# RegMean merging (merging_methods.py:266-416)
# ---------------------------------------------------------------------------

def regmean_merging(models: Sequence[StateDict], grams: Sequence[StateDict],
                    reduce_non_diagonal: float = 1.0) -> StateDict:
    """For each Dense weight with a recorded input Gram in every model,
    ``W* = solve(sum G_i, sum G_i W_i^T)^T`` in float64 (the port's
    ``weight`` is flax's kernel transposed); every other entry, and a
    weight whose system is singular, is averaged.

    ``grams[i]`` maps ``<Dense name>.weight`` to the (in, in) Gram of that
    layer's inputs under model i's data (:func:`collect_dense_grams`)."""
    def reduce_g(g: torch.Tensor) -> torch.Tensor:
        g = g.double()
        if reduce_non_diagonal != 1.0:
            g = reduce_non_diagonal * g + (1 - reduce_non_diagonal) * torch.diag(torch.diag(g))
        return g

    out = {}
    for k, w0 in models[0].items():
        gs = [g.get(k) for g in grams]
        if all(g is not None for g in gs) and w0.dim() == 2:
            rs = [reduce_g(g) for g in gs]
            rhs = sum(r @ m[k].double().T for r, m in zip(rs, models))
            sol, info = torch.linalg.solve_ex(sum(rs), rhs)
            if int(info) == 0:
                out[k] = sol.T.to(w0.dtype).contiguous()
                continue
        out[k] = _div(_sum([m[k] for m in models]), len(models))
    return out


def collect_dense_grams(module: nn.Module, batches: Sequence[tuple]
                        ) -> StateDict:
    """Input Gram matrices of every ``nn.Linear`` of ``module`` over
    ``batches`` (each a tuple of ``module``'s positional arguments): each
    call adds ``x2d^T x2d / rows`` in float64, and the sums are divided by
    the number of batches.  Keys ``<module name>.weight``, as in
    ``module.state_dict()``, ready for :func:`regmean_merging`."""
    grams: StateDict = {}

    def hook(name: str):
        def record(mod, args, output):
            x = args[0].detach().double()
            x2d = x.reshape(-1, x.shape[-1])
            g = x2d.T @ x2d / x2d.shape[0]
            key = f"{name}.weight"
            if key in grams:
                grams[key] += g
            else:
                grams[key] = g
        return record

    handles: List = [m.register_forward_hook(hook(n)) for n, m in module.named_modules()
                     if isinstance(m, nn.Linear)]
    try:
        with torch.no_grad():
            for batch in batches:
                module(*batch)
    finally:
        for h in handles:
            h.remove()
    n = max(len(batches), 1)
    return {k: v / n for k, v in grams.items()}
