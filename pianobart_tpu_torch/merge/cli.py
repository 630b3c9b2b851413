"""The ``merge`` command, the counterpart of ``pianobart_tpu/merge/cli.py``.

The reference ``model_merge.py``'s defaults (``mask_merging`` over
``average_merging``, mask rate 0.8, the delta format, the random strategy)
over checkpoint directories of the port or reference ``.ckpt``/``.pth``
files.  Only the shared ``pianobart`` trunk is merged; ``--head_from``
bundles one checkpoint's LM head with it.  The output is the flax msgpack
the JAX package writes (``{"pianobart": ..., "lm_head": ...}`` in flax
layout), which both packages' ``--ckpt`` load.

Fisher weights are squared gradients of the teacher-forced LM loss of each
trunk (f32 compute, eval mode) under an LM head drawn from seed 0; RegMean
Grams come from forward hooks on the trunk's Dense layers.  Both run on the
device (CUDA unless ``--device cpu``), batches of 4 windows of ``--data``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import vocab as V
from ..models.config import PianoBartConfig
from . import methods

TRUNK = "pianobart."
HEAD = "lm_head."
StateDict = Dict[str, torch.Tensor]


def _trunk(entries: StateDict, device) -> StateDict:
    """The ``pianobart.*`` entries without the prefix, as float32 on
    ``device`` (all of them where the checkpoint holds a bare trunk)."""
    keys = [k for k in entries if k.startswith(TRUNK)]
    if keys:
        return {k[len(TRUNK):]: entries[k].to(device=device, dtype=torch.float32)
                for k in keys}
    return {k: v.to(device=device, dtype=torch.float32) for k, v in entries.items()}


def _check_same_trunks(named: Dict[str, StateDict]) -> None:
    (first, ref), *rest = named.items()
    want = {k: tuple(v.shape) for k, v in ref.items()}
    for name, trunk in rest:
        got = {k: tuple(v.shape) for k, v in trunk.items()}
        if got != want:
            only = sorted(set(got) ^ set(want))
            shapes = sorted(k for k in set(got) & set(want) if got[k] != want[k])
            raise SystemExit(
                f"cannot merge {name} with {first}: their trunks differ "
                f"(entries in one only: {only[:4]}{' ...' if len(only) > 4 else ''}; "
                f"shapes differ: {shapes[:4]}{' ...' if len(shapes) > 4 else ''}) — "
                f"merge checkpoints of one architecture (a velocity finetune's "
                f"label decoder is not a plain trunk)")


def _fisher_batches(args) -> List[np.ndarray]:
    """(4, S, 8) batches of the first ``--num_examples`` windows of
    ``--data``."""
    if not getattr(args, "data", None):
        raise SystemExit("fisher/regmean merging needs --data <pretrain .npy>")
    arr = np.load(args.data, allow_pickle=True).astype(np.int64)
    n = min(getattr(args, "num_examples", 32), len(arr))
    bs = 4
    return [arr[i:i + bs] for i in range(0, n, bs)]


def _template_head(cfg: PianoBartConfig) -> StateDict:
    """The LM head of ``init_lm(cfg, seed=0)`` (f32), on the host: the head
    the Fisher loss is taken under, as the JAX package's is its seed-0
    template's."""
    from ..compat.from_jax import init_lm
    lm = init_lm(cfg.replace(dtype=torch.float32, param_dtype=torch.float32),
                 seed=0, device="cpu")
    return {HEAD + k: v for k, v in lm.lm_head.state_dict().items()}


def _inputs(batch, device):
    from ..train.objective import shift_right
    b = torch.as_tensor(np.asarray(batch), device=device).long()
    dec = shift_right(b, V.SOS)
    mask = (b[..., 0] != V.PAD[0]).float()
    return b, dec, mask


def _lm_grad_fn(cfg: PianoBartConfig, head: StateDict, device):
    """``grad_fn(trunk, batch)``: the gradient, with respect to the trunk,
    of the teacher-forced LM loss (``masked_field_ce`` over the real rows)
    of a ``PianoBartLM`` made of ``trunk`` and ``head`` (``lm_head.*``
    entries), in f32 compute and eval mode (no dropout)."""
    from ..models.pianobart import PianoBartLM
    from ..train.objective import masked_field_ce
    cfg32 = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    model = PianoBartLM(cfg32, device=device).eval().requires_grad_(False)
    head = {k: v.to(device=device, dtype=torch.float32) for k, v in head.items()}

    def grad_fn(trunk: StateDict, batch) -> StateDict:
        b, dec, mask = _inputs(batch, device)
        leaves = {k: v.detach().requires_grad_() for k, v in trunk.items()}
        params = {**{TRUNK + k: v for k, v in leaves.items()}, **head}
        fused = torch.func.functional_call(model, params, (b, dec, mask, mask))
        lm = mask[..., None].expand(b.shape)
        loss = masked_field_ce(fused, b, lm, cfg32)[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads))

    return grad_fn


def _trunk_grams(cfg: PianoBartConfig, trunk: StateDict, batches, device) -> StateDict:
    """Dense-input Gram matrices of a ``PianoBart`` trunk (f32 compute,
    eval mode) over ``batches``, keyed by the trunk's entry names."""
    from ..models.pianobart import PianoBart
    cfg32 = cfg.replace(dtype=torch.float32, param_dtype=torch.float32)
    model = PianoBart(cfg32, device=device).eval()
    model.load_state_dict(trunk)
    args = []
    for b in batches:
        b, dec, mask = _inputs(b, device)
        args.append((b, dec, mask, mask))
    return methods.collect_dense_grams(model, args)


def merge(args, cfg: Optional[PianoBartConfig] = None) -> StateDict:
    """The merged model as port-named entries (``pianobart.*``, and
    ``lm_head.*`` with ``--head_from``): float32 on the device."""
    from ..decode import checkpoint_entries
    from ..device import resolve_device
    device = resolve_device(getattr(args, "device", None))
    cfg = cfg or PianoBartConfig()
    loaded = {p: checkpoint_entries(p, cfg) for p in dict.fromkeys(args.models)}
    trunks = [_trunk(loaded[p], device) for p in args.models]
    pre = None
    if args.pretrained:
        pre = _trunk(checkpoint_entries(args.pretrained, cfg), device)
    named = dict(zip(args.models, trunks))
    if pre is not None:
        named[args.pretrained] = pre
    _check_same_trunks(named)

    apply = getattr(args, "mask_apply_method", "average_merging")
    needs_pre = args.method in ("task_arithmetic", "ties_merging") or (
        args.method == "mask_merging" and apply in ("task_arithmetic", "ties_merging"))
    if needs_pre and pre is None:
        raise SystemExit(
            f"--method {args.method} subtracts a base model: pass "
            f"--pretrained <checkpoint> (the reference's "
            f"pretrained_model_name, model_merge.py)")

    if args.method == "mask_merging":
        fmt = "delta_weight" if pre is not None else "finetuned_weight"
        masked = [methods.mask_model_weights(
            t, pre, weight_format=fmt, weight_mask_rate=args.weight_mask_rate,
            use_weight_rescale=args.use_weight_rescale,
            mask_strategy=args.mask_strategy, seed=i)
            for i, t in enumerate(trunks)]
        if apply == "average_merging":
            merged = methods.average_merging(masked)
        elif apply == "task_arithmetic":
            merged = methods.task_arithmetic(pre, masked, args.scaling_coefficient)
        else:
            merged = methods.ties_merging(pre, masked, args.param_value_mask_rate,
                                          args.scaling_coefficient)
    elif args.method == "average_merging":
        merged = methods.average_merging(trunks)
    elif args.method == "task_arithmetic":
        merged = methods.task_arithmetic(pre, trunks, args.scaling_coefficient)
    elif args.method == "ties_merging":
        merged = methods.ties_merging(pre, trunks, args.param_value_mask_rate,
                                      args.scaling_coefficient)
    elif args.method == "fisher_merging":
        batches = _fisher_batches(args)
        grad_fn = _lm_grad_fn(cfg, _template_head(cfg), device)
        fishers = [methods.compute_fisher_weights(grad_fn, t, batches) for t in trunks]
        merged = methods.fisher_merging(trunks, fishers)
    elif args.method == "regmean_merging":
        batches = _fisher_batches(args)
        grams = [_trunk_grams(cfg, t, batches, device) for t in trunks]
        merged = methods.regmean_merging(trunks, grams)
    else:
        raise ValueError(args.method)

    out = {TRUNK + k: v for k, v in merged.items()}
    head_from = getattr(args, "head_from", None)
    if head_from:
        # the reference loads merged backbones into a finetuned model that
        # keeps its own head (model_merge.py:60-78)
        src = loaded[head_from] if head_from in loaded else checkpoint_entries(head_from, cfg)
        head = {k: v for k, v in src.items() if k.startswith(HEAD)}
        if not head:
            raise SystemExit(
                f"--head_from {head_from}: subtree 'lm_head' is not in that "
                f"checkpoint — that checkpoint does not carry this head; pass "
                f"a checkpoint that owns the head you want bundled")
        out.update({k: v.to(device=device, dtype=torch.float32) for k, v in head.items()})
    return out


def save_merged(sd: StateDict, path: str) -> None:
    """Write port-named entries as the flax msgpack ``pbx merge`` writes."""
    from ..compat.flax_msgpack import write_msgpack
    from ..compat.from_jax import flax_tree_from_state_dict
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_msgpack(flax_tree_from_state_dict(sd), path)


def run_merge(args, cfg: Optional[PianoBartConfig] = None) -> str:
    """``merge`` as the CLI runs it: merge (``cfg`` defaults to the flagship
    ``PianoBartConfig()``, as the JAX package's does), write
    ``args.output``, print, return the path."""
    save_merged(merge(args, cfg), args.output)
    print(f"merged {len(args.models)} models with {args.method} -> {args.output}"
          + (f" (heads from {args.head_from})"
             if getattr(args, "head_from", None) else ""))
    return args.output
