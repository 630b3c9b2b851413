"""Weights for the port: carried across from a flax params tree
(``PianoBartLM``, ``SequenceClassification``, ``TokenClassification``), or
drawn at random from a seed.

The port's modules carry the flax module names (``layers_3`` becomes
``layers.3``), so the mapping is mechanical: Dense ``kernel (in, out)`` ->
``weight (out, in)``, LayerNorm ``scale`` -> ``weight``, and ``bias``,
``embed.table`` and ``embed_positions.embedding`` map across as they are.
:func:`flax_tree_from_state_dict` maps back, for the flax msgpack a merge
writes.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.bart import LayerNorm, PositionalEmbedding
from ..models.config import PianoBartConfig
from ..models.embedding import LabelEmbedding, OctupleEmbedding
from ..models.heads import (AttentionPooling, Excitation, SequenceClassifierHead,
                            TokenClassifierHead)
from ..models.pianobart import PianoBartLM

__all__ = ["lm_state_dict_from_jax", "flax_tree_from_state_dict", "init_lm",
           "init_model", "draw_params_"]

# modules whose Linear layers flax builds with its default kernel init
_LECUN = (LabelEmbedding, AttentionPooling, SequenceClassifierHead,
          TokenClassifierHead, Excitation)


def _to_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):  # a leaf of compat/flax_msgpack.py
        return leaf
    if hasattr(leaf, "unbox"):          # flax nn.Partitioned from model.init
        leaf = leaf.unbox()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)    # load_state_dict casts to param_dtype
    return torch.tensor(arr)


def lm_state_dict_from_jax(params: Mapping, cfg: PianoBartConfig
                           ) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the inner tree) of a
    ``PianoBartLM`` or a classifier (``pianobart`` and ``head`` subtrees) ->
    the port's ``state_dict`` of the same model."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + re.sub(r"^layers_(\d+)$", r"layers.\1", key) + ".")
                continue
            t = _to_tensor(val)
            if key == "kernel":
                key, t = "weight", t.T.contiguous()
            elif key == "scale":
                key = "weight"
            sd[prefix + key] = t

    walk(tree, "")
    if "pianobart" not in tree:     # a head or a module of its own
        return sd
    for part, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        found = {k.split(".")[3] for k in sd if k.startswith(f"pianobart.{part}.layers.")}
        if len(found) != n:
            raise ValueError(f"params hold {len(found)} {part} layers, cfg says {n}")
    return sd


def flax_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`lm_state_dict_from_jax`: the port's names and
    tensors -> a nested flax params dict (``layers.N`` -> ``layers_N``, a
    2-D ``weight`` -> ``kernel`` transposed, a 1-D ``weight`` -> ``scale``),
    in the state_dict's order.  Tensors stay on their device."""
    tree: Dict[str, Any] = {}
    for name, t in sd.items():
        parts = re.sub(r"(^|\.)layers\.(\d+)(?=\.)", r"\1layers_\2", name).split(".")
        leaf = parts[-1]
        if leaf == "weight":
            leaf, t = ("kernel", t.T) if t.dim() == 2 else ("scale", t)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def draw_params_(model: nn.Module, seed: int = 0, skip=()) -> nn.Module:
    """Draw ``model``'s parameters in place as the flax initialisers draw
    them: normal(0.02) for the trunk's and the LM head's dense kernels and
    the positions, normal(1.0) for the embedding tables, flax's default
    ``lecun_normal`` (a normal truncated at two deviations, of variance
    1/fan_in) for the heads' and the label embedding's kernels, zero
    biases, unit LayerNorm scales.  The draws come in module order from one
    CPU generator seeded with ``seed``, in f32, and are cast to each
    parameter's type and device.  Parameters named in ``skip`` are left as
    they are and take no draw."""
    gen = torch.Generator().manual_seed(seed)
    lecun = {id(m) for owner in model.modules() if isinstance(owner, _LECUN)
             for m in owner.modules() if isinstance(m, nn.Linear)}

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    def lecun_(p: torch.Tensor) -> None:
        t = torch.empty(p.shape)
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        # flax's variance_scaling: the deviation of the truncated draw
        p.copy_(t * (p.shape[1] ** -0.5 / .87962566103423978))

    with torch.no_grad():
        for name, mod in model.named_modules():
            def want(leaf: str) -> bool:
                return (f"{name}.{leaf}" if name else leaf) not in skip
            if isinstance(mod, nn.Linear):
                if want("weight"):
                    if id(mod) in lecun:
                        lecun_(mod.weight)
                    else:
                        normal_(mod.weight, 0.02)
                if mod.bias is not None and want("bias"):
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                if want("weight"):
                    mod.weight.fill_(1.0)
                if want("bias"):
                    mod.bias.zero_()
            elif isinstance(mod, (OctupleEmbedding, LabelEmbedding)):
                if want("table"):
                    normal_(mod.table, 1.0)
            elif isinstance(mod, PositionalEmbedding):
                if want("embedding"):
                    normal_(mod.embedding, 0.02)
    return model


def init_model(cls, cfg: PianoBartConfig, seed: int = 0, device: DeviceLike = None,
               train: bool = False, **kw) -> nn.Module:
    """``cls(cfg, **kw)`` (``PianoBartLM``, ``SequenceClassification``,
    ``TokenClassification`` with its ``class_num``) with random weights
    from ``seed`` (:func:`draw_params_`), on CUDA unless ``device`` says
    otherwise.  Returned in eval mode, or in train mode when ``train``."""
    model = cls(cfg, device=resolve_device(device), **kw)
    return draw_params_(model, seed).train(train)


def init_lm(cfg: PianoBartConfig, seed: int = 0, device: DeviceLike = None,
            train: bool = False) -> PianoBartLM:
    """A ``PianoBartLM`` with random weights drawn as the flax initialisers
    draw them (:func:`draw_params_`).  The draw is made on the CPU in f32
    from ``seed`` and cast to ``cfg.param_dtype``, so every device gets the
    same weights.  Returned in eval mode, or in train mode (dropout on)
    when ``train``."""
    return init_model(PianoBartLM, cfg, seed, device, train)
