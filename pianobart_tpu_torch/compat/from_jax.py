"""Weights for the port: carried across from a flax ``PianoBartLM`` params
tree, or drawn at random from a seed.

The port's modules carry the flax module names (``layers_3`` becomes
``layers.3``), so the mapping is mechanical: Dense ``kernel (in, out)`` ->
``weight (out, in)``, LayerNorm ``scale`` -> ``weight``, and ``bias``,
``embed.table`` and ``embed_positions.embedding`` map across as they are.
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
from ..models.embedding import OctupleEmbedding
from ..models.pianobart import PianoBartLM

__all__ = ["lm_state_dict_from_jax", "init_lm"]


def _to_tensor(leaf: Any) -> torch.Tensor:
    if hasattr(leaf, "unbox"):          # flax nn.Partitioned from model.init
        leaf = leaf.unbox()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)    # load_state_dict casts to param_dtype
    return torch.tensor(arr)


def lm_state_dict_from_jax(params: Mapping, cfg: PianoBartConfig
                           ) -> Dict[str, torch.Tensor]:
    """flax ``PianoBartLM`` params (``{"params": ...}`` or the inner tree)
    -> the port's ``PianoBartLM`` ``state_dict``."""
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
    for part, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        found = {k.split(".")[3] for k in sd if k.startswith(f"pianobart.{part}.layers.")}
        if len(found) != n:
            raise ValueError(f"params hold {len(found)} {part} layers, cfg says {n}")
    return sd


def init_lm(cfg: PianoBartConfig, seed: int = 0, device: DeviceLike = None,
            train: bool = False) -> PianoBartLM:
    """A ``PianoBartLM`` with random weights drawn as the flax initialisers
    draw them: normal(0.02) for dense kernels and positions, normal(1.0) for
    the embedding table, zero biases, unit LayerNorm scales.  The draw is
    made on the CPU in f32 from ``seed`` and cast to ``cfg.param_dtype``, so
    every device gets the same weights.  Returned in eval mode, or in train
    mode (dropout on) when ``train``."""
    model = PianoBartLM(cfg, device=resolve_device(device))
    gen = torch.Generator().manual_seed(seed)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                normal_(mod.weight, 0.02)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, OctupleEmbedding):
                normal_(mod.table, 1.0)
            elif isinstance(mod, PositionalEmbedding):
                normal_(mod.embedding, 0.02)
    return model.train(train)
