"""Import reference PianoBART checkpoints into the port, the counterpart of
``pianobart_tpu/compat/torch_import.py``.

The reference saves (SURVEY §5, checkpoint duality):

* a trunk-only ``PianoBart.state_dict()`` (its pretraining);
* a whole ``PianoBartLM`` / ``SequenceClassification`` /
  ``TokenClassification`` (its finetunes), optionally wrapped in
  ``{'state_dict': ...}`` and with ``nn.DataParallel``'s ``module.`` prefix.

The output is the port's ``state_dict`` of the same model, in the flax names
(``pianobart.embed.table``, ``pianobart.encoder.layers.0.ffn.fc1.weight``,
``lm_head.proj.weight``, ``head.dense1.weight``, ...).  Fused as the JAX
importer fuses: the 8 per-field tables ``word_emb.{i}.lut`` become one
(1280, emb_size) table (rows concatenated), ``encoder_linear`` the
``fusion`` Dense, the 8 LM heads ``mask_lm.proj.{i}`` one (1280, d_model)
projection.  A ``nn.Linear`` weight keeps its (out, in) layout.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from ..models.config import PianoBartConfig

__all__ = ["load_torch_checkpoint", "import_trunk", "import_lm",
           "import_sequence_classifier", "import_token_classifier",
           "import_checkpoint", "KINDS"]

StateDict = Dict[str, torch.Tensor]
KINDS = ("trunk", "lm", "seq", "token")


def load_torch_checkpoint(path: str) -> StateDict:
    """A ``.ckpt``/``.pth`` file's state dict (``torch.load`` with
    ``weights_only=True``, on the host), unwrapped from ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def _strip_prefixes(sd: Mapping[str, torch.Tensor]) -> StateDict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _linear(out: StateDict, ours: str, sd: Mapping, theirs: str) -> None:
    out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
    if f"{theirs}.bias" in sd:
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]


def _layer(out: StateDict, ours: str, sd: Mapping, theirs: str,
           cross: bool) -> None:
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(out, f"{ours}.self_attn.{p}", sd, f"{theirs}.self_attn.{p}")
    _linear(out, f"{ours}.self_attn_layer_norm", sd, f"{theirs}.self_attn_layer_norm")
    _linear(out, f"{ours}.ffn.fc1", sd, f"{theirs}.fc1")
    _linear(out, f"{ours}.ffn.fc2", sd, f"{theirs}.fc2")
    _linear(out, f"{ours}.final_layer_norm", sd, f"{theirs}.final_layer_norm")
    if cross:
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, f"{ours}.cross_attn.{p}", sd, f"{theirs}.encoder_attn.{p}")
        _linear(out, f"{ours}.cross_attn_layer_norm", sd,
                f"{theirs}.encoder_attn_layer_norm")


def import_trunk(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig,
                 prefix: str = "") -> StateDict:
    """A reference ``PianoBart`` state dict (keys under ``prefix``) -> the
    port's ``PianoBart`` entries, named from the trunk (``embed.table``,
    ...)."""
    sd = {k[len(prefix):]: v for k, v in _strip_prefixes(sd).items()
          if k.startswith(prefix)}
    table = torch.cat([sd[f"word_emb.{i}.lut.weight"] for i in range(cfg.n_fields)])
    if tuple(table.shape) != (cfg.total_vocab, cfg.emb_size):
        raise ValueError(f"embedding tables fuse to {tuple(table.shape)}, the "
                         f"config wants ({cfg.total_vocab}, {cfg.emb_size})")
    out: StateDict = {"embed.table": table}
    _linear(out, "embed.fusion", sd, "encoder_linear")
    for side, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        out[f"{side}.embed_positions.embedding"] = sd[f"bart.{side}.embed_positions.weight"]
        _linear(out, f"{side}.layernorm_embedding", sd, f"bart.{side}.layernorm_embedding")
        for i in range(n):
            _layer(out, f"{side}.layers.{i}", sd, f"bart.{side}.layers.{i}",
                   cross=side == "decoder")
    if cfg.decoder_label_vocab is not None and "decoder_emb.lut.weight" in sd:
        # the velocity finetune's swapped decoder embedding
        out["decoder_embed.table"] = sd["decoder_emb.lut.weight"]
        _linear(out, "decoder_embed.proj", sd, "decoder_linear")
    return out


def _with_trunk(sd: Mapping, cfg: PianoBartConfig) -> StateDict:
    return {f"pianobart.{k}": v
            for k, v in import_trunk(sd, cfg, prefix="pianobart.").items()}


def import_lm(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig) -> StateDict:
    """A reference ``PianoBartLM`` state dict -> the port's ``PianoBartLM``."""
    sd = _strip_prefixes(sd)
    out = _with_trunk(sd, cfg)
    out["lm_head.proj.weight"] = torch.cat(
        [sd[f"mask_lm.proj.{i}.weight"] for i in range(cfg.n_fields)])
    out["lm_head.proj.bias"] = torch.cat(
        [sd[f"mask_lm.proj.{i}.bias"] for i in range(cfg.n_fields)])
    return out


def import_sequence_classifier(sd: Mapping[str, torch.Tensor],
                               cfg: PianoBartConfig) -> StateDict:
    """A reference ``SequenceClassification`` (attention pooling and a
    two-layer classifier, ``model.py:165-218``)."""
    sd = _strip_prefixes(sd)
    out = _with_trunk(sd, cfg)
    out["head.attention.ws1.weight"] = sd["attention.ws1.weight"]
    out["head.attention.ws2.weight"] = sd["attention.ws2.weight"]
    _linear(out, "head.dense1", sd, "classifier.1")
    _linear(out, "head.dense2", sd, "classifier.3")
    return out


def import_token_classifier(sd: Mapping[str, torch.Tensor],
                            cfg: PianoBartConfig) -> StateDict:
    """A reference ``TokenClassification`` (``model.py:236-272``)."""
    sd = _strip_prefixes(sd)
    out = _with_trunk(sd, cfg)
    _linear(out, "head.dense1", sd, "classifier.1")
    _linear(out, "head.dense2", sd, "classifier.3")
    return out


def import_checkpoint(path_or_sd: Union[str, Mapping[str, torch.Tensor]],
                      cfg: PianoBartConfig, kind: Optional[str] = None) -> StateDict:
    """A reference checkpoint (a path or a state dict) -> the port's
    ``state_dict`` entries.  ``kind`` in {None, 'trunk', 'lm', 'seq',
    'token'}; None detects it from the key names.  A trunk gives only
    ``pianobart.*`` entries."""
    sd = (load_torch_checkpoint(path_or_sd) if isinstance(path_or_sd, str)
          else dict(path_or_sd))
    sd = _strip_prefixes(sd)
    if kind is None:
        if any(k.startswith("mask_lm.") for k in sd):
            kind = "lm"
        elif any(k.startswith("attention.ws1") for k in sd):
            kind = "seq"
        elif any(k.startswith("classifier.") for k in sd):
            kind = "token"
        else:
            kind = "trunk"
    if kind == "trunk":
        return {f"pianobart.{k}": v for k, v in import_trunk(sd, cfg).items()}
    if kind == "lm":
        return import_lm(sd, cfg)
    if kind == "seq":
        return import_sequence_classifier(sd, cfg)
    if kind == "token":
        return import_token_classifier(sd, cfg)
    raise ValueError(f"unknown checkpoint kind: {kind}")
