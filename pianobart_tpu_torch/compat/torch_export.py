"""Export the port's weights in the reference PianoBART checkpoint layout,
the counterpart of ``pianobart_tpu/compat/torch_export.py`` and the inverse
of :mod:`.torch_import`: the fused (1280, emb_size) table goes back into 8
``word_emb.{i}.lut.weight`` tables, the fused LM head into 8
``mask_lm.proj.{i}`` linears.

The inputs are the port's ``state_dict``s (``model.state_dict()``, or a
checkpoint's).  The Bart token-embedding tables that the reference carries
but never uses with octuple inputs (``bart.shared``, ``embed_tokens``) are
emitted only with ``strict_ref``, for the reference's strict
``load_state_dict`` (its ``main.py:168``); zeros there behave the same.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.config import PianoBartConfig

__all__ = ["export_trunk", "export_lm", "export_sequence_classifier",
           "export_token_classifier", "save_torch_checkpoint",
           "HF_BART_DEFAULT_VOCAB"]

StateDict = Dict[str, torch.Tensor]
HF_BART_DEFAULT_VOCAB = 50265  # transformers BartConfig default


def _linear(out: StateDict, theirs: str, sd: Mapping, ours: str) -> None:
    out[f"{theirs}.weight"] = sd[f"{ours}.weight"]
    if f"{ours}.bias" in sd:
        out[f"{theirs}.bias"] = sd[f"{ours}.bias"]


def _layer(out: StateDict, theirs: str, sd: Mapping, ours: str, cross: bool) -> None:
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(out, f"{theirs}.self_attn.{p}", sd, f"{ours}.self_attn.{p}")
    _linear(out, f"{theirs}.self_attn_layer_norm", sd, f"{ours}.self_attn_layer_norm")
    _linear(out, f"{theirs}.fc1", sd, f"{ours}.ffn.fc1")
    _linear(out, f"{theirs}.fc2", sd, f"{ours}.ffn.fc2")
    _linear(out, f"{theirs}.final_layer_norm", sd, f"{ours}.final_layer_norm")
    if cross:
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(out, f"{theirs}.encoder_attn.{p}", sd, f"{ours}.cross_attn.{p}")
        _linear(out, f"{theirs}.encoder_attn_layer_norm", sd,
                f"{ours}.cross_attn_layer_norm")


def _ref_unused_embeddings(cfg: PianoBartConfig) -> StateDict:
    """The reference ``BartModel``'s token-embedding tables (one shared
    zero tensor): its strict ``load_state_dict`` wants them."""
    z = torch.zeros(HF_BART_DEFAULT_VOCAB, cfg.d_model)
    return {"bart.shared.weight": z, "bart.encoder.embed_tokens.weight": z,
            "bart.decoder.embed_tokens.weight": z}


def export_trunk(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig,
                 prefix: str = "", strict_ref: bool = False,
                 source: str = "pianobart.") -> StateDict:
    """The port's trunk entries (named ``{source}embed.table``, ...) -> a
    reference ``PianoBart`` state dict under ``prefix``."""
    t = {k[len(source):]: v for k, v in sd.items() if k.startswith(source)}
    out: StateDict = _ref_unused_embeddings(cfg) if strict_ref else {}
    for i, part in enumerate(torch.split(t["embed.table"], list(cfg.field_sizes))):
        out[f"word_emb.{i}.lut.weight"] = part
    _linear(out, "encoder_linear", t, "embed.fusion")
    if cfg.decoder_label_vocab is None:
        # the reference's decoder_linear aliases encoder_linear
        _linear(out, "decoder_linear", t, "embed.fusion")
    elif "decoder_embed.table" in t:
        out["decoder_emb.lut.weight"] = t["decoder_embed.table"]
        _linear(out, "decoder_linear", t, "decoder_embed.proj")
    for side, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        out[f"bart.{side}.embed_positions.weight"] = t[f"{side}.embed_positions.embedding"]
        _linear(out, f"bart.{side}.layernorm_embedding", t, f"{side}.layernorm_embedding")
        for i in range(n):
            _layer(out, f"bart.{side}.layers.{i}", t, f"{side}.layers.{i}",
                   cross=side == "decoder")
    return {prefix + k: v for k, v in out.items()}


def export_lm(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig,
              strict_ref: bool = False) -> StateDict:
    """The port's ``PianoBartLM`` -> a reference ``PianoBartLM``."""
    out = export_trunk(sd, cfg, prefix="pianobart.", strict_ref=strict_ref)
    sizes = list(cfg.field_sizes)
    for i, (w, b) in enumerate(zip(torch.split(sd["lm_head.proj.weight"], sizes),
                                   torch.split(sd["lm_head.proj.bias"], sizes))):
        out[f"mask_lm.proj.{i}.weight"] = w
        out[f"mask_lm.proj.{i}.bias"] = b
    return out


def export_sequence_classifier(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig,
                               strict_ref: bool = False) -> StateDict:
    """The port's ``SequenceClassification`` -> the reference's (attention
    pooling and a two-layer classifier, ``model.py:165-218``)."""
    out = export_trunk(sd, cfg, prefix="pianobart.", strict_ref=strict_ref)
    out["attention.ws1.weight"] = sd["head.attention.ws1.weight"]
    out["attention.ws2.weight"] = sd["head.attention.ws2.weight"]
    _linear(out, "classifier.1", sd, "head.dense1")
    _linear(out, "classifier.3", sd, "head.dense2")
    return out


def export_token_classifier(sd: Mapping[str, torch.Tensor], cfg: PianoBartConfig,
                            strict_ref: bool = False) -> StateDict:
    """The port's ``TokenClassification`` -> the reference's
    (``model.py:236-272``)."""
    out = export_trunk(sd, cfg, prefix="pianobart.", strict_ref=strict_ref)
    _linear(out, "classifier.1", sd, "head.dense1")
    _linear(out, "classifier.3", sd, "head.dense2")
    return out


def save_torch_checkpoint(sd: Mapping[str, torch.Tensor], path: str,
                          epoch: int = 0) -> None:
    """Write a reference-format ``{'epoch': ..., 'state_dict': ...}`` file,
    every tensor f32, contiguous, on the host."""
    tensors = {k: v.detach().to("cpu", torch.float32).contiguous()
               for k, v in sd.items()}
    torch.save({"epoch": epoch, "state_dict": tensors}, path)
