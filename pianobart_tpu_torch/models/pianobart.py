"""PianoBart trunk and LM (``pianobart_tpu/models/pianobart.py``).

* :class:`PianoBart` — fused octuple embeddings + BART encoder-decoder.
* :class:`PianoBartLM` — trunk + fused LM head, with the decode-loop entry
  points ``encode``, ``decode_step`` and ``build_cache``.
* :class:`SequenceClassification` — composer / emotion: the decoder is fed
  the encoder's ids and mask, then attention pooling and an MLP.
* :class:`TokenClassification` — melody / velocity: a per-position MLP; with
  ``cfg.decoder_label_vocab`` the decoder reads label ids through a
  :class:`~.embedding.LabelEmbedding` (velocity).

The training forward is ``model.train()`` then ``model(..., generator=g)``:
dropout draws its bits from ``g``.  In eval mode no generator is needed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import vocab as V
from .bart import Decoder, Encoder
from .config import PianoBartConfig
from .embedding import LabelEmbedding, OctupleEmbedding
from .heads import OctupleLMHead, SequenceClassifierHead, TokenClassifierHead


def attention_mask_from_bars(ids: torch.Tensor) -> torch.Tensor:
    """1.0 where the octuple is not padding (Bar field != Bar <PAD>)."""
    return (ids[..., 0] != V.PAD[0]).float()


class PianoBart(nn.Module):
    """Encoder-decoder trunk over octuple ids (the decoder over label ids
    when ``cfg.decoder_label_vocab`` is set)."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = OctupleEmbedding(cfg, device)
        if cfg.decoder_label_vocab is not None:
            self.decoder_embed = LabelEmbedding(cfg, device)
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)

    def _decoder_inputs(self, decoder_ids: torch.Tensor) -> torch.Tensor:
        if self.cfg.decoder_label_vocab is not None:
            return self.decoder_embed(decoder_ids)
        return self.embed(decoder_ids)

    def forward(self, encoder_ids, decoder_ids=None, encoder_mask=None,
                decoder_mask=None, generator: Optional[torch.Generator] = None):
        enc_out = self.encode(encoder_ids, encoder_mask, generator)
        if decoder_ids is None:
            return enc_out  # encoder-only path
        dec_out, _ = self.decoder(self._decoder_inputs(decoder_ids), enc_out,
                                  self_mask=decoder_mask, enc_mask=encoder_mask,
                                  generator=generator)
        return dec_out

    def encode(self, encoder_ids, encoder_mask=None,
               generator: Optional[torch.Generator] = None):
        return self.encoder(self.embed(encoder_ids), encoder_mask, generator)

    def decode_step(self, decoder_ids_step, enc_out, encoder_mask, cache,
                    cache_index):
        """One incremental step: ids (B, 1, 8) + cache -> hidden, cache."""
        return self.decoder(self._decoder_inputs(decoder_ids_step), enc_out,
                            self_mask=None, enc_mask=encoder_mask,
                            cache=cache, cache_index=cache_index)

    def build_cache(self, enc_out, batch: int, length: int):
        """Zeroed self-attention K/V + empty cross slots (cross K/V are
        filled on the first decode step and reused)."""
        cfg = self.cfg
        shape = (batch, length, cfg.num_heads, cfg.head_dim)

        def zeros():
            return {"k": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device),
                    "v": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device)}
        return {f"layers_{i}": {"self": zeros(), "cross": {}}
                for i in range(cfg.decoder_layers)}


class PianoBartLM(nn.Module):
    """Trunk + fused octuple LM head (pretrain / generation model)."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.pianobart = PianoBart(cfg, device)
        self.lm_head = OctupleLMHead(cfg, device)

    def forward(self, encoder_ids, decoder_ids=None, encoder_mask=None,
                decoder_mask=None, generator: Optional[torch.Generator] = None):
        hidden = self.pianobart(encoder_ids, decoder_ids, encoder_mask,
                                decoder_mask, generator)
        return self.lm_head(hidden)  # fused logits (B, S, 1280)

    def encode(self, encoder_ids, encoder_mask: Optional[torch.Tensor] = None):
        return self.pianobart.encode(encoder_ids, encoder_mask)

    def decode_step(self, decoder_ids_step, enc_out, encoder_mask, cache,
                    cache_index):
        hidden, new_cache = self.pianobart.decode_step(
            decoder_ids_step, enc_out, encoder_mask, cache, cache_index)
        return self.lm_head(hidden), new_cache

    def build_cache(self, enc_out, batch, length):
        return self.pianobart.build_cache(enc_out, batch, length)


class SequenceClassification(nn.Module):
    """Composer / emotion classifier: the decoder is fed the encoder's ids
    and mask (reference ``model.py:204``), its output pooled."""

    def __init__(self, cfg: PianoBartConfig, class_num: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.class_num = class_num
        self.pianobart = PianoBart(cfg, device)
        self.head = SequenceClassifierHead(cfg, class_num, device=device)

    def forward(self, encoder_ids, encoder_mask=None,
                generator: Optional[torch.Generator] = None,
                head_generator: Optional[torch.Generator] = None):
        """``head_generator`` (default ``generator``) draws the head's
        dropout: the mesh steps pass one that every rank of a dp block
        shares, as the pooled vector they all compute is one."""
        hidden = self.pianobart(encoder_ids, encoder_ids, encoder_mask,
                                encoder_mask, generator)
        return self.head(hidden, generator if head_generator is None
                         else head_generator)  # (B, class_num)


class TokenClassification(nn.Module):
    """Melody / velocity per-token classifier.  ``class_num`` counts the
    extra pad class: the caller passes ``n_labels + 1``, as the reference's
    ``finetune.py:98`` does."""

    def __init__(self, cfg: PianoBartConfig, class_num: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.class_num = class_num
        self.pianobart = PianoBart(cfg, device)
        self.head = TokenClassifierHead(cfg, class_num, device)

    def forward(self, encoder_ids, decoder_ids, encoder_mask=None,
                decoder_mask=None, generator: Optional[torch.Generator] = None):
        hidden = self.pianobart(encoder_ids, decoder_ids, encoder_mask,
                                decoder_mask, generator)
        return self.head(hidden, generator)  # (B, S, class_num)
