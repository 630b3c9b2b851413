"""Model configuration: the dataclass of ``pianobart_tpu/models/config.py``
with ``torch.dtype`` fields, and the reference's defaults for remat and the
ring/TP fields.  ``fused_dropout_ln`` stands in for the reference's
``PBX_FUSED_DROPLN`` environment switch.

Parameters are held in ``param_dtype`` and cast to ``dtype`` where they are
used, as flax's ``Dense(dtype, param_dtype)`` does: f32 weights under bf16
compute for training (a bf16 weight of magnitude 0.02 would round away an
AdamW step of 2e-5), bf16 weights for serving.

Defaults are the published PianoBART shape: d_model 1024, 8+8 layers, ffn
2048, 8 heads, seq 1024, Octuple vocab 1280.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import vocab as V


@dataclasses.dataclass(frozen=True)
class PianoBartConfig:
    field_sizes: Tuple[int, ...] = V.FIELD_SIZES
    emb_size: int = 256                    # per-field embedding width
    d_model: int = 1024
    encoder_layers: int = 8
    decoder_layers: int = 8
    ffn_dim: int = 2048
    num_heads: int = 8
    max_len: int = V.MAX_WINDOW
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    pos_offset: int = 2                    # HF Bart learned-pos-embedding offset
    # The velocity finetune's decoder reads label ids through a
    # LabelEmbedding of this vocabulary instead of the octuple embedding.
    decoder_label_vocab: Optional[int] = None
    decoder_label_dim: int = 64
    dtype: torch.dtype = torch.float32     # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    use_flash_attention: bool = True       # flash kernel where eligible
    # Every sublayer tail LayerNorm(residual + dropout(h)) as the fused K4
    # kernels (ops/fused_ln.py) when training with dropout on eligible
    # shapes: the counterpart of the reference's PBX_FUSED_DROPLN=1, which
    # is off by default there.  Read from the config, never the environment.
    fused_dropout_ln: bool = False
    # Recompute every layer in the backward (torch.utils.checkpoint), or with
    # remat_ffn only the FFN: memory for compute.  Dropout replays its bits.
    remat: bool = False
    remat_ffn: bool = False
    # Sequence-parallel ring attention: the mesh axis ("sp") the sequence is
    # sharded over (ops/ring.py), resolved to a process group of the mesh
    # active around the forward (parallel/mesh.py:use_mesh).  None = dense.
    ring_axis: Optional[str] = None
    # TP∘SP: the tp mesh axis and its size; each tp rank projects and
    # ring-attends num_heads / ring_tp_size heads of replicated weights.
    ring_tp_axis: Optional[str] = None
    ring_tp_size: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def n_fields(self) -> int:
        return len(self.field_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_sizes))

    @property
    def field_offsets(self) -> Tuple[int, ...]:
        off, acc = [], 0
        for s in self.field_sizes:
            off.append(acc)
            acc += s
        return tuple(off)

    def replace(self, **kw) -> "PianoBartConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**kw) -> PianoBartConfig:
    """Small config for tests (same as the JAX package's ``tiny_config``)."""
    base = dict(d_model=64, emb_size=16, encoder_layers=2, decoder_layers=2,
                ffn_dim=128, num_heads=4, max_len=32, dropout=0.0,
                use_flash_attention=False)
    base.update(kw)
    return PianoBartConfig(**base)
