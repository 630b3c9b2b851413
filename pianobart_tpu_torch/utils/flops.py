"""Analytic FLOP count of the pretrain step, the counterpart of
``pianobart_tpu/utils/flops.py``, with the H100's peaks in place of the TPU
table, and the roofline bound of a kernel's work on one H100.

* dense products: ``6 * tokens * (parameters that enter a product)`` for
  forward and backward;
* attention, two conventions: **model FLOPs** count 2 forward and 4
  backward S x S x d_model products per attention module; **hardware FLOPs**
  count 2 forward and 5 backward, as a flash backward recomputes the scores
  (the port's K2, and K3a + K3b at S > 1024, compute them twice more: the
  dK/dV and dQ passes each take S and dP, so they execute 7 backward
  products).

MFU is model FLOPs per second over the peak.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

__all__ = ["PEAK_BF16_H100", "PEAK_TF32_H100", "PEAK_F32_H100", "HBM_BYTES_PER_S_H100",
           "roofline_ms", "matmul_param_count", "pretrain_step_flops"]

# NVIDIA H100 SXM data-sheet peaks at a 700 W power limit
PEAK_BF16_H100 = 989e12         # dense bf16 tensor-core FLOP/s
PEAK_TF32_H100 = 495e12         # dense tf32 tensor-core FLOP/s (3xTF32 f32: a third)
PEAK_F32_H100 = 67e12           # f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S_H100 = 3.35e12  # HBM3


def roofline_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_H100
                ) -> Tuple[float, str]:
    """Least time (ms) one H100 could take for ``flops`` operations at
    ``peak`` and ``nbytes`` moved once through HBM, and which of the two
    bounds it: ``"operations"`` or ``"bytes"``."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S_H100
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def matmul_param_count(state_dict: Mapping[str, torch.Tensor]) -> int:
    """Parameters that enter a matrix product: every tensor of two or more
    dimensions except the gathered tables (positions ``...embedding``, the
    fused octuple ``...table``)."""
    return sum(t.numel() for name, t in state_dict.items()
               if t.dim() >= 2 and not name.endswith(("embedding", "table")))


def pretrain_step_flops(state_dict: Mapping[str, torch.Tensor], cfg,
                        batch_size: int, seq_len: int) -> Tuple[float, float]:
    """(model_flops, hardware_flops) of one forward+backward pretrain step."""
    tokens = batch_size * seq_len
    dense = 6 * tokens * matmul_param_count(state_dict)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    attn_unit = 2 * batch_size * seq_len * seq_len * cfg.d_model
    return (float(dense + n_attn * (2 + 4) * attn_unit),
            float(dense + n_attn * (2 + 5) * attn_unit))
