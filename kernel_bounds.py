#!/usr/bin/env python3
"""Roofline bounds on one H100 of the TPU kernels that the PyTorch port has
not ported yet, at the shapes they would run:

    python3 kernel_bounds.py

Each input is read once and each output written once; activations are bf16.

* K3a/K3b, the two-kernel flash backward (dQ; dK and dV), at the long
  context B=16, S=2048, H=8, D=128 (the flagship's tokens per batch), no
  mask: 3 and 4 products of ``2*S*S*D`` FLOPs per (b, h);
* K4a/K4b, LayerNorm(residual + dropout(h)) and its backward, over the
  flagship batch's N=32768 rows of D=1024, about 10 and 20 f32 operations
  per element;
* L1/L2, K1's forward redesigned, at K1's train shape B=32, S=1024, no
  mask: 2 products.

The ported kernels' bounds are computed by ``chip_smoke.py`` from its own
inputs.  Pure arithmetic: needs no card.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pianobart_tpu_torch.utils.flops import PEAK_F32_H100, roofline_ms  # noqa: E402


def unported_kernel_bounds():
    """``{id: (shape, ms, bound_by)}`` for the kernels still to port."""
    out = {}
    B, S, H, D = 16, 2048, 8, 128
    act = B * S * H * D * 2                       # one (B, S, H, D) bf16 array
    rows = B * H * S * 4                          # lse or delta, f32
    for kid, products, n_out in (("K3a", 3, 1), ("K3b", 4, 2)):
        out[kid] = (f"B={B} S={S} H={H} D={D} bf16",
                    *roofline_ms(products * 2.0 * S * S * D * B * H,
                                 (4 + n_out) * act + 2 * rows))
    N, Dm = 32 * 1024, 1024
    x, vec, stat = N * Dm * 2, Dm * 4, N * 4
    out["K4a"] = (f"N={N} D={Dm} bf16", *roofline_ms(
        10.0 * N * Dm, 3 * x + 2 * vec + 2 * stat, PEAK_F32_H100))
    out["K4b"] = (f"N={N} D={Dm} bf16", *roofline_ms(
        20.0 * N * Dm, 5 * x + vec + 2 * stat, PEAK_F32_H100))
    B, S = 32, 1024
    for kid in ("L1", "L2"):
        out[kid] = (f"B={B} S={S} H={H} D={D} bf16", *roofline_ms(
            2 * 2.0 * S * S * D * B * H, 4 * B * S * H * D * 2 + B * H * S * 4))
    return out


if __name__ == "__main__":
    for kid, (shape, ms, by) in unported_kernel_bounds().items():
        print(f"{kid}  {shape}: bound {ms:.4f} ms ({by})")
