#!/usr/bin/env python3
"""Roofline bounds on one H100 of the TPU kernels that the PyTorch port has
not ported yet, at the shapes they would run:

    python3 kernel_bounds.py

Each input is read once and each output written once; activations are bf16.
The two left are L1 and L2, TPU experiments on K1's forward whose Hopper
counterpart is K1's redesign, at K1's train shape B=32, S=1024, H=8, D=128,
no mask: 2 products of ``2*S*S*D`` FLOPs per (b, h).

The ported kernels' bounds are computed by ``chip_smoke.py`` from its own
inputs.  Pure arithmetic: needs no card.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pianobart_tpu_torch.utils.flops import roofline_ms  # noqa: E402


def unported_kernel_bounds():
    """``{id: (shape, ms, bound_by)}`` for the kernels still to port."""
    out = {}
    B, S, H, D = 32, 1024, 8, 128
    for kid in ("L1", "L2"):
        out[kid] = (f"B={B} S={S} H={H} D={D} bf16", *roofline_ms(
            2 * 2.0 * S * S * D * B * H, 4 * B * S * H * D * 2 + B * H * S * 4))
    return out


if __name__ == "__main__":
    for kid, (shape, ms, by) in unported_kernel_bounds().items():
        print(f"{kid}  {shape}: bound {ms:.4f} ms ({by})")
