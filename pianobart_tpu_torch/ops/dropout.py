"""Bit-sampled dropout, the counterpart of ``pianobart_tpu/ops/dropout.py``.

One uint8 of randomness per element compared with an integer threshold
``t = min(round(rate * 256), 255)``: the drop probability is quantised to
``t / 256`` (rate 0.1 becomes 26/256) and survivors are scaled by
``256 / (256 - t)``, the inverse of the quantised keep rate, so the output
stays unbiased.  The scale is first rounded to ``x.dtype``, as the reference
casts it (1.109375 in bf16 at rate 0.1, not 1.113043).  ``t`` is clamped at
255 so that rates in [0.998, 1) do not overflow uint8.

The bits come from an explicit ``torch.Generator`` on the tensor's device,
never from the global generator: a train step owns its randomness.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout", "threshold"]


def threshold(rate: float) -> int:
    """The uint8 drop threshold of ``rate``."""
    return min(int(round(rate * 256.0)), 255)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool = False) -> torch.Tensor:
    """``x`` with each element dropped with probability ``threshold(rate)/256``
    and the rest scaled to keep the mean; identity when ``deterministic`` or
    at rate 0."""
    if rate == 0.0 or deterministic:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    t = threshold(rate)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    # rounded to x.dtype on the host: a Python float, so no device copy
    scale = torch.tensor(256.0 / (256.0 - t), dtype=x.dtype).item()
    return torch.where(bits >= t, x * scale, 0.0)
