"""Window padding (``pianobart_tpu/tokenizer/segment.py``).

The serving path's part of the segmentation module: ``pad_segment``, which
the demo's intro windowing uses (reference ``convert.py:321-333``
``padding``).  Song segmentation, task packaging and ``data_split`` come
with the dataset tokenizer.
"""
from __future__ import annotations

from typing import List, Tuple

from .. import vocab as V

__all__ = ["pad_segment"]

_EOS = tuple(V.EOS)
_PAD = tuple(V.PAD)


def pad_segment(segment: List[Tuple[int, ...]], window: int = V.MAX_WINDOW,
                last: bool = False) -> List[Tuple[int, ...]]:
    """Pad with ``<PAD>`` rows to ``window`` or truncate + ``<EOS>``.

    Mirrors ``padding`` (convert.py:321-333): an over-long segment keeps the
    first ``window-1`` rows (or the *last* ``window-1`` when ``last=True``,
    used by the demo's intro windowing, demo.py:64) and appends ``<EOS>``.
    """
    pad_num = window - len(segment)
    if pad_num < 0:
        segment = segment[1 - window:] if last else segment[:window - 1]
        return list(segment) + [_EOS]
    return list(segment) + [_PAD] * pad_num
