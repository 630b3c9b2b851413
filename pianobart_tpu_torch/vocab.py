"""Octuple vocabulary constants the serving and pretrain paths need.

A copy of the field layout of ``pianobart_tpu/vocab.py`` (the port imports
nothing from the JAX package).  Eight per-field token spaces, each ending
with six specials ``<PAD> <MASK> <SOS> <EOS> <CLS> <SEP>`` whose ids follow
the largest content id of the field:

    Bar 262, Position 134, Instrument 135, Pitch 262,
    Duration 134, Velocity 38, TimeSig 260, Tempo 55
"""
from __future__ import annotations

from typing import Tuple

MAX_WINDOW = 1024          # model sequence window

#: Largest *content* id per field.
TOKEN_BOUNDARY: Tuple[int, ...] = (255, 127, 128, 255, 127, 31, 253, 48)

#: Per-field id of each special token.
PAD = tuple(b + 1 for b in TOKEN_BOUNDARY)
MASK = tuple(b + 2 for b in TOKEN_BOUNDARY)
SOS = tuple(b + 3 for b in TOKEN_BOUNDARY)
EOS = tuple(b + 4 for b in TOKEN_BOUNDARY)
CLS = tuple(b + 5 for b in TOKEN_BOUNDARY)
SEP = tuple(b + 6 for b in TOKEN_BOUNDARY)

#: Per-field vocabulary sizes (content + 6 specials).
FIELD_SIZES: Tuple[int, ...] = tuple(b + 7 for b in TOKEN_BOUNDARY)
TOTAL_VOCAB = sum(FIELD_SIZES)  # 1280

#: Offsets of each field within the fused (concatenated) vocabulary.
FIELD_OFFSETS: Tuple[int, ...] = tuple(sum(FIELD_SIZES[:i])
                                       for i in range(len(FIELD_SIZES)))
