"""Octuple vocabulary: field layout, quantizer constants and bin tables.

A copy of ``pianobart_tpu/vocab.py`` up to its event naming (the port
imports nothing from the JAX package).  Eight per-field token spaces, each
ending with six specials ``<PAD> <MASK> <SOS> <EOS> <CLS> <SEP>`` whose ids
follow the largest content id of the field:

    Bar 262, Position 134, Instrument 135, Pitch 262,
    Duration 134, Velocity 38, TimeSig 260, Tempo 55

The quantizers (tempo, velocity, duration, time signature) are what the
MIDI codec (:mod:`pianobart_tpu_torch.tokenizer.codec`) needs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Quantizer constants (reference convert.py:16-43 / make_dict.py:4-24).
# ---------------------------------------------------------------------------
POS_RESOLUTION = 16        # positions per quarter-note beat
MAX_BAR = 255              # max content bar id (bar field has 256 content ids)
BAR_COUNT = MAX_BAR + 1
VELOCITY_QUANT = 4
TEMPO_QUANT = 12           # tempo bins per octave: 2 ** (1/12)
MIN_TEMPO = 16
MAX_TEMPO = 256
DURATION_MAX = 8           # in beats (2 ** 8 ticks worth of geometric table)
MAX_TS_DENOMINATOR = 6     # denominators 1..64
MAX_NOTES_PER_BAR = 2
BEAT_NOTE_FACTOR = 4       # MIDI whole note = 4 beats
MAX_INST = 128             # 0..127 programs, 128 = percussion
MAX_PITCH = 255            # 0..127 pitch, 128..255 percussion pitch
MAX_VELOCITY_TOK = 31
MAX_POS_TOK = 127
MAX_DURATION_TOK = 127
MAX_TS_TOK = 253
MAX_TEMPO_TOK = 48
TOKENS_PER_NOTE = 8
TRUNC_POS = 2 ** 16        # ~30 minutes cap during encoding
MAX_WINDOW = 1024          # model sequence window

FIELDS: Tuple[str, ...] = (
    "Bar", "Position", "Instrument", "Pitch",
    "Duration", "Velocity", "TimeSig", "Tempo",
)

#: Largest *content* id per field.
TOKEN_BOUNDARY: Tuple[int, ...] = (
    MAX_BAR, MAX_POS_TOK, MAX_INST, MAX_PITCH,
    MAX_DURATION_TOK, MAX_VELOCITY_TOK, MAX_TS_TOK, MAX_TEMPO_TOK,
)

SPECIALS: Tuple[str, ...] = ("<PAD>", "<MASK>", "<SOS>", "<EOS>", "<CLS>", "<SEP>")

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


def tempo_to_bin(bpm: float) -> int:
    """Log-quantize a BPM value (reference convert.py:120-126 ``b2e``)."""
    bpm = min(max(bpm, MIN_TEMPO), MAX_TEMPO)
    return int(round(math.log2(bpm / MIN_TEMPO) * TEMPO_QUANT))


def bin_to_tempo(e: int) -> float:
    """Inverse of :func:`tempo_to_bin` (reference convert.py:128-129 ``e2b``)."""
    return 2 ** (e / TEMPO_QUANT) * MIN_TEMPO


def velocity_to_bin(v: int) -> int:
    """reference convert.py:112-113 ``v2e``."""
    return v // VELOCITY_QUANT


def bin_to_velocity(e: int) -> int:
    """reference convert.py:116-117 ``e2v``."""
    return e * VELOCITY_QUANT + VELOCITY_QUANT // 2


def _build_ts_table() -> Tuple[Dict[Tuple[int, int], int], List[Tuple[int, int]]]:
    """Time-signature enumeration (reference convert.py:81-86)."""
    ts_dict: Dict[Tuple[int, int], int] = {}
    ts_list: List[Tuple[int, int]] = []
    for i in range(MAX_TS_DENOMINATOR + 1):
        for j in range(1, (2 ** i) * MAX_NOTES_PER_BAR + 1):
            ts_dict[(j, 2 ** i)] = len(ts_dict)
            ts_list.append((j, 2 ** i))
    return ts_dict, ts_list


TS_DICT, TS_LIST = _build_ts_table()


def _build_duration_tables() -> Tuple[np.ndarray, np.ndarray]:
    """Geometric duration quantization tables (reference convert.py:87-93).

    ``dur_enc[t]`` maps a tick-duration to a bin; ``dur_dec[bin]`` maps back
    to a representative tick count.
    """
    enc: List[int] = []
    dec: List[int] = []
    for i in range(DURATION_MAX):
        for _ in range(POS_RESOLUTION):
            dec.append(len(enc))
            for _ in range(2 ** i):
                enc.append(len(dec) - 1)
    return np.asarray(enc, dtype=np.int32), np.asarray(dec, dtype=np.int32)


DUR_ENC, DUR_DEC = _build_duration_tables()


def duration_to_bin(d: int) -> int:
    """reference convert.py:104-105 ``d2e``.

    A negative d (a caller-built note with end < start; parsed files never
    give one) clamps to bin 0, as the JAX package does."""
    if d < 0:
        return int(DUR_ENC[0])
    return int(DUR_ENC[d]) if d < len(DUR_ENC) else int(DUR_ENC[-1])


def bin_to_duration(e: int) -> int:
    """reference convert.py:108-109 ``e2d``."""
    return int(DUR_DEC[e]) if e < len(DUR_DEC) else int(DUR_DEC[-1])


def ts_to_bin(numerator: int, denominator: int) -> int:
    """reference convert.py:95-97 ``t2e`` (expects an already-reduced sig)."""
    key = (numerator, denominator)
    if key not in TS_DICT:
        raise ValueError(f"unsupported time signature: {key}")
    return TS_DICT[key]


def bin_to_ts(e: int) -> Tuple[int, int]:
    """reference convert.py:100-101 ``e2t``."""
    return TS_LIST[e]


def time_signature_reduce(numerator: int, denominator: int) -> Tuple[int, int]:
    """Normalize a raw MIDI time signature (reference convert.py:138-149)."""
    while (denominator > 2 ** MAX_TS_DENOMINATOR and denominator % 2 == 0
           and numerator % 2 == 0):
        denominator //= 2
        numerator //= 2
    while numerator > MAX_NOTES_PER_BAR * denominator:
        for i in range(2, numerator + 1):
            if numerator % i == 0:
                numerator //= i
                break
    return numerator, denominator
