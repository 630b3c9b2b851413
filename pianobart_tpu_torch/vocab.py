"""Octuple vocabulary: field layout, quantizer constants, bin tables and
the reference-compatible dictionary (``Octuple.pkl``, ``dict.txt``).

A copy of ``pianobart_tpu/vocab.py`` (the port imports nothing from the JAX
package).  Eight per-field token spaces, each
ending with six specials ``<PAD> <MASK> <SOS> <EOS> <CLS> <SEP>`` whose ids
follow the largest content id of the field:

    Bar 262, Position 134, Instrument 135, Pitch 262,
    Duration 134, Velocity 38, TimeSig 260, Tempo 55

The quantizers (tempo, velocity, duration, time signature) are what the
MIDI codec (:mod:`pianobart_tpu_torch.tokenizer.codec`) needs;
:class:`OctupleVocab` names every event as the reference's ``make_dict.py``
does (``cli make-dict`` writes its pickle and ``dict.txt``).
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from functools import cached_property
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

PAD_WORD = np.array(PAD, dtype=np.int64)
MASK_WORD = np.array(MASK, dtype=np.int64)
SOS_WORD = np.array(SOS, dtype=np.int64)
EOS_WORD = np.array(EOS, dtype=np.int64)
CLS_WORD = np.array(CLS, dtype=np.int64)
SEP_WORD = np.array(SEP, dtype=np.int64)


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


# ---------------------------------------------------------------------------
# Human-readable event naming (make_dict.py parity).
# ---------------------------------------------------------------------------

def _format_tempo(e: int) -> str:
    # make_dict.py prints the float produced by e2b verbatim via f-string.
    return f"Tempo {bin_to_tempo(e)}"


def _content_event_names(field: str) -> List[str]:
    if field == "Bar":
        return [f"Bar {i}" for i in range(BAR_COUNT)]
    if field == "Position":
        denom = BEAT_NOTE_FACTOR * POS_RESOLUTION
        return [f"Position {i}/{denom}" for i in range(MAX_POS_TOK + 1)]
    if field == "Instrument":
        return [f"Instrument {i}" for i in range(MAX_INST)] + ["Instrument percussion"]
    if field == "Pitch":
        names = [f"Pitch {i}" for i in range(128)]
        names += [f"Pitch percussion {i}" for i in range(128)]
        return names
    if field == "Duration":
        return [f"Duration {i}" for i in range(MAX_DURATION_TOK + 1)]
    if field == "Velocity":
        return [f"Velocity {bin_to_velocity(i)}" for i in range(MAX_VELOCITY_TOK + 1)]
    if field == "TimeSig":
        return [f"TimeSig {n}/{d}" for (n, d) in TS_LIST]
    if field == "Tempo":
        return [_format_tempo(i) for i in range(MAX_TEMPO_TOK + 1)]
    raise KeyError(field)


@dataclasses.dataclass(frozen=True)
class OctupleVocab:
    """The 8-field Octuple vocabulary with reference-compatible views."""

    fields: Tuple[str, ...] = FIELDS
    sizes: Tuple[int, ...] = FIELD_SIZES

    @cached_property
    def e2w(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for f in self.fields:
            names = _content_event_names(f) + [f"{f} {s}" for s in SPECIALS]
            out[f] = {name: i for i, name in enumerate(names)}
        return out

    @cached_property
    def w2e(self) -> Dict[str, Dict[int, str]]:
        return {f: {i: n for n, i in m.items()} for f, m in self.e2w.items()}

    @property
    def n_tokens(self) -> List[int]:
        return list(self.sizes)

    @property
    def total(self) -> int:
        return TOTAL_VOCAB

    @property
    def offsets(self) -> Tuple[int, ...]:
        return FIELD_OFFSETS

    # Special words as (8,) arrays, mirroring PianoBart.py:38-41.
    pad_word = PAD_WORD
    mask_word = MASK_WORD
    sos_word = SOS_WORD
    eos_word = EOS_WORD
    cls_word = CLS_WORD
    sep_word = SEP_WORD

    @property
    def bar_pad_id(self) -> int:
        return PAD[0]

    def save_pickle(self, path: str) -> None:
        """Dump an ``Octuple.pkl``-compatible ``(e2w, w2e)`` tuple."""
        with open(path, "wb") as f:
            pickle.dump((self.e2w, self.w2e), f)

    @staticmethod
    def from_pickle(path: str) -> "OctupleVocab":
        """Load and *verify* a reference pickle matches the derived vocab."""
        with open(path, "rb") as f:
            e2w, _ = pickle.load(f)
        vocab = OctupleVocab()
        derived = vocab.e2w

        def _norm(name: str) -> str:
            # Tempo event names embed a float repr that differs across Python
            # versions; normalize numerically.
            if name.startswith("Tempo ") and not any(s in name for s in SPECIALS):
                return f"Tempo {float(name.split(' ', 1)[1]):.9g}"
            return name

        for field in vocab.fields:
            ref = {_norm(k): v for k, v in e2w[field].items()}
            mine = {_norm(k): v for k, v in derived[field].items()}
            if ref != mine:
                raise ValueError(f"pickle vocabulary mismatch in field {field}")
        return vocab

    def dump_dict_txt(self, path: str) -> None:
        """Write a ``dict.txt``-compatible listing (one line per token)."""
        with open(path, "w") as f:
            for field in self.fields:
                for name, idx in self.e2w[field].items():
                    f.write(f"{name}:  {idx}\n")


VOCAB = OctupleVocab()
