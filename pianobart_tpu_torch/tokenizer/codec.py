"""MIDI <-> Octuple codec (a copy of ``pianobart_tpu/tokenizer/codec.py``).

Re-derivation of the reference quantization pipeline with bit-identical
output streams (reference ``Data/data_generation/convert.py:157-319``:
``MIDI_to_encoding`` / ``encoding_to_MIDI``).  Works on
:class:`pianobart_tpu_torch.midi.events.MidiFile` objects instead of miditoolkit.

Numerical parity notes:

* position quantization uses Python's banker's rounding, as the reference's
  ``round()`` does (``convert.py:160``);
* per-bar time signature is the majority vote with ties resolved to the
  smallest bin id (CPython ``max(set(i), key=i.count)`` over small-int sets
  scans in ascending order, keeping the first maximum — ``convert.py:249``);
* per-position tempo is the banker's-rounded mean (``convert.py:272``).

Deliberate deviation: the reference encoder maps drum notes to
``Program 129 / Pitch+256`` (convert.py:214 with the module-local
``max_inst=128, max_pitch=255``) — ids *outside* the 135/262-entry
Instrument/Pitch vocabularies, which its own decoder (convert.py:281-297,
``i == 128`` drum check) and its dictionary ("Instrument percussion" = 128,
"Pitch percussion" = 128..255) cannot represent; its piano-only datasets
never exercise the path.  We implement the documented intent
(convert.py:78): drums are ``Program 128 / Pitch+128``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..midi.events import Instrument, MidiFile, Note, TempoChange, TimeSignature
from .. import vocab as V

__all__ = [
    "midi_to_octuple",
    "octuple_to_midi",
    "MELODY_MAP",
    "VELOCITY_MAP",
    "EMOTION_MAP",
    "velocity_label",
]

# Downstream-task label maps (reference convert.py:45-67).
MELODY_MAP = {"MELODY": 0, "BRIDGE": 1, "PIANO": 2, "OTHER": 3}
VELOCITY_MAP = {"pp": 0, "p": 1, "mp": 2, "mf": 3, "f": 4, "ff": 5, "OTHER": 6}
EMOTION_MAP = {"HVHA": 0, "HVLA": 1, "LVHA": 2, "LVLA": 3}


def velocity_label(v: int) -> int:
    """6-way dynamic-level label for the velocity task (convert.py:217-223)."""
    if 0 <= v <= 15:
        return 0
    if 112 <= v <= 127:
        return 5
    label = (v - 32) // 16 + 1
    assert 0 <= label <= 5
    return label


def midi_to_octuple(midi: MidiFile, task: str = "pretrain") -> List[Tuple[int, ...]]:
    """Quantize a MIDI file into sorted Octuple tuples.

    Returns tuples ``(Bar, Pos, Program, Pitch, Duration, Velocity, TimeSig,
    Tempo)`` — with a trailing task label for ``melody``/``velocity`` —
    sorted lexicographically, exactly like the reference encoder.
    """
    tpb = midi.ticks_per_beat

    def time_to_pos(t: int) -> int:
        return round(t * V.POS_RESOLUTION / tpb)

    starts = [time_to_pos(n.start) for inst in midi.instruments for n in inst.notes]
    if not starts:
        return []
    max_pos = min(max(starts) + 1, V.TRUNC_POS)

    # Per-position (bar, timesig_bin, pos_in_bar, tempo_bin).
    ts_bin = [0] * max_pos
    ts_set = [False] * max_pos
    tempo_bin = [0] * max_pos
    tempo_set = [False] * max_pos

    tsc = midi.time_signature_changes
    for i, ts in enumerate(tsc):
        lo = time_to_pos(ts.time)
        hi = time_to_pos(tsc[i + 1].time) if i < len(tsc) - 1 else max_pos
        b = V.ts_to_bin(*V.time_signature_reduce(ts.numerator, ts.denominator))
        for j in range(lo, hi):
            if 0 <= j < max_pos:
                ts_bin[j] = b
                ts_set[j] = True
    tpc = midi.tempo_changes
    for i, tc in enumerate(tpc):
        lo = time_to_pos(tc.time)
        hi = time_to_pos(tpc[i + 1].time) if i < len(tpc) - 1 else max_pos
        b = V.tempo_to_bin(tc.tempo)
        for j in range(lo, hi):
            if 0 <= j < max_pos:
                tempo_bin[j] = b
                tempo_set[j] = True

    default_ts = V.ts_to_bin(*V.time_signature_reduce(4, 4))
    default_tempo = V.tempo_to_bin(120.0)
    for j in range(max_pos):
        if not ts_set[j]:
            ts_bin[j] = default_ts
        if not tempo_set[j]:
            tempo_bin[j] = default_tempo

    # Walk positions assigning (bar index, position-in-bar) from the active
    # time signature; a signature change mid-measure is invalid input
    # (convert.py:199-201).
    bar_of = [0] * max_pos
    pos_of = [0] * max_pos
    cnt = 0
    bar = 0
    measure_length = None
    for j in range(max_pos):
        num, den = V.bin_to_ts(ts_bin[j])
        if cnt == 0:
            measure_length = num * V.BEAT_NOTE_FACTOR * V.POS_RESOLUTION // den
        bar_of[j] = bar
        pos_of[j] = cnt
        cnt += 1
        if cnt >= measure_length:
            assert cnt == measure_length, f"invalid time signature change: pos = {j}"
            cnt -= measure_length
            bar += 1

    encoding: List[Tuple[int, ...]] = []
    for inst in midi.instruments:
        if inst.is_drum:
            program, pitch_shift = V.MAX_INST, 128
        else:
            program, pitch_shift = inst.program, 0
        if task == "melody":
            label = MELODY_MAP.get(inst.name, MELODY_MAP["OTHER"])
        for note in inst.notes:
            sp = time_to_pos(note.start)
            if sp >= V.TRUNC_POS:
                continue
            dur = V.duration_to_bin(time_to_pos(note.end) - sp)
            base = (bar_of[sp], pos_of[sp], program, note.pitch + pitch_shift,
                    dur, V.velocity_to_bin(note.velocity), ts_bin[sp], tempo_bin[sp])
            if task == "melody":
                encoding.append(base + (label,))
            elif task == "velocity":
                encoding.append(base + (velocity_label(note.velocity),))
            else:
                encoding.append(base)
    encoding.sort()
    return encoding


def _majority_smallest(values: Sequence[int]) -> int:
    """Most frequent value; ties resolve to the smallest (see module doc)."""
    counts: dict = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    best = max(counts.values())
    return min(v for v, c in counts.items() if c == best)


def octuple_to_midi(encoding: Sequence[Sequence[int]],
                    ticks_per_beat: int = 480) -> MidiFile:
    """Reconstruct a MIDI file from Octuple tuples (convert.py:243-319)."""
    if not len(encoding):
        raise ValueError("empty encoding")
    n_bars = max(e[0] for e in encoding) + 1

    per_bar_ts: List[List[int]] = [[] for _ in range(n_bars)]
    for e in encoding:
        per_bar_ts[e[0]].append(e[6])
    bar_ts: List[Optional[int]] = [
        _majority_smallest(v) if v else None for v in per_bar_ts]
    default_ts = V.ts_to_bin(*V.time_signature_reduce(4, 4))
    for i in range(n_bars):
        if bar_ts[i] is None:
            bar_ts[i] = default_ts if i == 0 else bar_ts[i - 1]

    bar_to_pos = [0] * n_bars
    cur_pos = 0
    for i in range(n_bars):
        bar_to_pos[i] = cur_pos
        try:
            num, den = V.bin_to_ts(bar_ts[i])
        except IndexError:
            continue
        cur_pos += num * V.BEAT_NOTE_FACTOR * V.POS_RESOLUTION // den

    total_pos = cur_pos + max(e[1] for e in encoding)
    per_pos_tempo: List[List[int]] = [[] for _ in range(total_pos)]
    for e in encoding:
        p = bar_to_pos[e[0]] + e[1]
        if 0 <= p < total_pos:
            per_pos_tempo[p].append(e[7])
    pos_tempo: List[Optional[int]] = [
        round(sum(v) / len(v)) if v else None for v in per_pos_tempo]
    default_tempo = V.tempo_to_bin(120.0)
    for i in range(total_pos):
        if pos_tempo[i] is None:
            pos_tempo[i] = default_tempo if i == 0 else pos_tempo[i - 1]

    midi = MidiFile(ticks_per_beat=ticks_per_beat)

    def get_tick(bar: int, pos: int) -> int:
        return (bar_to_pos[bar] + pos) * ticks_per_beat // V.POS_RESOLUTION

    instruments = [
        Instrument(program=(0 if i == V.MAX_INST else i),
                   is_drum=(i == V.MAX_INST), name=str(i))
        for i in range(V.MAX_INST + 1)
    ]
    for e in encoding:
        program = e[2]
        if not 0 <= program <= V.MAX_INST:
            continue
        start = get_tick(e[0], e[1])
        duration = max(1, get_tick(0, V.bin_to_duration(e[4])))
        pitch = e[3] - 128 if program == V.MAX_INST else e[3]
        instruments[program].notes.append(Note(
            velocity=V.bin_to_velocity(e[5]), pitch=pitch,
            start=start, end=start + duration))
    midi.instruments = [i for i in instruments if i.notes]

    cur = None
    for i in range(n_bars):
        if bar_ts[i] != cur:
            try:
                num, den = V.bin_to_ts(bar_ts[i])
            except IndexError:
                continue
            midi.time_signature_changes.append(
                TimeSignature(numerator=num, denominator=den, time=get_tick(i, 0)))
            cur = bar_ts[i]
    cur = None
    for i in range(total_pos):
        if pos_tempo[i] != cur:
            midi.tempo_changes.append(
                TempoChange(tempo=V.bin_to_tempo(pos_tempo[i]), time=get_tick(0, i)))
            cur = pos_tempo[i]
    return midi
