"""Lightweight MIDI object model (a copy of ``pianobart_tpu/midi/events.py``).

Standalone replacement for the ``miditoolkit`` containers the reference
consumes (``Data/data_generation/convert.py:157-319`` uses ``MidiFile``,
``Instrument``, ``Note``, ``TimeSignature``, ``TempoChange``).  Attribute
names deliberately match miditoolkit so the tokenizer layer reads naturally.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Note:
    velocity: int
    pitch: int
    start: int  # ticks
    end: int    # ticks

    def __repr__(self) -> str:
        return (f"Note(start={self.start}, end={self.end}, "
                f"pitch={self.pitch}, velocity={self.velocity})")


@dataclasses.dataclass
class TempoChange:
    tempo: float  # BPM
    time: int     # ticks


@dataclasses.dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: int  # ticks


@dataclasses.dataclass
class Instrument:
    program: int
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MidiFile:
    ticks_per_beat: int = 480
    instruments: List[Instrument] = dataclasses.field(default_factory=list)
    tempo_changes: List[TempoChange] = dataclasses.field(default_factory=list)
    time_signature_changes: List[TimeSignature] = dataclasses.field(default_factory=list)

    @property
    def max_tick(self) -> int:
        return max((n.end for i in self.instruments for n in i.notes), default=0)

    def dump(self, path: str) -> None:
        from .writer import write_midi
        write_midi(self, path)

    @staticmethod
    def parse(path: str) -> "MidiFile":
        from .parser import read_midi
        return read_midi(path)
