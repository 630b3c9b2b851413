from .events import Instrument, MidiFile, Note, TempoChange, TimeSignature
from .parser import read_midi, read_midi_bytes
from .writer import midi_bytes, write_midi

__all__ = [
    "Instrument", "MidiFile", "Note", "TempoChange", "TimeSignature",
    "read_midi", "read_midi_bytes", "midi_bytes", "write_midi",
]
