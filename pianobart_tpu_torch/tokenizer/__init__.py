from .codec import (EMOTION_MAP, MELODY_MAP, VELOCITY_MAP, midi_to_octuple,
                    octuple_to_midi, velocity_label)
from .segment import (ProcessResult, data_split, encoding_hash, pad_segment,
                      process_bytes, process_file, segment_song)

__all__ = [
    "EMOTION_MAP", "MELODY_MAP", "VELOCITY_MAP", "midi_to_octuple",
    "octuple_to_midi", "velocity_label", "ProcessResult", "data_split",
    "encoding_hash", "pad_segment", "process_bytes", "process_file",
    "segment_song",
]
