from .codec import (EMOTION_MAP, MELODY_MAP, VELOCITY_MAP, midi_to_octuple,
                    octuple_to_midi, velocity_label)
from .segment import pad_segment

__all__ = [
    "EMOTION_MAP", "MELODY_MAP", "VELOCITY_MAP", "midi_to_octuple",
    "octuple_to_midi", "velocity_label", "pad_segment",
]
