"""Standard MIDI File (format 1) writer.

Inverse of :mod:`pianobart_tpu_torch.midi.parser` (a copy of
``pianobart_tpu/midi/writer.py``); used by the Octuple decoder
(reference ``encoding_to_MIDI`` returns a miditoolkit object and calls
``.dump``, ``demo.py:102``).  Track 0 carries tempo/time-signature metas;
each instrument gets its own track/channel (drums forced to channel 9).
"""
from __future__ import annotations

from typing import List

from .events import MidiFile

__all__ = ["write_midi", "midi_bytes"]


def _varint(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative delta time")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(out))


def _meta(delta: int, meta_type: int, body: bytes) -> bytes:
    return _varint(delta) + bytes([0xFF, meta_type]) + _varint(len(body)) + body


def _track_chunk(events: bytes) -> bytes:
    events += _meta(0, 0x2F, b"")  # end of track
    return b"MTrk" + len(events).to_bytes(4, "big") + events


def write_midi(midi: MidiFile, path: str) -> None:
    with open(path, "wb") as f:
        f.write(midi_bytes(midi))


def midi_bytes(midi: MidiFile) -> bytes:
    ntracks = 1 + len(midi.instruments)
    header = b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big") \
        + ntracks.to_bytes(2, "big") + int(midi.ticks_per_beat).to_bytes(2, "big")

    # Conductor track: tempo + time signature events.
    metas: List[tuple] = []  # (tick, priority, bytes-after-delta)
    for ts in midi.time_signature_changes:
        denom_pow = max(0, int(ts.denominator).bit_length() - 1)
        metas.append((ts.time, 0,
                      bytes([0xFF, 0x58, 4, ts.numerator, denom_pow, 24, 8])))
    for tc in midi.tempo_changes:
        usq = max(1, min(0xFFFFFF, round(60_000_000 / max(tc.tempo, 1e-6))))
        metas.append((tc.time, 1, bytes([0xFF, 0x51, 3]) + usq.to_bytes(3, "big")))
    metas.sort(key=lambda m: (m[0], m[1]))
    conductor = bytearray()
    last_tick = 0
    for tick, _, payload in metas:
        conductor += _varint(tick - last_tick) + payload
        last_tick = tick
    chunks = [_track_chunk(bytes(conductor))]

    # One track per instrument; cycle channels skipping the drum channel.
    melodic_channels = [c for c in range(16) if c != 9]
    melodic_idx = 0
    for inst in midi.instruments:
        if inst.is_drum:
            channel = 9
        else:
            channel = melodic_channels[melodic_idx % len(melodic_channels)]
            melodic_idx += 1
        events: List[tuple] = []  # (tick, order, raw-event-bytes)
        for note in inst.notes:
            pitch = min(max(int(note.pitch), 0), 127)
            velocity = min(max(int(note.velocity), 1), 127)
            events.append((int(note.start), 1, bytes([0x90 | channel, pitch, velocity])))
            events.append((int(note.end), 0, bytes([0x80 | channel, pitch, 64])))
        events.sort(key=lambda e: (e[0], e[1]))
        track = bytearray()
        if inst.name:
            name = inst.name.encode("latin-1", errors="replace")
            track += _meta(0, 0x03, name)
        track += _varint(0) + bytes([0xC0 | channel, int(inst.program) & 0x7F])
        last_tick = 0
        for tick, _, raw in events:
            track += _varint(tick - last_tick) + raw
            last_tick = tick
        chunks.append(_track_chunk(bytes(track)))

    return header + b"".join(chunks)
