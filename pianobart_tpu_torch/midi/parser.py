"""Standard MIDI File (SMF 0/1) reader: the port's copy of
``pianobart_tpu/midi/parser.py``, policy for policy.

Self-contained replacement for the ``miditoolkit`` parser the reference
depends on (``convert.py:7``, ``demo.py:9``); the environment does not ship
miditoolkit, and a framework should own its IO path anyway.  Follows the
pretty_midi/miditoolkit conventions that matter to the Octuple tokenizer:

* ``ticks_per_beat`` from the header division (SMPTE division unsupported).
* Tempo / time-signature meta events merged across tracks, sorted by tick.
* Notes grouped into instruments keyed by ``(track, channel, program)`` with
  channel 10 (index 9) marked ``is_drum``; instrument ``name`` is the track
  name (needed by the melody task's ``MELODY``/``BRIDGE``/``PIANO`` labels,
  reference ``convert.py:213``).
* ``note_on`` with velocity 0 is a note-off; note-offs close the oldest open
  note of the same (channel, pitch).

The JAX package also has a C++ fast path with identical semantics
(``pianobart_tpu/midi/native/midi_codec.cpp``) for offline dataset
tokenization; the port's copy of it comes with the dataset tokenizer.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

from .events import Instrument, MidiFile, Note, TempoChange, TimeSignature

__all__ = ["read_midi", "read_midi_bytes"]


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = buf[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def read_midi(path: str) -> MidiFile:
    with open(path, "rb") as f:
        return read_midi_bytes(f.read())


def read_midi_bytes(data: bytes) -> MidiFile:
    buf = memoryview(data)
    if bytes(buf[0:4]) != b"MThd":
        # Some files prepend junk; search for the header chunk.
        idx = data.find(b"MThd")
        if idx < 0:
            raise ValueError("not a standard MIDI file (no MThd)")
        buf = memoryview(data)[idx:]
    if len(buf) < 14:
        # matches the native codec of the JAX package: a header chunk is 14 bytes; don't
        # parse garbage division/track counts out of a shorter prefix
        raise ValueError("not a standard MIDI file (no MThd)")
    header_len = int.from_bytes(buf[4:8], "big")
    fmt = int.from_bytes(buf[8:10], "big")
    ntracks = int.from_bytes(buf[10:12], "big")
    division = int.from_bytes(buf[12:14], "big")
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    ticks_per_beat = division

    midi = MidiFile(ticks_per_beat=ticks_per_beat)
    tempos: List[TempoChange] = []
    timesigs: List[TimeSignature] = []
    # (track, channel, program) -> Instrument, in first-seen order.
    instruments: "OrderedDict[Tuple[int, int, int], Instrument]" = OrderedDict()

    pos = 8 + header_len
    for track_idx in range(ntracks):
        if pos + 8 > len(buf):
            break  # truncated file: keep what we parsed
        chunk_type = bytes(buf[pos:pos + 4])
        chunk_len = int.from_bytes(buf[pos + 4:pos + 8], "big")
        body_start = pos + 8
        pos = body_start + chunk_len
        if chunk_type != b"MTrk":
            continue
        try:
            _parse_track(buf[body_start:body_start + chunk_len], track_idx,
                         tempos, timesigs, instruments)
        except IndexError:
            # Truncated track body: keep the events parsed so far.
            continue

    tempos.sort(key=lambda t: t.time)
    timesigs.sort(key=lambda t: t.time)
    midi.tempo_changes = tempos
    midi.time_signature_changes = timesigs
    midi.instruments = [inst for inst in instruments.values() if inst.notes]
    return midi


def _parse_track(
    track: memoryview,
    track_idx: int,
    tempos: List[TempoChange],
    timesigs: List[TimeSignature],
    instruments: "OrderedDict[Tuple[int, int, int], Instrument]",
) -> None:
    tick = 0
    p = 0
    running_status = 0
    track_name = ""
    channel_program = [0] * 16
    # (channel, pitch) -> list of (start_tick, velocity, instrument_key)
    open_notes: Dict[Tuple[int, int], List[Tuple[int, int, Tuple[int, int, int]]]] = {}
    # Instruments created lazily in this track, to be renamed once the track
    # name meta arrives (track name may appear after the first note).
    local_keys: List[Tuple[int, int, int]] = []
    n = len(track)

    def get_instrument(channel: int) -> Tuple[int, int, int]:
        program = channel_program[channel]
        key = (track_idx, channel, program)
        if key not in instruments:
            instruments[key] = Instrument(
                program=program, is_drum=(channel == 9), name=track_name)
            local_keys.append(key)
        return key

    def close_note(channel: int, pitch: int, end_tick: int) -> None:
        stack = open_notes.get((channel, pitch))
        if not stack:
            return
        start_tick, velocity, key = stack.pop(0)
        if end_tick > start_tick:
            instruments[key].notes.append(
                Note(velocity=velocity, pitch=pitch, start=start_tick, end=end_tick))

    # Truncated mid-event bodies raise IndexError; treat that like the
    # C++ codec's bounds-checked break so the dangling-note flush below
    # still runs and the two paths stay note-for-note identical on
    # truncated input (fuzz parity test).
    try:
        while p < n:
            delta, p = _read_varint(track, p)
            tick += delta
            if p >= n:
                break
            status = track[p]
            if status & 0x80:
                p += 1
                if status < 0xF0:
                    running_status = status
            else:
                status = running_status
                if status == 0:
                    break  # data byte with no status: stop, keep what we have

            kind = status & 0xF0
            channel = status & 0x0F
            if kind == 0x90:  # note on
                pitch, velocity = track[p], track[p + 1]
                p += 2
                if velocity == 0:
                    close_note(channel, pitch, tick)
                else:
                    key = get_instrument(channel)
                    open_notes.setdefault((channel, pitch), []).append(
                        (tick, velocity, key))
            elif kind == 0x80:  # note off
                pitch = track[p]
                p += 2
                close_note(channel, pitch, tick)
            elif kind in (0xA0, 0xB0, 0xE0):  # aftertouch / CC / pitch bend
                p += 2
            elif kind == 0xC0:  # program change
                channel_program[channel] = track[p]
                p += 1
            elif kind == 0xD0:  # channel aftertouch
                p += 1
            elif status in (0xF0, 0xF7):  # sysex
                length, p = _read_varint(track, p)
                p += length
            elif status == 0xFF:  # meta
                meta_type = track[p]
                p += 1
                length, p = _read_varint(track, p)
                if p + length > n:
                    # truncated meta body: the slice below would silently
                    # clamp and process garbage (e.g. a 2-byte tempo read
                    # as 3) — stop like the C++ codec's bounds check
                    break
                body = bytes(track[p:p + length])
                p += length
                if meta_type == 0x51 and length >= 3:  # set tempo
                    usq = int.from_bytes(body[:3], "big")
                    if usq > 0:
                        tempos.append(TempoChange(tempo=60_000_000 / usq, time=tick))
                elif meta_type == 0x58 and length >= 2:  # time signature
                    timesigs.append(TimeSignature(
                        numerator=body[0], denominator=2 ** body[1], time=tick))
                elif meta_type == 0x03:  # track name
                    track_name = body.decode("latin-1", errors="replace").strip("\x00")
                    for key in local_keys:
                        if not instruments[key].name:
                            instruments[key].name = track_name
                elif meta_type == 0x2F:  # end of track
                    break
            else:
                # unknown status (e.g. stray system-realtime 0xF8-0xFE):
                # stop this track, keep what we have — same tolerant-stop
                # policy as the native codec
                break

    except IndexError:
        pass

    # Close any dangling notes at the final tick (defensive; matches the
    # tolerant behavior of common parsers).
    for (channel, pitch), stack in open_notes.items():
        for start_tick, velocity, key in stack:
            if tick > start_tick:
                instruments[key].notes.append(
                    Note(velocity=velocity, pitch=pitch, start=start_tick, end=tick))
