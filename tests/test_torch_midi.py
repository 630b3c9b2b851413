"""The port's MIDI parser and writer (``pianobart_tpu_torch/midi``) against
the JAX package's on the same bytes: equal note, tempo and time-signature
streams, identical written bytes, the same exception on corrupt input."""
import numpy as np
import pytest

from pianobart_tpu import midi as jm
from pianobart_tpu_torch import midi as tm
from tests.test_midi_io import make_song

SEEDS = range(6)


def to_port(song):
    """The same song as the port's event objects."""
    out = tm.MidiFile(ticks_per_beat=song.ticks_per_beat)
    out.tempo_changes = [tm.TempoChange(t.tempo, t.time) for t in song.tempo_changes]
    out.time_signature_changes = [tm.TimeSignature(t.numerator, t.denominator, t.time)
                                  for t in song.time_signature_changes]
    for inst in song.instruments:
        out.instruments.append(tm.Instrument(
            program=inst.program, is_drum=inst.is_drum, name=inst.name,
            notes=[tm.Note(n.velocity, n.pitch, n.start, n.end) for n in inst.notes]))
    return out


def streams(midi):
    """Every event of a parsed file, as plain tuples in parse order."""
    return (midi.ticks_per_beat,
            [(t.tempo, t.time) for t in midi.tempo_changes],
            [(t.numerator, t.denominator, t.time) for t in midi.time_signature_changes],
            [(i.program, i.is_drum, i.name,
              [(n.velocity, n.pitch, n.start, n.end) for n in i.notes])
             for i in midi.instruments])


def outcome(read, data):
    try:
        return "ok", streams(read(data))
    except Exception as exc:  # the exception class and message are compared
        return type(exc).__name__, str(exc)


def _track_file(body, fmt=0):
    return (b"MThd" + (6).to_bytes(4, "big") + fmt.to_bytes(2, "big")
            + (1).to_bytes(2, "big") + (480).to_bytes(2, "big")
            + b"MTrk" + len(body).to_bytes(4, "big") + body)


@pytest.mark.parametrize("drum", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_writer_bytes_and_parser_streams_match(seed, drum):
    song = make_song(np.random.default_rng(seed), n_notes=80, n_tracks=3, drum=drum)
    data = jm.midi_bytes(song)
    assert tm.midi_bytes(to_port(song)) == data
    assert streams(tm.read_midi_bytes(data)) == streams(jm.read_midi_bytes(data))


def test_running_status_velocity0_and_oldest_note_first():
    track = bytes([
        0x00, 0xFF, 0x03, 3, ord("P"), ord("n"), ord("o"),   # track name
        0x00, 0xC0, 5,                                       # program change
        0x00, 0x90, 60, 100,      # note on
        0x10, 60, 90,             # running status: a second 60 still open
        0x60, 62, 100,
        0x20, 0x80, 60, 0,        # note off closes the OLDEST 60
        0x10, 0x90, 60, 0,        # vel-0 note on closes the other
        0x60, 62, 0,
        0x00, 0x99, 36, 80,       # a drum note on channel 10
        0x30, 36, 0,
        0x00, 0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20,            # tempo
        0x00, 0xFF, 0x58, 0x04, 3, 2, 24, 8,                  # 3/4
        0x00, 0xFF, 0x2F, 0x00,
    ])
    data = _track_file(track)
    got, want = tm.read_midi_bytes(data), jm.read_midi_bytes(data)
    assert streams(got) == streams(want)
    assert [(n.start, n.end) for n in got.instruments[0].notes if n.pitch == 60] \
        == [(0, 0x10 + 0x60 + 0x20), (0x10, 0x10 + 0x60 + 0x20 + 0x10)]
    assert got.instruments[-1].is_drum


def test_files_on_disk_round_trip_through_both(tmp_path):
    song = make_song(np.random.default_rng(7), n_notes=40, drum=True)
    to_port(song).dump(str(tmp_path / "port.mid"))
    song.dump(str(tmp_path / "jax.mid"))
    assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes()
    assert streams(tm.MidiFile.parse(str(tmp_path / "jax.mid"))) \
        == streams(jm.MidiFile.parse(str(tmp_path / "port.mid")))
    assert tm.MidiFile.parse(str(tmp_path / "port.mid")).max_tick \
        == song.max_tick


def _corrupt_cases():
    good = jm.midi_bytes(make_song(np.random.default_rng(3), n_notes=30, drum=True))
    rng = np.random.default_rng(0)
    cases = [good[:cut] for cut in range(0, len(good), 7)]
    for _ in range(120):
        data = bytearray(good)
        for _ in range(rng.integers(1, 8)):
            data[rng.integers(0, len(data))] = rng.integers(0, 256)
        cases.append(bytes(data))
    for trial in range(60):
        junk = rng.integers(0, 256, rng.integers(1, 400), dtype=np.uint8).tobytes()
        cases.append(b"MThd" + junk if trial % 2 else junk)
    # a truncated tempo meta, a data byte with no status, an SMPTE division,
    # a header too close to the end, a stray realtime byte
    cases += [_track_file(b"\x00\x90\x3c\x40\x60\x80\x3c\x00\x00\xff\x51\x03\x07\xa1"),
              _track_file(b"\x00\x3c\x40"),
              good[:12] + b"\xe7\x28" + good[14:],
              b"\x00" * 10 + b"MThd",
              _track_file(b"\x00\x90\x3c\x40\x10\xf8\x20\x80\x3c\x00")]
    return cases


def test_corrupt_bytes_give_the_same_outcome():
    """Truncated and garbage bytes: both parsers keep the same events, or
    both raise the same exception class with the same message."""
    kinds = set()
    for data in _corrupt_cases():
        got, want = outcome(tm.read_midi_bytes, data), outcome(jm.read_midi_bytes, data)
        assert got == want, data.hex()[:80]
        kinds.add(want[0])
    assert {"ok", "ValueError"} <= kinds


@pytest.mark.parametrize("cut", range(14))
def test_short_header_rejected_by_both(cut):
    data = jm.midi_bytes(make_song(np.random.default_rng(1), n_notes=4))[:cut]
    with pytest.raises(ValueError) as want:
        jm.read_midi_bytes(data)
    with pytest.raises(ValueError) as got:
        tm.read_midi_bytes(data)
    assert str(got.value) == str(want.value)


def test_truncation_flushes_open_notes_in_both():
    good = jm.midi_bytes(make_song(np.random.default_rng(2), n_notes=20))
    partial = 0
    for cut in range(20, len(good)):
        got, want = tm.read_midi_bytes(good[:cut]), jm.read_midi_bytes(good[:cut])
        assert streams(got) == streams(want)
        partial += bool(got.instruments) and cut < len(good) - 1
    assert partial > 10
