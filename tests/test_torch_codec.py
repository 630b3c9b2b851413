"""The port's vocabulary quantizers, Octuple codec, ``pad_segment`` and the
demo's window helpers against the JAX package's, on the same inputs:
identical rows, grids and bytes."""
import numpy as np
import pytest

from pianobart_tpu import vocab as JV
from pianobart_tpu.midi import read_midi_bytes as j_read
from pianobart_tpu.serve import demo as jd
from pianobart_tpu.tokenizer import codec as jc
from pianobart_tpu.tokenizer.segment import pad_segment as j_pad
from pianobart_tpu_torch import vocab as TV
from pianobart_tpu_torch.midi import read_midi_bytes as t_read
from pianobart_tpu_torch.serve import demo as td
from pianobart_tpu_torch.tokenizer import codec as tc
from pianobart_tpu_torch.tokenizer import pad_segment as t_pad
from tests.test_midi_io import make_song
from tests.test_torch_midi import streams

TASKS = ["pretrain", "composer", "emotion", "generate", "melody", "velocity"]


def _song_bytes(seed, drum=True, n_notes=120):
    rng = np.random.default_rng(seed)
    song = make_song(rng, n_notes=n_notes, n_tracks=3, drum=drum)
    for inst, name in zip(song.instruments, ("MELODY", "PIANO", "BRIDGE")):
        inst.name = name
    from pianobart_tpu.midi import midi_bytes
    return midi_bytes(song)


def _both(fn_name, args, mods=(JV, TV)):
    out = []
    for mod in mods:
        try:
            out.append(("ok", getattr(mod, fn_name)(*args)))
        except Exception as exc:  # the class is compared
            out.append((type(exc).__name__, None))
    return out


# -- vocab ------------------------------------------------------------------

def test_constants_and_tables_are_equal():
    for name in ("POS_RESOLUTION", "MAX_BAR", "BAR_COUNT", "VELOCITY_QUANT",
                 "TEMPO_QUANT", "MIN_TEMPO", "MAX_TEMPO", "DURATION_MAX",
                 "MAX_TS_DENOMINATOR", "MAX_NOTES_PER_BAR", "BEAT_NOTE_FACTOR",
                 "MAX_INST", "MAX_PITCH", "MAX_VELOCITY_TOK", "MAX_POS_TOK",
                 "MAX_DURATION_TOK", "MAX_TS_TOK", "MAX_TEMPO_TOK",
                 "TOKENS_PER_NOTE", "TRUNC_POS", "MAX_WINDOW", "FIELDS",
                 "TOKEN_BOUNDARY", "SPECIALS", "PAD", "MASK", "SOS", "EOS", "CLS",
                 "SEP", "FIELD_SIZES", "TOTAL_VOCAB", "FIELD_OFFSETS",
                 "TS_DICT", "TS_LIST"):
        assert getattr(TV, name) == getattr(JV, name), name
    for name in ("DUR_ENC", "DUR_DEC"):
        a, b = getattr(TV, name), getattr(JV, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_bin_functions_agree_over_their_domain():
    for bpm in list(np.linspace(0.5, 400.0, 4001)) + [16, 256, 120.0, 1e-6, 1e9]:
        assert TV.tempo_to_bin(bpm) == JV.tempo_to_bin(bpm)
    for e in range(-2, JV.MAX_TEMPO_TOK + 3):
        assert TV.bin_to_tempo(e) == JV.bin_to_tempo(e)
    for v in range(0, 256):
        assert TV.velocity_to_bin(v) == JV.velocity_to_bin(v)
    for e in range(0, JV.MAX_VELOCITY_TOK + 2):
        assert TV.bin_to_velocity(e) == JV.bin_to_velocity(e)
    for d in range(-5, len(JV.DUR_ENC) + 10):
        assert TV.duration_to_bin(d) == JV.duration_to_bin(d)
    for e in range(0, len(JV.DUR_DEC) + 5):
        assert TV.bin_to_duration(e) == JV.bin_to_duration(e)
    for e in range(0, len(JV.TS_LIST) + 2):
        got, want = _both("bin_to_ts", (e,))
        assert got == want, e
    for num in range(0, 70):
        for den in [1, 2, 3, 4, 8, 16, 32, 64, 128, 256]:
            assert TV.time_signature_reduce(num if num else 1, den) \
                == JV.time_signature_reduce(num if num else 1, den)
            got, want = _both("ts_to_bin", (num, den))
            assert got == want, (num, den)


# -- codec ------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("seed", range(3))
def test_midi_to_octuple_rows_are_identical(seed, task):
    data = _song_bytes(seed)
    want = jc.midi_to_octuple(j_read(data), task=task)
    got = tc.midi_to_octuple(t_read(data), task=task)
    assert want and got == want


def test_midi_to_octuple_edge_inputs():
    """An empty file, and a time signature change in mid-measure."""
    from pianobart_tpu.midi import MidiFile, Instrument, Note, TimeSignature, midi_bytes
    empty = midi_bytes(MidiFile())
    assert tc.midi_to_octuple(t_read(empty)) == jc.midi_to_octuple(j_read(empty)) == []
    song = MidiFile()
    song.time_signature_changes = [TimeSignature(4, 4, 0), TimeSignature(3, 4, 100),
                                   TimeSignature(6, 8, 2000)]
    song.instruments = [Instrument(0, notes=[Note(80, 60 + i, 240 * i, 240 * i + 200)
                                             for i in range(40)])]
    data = midi_bytes(song)
    want = jc.midi_to_octuple(j_read(data))
    assert len(want) == 40 and tc.midi_to_octuple(t_read(data)) == want


@pytest.mark.parametrize("seed", range(4))
def test_octuple_to_midi_events_are_equal(seed):
    enc = jc.midi_to_octuple(j_read(_song_bytes(seed)))
    rng = np.random.default_rng(seed)
    # perturbed rows as a decoder might sample them: ties in the majority
    # time signature, mixed tempos at one position, drums, out-of-range
    # programs that the decoder skips
    noisy = [list(r) for r in enc]
    for r in noisy:
        if rng.random() < 0.3:
            r[6] = int(rng.integers(0, 40))
        if rng.random() < 0.3:
            r[7] = int(rng.integers(0, JV.MAX_TEMPO_TOK + 1))
        if rng.random() < 0.05:
            r[2] = int(rng.integers(0, 135))
    for e in (enc, noisy):
        assert streams(tc.octuple_to_midi(e)) == streams(jc.octuple_to_midi(e))
        assert streams(tc.octuple_to_midi(e, ticks_per_beat=96)) \
            == streams(jc.octuple_to_midi(e, ticks_per_beat=96))
    with pytest.raises(ValueError):
        tc.octuple_to_midi([])


def test_label_maps_and_velocity_label():
    assert tc.MELODY_MAP == jc.MELODY_MAP
    assert tc.VELOCITY_MAP == jc.VELOCITY_MAP
    assert tc.EMOTION_MAP == jc.EMOTION_MAP
    for v in range(128):
        assert tc.velocity_label(v) == jc.velocity_label(v)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("n", [0, 5, 63, 64, 65, 300])
def test_pad_segment_is_identical(n, last):
    rows = [tuple(int(x) for x in r)
            for r in np.random.default_rng(n).integers(0, 100, (n, 8))]
    assert t_pad(rows, window=64, last=last) == j_pad(rows, window=64, last=last)


# -- the demo's window helpers ----------------------------------------------

@pytest.mark.parametrize("window", [1024, 64])
def test_midi_to_window_is_identical(tmp_path, window):
    for seed in range(2):
        path = str(tmp_path / f"s{seed}.mid")
        with open(path, "wb") as f:
            f.write(_song_bytes(seed, n_notes=400 if window == 1024 else 30))
        got, want = td.midi_to_window(path, window), jd.midi_to_window(path, window)
        # the song is longer than the window: the LAST rows are kept
        assert got.shape == (1, window, 8) and got.dtype == want.dtype
        assert (got[0, -1] == np.asarray(JV.EOS)).all()
        assert np.array_equal(got, want)


def test_midi_to_window_refuses_a_file_without_notes(tmp_path):
    from pianobart_tpu.midi import MidiFile
    path = str(tmp_path / "empty.mid")
    MidiFile().dump(path)
    with pytest.raises(ValueError, match="no notes"):
        td.midi_to_window(path)


def _random_grids(seed, S=64):
    """Content grids with specials, drum pitches and EOS rows sprinkled in."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(JV.TOKEN_BOUNDARY) + 1
    grids = []
    for k in range(6):
        g = (rng.random((S, 8)) * np.minimum(hi, [8, 128, 129, 128, 128, 32, 60, 49])
             ).astype(np.int32)
        g[:, 0] = np.sort(g[:, 0])
        if k == 1:
            g[int(rng.integers(0, S)), 3] = int(rng.integers(128, 256))  # a drum pitch
        if k == 2:
            r, c = int(rng.integers(0, S)), int(rng.integers(0, 8))
            g[r, c] = JV.PAD[c] + int(rng.integers(0, 6))               # a special
        if k == 3:
            g[0] = np.asarray(JV.PAD)                                   # empty
        if k == 4:
            g[int(rng.integers(1, S))] = np.asarray(JV.EOS)
        grids.append(g)
    return grids


@pytest.mark.parametrize("seed", range(3))
def test_clean_generated_and_window_to_midi_are_identical(tmp_path, seed):
    for i, g in enumerate(_random_grids(seed)):
        assert np.array_equal(td.clean_generated(g), jd.clean_generated(g))
        tp, jp = str(tmp_path / f"t{i}.mid"), str(tmp_path / f"j{i}.mid")
        ok = td.window_to_midi(g, tp)
        assert ok == jd.window_to_midi(g, jp)
        if ok:
            with open(tp, "rb") as a, open(jp, "rb") as b:
                assert a.read() == b.read()
