"""The port's dataset tokenizer against the JAX package's, on a corpus from
``scripts/make_corpus.py`` (public-domain repertoire, procedural songs with
tempo and meter changes, drums, >255-bar pieces, duplicates, a truncated
file): the native codec row for row (also on corrupt bytes), the
segmentation helpers, ``run_dataset_pipeline`` for all six tasks (every
``.npy`` and ``.json`` byte for byte), the validators' reports, and the
vocabulary files.  Integer data: every comparison is exact."""
import os
import pickle

import numpy as np
import pytest

from pianobart_tpu import vocab as JV
from pianobart_tpu.midi import midi_bytes as j_midi_bytes
from pianobart_tpu.midi import native as j_native
from pianobart_tpu.midi.parser import read_midi_bytes as j_read
from pianobart_tpu.tokenizer import codec as jc
from pianobart_tpu.tokenizer import pipeline as jp
from pianobart_tpu.tokenizer import segment as js
from pianobart_tpu.tokenizer import validate as jval
from pianobart_tpu_torch import vocab as TV
from pianobart_tpu_torch.midi import native as t_native
from pianobart_tpu_torch.midi.parser import read_midi_bytes as t_read
from pianobart_tpu_torch.tokenizer import codec as tc
from pianobart_tpu_torch.tokenizer import pipeline as tp
from pianobart_tpu_torch.tokenizer import segment as ts
from pianobart_tpu_torch.tokenizer import validate as tval
from scripts.make_corpus import make_corpus
from tests.test_midi_io import make_song

TASKS = ["pretrain", "composer", "emotion", "generate", "melody", "velocity"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus") / "songs"
    make_corpus(str(root), n_files=24, seed=5)
    return str(root)


@pytest.fixture(scope="module")
def files(corpus):
    return jp.list_midi_files(corpus)


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, AssertionError) as exc:  # the class is compared
        return (type(exc).__name__, None)


def test_native_codecs_build():
    assert t_native.available() and j_native.available()


@pytest.mark.parametrize("task", ["pretrain", "melody", "velocity"])
def test_native_codec_matches_jax_and_python_path(files, task):
    """Every corpus file: the port's native rows == the JAX package's native
    rows == the port's Python path (parser + codec) == JAX's Python path."""
    assert len(files) >= 20
    rows = 0
    for name, data in files:
        port = _outcome(lambda: t_native.midi_bytes_to_octuple(data, task))
        ref = _outcome(lambda: j_native.midi_bytes_to_octuple(data, task))
        py = _outcome(lambda: [tuple(r) for r in tc.midi_to_octuple(t_read(data), task)])
        jpy = _outcome(lambda: [tuple(r) for r in jc.midi_to_octuple(j_read(data), task)])
        assert port == ref == py == jpy, name
        rows += len(port[1] or [])
    assert rows > 10_000


def _corrupt_cases(good, rng):
    cases = [good[:cut] for cut in range(0, len(good), 5)]
    for _ in range(80):
        data = bytearray(good)
        for _ in range(rng.integers(1, 8)):
            data[rng.integers(0, len(data))] = rng.integers(0, 256)
        cases.append(bytes(data))
    for trial in range(40):
        junk = rng.integers(0, 256, rng.integers(1, 400), dtype=np.uint8).tobytes()
        cases.append(b"MThd" + junk if trial % 2 else junk)
    return cases + [b"\x00" * 10 + b"MThd", b""]


def test_native_codec_matches_jax_on_corrupt_bytes():
    """Truncations, flipped bytes and junk over a two-track file: the port's
    native codec gives the JAX package's native rows (or the same exception
    class), the port's Python path the JAX Python path's, and
    ``process_bytes`` the same status and windows.  (The JAX package's own
    two paths part on some of these cut multi-track files, so each path is
    held to its JAX counterpart.)"""
    rng = np.random.default_rng(11)
    song = make_song(rng, n_notes=60, n_tracks=2)
    song.instruments[0].name = "MELODY"
    good = j_midi_bytes(song)
    accepted = 0
    for data in _corrupt_cases(good, rng):
        for task in ("pretrain", "melody"):
            port = _outcome(lambda: t_native.midi_bytes_to_octuple(data, task))
            ref = _outcome(lambda: j_native.midi_bytes_to_octuple(data, task))
            assert port == ref, data.hex()[:80]
            py = _outcome(lambda: [tuple(r) for r in tc.midi_to_octuple(t_read(data), task)])
            jpy = _outcome(lambda: [tuple(r) for r in jc.midi_to_octuple(j_read(data), task)])
            assert py == jpy, data.hex()[:80]
            accepted += port[0] == "ok"
        a, b = ts.process_bytes(data), js.process_bytes(data)
        assert (a.status, a.detail, a.sequences) == (b.status, b.detail, b.sequences)
    assert accepted > 100


def test_segmentation_helpers_match_jax(files):
    """``segment_song`` (a >255-bar piece splits and renumbers),
    ``encoding_hash``, ``data_split`` at two windows, and ``process_bytes``
    per task with a shared dedup table (duplicates found alike)."""
    split_seen = False
    for name, data in files[:12]:
        enc = j_native.midi_bytes_to_octuple(data, "pretrain") or []
        if not enc:
            continue
        assert ts.segment_song(enc) == js.segment_song(enc)
        split_seen |= len(ts.segment_song(enc)) > 1
        assert ts.encoding_hash(enc) == js.encoding_hash(enc)
        flat = np.asarray(enc, dtype=np.int64)
        for window in (1024, 2048):
            np.testing.assert_array_equal(ts.data_split(flat, window=window),
                                          js.data_split(flat, window=window))
    assert split_seen
    labels = np.arange(37, dtype=np.int64)
    np.testing.assert_array_equal(ts.data_split(labels, content=3, tokens_per_line=1),
                                  js.data_split(labels, content=3, tokens_per_line=1))
    for task in TASKS:
        seen_t, seen_j = {}, {}
        for pad in (True, False) if task == "pretrain" else (task not in ("melody", "velocity"),):
            for name, data in files:
                a = ts.process_bytes(data, task=task, pad=pad, composer="c",
                                     emotion=1, dedup_seen=seen_t, file_name=name)
                b = js.process_bytes(data, task=task, pad=pad, composer="c",
                                     emotion=1, dedup_seen=seen_j, file_name=name)
                assert (a.status, a.detail, a.sequences, a.labels) == \
                    (b.status, b.detail, b.sequences, b.labels), (task, name)
        assert seen_t == seen_j


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("task,pad,path", [
    ("pretrain", True, "native"), ("pretrain", False, "native"),
    ("pretrain", False, "python"), ("composer", None, "native"),
    ("emotion", None, "native"), ("generate", None, "native"),
    ("melody", None, "native"), ("velocity", None, "python")])
def test_run_dataset_pipeline_matches_jax(corpus, tmp_path, monkeypatch, task,
                                          pad, path):
    """The same artifacts, byte for byte, and the same log lines; ``python``
    runs the port without its native codec (the g++-less fallback)."""
    if path == "python":
        monkeypatch.setattr(t_native, "_get", lambda: None)
    logs_t, logs_j = [], []
    got = tp.run_dataset_pipeline(corpus, task=task, pad=pad,
                                  out_root=str(tmp_path / "t"), log=logs_t.append)
    want = jp.run_dataset_pipeline(corpus, task=task, pad=pad,
                                   out_root=str(tmp_path / "j"), log=logs_j.append)
    assert logs_t == [l.replace(str(tmp_path / "j"), str(tmp_path / "t"))
                      for l in logs_j]
    assert {k: os.path.relpath(v, tmp_path / "t") for k, v in got.items()} == \
        {k: os.path.relpath(v, tmp_path / "j") for k, v in want.items()}
    t_files, j_files = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert t_files.keys() == j_files.keys() and len(t_files) >= 2
    for name in t_files:
        assert t_files[name] == j_files[name], name


def test_validate_reports_match_jax(tmp_path):
    """Reports on clean windows, a packed stream, and each kind of fault;
    ``roundtrip_sample`` writes the same MIDI bytes."""
    rng = np.random.default_rng(4)
    good = np.tile(np.asarray(TV.PAD, dtype=np.int64), (3, 16, 1))
    for i in range(3):
        good[i, :10] = rng.integers(0, 30, (10, 8))
        good[i, :10, 0] = np.sort(rng.integers(0, 4, 10))
        good[i, 10] = TV.EOS
    over = good.copy()
    over[0, 0, 3] = TV.EOS[3] + 1
    neg = good.copy()
    neg[1, 2, 5] = -1
    no_eos = good.copy()
    no_eos[2, 10] = TV.PAD
    vel = good.copy()
    vel[0, 12, 5] = 3
    cases = [(good, False), (good, True), (over, False), (neg, False),
             (no_eos, False), (no_eos.reshape(-1, 8)[None, :40], True),
             (good[0], False), (vel, False)]
    for arr, packed in cases:
        a, b = tval.check_pretrain(arr, packed=packed), jval.check_pretrain(arr, packed=packed)
        assert (a.ok, a.issues, str(a)) == (b.ok, b.issues, str(b))
    assert not tval.check_pretrain(over).ok and tval.check_pretrain(good).ok
    labels = {"melody": rng.integers(0, 5, 3), "velocity": rng.integers(0, 8, 2),
              "composer": rng.integers(0, 8, 3), "generate": good, "emotion": None}
    for task, ans in labels.items():
        a = tval.check_finetune(good, ans, task)
        b = jval.check_finetune(good, ans, task)
        assert (a.ok, a.issues) == (b.ok, b.issues), task
    for index in (0, 2):
        tval.roundtrip_sample(good, str(tmp_path / "t.mid"), index=index)
        jval.roundtrip_sample(good, str(tmp_path / "j.mid"), index=index)
        assert (tmp_path / "t.mid").read_bytes() == (tmp_path / "j.mid").read_bytes()
    with pytest.raises(IndexError):
        tval.roundtrip_sample(good[0], str(tmp_path / "x.mid"), index=1)


def test_vocab_pickle_and_dict_txt_match_jax(tmp_path):
    """``Octuple.pkl`` loads to the JAX package's ``(e2w, w2e)`` and
    verifies back through both ``from_pickle``; ``dict.txt`` is the same
    bytes."""
    TV.VOCAB.save_pickle(str(tmp_path / "t.pkl"))
    JV.VOCAB.save_pickle(str(tmp_path / "j.pkl"))
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    assert got == (JV.VOCAB.e2w, JV.VOCAB.w2e)
    assert sum(len(m) for m in got[0].values()) == TV.TOTAL_VOCAB == 1280
    assert TV.OctupleVocab.from_pickle(str(tmp_path / "j.pkl")).total == 1280
    assert JV.OctupleVocab.from_pickle(str(tmp_path / "t.pkl")).total == 1280
    TV.VOCAB.dump_dict_txt(str(tmp_path / "t.txt"))
    JV.VOCAB.dump_dict_txt(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    e2w, w2e = got
    e2w["Pitch"] = dict(e2w["Pitch"], **{"Pitch 0": 5})
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump((e2w, w2e), f)
    with pytest.raises(ValueError, match="Pitch"):
        TV.OctupleVocab.from_pickle(str(tmp_path / "bad.pkl"))
    for attr in ("pad_word", "mask_word", "sos_word", "eos_word", "cls_word",
                 "sep_word"):
        np.testing.assert_array_equal(getattr(TV.VOCAB, attr), getattr(JV.VOCAB, attr))
    assert TV.VOCAB.n_tokens == JV.VOCAB.n_tokens and TV.VOCAB.bar_pad_id == JV.VOCAB.bar_pad_id
