"""The port's finetune CLI on the CPU at a tiny width, on a corpus written by
the port's MIDI writer and tokenized by the port's ``tokenize``:
``finetune`` (all four tasks, ``--weight``, ``--ckpt``), ``finetune-generation``
(``--fad``, ``--fad_jit``, both decoder modes), ``ablation`` and ``eval-gen``.
Where the output is deterministic across the packages (the files written,
``meta.json``'s history steps and best step, the events' keys, the test
outputs' and eval-gen's shapes and types, the out-of-range label message)
it is held against the JAX CLI's on the same files and flags."""
import json
import os

import numpy as np
import pytest
import torch

from pianobart_tpu import cli as jcli
from pianobart_tpu_torch import cli
from pianobart_tpu_torch.midi import Instrument, MidiFile, Note, TempoChange, TimeSignature

torch.set_num_threads(2)
MODEL = ["--hs", "64", "--layers", "1", "--heads", "2", "--ffn_dims", "128"]
RUN = MODEL + ["--epochs", "1", "--batch_size", "2"]


def _song(rng, n_notes):
    song = MidiFile(ticks_per_beat=480)
    song.tempo_changes = [TempoChange(tempo=float(rng.integers(70, 160)), time=0)]
    song.time_signature_changes = [TimeSignature(4, 4, 0)]
    for program, lo, hi, name in ((0, 60, 96, "MELODY"), (32, 28, 60, "PIANO")):
        inst, tick = Instrument(program=program, name=name), 0
        for _ in range(n_notes):
            dur = int(rng.choice([120, 240, 480]))
            inst.notes.append(Note(velocity=int(rng.integers(40, 120)),
                                   pitch=int(rng.integers(lo, hi)),
                                   start=tick, end=tick + dur))
            tick += int(rng.choice([120, 240, 480]))
        song.instruments.append(inst)
    return song


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Songs by two composers (their names carry emotion labels), tokenized
    for every finetune task (composer and emotion at 64-row windows)."""
    root = tmp_path_factory.mktemp("ft")
    rng = np.random.default_rng(11)
    songs = root / "songs"
    for comp in ("Bach", "Chopin"):
        os.makedirs(songs / comp)
        for i in range(5):
            _song(rng, 80 + 20 * i).dump(str(songs / comp / f"Q{i % 4 + 1}_p{i}.mid"))
    out = {}
    for task in ("composer", "emotion", "melody", "velocity", "generate"):
        dest = root / "Data" / task
        extra = ["--max_seq_len", "64"] if task in ("composer", "emotion") else []
        assert cli.main(["tokenize", "--dataset", str(songs), "--task", task,
                         "--out_root", str(dest)] + extra) == 0
        out[task] = str(dest / "songs")
    return out


def _jax(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def _summary(run_dir):
    """What both CLIs write alike: the files, the history's steps, the best
    step, each event's keys, the test outputs' shape and type."""
    files = sorted(os.listdir(run_dir))
    meta = json.load(open(os.path.join(run_dir, "meta.json")))
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        events = [{k: sorted(v) if isinstance(v, dict) else
                   v if isinstance(v, str) else None
                   for k, v in json.loads(line).items() if k != "t"} for line in f]
    test = np.load(os.path.join(run_dir, "test_outputs.npy"))
    return (files, [h["step"] for h in meta["history"]], meta["best_step"],
            sorted(meta["history"][0]), events, test.shape, test.dtype.kind)


def _both(tmp_path, monkeypatch, argv, run, jax_too=True):
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _summary(os.path.join("result", "finetune", run))
    if jax_too:
        os.rename("result", "port_result")
        assert _jax(argv + ["--mesh", "1x1x1"]) == 0
        assert got == _summary(os.path.join("result", "finetune", run))
    return got


@pytest.mark.parametrize("task", ["composer", "velocity"])
def test_finetune_matches_jax_layout(data, tmp_path, monkeypatch, task):
    seq = task == "composer"
    argv = ["finetune", "--task", task, "--dataroot", data[task], "--dataset",
            "songs", "--max_seq_len", "64" if seq else "1024"] + RUN
    # the JAX CLI once, for the sequence task (the token task's layout is
    # the same code path of its runner)
    files, *_, shape, kind = _both(tmp_path, monkeypatch, argv, f"{task}_pianobart",
                                   jax_too=seq)
    assert {"best", "step_1", "meta.json", "metrics.jsonl", "test_outputs.npy"} <= set(files)
    n_test = len(np.load(os.path.join(data[task], "songs_test.npy")))
    assert shape == ((n_test,) if seq else (n_test, 1024)) and kind == "i"


@pytest.mark.parametrize("task,extra", [("emotion", ["--weight", "1e-3"]),
                                        ("melody", ["--ckpt", "GEN"])])
def test_finetune_other_tasks(data, tmp_path, monkeypatch, task, extra):
    """Emotion with the L2 term; melody from a checkpoint (a generation
    finetune's directory: its trunk grafted onto the classifier)."""
    monkeypatch.chdir(tmp_path)
    if "GEN" in extra:
        assert cli.main(["finetune-generation", "--dataroot", data["generate"],
                         "--datasets", "songs", "--max_seq_len", "1024",
                         "--device", "cpu"] + RUN) == 0
        extra = ["--ckpt", str(tmp_path / "result" / "finetune" / "generation_pianobart")]
    S = "64" if task == "emotion" else "1024"
    assert cli.main(["finetune", "--task", task, "--dataroot", data[task],
                     "--dataset", "songs", "--max_seq_len", S, "--device", "cpu"]
                    + RUN + extra) == 0
    meta = json.load(open(tmp_path / "result" / "finetune" / f"{task}_pianobart" /
                          "meta.json"))
    assert meta["best_step"] == 1 and np.isfinite(meta["history"][0]["loss"])


def test_out_of_range_labels_fail_fast_as_jax(data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["finetune", "--task", "composer", "--dataroot", data["composer"],
            "--dataset", "songs", "--max_seq_len", "64", "--class_num", "1"] + RUN
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        _jax(argv + ["--mesh", "1x1x1"])
    assert str(got.value) == str(want.value) and "out of range" in str(got.value)


@pytest.mark.parametrize("extra", [["--fad"], ["--fad", "--fad_jit", "--decoder_mode",
                                                "shifted"]])
def test_finetune_generation_matches_jax_layout(data, tmp_path, monkeypatch, extra):
    argv = ["finetune-generation", "--dataroot", data["generate"], "--datasets",
            "songs", "--max_seq_len", "1024"] + RUN + extra
    got = _both(tmp_path, monkeypatch, argv, "generation_pianobart",
                jax_too=extra == ["--fad"])
    epoch = [e for e in got[4] if e["event"] == "epoch"][0]
    assert epoch["valid"] is not None and {"fad", "fad_bar"} <= set(epoch["valid"])


def test_ablation_and_eval_gen_match_jax(data, tmp_path, monkeypatch):
    """The ablation's seeded 80/10/10 split gives both CLIs the same test
    split; ``eval-gen`` pads the tail batch and stacks one ``.npy``."""
    argv = ["ablation", "--dataroot", data["generate"], "--datasets", "songs",
            "--max_seq_len", "1024"] + RUN
    _both(tmp_path, monkeypatch, argv, "ablation_pianobart")
    ckpt = str(tmp_path / "port_result" / "finetune" / "ablation_pianobart")
    gen = ["eval-gen", "--dataroot", data["generate"], "--datasets", "songs",
           "--max_seq_len", "1024", "--batch_size", "2"] + MODEL
    assert cli.main(gen + ["--ckpt", ckpt, "--output", "p.npy", "--device", "cpu"]) == 0
    assert _jax(gen + ["--nopretrain", "--output", "j.npy", "--mesh", "1x1x1"]) == 0
    p, j = np.load("p.npy"), np.load("j.npy")
    assert p.shape == j.shape == (len(np.load(os.path.join(
        data["generate"], "songs_test.npy"))), 1024, 8)
    assert p.dtype == j.dtype
