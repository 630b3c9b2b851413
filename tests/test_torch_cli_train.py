"""The port's data and training CLI: ``tokenize``, ``concat``, ``check`` and
``make-dict`` write what the JAX CLI writes, byte for byte; ``pretrain``
runs end to end on the CPU at a tiny width, then resumes; a preemption maps
to exit 75; ``--ckpt`` a merged ``.msgpack``; the refusals (a ``.msgpack``
of another model, a window length that differs from ``--max_seq_len``, no
card without ``--device cpu``)."""
import json
import os

import numpy as np
import pytest
import torch

from pianobart_tpu import cli as jcli
from pianobart_tpu_torch import cli
from pianobart_tpu_torch.utils.preemption import EXIT_PREEMPTED, Preempted
from tests.test_midi_io import make_song

TINY = ["--device", "cpu", "--hs", "64", "--layers", "1", "--heads", "2",
        "--ffn_dims", "128"]


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    root = tmp_path_factory.mktemp("midi") / "songs"
    rng = np.random.default_rng(7)
    for comp in ("Bach", "Chopin"):
        os.makedirs(root / comp)
        for i in range(5):
            song = make_song(rng, n_notes=150 + 30 * i, n_tracks=2)
            song.instruments[0].name = "MELODY"
            song.dump(str(root / comp / f"Q{i % 4 + 1}_piece{i}.mid"))
    return str(root)


def _jax(argv):
    """The JAX CLI's subcommand function on the same arguments (its
    ``main`` would also set up an XLA compile cache)."""
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.mark.parametrize("extra", [["--no_pad"], ["--task", "composer"],
                                   ["--task", "melody", "--max_seq_len", "2048"]])
def test_tokenize_concat_check_make_dict_match_jax(songs, tmp_path, capsys, extra):
    for tag, run in (("p", cli.main), ("j", _jax)):
        out = str(tmp_path / tag)
        assert run(["tokenize", "--dataset", songs, "--out_root", out] + extra) == 0
        assert run(["make-dict", "--out_dir", os.path.join(out, "dict")]) == 0
    logs = capsys.readouterr().out
    assert logs.count("MIDI files successfully processed") == 2
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    if extra != ["--no_pad"]:
        return
    for tag, run in (("p", cli.main), ("j", _jax)):
        out = str(tmp_path / tag)
        assert run(["concat", "--dataroot", out, "--datasets", "songs",
                    "--output", os.path.join(out, "all.npy")]) == 0
        split = os.path.join(out, "songs", "songs_train_split.npy")
        assert run(["check", "--file", split, "--packed", "--sample",
                    os.path.join(out, "a.mid")]) == 0
        # unpacked windows hold several EOS rows: the check fails, exit 1
        assert run(["check", "--file", split]) == 1
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    out = capsys.readouterr().out
    assert out.count("check: OK") == 2 and out.count("check: FAILED") == 2


def test_pretrain_end_to_end_then_resume(songs, tmp_path, monkeypatch):
    """Two epochs at d_model 64 (bf16 compute, f32 parameters) with a safety
    save every dispatch, then ``--resume`` to 3 epochs; ``--ckpt`` of the
    result seeds a fresh run, and a window length other than
    ``--max_seq_len`` is refused."""
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    assert cli.main(["tokenize", "--dataset", songs, "--no_pad",
                     "--out_root", data]) == 0
    base = ["pretrain", "--dataroot", data, "--datasets", "songs",
            "--batch_size", "2", "--checkpoint_every_dispatches", "1"] + TINY
    assert cli.main(base + ["--epochs", "2"]) == 0
    save = tmp_path / "result" / "pretrain" / "pianobart"
    meta = json.loads((save / "meta.json").read_text())
    assert meta["last_step"] == 2 and "safety" not in meta
    assert cli.main(base + ["--epochs", "3", "--resume"]) == 0
    meta = json.loads((save / "meta.json").read_text())
    assert [h["step"] for h in meta["history"]] == [1, 2, 3]
    events = [json.loads(l) for l in (save / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2, 3]
    assert all(np.isfinite(e["train"]["loss"]) for e in events if e["event"] == "epoch")
    assert cli.main(base + ["--epochs", "1", "--name", "seeded", "--ckpt",
                            str(save)]) == 0
    with pytest.raises(SystemExit, match="--max_seq_len"):
        cli.main(base + ["--epochs", "1", "--max_seq_len", "512"])


def test_pretrain_refusals(songs, tmp_path, monkeypatch):
    """A merged ``.msgpack`` of the model's widths loads (its trunk and
    head grafted); one none of whose top-level keys the model has raises
    ``SystemExit`` with the JAX package's words, unless ``--nopretrain``; a
    reference ``.ckpt`` that is not there raises ``FileNotFoundError``
    (loading one is ``tests/test_torch_interop.py``'s); without a card and
    without ``--device`` the command raises."""
    from pianobart_tpu_torch.compat.flax_msgpack import write_msgpack
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.merge.cli import save_merged
    from pianobart_tpu_torch.models import PianoBartConfig
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    cli.main(["tokenize", "--dataset", songs, "--no_pad", "--out_root", data])
    base = ["pretrain", "--dataroot", data, "--datasets", "songs", "--epochs", "0"]
    cfg = PianoBartConfig(d_model=64, encoder_layers=1, decoder_layers=1, ffn_dim=128,
                          num_heads=2)
    save_merged(init_lm(cfg, seed=4, device="cpu").state_dict(), "merged.msgpack")
    assert cli.main(base + TINY + ["--ckpt", "merged.msgpack"]) == 0
    write_msgpack({"foo": {"bias": torch.zeros(2)}}, "wrong.msgpack")
    with pytest.raises(SystemExit, match="none match this model's parameter tree"):
        cli.main(base + TINY + ["--ckpt", "wrong.msgpack"])
    with pytest.raises(FileNotFoundError):
        cli.main(base + TINY + ["--ckpt", "ref.ckpt"])
    assert cli.main(base + TINY + ["--ckpt", "wrong.msgpack", "--nopretrain"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(base)


def test_run_guarded_maps_preempted_to_75(capsys):
    class Logger:
        closed = False

        def close(self):
            self.closed = True

    class Runner:
        preempt = None

        def __init__(self, exc=None):
            self.exc = exc
            self.logger = Logger()

        def run(self, epochs, resume=False):
            assert self.preempt is not None   # the guard reached the runner
            if self.exc:
                raise self.exc

    runners = [Runner(Preempted("saved")), Runner(), Runner(ValueError("boom"))]
    assert cli._run_guarded(runners[0], 1, False) == EXIT_PREEMPTED == 75
    assert "[preempt] saved" in capsys.readouterr().err
    assert cli._run_guarded(runners[1], 1, True) == 0
    with pytest.raises(ValueError):
        cli._run_guarded(runners[2], 1, False)
    # every way out closes the run's TensorBoard writer
    assert all(r.logger.closed for r in runners)
