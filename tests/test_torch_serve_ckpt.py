"""Serving from checkpoints: the registry of ``create_app`` loads a
checkpoint directory of the port and a reference ``.ckpt`` at first use,
each model holding the checkpoint's weights (a trunk-only file: the LM head
drawn from the seed, without drawing the rest), and answers ``GET
/api/generate/<model>/<file>``; ``/api/health`` gives the JAX App's JSON for
the same registry; ``demo --ckpt`` on the CPU; a merged ``.msgpack`` loads
through every entry point that takes a checkpoint."""
import json
import os

import numpy as np
import pytest
import torch

from pianobart_tpu.serve import app as japp
from pianobart_tpu_torch import cli
from pianobart_tpu_torch.compat import torch_export as pexport
from pianobart_tpu_torch.compat.from_jax import init_lm
from pianobart_tpu_torch.decode import load_inference_model
from pianobart_tpu_torch.midi import read_midi
from pianobart_tpu_torch.models import PianoBartConfig
from pianobart_tpu_torch.serve import app as tapp
from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
from tests.test_midi_io import make_song
from tests.test_serve import wsgi_call
from tests.test_torch_app import _call, _echo, _song, _upload

torch.set_num_threads(2)
# the demo CLI's model for --hs 128 --layers 2 --ffn_dims 256 --heads 2
# --max_seq_len 64, with the CLI's f32 parameters
CFG = PianoBartConfig(d_model=128, encoder_layers=2, decoder_layers=2, ffn_dim=256,
                      num_heads=2, max_len=64)
DEMO = ["--hs", "128", "--layers", "2", "--ffn_dims", "256", "--heads", "2",
        "--max_seq_len", "64"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A checkpoint directory, the same weights as a reference LM file, and
    their trunk alone as a reference file."""
    root = tmp_path_factory.mktemp("ckpts")
    model = init_lm(CFG, seed=7, device="cpu")
    CheckpointManager(str(root / "run")).save(1, create_train_state(model),
                                              {"weighted_acc": 0.5}, is_best=True)
    sd = model.state_dict()
    pexport.save_torch_checkpoint(pexport.export_lm(sd, CFG), str(root / "lm.ckpt"))
    pexport.save_torch_checkpoint(pexport.export_trunk(sd, CFG), str(root / "trunk.ckpt"))
    return {"dir": str(root / "run"), "lm": str(root / "lm.ckpt"),
            "trunk": str(root / "trunk.ckpt"), "weights": sd}


def test_registry_loads_both_forms_and_serves(ckpts, tmp_path, monkeypatch):
    """Nothing loads before the first use; then each service's model holds
    the checkpoint's weights, on its device and in eval mode, and a request
    to each model answers a 200 whose MIDI parses back (or the JAX App's 500
    "no notes")."""
    monkeypatch.chdir(tmp_path)
    app = tapp.create_app(ckpts={"run": ckpts["dir"], "ref": ckpts["lm"]},
                          device="cpu", cfg=CFG, batch_window_s=0.0)
    assert not any(s.ready for s in app.services.values())
    name, _ = _upload(app, _song(n_notes=60))
    for model in ("run", "ref"):
        status, j, raw = _call(app, "GET", f"/api/generate/{model}/{name}")
        svc = app.services[model]
        assert svc.ready and not svc.model.training
        for k, v in svc.model.state_dict().items():
            assert torch.equal(v, ckpts["weights"][k]), (model, k)
        if status == "500 Internal Server Error":
            assert j == {"error": "generation produced no notes"}
            continue
        assert status == "200 OK" and j["model"] == model, raw
        st, _, blob = wsgi_call(app, "GET", f"/api/outputs/{json.loads(raw)['file']}")
        (tmp_path / "out.mid").write_bytes(blob)
        assert st == "200 OK"
        assert sum(len(i.notes) for i in read_midi(str(tmp_path / "out.mid")).instruments)


def test_trunk_file_draws_only_the_head(ckpts, monkeypatch):
    """A trunk-only file: the trunk is the file's; the LM head, the only
    parameters it lacks, is drawn from the seed (N(0, 0.02), zero bias), and
    nothing else is drawn (the model is built on the meta device)."""
    drawn = []
    real = torch.randn

    def counting(*a, **k):
        drawn.append(a[0])
        return real(*a, **k)
    monkeypatch.setattr(torch, "randn", counting)
    model = load_inference_model(CFG, ckpts["trunk"], seed=3, device="cpu")
    assert drawn == [torch.Size([CFG.total_vocab, CFG.d_model])]
    for k, v in model.state_dict().items():
        if k.startswith("pianobart."):
            assert torch.equal(v, ckpts["weights"][k]), k
    w = model.lm_head.proj.weight
    assert abs(float(w.detach().std()) - 0.02) < 2e-3 and not model.lm_head.proj.bias.any()
    assert not model.training


@pytest.mark.parametrize("single", [False, True])
def test_health_matches_jax(ckpts, tmp_path, monkeypatch, single):
    """``/api/health``: the top-level ``ckpt`` (the single path, else the
    registry's first) and each model's ``ckpt``, as the JAX App reports
    them."""
    monkeypatch.chdir(tmp_path)
    kw = ({"ckpt": ckpts["dir"]} if single
          else {"ckpts": {"run": ckpts["dir"], "ref": ckpts["lm"], "rand": None}})
    got = _call(tapp.create_app(device="cpu", generate_fn=_echo, **kw),
                "GET", "/api/health")
    want = _call(japp.create_app(generate_fn=_echo, **kw), "GET", "/api/health")
    assert got == want and got[0] == "200 OK"


def test_demo_cli_loads_a_checkpoint(ckpts, tmp_path, monkeypatch, capsys):
    """``demo --ckpt`` (a directory, then the reference file) on the CPU:
    the same weights give the same continuation."""
    monkeypatch.chdir(tmp_path)
    make_song(np.random.default_rng(1), n_notes=60).dump("in.mid")
    outs = []
    for path in (ckpts["dir"], ckpts["lm"]):
        assert cli.main(["demo", "--input", "in.mid", "--output", "out.mid",
                         "--ckpt", path, "--device", "cpu"] + DEMO) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        outs.append(open("out.mid", "rb").read() if last == "Saved to out.mid" else last)
        if os.path.exists("out.mid"):
            os.remove("out.mid")
    assert outs[0] == outs[1]


def test_msgpack_is_refused_everywhere(ckpts, tmp_path, monkeypatch):
    """A merged ``.msgpack`` (the ``merge`` output) loads everywhere a
    checkpoint does: the loader, the service, ``eval-gen --ckpt`` and the
    training commands' ``--ckpt``, every tensor the file's; a ``.msgpack``
    none of whose top-level keys the model has is refused with the JAX
    package's words before any work (the service's App with its JSON
    500 at the first request)."""
    from pianobart_tpu_torch.compat.flax_msgpack import write_msgpack
    from pianobart_tpu_torch.merge.cli import save_merged
    monkeypatch.chdir(tmp_path)
    save_merged(ckpts["weights"], "m.msgpack")
    write_msgpack({"foo": {"bias": torch.zeros(2)}}, "wrong.msgpack")

    class Args:      # what every training command grafts its --ckpt with
        ckpt, nopretrain = "m.msgpack", False
    svc = tapp.GenerationService(ckpt="m.msgpack", cfg=CFG, device="cpu")
    svc._ensure()
    for model in (load_inference_model(CFG, "m.msgpack", device="cpu"), svc.model,
                  cli._load_init_ckpt(init_lm(CFG, seed=1, device="cpu"), Args)):
        for k, v in model.state_dict().items():
            assert torch.equal(v, ckpts["weights"][k]), k
    np.save("x_test.npy", np.zeros((1, 64, 8), np.int64))
    assert cli.main(["eval-gen", "--dataroot", ".", "--datasets", "x", "--ckpt",
                     "m.msgpack", "--device", "cpu", "--output", "gen.npy"] + DEMO) == 0
    assert np.load("gen.npy").shape == (1, 64, 8)

    Args.ckpt = "wrong.msgpack"
    match = "none match this model's parameter tree"
    with pytest.raises(SystemExit, match=match):
        load_inference_model(CFG, "wrong.msgpack", device="cpu")
    with pytest.raises(SystemExit, match=match):
        cli.main(["eval-gen", "--dataroot", ".", "--datasets", "x", "--ckpt",
                  "wrong.msgpack", "--device", "cpu", "--output", "bad.npy"] + DEMO)
    with pytest.raises(SystemExit, match=match):
        cli._load_init_ckpt(init_lm(CFG, device="cpu"), Args)
    assert not os.path.exists("bad.npy")
    # the service loads at the first request: the App answers its JSON 500
    app = tapp.create_app(ckpts={"bad": "wrong.msgpack"}, device="cpu", cfg=CFG)
    name, _ = _upload(app, _song())
    status, j, _ = _call(app, "GET", f"/api/generate/bad/{name}")
    assert status == "500 Internal Server Error" and match in j["error"]
    assert not app.services["bad"].ready
