"""The port's HTTP App, ``GenerationService.generate``, ``run_demo`` and CLI
against the JAX package's: every route test of tests/test_serve.py as a
case over both packages' ``create_app`` (their JSON bodies agree, apart
from ``latency_s`` and the upload's uuid prefix), the MIDI-file plumbing
with the same fixed continuation, a tiny real model end to end on the CPU,
a merged ``.msgpack`` through the App, the demo and the CLI, and the
refusals (a ``.msgpack`` of another model; no card without ``--device
cpu``)."""
import json
import os
import re
import shutil
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pianobart_tpu.midi.writer import midi_bytes
from pianobart_tpu.serve import app as japp
from pianobart_tpu_torch import cli
from pianobart_tpu_torch import vocab as TV
from pianobart_tpu_torch.models import PianoBartConfig
from pianobart_tpu_torch.serve import app as tapp
from pianobart_tpu_torch.serve import demo as tdemo
from tests.test_midi_io import make_song
from tests.test_serve import multipart, wsgi_call

torch.set_num_threads(2)

PKGS = ("jax", "torch")


def _create_app(pkg, **kw):
    if pkg == "torch":
        return tapp.create_app(device="cpu", **kw)
    return japp.create_app(**kw)


def _echo(midi_in, midi_out, seed=0):
    shutil.copyfile(midi_in, midi_out)  # echo "model"
    return True


def _norm(obj):
    """A JSON body without what differs per run: latency and uuid prefix."""
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items() if k != "latency_s"}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"[0-9a-f]{8}_", "<id>_", obj)
    return obj


def _call(app, method, path, body=b"", ctype=None):
    status, headers, out = wsgi_call(app, method, path, body, ctype)
    if headers.get("Content-Type") == "application/json":
        return status, _norm(json.loads(out)), out
    return status, None, out


def _song(n_notes=30, seed=2023):
    return midi_bytes(make_song(np.random.default_rng(seed), n_notes=n_notes))


def _upload(app, data, name="song.mid"):
    body, ctype = multipart("file", name, data)
    status, j, raw = _call(app, "POST", "/api/upload", body, ctype)
    assert status == "200 OK"
    return json.loads(raw)["file"], (status, j)


# -- the route tests of tests/test_serve.py, each a scenario over one app ----

def _health(make):
    app = make(generate_fn=_echo)
    status, j, _ = _call(app, "GET", "/api/health")
    assert status == "200 OK" and j["status"] == "ok" and j["model_loaded"] is False
    return [(status, j)]


def _index(make):
    app = make(generate_fn=_echo)
    status, headers, body = wsgi_call(app, "GET", "/")
    assert status == "200 OK" and headers["Content-Type"] == "text/html"
    assert b"PianoBART" in body
    assert b"/api/upload" in body and b"/api/generate/" in body
    return [status]


def _roundtrip(make):
    app = make(generate_fn=_echo)
    data = _song()
    name, up = _upload(app, data)
    status, gen, raw = _call(app, "GET", f"/api/generate/pianobart/{name}")
    assert status == "200 OK" and gen["file"].startswith("gen_")
    status2, headers, blob = wsgi_call(app, "GET", f"/api/outputs/{json.loads(raw)['file']}")
    assert status2 == "200 OK" and blob == data  # the echo "model"
    status3, _, blob3 = wsgi_call(app, "GET", f"/api/uploads/{name}")
    assert status3 == "200 OK" and blob3 == data
    return [up, (status, gen), (status2, headers["Content-Type"]), status3]


def _upload_without_file(make):
    app = make(generate_fn=_echo)
    out = []
    body, ctype = multipart("other", "x.mid", b"123")
    out.append(_call(app, "POST", "/api/upload", body, ctype)[:2])
    out.append(_call(app, "POST", "/api/upload", b"raw", "text/plain")[:2])
    assert [s for s, _ in out] == ["400 Bad Request"] * 2
    return out


def _missing_file(make):
    app = make(generate_fn=_echo)
    status, j, _ = _call(app, "GET", "/api/generate/pianobart/nope.mid")
    assert status == "404 Not Found"
    return [(status, j), _call(app, "GET", "/api/generate/pianobart")[:2],
            _call(app, "GET", "/api/outputs/nope.mid")[:2]]


def _unknown_routes(make):
    app = make(generate_fn=_echo)
    out = [_call(app, m, p)[:2] for m, p in
           [("GET", "/api/secrets/passwd"), ("GET", "/nope"),
            ("POST", "/api/health"), ("GET", "/api/uploads/../../etc/passwd")]]
    assert all(s == "404 Not Found" for s, _ in out)
    return out


def _model_registry(make):
    served = []

    def fake_generate(midi_in, midi_out, seed=0):
        shutil.copyfile(midi_in, midi_out)
        served.append(os.path.basename(midi_out))
        return True

    app = make(ckpts={"base": None, "finetuned": None}, generate_fn=fake_generate)
    status, j, _ = _call(app, "GET", "/api/health")
    assert set(j["models"]) == {"base", "finetuned"}
    name, _ = _upload(app, _song())
    status2, gen, _ = _call(app, "GET", f"/api/generate/finetuned/{name}")
    assert status2 == "200 OK" and gen["model"] == "finetuned"
    status3, j3, _ = _call(app, "GET", f"/api/generate/nope/{name}")
    assert status3 == "404 Not Found" and j3["models"] == ["base", "finetuned"]
    return [(status, j), (status2, gen), (status3, j3), _norm(served)]


def _outputs_per_model(make):
    def fake_generate(midi_in, midi_out, seed=0):
        with open(midi_out, "wb") as f:
            f.write(os.path.basename(midi_out).encode())  # distinguishable
        return True

    app = make(ckpts={"base": None, "finetuned": None}, generate_fn=fake_generate)
    name, _ = _upload(app, _song())
    out, files = [], {}
    for model in ("base", "finetuned"):
        status, j, raw = _call(app, "GET", f"/api/generate/{model}/{name}")
        assert status == "200 OK"
        files[model] = json.loads(raw)["file"]
        out.append((status, j))
    assert files["base"] != files["finetuned"]
    for model, fname in files.items():
        assert model in fname
        status, _, blob = wsgi_call(app, "GET", f"/api/outputs/{fname}")
        assert status == "200 OK"
        out.append((status, _norm(blob.decode())))
    return out


def _generation_fails(make):
    app = make(generate_fn=lambda a, b, seed=0: False)
    name, _ = _upload(app, _song())
    status, j, _ = _call(app, "GET", f"/api/generate/pianobart/{name}")
    assert status == "500 Internal Server Error"
    assert j == {"error": "generation produced no notes"}
    return [(status, j)]


SCENARIOS = {"health": _health, "index": _index,
             "upload_generate_download_roundtrip": _roundtrip,
             "upload_without_file": _upload_without_file,
             "generate_missing_file": _missing_file,
             "unknown_routes": _unknown_routes,
             "model_registry_selection": _model_registry,
             "generate_outputs_namespaced_per_model": _outputs_per_model,
             "generation_produced_no_notes": _generation_fails}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("route", list(SCENARIOS))
def test_route(route, pkg, tmp_path, monkeypatch):
    """The JAX test's assertions on either package's App; the port's JSON
    bodies equal the JAX App's on the same calls."""
    scenario = SCENARIOS[route]
    (tmp_path / pkg).mkdir()
    monkeypatch.chdir(tmp_path / pkg)
    got = scenario(lambda **kw: _create_app(pkg, **kw))
    if pkg == "torch":
        (tmp_path / "ref").mkdir()
        monkeypatch.chdir(tmp_path / "ref")
        assert got == scenario(lambda **kw: _create_app("jax", **kw))


@pytest.mark.parametrize("mod", [japp, tapp], ids=PKGS)
def test_parse_ckpt_registry(mod):
    assert mod.parse_ckpt_registry(None) == {"pianobart": None}
    assert mod.parse_ckpt_registry(["a/b"]) == {"pianobart": "a/b"}
    assert mod.parse_ckpt_registry(["x=p1", "y=p2", "bare"]) == {
        "x": "p1", "y": "p2", "pianobart": "bare"}
    assert mod.parse_ckpt_registry(["result/pretrain/lr=1e-3/best"]) == {
        "pianobart": "result/pretrain/lr=1e-3/best"}
    assert mod.parse_ckpt_registry(["=weird/path"]) == {"pianobart": "=weird/path"}
    with pytest.raises(SystemExit, match="duplicate"):
        mod.parse_ckpt_registry(["x=p1", "x=p2"])


@pytest.mark.parametrize("mod", [japp, tapp], ids=PKGS)
def test_multipart_preserves_trailing_bytes(mod):
    import io
    for payload in (b"MThd\x00\x01\n\r\n", b"data--", b"x\r\n\r\n",
                    b"plain", b"ends-with-lf\n", b""):
        body, ctype = multipart("file", "a.mid", payload)
        environ = {"CONTENT_TYPE": ctype, "CONTENT_LENGTH": str(len(body)),
                   "wsgi.input": io.BytesIO(body)}
        assert mod._parse_multipart_file(environ, "file") == ("a.mid", payload)


# -- GenerationService.generate: the MIDI-file plumbing ----------------------

def _stub_services(S, n_empty):
    """Both packages' services with the model replaced by the same fixed
    continuation: the intro itself, or an empty grid for the first
    ``n_empty`` attempts of a request (seed - first seed < n_empty)."""
    pad = np.asarray(TV.PAD)
    svcs, seeds = [], []
    for svc in (japp.GenerationService(batch_window_s=0.0),
                tapp.GenerationService(device="cpu", batch_window_s=0.0)):
        svc._ready = True  # no model load
        svc.cfg = SimpleNamespace(max_len=S)
        seen = []

        def decode(intros, req_seeds, seen=seen):
            seen.append(list(req_seeds))
            out = np.array(intros)
            for i, s in enumerate(req_seeds):
                if s - 100 < n_empty:
                    out[i] = pad
            return out

        svc._decode_batch = decode
        svcs.append(svc)
        seeds.append(seen)
    return svcs, seeds


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("n_empty,retries", [(0, None), (2, None), (5, "3")])
def test_generate_plumbing_matches(tmp_path, monkeypatch, S, n_empty, retries):
    if retries is None:
        monkeypatch.delenv("PBX_DEMO_RETRIES", raising=False)
    else:
        monkeypatch.setenv("PBX_DEMO_RETRIES", retries)
    src = tmp_path / "in.mid"
    src.write_bytes(_song(n_notes=400 if S == 1024 else 40))
    (jsvc, tsvc), (jseeds, tseeds) = _stub_services(S, n_empty)
    jout, tout = str(tmp_path / "j.mid"), str(tmp_path / "t.mid")
    want = jsvc.generate(str(src), jout, seed=100)
    got = tsvc.generate(str(src), tout, seed=100)
    assert got == want and tseeds == jseeds
    attempts = min(n_empty + 1, int(retries or 4))
    assert got[1]["attempts"] == attempts and got[1]["retries"] == attempts - 1
    assert got[1]["batch_size_served"] == 1
    assert got[1]["seed_semantics"] == "per-request"
    assert got[0] == (n_empty < attempts)
    if got[0]:
        assert open(tout, "rb").read() == open(jout, "rb").read()
    else:
        assert not os.path.exists(tout) and not os.path.exists(jout)


def test_generate_hook_and_warmup_without_a_model(tmp_path):
    svc = tapp.GenerationService(device="cpu", generate_fn=lambda a, b, c: True)
    assert svc.generate("a", "b", 3) == (True, {})
    assert svc.warmup() == {} and not svc.ready and svc.ckpt is None


def test_concurrent_generate_coalesces_and_reports_the_batch(tmp_path):
    (_, svc), _ = _stub_services(64, 0)
    svc.batch_window_s = 0.05
    src = tmp_path / "in.mid"
    src.write_bytes(_song(n_notes=40))
    infos = [None] * 5

    def client(i):
        infos[i] = svc.generate(str(src), str(tmp_path / f"o{i}.mid"), seed=100 + i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert all(ok for ok, _ in infos)
    assert sum(svc.batch_sizes_served) == 5 and max(svc.batch_sizes_served) > 1
    for ok, info in infos:
        n = info["batch_size_served"]
        assert n in svc.batch_sizes_served
        assert info["seed_semantics"] == ("per-request" if n == 1 else
                                          f"batch-level stream over {n} coalesced requests")


# -- a tiny real model end to end on the CPU --------------------------------

def test_tiny_model_through_the_app_end_to_end(tmp_path, monkeypatch):
    from pianobart_tpu_torch.midi import read_midi

    monkeypatch.chdir(tmp_path)
    cfg = PianoBartConfig(d_model=128, emb_size=32, encoder_layers=2,
                          decoder_layers=2, ffn_dim=256, num_heads=2, max_len=64)
    svc = tapp.GenerationService(cfg=cfg, device="cpu", seed=0, max_batch=4,
                                 batch_window_s=0.05)
    grids = []
    decode = svc._decode_batch

    def recording(intros, seeds):
        out = decode(intros, seeds)
        grids.extend(out)
        return out

    svc._decode_batch = recording
    app = tapp.App(svc)
    names = [_upload(app, _song(n_notes=60, seed=s), f"s{s}.mid")[0] for s in range(2)]
    answers = [None] * len(names)

    def client(i):
        answers[i] = _call(app, "GET", f"/api/generate/pianobart/{names[i]}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and svc.ready
    assert all(g.shape == (64, 8) for g in grids)
    for status, j, raw in answers:
        if status == "500 Internal Server Error":
            assert j == {"error": "generation produced no notes"}
            continue
        assert status == "200 OK", raw
        assert 1 <= j["attempts"] <= 4 and j["model"] == "pianobart"
        st, _, blob = wsgi_call(app, "GET", f"/api/outputs/{json.loads(raw)['file']}")
        assert st == "200 OK"
        path = tmp_path / "out.mid"
        path.write_bytes(blob)
        assert sum(len(i.notes) for i in read_midi(str(path)).instruments) > 0
        # the served file is one decoded grid, cleaned and written
        written = []
        for g in grids:
            ref = tmp_path / "ref.mid"
            if tdemo.window_to_midi(g, str(ref)):
                written.append(ref.read_bytes())
        assert blob in written


def test_app_run_serves_over_a_localhost_socket(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    app = tapp.create_app(generate_fn=_echo, device="cpu")
    server = threading.Thread(target=app.run, kwargs={"host": "127.0.0.1", "port": 0},
                              daemon=True)
    server.start()
    for _ in range(200):
        if app.server is not None:
            break
        time.sleep(0.01)
    url = f"http://127.0.0.1:{app.server.server_port}"
    try:
        with urllib.request.urlopen(f"{url}/api/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        data = _song()
        body, ctype = multipart("file", "song.mid", data)
        req = urllib.request.Request(f"{url}/api/upload", data=body,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=10) as r:
            name = json.loads(r.read())["file"]
        with urllib.request.urlopen(f"{url}/api/generate/pianobart/{name}",
                                    timeout=10) as r:
            gen = json.loads(r.read())
        with urllib.request.urlopen(f"{url}/api/outputs/{gen['file']}", timeout=10) as r:
            assert r.read() == data
    finally:
        app.shutdown()
        server.join(timeout=10)
    assert not server.is_alive()


# -- run_demo ---------------------------------------------------------------

def _fake_generate(calls, S, n_empty, as_torch):
    from pianobart_tpu import vocab as V

    def fake(*args, **kw):
        seed = (kw["generator"].initial_seed() if as_torch
                else int(np.asarray(kw["rng"])[-1]))
        calls.append(seed)
        grid = np.zeros((1, S, 8), np.int32)
        if len(calls) <= n_empty:                # illegal row 0
            grid[:, :, :] = np.asarray(V.PAD)
        else:                                    # valid content, then EOS
            grid[0, 4] = np.asarray(V.PAD) + 3
        return torch.as_tensor(grid) if as_torch else grid
    return fake


def test_run_demo_retries_seeds_until_nonempty(tmp_path, monkeypatch, capsys):
    """The port's demo retries seeds rng_seed+1+attempt and prints what the
    JAX demo prints."""
    import pianobart_tpu.decode as jdecode
    import pianobart_tpu_torch.decode as tdecode
    from pianobart_tpu.serve.demo import run_demo as j_run

    monkeypatch.chdir(tmp_path)
    make_song(np.random.default_rng(0), n_notes=30).dump("in.mid")
    S, kw = 32, dict(max_seq_len=32, hs=64, layers=1, ffn_dims=128, heads=2)
    for retries, n_empty in ((None, 2), ("2", 5)):
        if retries:
            monkeypatch.setenv("PBX_DEMO_RETRIES", retries)
        printed, written = [], []
        for pkg, mod, run in (("jax", jdecode, j_run), ("torch", tdecode, tdemo.run_demo)):
            calls = []
            monkeypatch.setattr(mod, "generate",
                                _fake_generate(calls, S, n_empty, pkg == "torch"))
            extra = {"device": "cpu"} if pkg == "torch" else {}
            path = f"{pkg}_{retries}.mid"
            intro, out = run(input_path="in.mid", output_path=path,
                             rng_seed=10, **kw, **extra)
            printed.append(capsys.readouterr().out.replace(path, "<out>"))
            written.append(os.path.exists(path))
            assert intro.shape == (1, S, 8) and out.shape == (S, 8)
            if pkg == "torch":
                assert calls == list(range(11, 11 + len(calls)))
                assert len(calls) == min(n_empty + 1, int(retries or 4))
        assert printed[0] == printed[1] and written[0] == written[1]
        assert written[1] == (retries is None)


# -- checkpoint paths and refusals -----------------------------------------

def test_checkpoint_paths_are_refused(tmp_path, monkeypatch, capsys):
    """A merged ``.msgpack`` (the ``merge`` output) loads wherever a
    checkpoint does: ``create_app(ckpt=...)`` and a named registry entry,
    ``run_demo``, the ``demo`` and ``serve`` CLI; a ``.msgpack`` none of
    whose top-level keys the model has is refused with the JAX package's
    words before any decode.  The other load forms are
    ``tests/test_torch_serve_ckpt.py``'s."""
    from pianobart_tpu_torch.compat.flax_msgpack import write_msgpack
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.merge.cli import save_merged
    monkeypatch.chdir(tmp_path)
    cfg = PianoBartConfig(d_model=128, encoder_layers=2, decoder_layers=2,
                          ffn_dim=256, num_heads=2, max_len=64)
    dims = ["--hs", "128", "--layers", "2", "--ffn_dims", "256", "--heads", "2",
            "--max_seq_len", "64"]
    weights = init_lm(cfg, seed=7, device="cpu").state_dict()
    save_merged(weights, "ck.msgpack")
    write_msgpack({"foo": {"bias": torch.zeros(2)}}, "wrong.msgpack")
    for app, name in ((tapp.create_app(ckpt="ck.msgpack", device="cpu", cfg=cfg),
                       "pianobart"),
                      (tapp.create_app(ckpts={"a": None, "b": "ck.msgpack"},
                                       device="cpu", cfg=cfg), "b")):
        svc = app.services[name]
        svc._ensure()
        for k, v in svc.model.state_dict().items():
            assert torch.equal(v, weights[k]), k
    make_song(np.random.default_rng(0), n_notes=30).dump("in.mid")
    tdemo.run_demo("in.mid", "out.mid", ckpt="ck.msgpack", device="cpu",
                   max_seq_len=64, hs=128, layers=2, ffn_dims=256, heads=2)
    assert cli.main(["demo", "--input", "in.mid", "--output", "out2.mid",
                     "--ckpt", "ck.msgpack", "--device", "cpu"] + dims) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last in ("Saved to out2.mid", "Generate Fail! (empty)")
    ran = []
    monkeypatch.setattr(tapp.App, "run", lambda self, host, port: ran.append(port))
    assert cli.main(["serve", "--ckpt", "name=ck.msgpack", "--device", "cpu"]) == 0
    assert ran == [5000]
    for path in ("out.mid", "out2.mid"):
        if os.path.exists(path):
            os.remove(path)
    with pytest.raises(SystemExit, match="none match this model's parameter tree"):
        tdemo.run_demo("in.mid", "out.mid", ckpt="wrong.msgpack", device="cpu",
                       max_seq_len=64, hs=128, layers=2, ffn_dims=256, heads=2)
    with pytest.raises(SystemExit, match="none match this model's parameter tree"):
        cli.main(["demo", "--input", "in.mid", "--ckpt", "wrong.msgpack",
                  "--device", "cpu"] + dims)
    assert not os.path.exists("out.mid") and not os.path.exists("output.mid")


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_song(np.random.default_rng(0), n_notes=30).dump("in.mid")
    ran = []
    monkeypatch.setattr(tapp.App, "run", lambda self, host, port: ran.append((host, port)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["demo", "--input", "in.mid", "--output", "out.mid"])
    assert ran == [] and not os.path.exists("out.mid")
    assert cli.main(["serve", "--device", "cpu", "--port", "5050"]) == 0
    assert ran == [("0.0.0.0", 5050)]


def test_cli_demo_on_the_cpu_with_a_tiny_model(tmp_path, monkeypatch, capsys):
    from pianobart_tpu_torch.midi import read_midi

    monkeypatch.chdir(tmp_path)
    make_song(np.random.default_rng(1), n_notes=60).dump("in.mid")
    assert cli.main(["demo", "--input", "in.mid", "--output", "out.mid",
                     "--hs", "128", "--layers", "2", "--ffn_dims", "256",
                     "--heads", "2", "--max_seq_len", "64",
                     "--nopretrain", "--ckpt", "ignored", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    if last == "Saved to out.mid":
        assert sum(len(i.notes) for i in read_midi("out.mid").instruments) > 0
    else:
        assert last == "Generate Fail! (empty)" and not os.path.exists("out.mid")
