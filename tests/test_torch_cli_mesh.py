"""``pretrain --mesh`` of the port's CLI on the CPU over gloo.

* The refusals of the reference CLI (a batch dp does not divide, a length sp
  does not divide, heads tp does not divide, a mesh the job's ranks do not
  fill) and NCCL on the CPU, each before any process group exists.
* ``--mesh 2x1x1`` on two ranks (each runs ``cli.main`` in its own process,
  the process group from the environment as ``torch.distributed.run`` sets
  it): a real SIGTERM to rank 1 alone after epoch 1's validation stops BOTH
  ranks at the top of epoch 2 with exit 75 (they agree at each dispatch
  boundary); ``--resume`` then ends bit-equal to an uninterrupted run, and
  only rank 0 wrote ``metrics.jsonl``.
* ``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
  pianobart_tpu_torch.cli pretrain --mesh 1x1x2``, as a user starts it: one
  epoch through the ring, exit 0, ``best/`` written.

The spawned ranks import this module and need torch only.
"""
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pianobart_tpu_torch import cli
from pianobart_tpu_torch.parallel.launch import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--dist_backend", "gloo", "--hs", "64", "--layers", "1",
        "--heads", "2", "--ffn_dims", "128"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small pretrain corpus tokenized by the port's CLI."""
    from tests.test_midi_io import make_song
    root = tmp_path_factory.mktemp("mesh_cli")
    songs = root / "songs"
    os.makedirs(songs)
    rng = np.random.default_rng(3)
    for i in range(8):
        make_song(rng, n_notes=400 + 50 * i, n_tracks=2).dump(str(songs / f"s{i}.mid"))
    data = str(root / "data")
    assert cli.main(["tokenize", "--dataset", str(songs), "--no_pad",
                     "--out_root", data]) == 0
    return data


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world,argv,msg", [
    (2, ["--batch_size", "3"], "not divisible by the 2 ranks"),
    (2, ["--mesh", "2x1x2"], "needs 4 ranks; the job has 2"),
    (2, ["--mesh", "2x1x1", "--batch_size", "3"],
     r"must be divisible by the dp mesh axis \(2\)"),
    (3, ["--mesh", "1x1x3"], r"--max_seq_len 1024 must be divisible by the sp mesh axis \(3\)"),
    (3, ["--mesh", "1x3x1", "--batch_size", "3"],
     r"--heads 2 must be divisible by the tp mesh axis \(3\)"),
    (2, ["--mesh", "2x2"], "not dpxTPxSP"),
    (2, ["--mesh", "1x1x2", "--dist_backend", "nccl"], "nccl backend runs on CUDA"),
], ids=["batch_vs_ranks", "mesh_vs_ranks", "batch_vs_dp", "len_vs_sp", "heads_vs_tp",
        "layout", "nccl_on_cpu"])
def test_pretrain_mesh_refusals(monkeypatch, world, argv, msg):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=msg):
        cli.main(["pretrain", "--dataroot", "nowhere", "--datasets", "x"] + TINY + argv)
    assert not torch.distributed.is_initialized()


def _cli_rank(rank, world, cwd, argv, port, sigterm_rank):
    """One rank of a job: the environment ``torch.distributed.run`` gives a
    worker, then ``cli.main``; its exit code goes to ``rc<rank>``.  On
    ``sigterm_rank`` the process sends itself SIGTERM once epoch 1 has
    validated."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    os.chdir(cwd)
    if rank == sigterm_rank:
        from pianobart_tpu_torch.train.runner import PretrainRunner
        real = PretrainRunner.valid_epoch

        def valid_then_sigterm(self):
            out = real(self)
            if self._cur_epoch == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        PretrainRunner.valid_epoch = valid_then_sigterm
    rc = cli.main(argv)
    with open(os.path.join(cwd, f"rc{rank}"), "w") as f:
        f.write(str(rc))


def _job(cwd, argv, sigterm_rank=-1):
    os.makedirs(cwd, exist_ok=True)
    spawn(_cli_rank, 2, (str(cwd), argv, _free_port(), sigterm_rank), backend=None,
          threads=2)
    return [int(open(os.path.join(cwd, f"rc{r}")).read()) for r in range(2)]


def _epochs(cwd):
    path = os.path.join(cwd, "result", "pretrain", "pianobart", "metrics.jsonl")
    with open(path) as f:
        return [e["epoch"] for e in map(json.loads, f) if e["event"] == "epoch"]


def _weights(cwd, step):
    path = os.path.join(cwd, "result", "pretrain", "pianobart", f"step_{step}", "state.pt")
    return torch.load(path, weights_only=True)["model"]


def test_sigterm_on_one_rank_stops_both_and_resume_matches(corpus, tmp_path):
    argv = ["pretrain", "--dataroot", corpus, "--datasets", "songs", "--mesh", "2x1x1",
            "--batch_size", "2", "--epochs", "3"] + TINY
    assert _job(tmp_path / "ref", argv) == [0, 0]
    assert _job(tmp_path / "run", argv, sigterm_rank=1) == [75, 75]
    meta = json.loads((tmp_path / "run/result/pretrain/pianobart/meta.json").read_text())
    assert meta["last_step"] == 1 and meta["safety"]["epoch"] == 1
    assert _job(tmp_path / "run", argv + ["--resume"]) == [0, 0]
    assert _epochs(tmp_path / "ref") == _epochs(tmp_path / "run") == [1, 2, 3]
    want, got = _weights(tmp_path / "ref", 3), _weights(tmp_path / "run", 3)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


def test_torch_distributed_run_with_the_ring(corpus, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "pianobart_tpu_torch.cli", "pretrain",
         "--dataroot", corpus, "--datasets", "songs", "--mesh", "1x1x2",
         "--batch_size", "2", "--epochs", "1"] + TINY,
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("of mesh 1x1x2") == 2
    save = tmp_path / "result" / "pretrain" / "pianobart"
    assert (save / "best" / "state.pt").exists()
    events = [json.loads(l) for l in (save / "metrics.jsonl").read_text().splitlines()]
    epochs = [e for e in events if e["event"] == "epoch"]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train"]["loss"])
