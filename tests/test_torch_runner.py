"""The port's PretrainRunner against the JAX package's, and its resume.

* Both runners driven by the same deterministic ``train_step_fn`` and
  ``eval_step_fn`` write the same ``metrics.jsonl`` events (``t`` and
  tokens/s aside), the same best flags and early stop, and the same epoch
  lines.  The step values are exact in f32 and each mean is over 4 values,
  so every mean is exact on both sides (XLA's f32 mean multiplies by 1/n,
  torch's divides by n: over 3 values they can part by an ulp).
* On a tiny real model on the CPU, a run preempted through
  ``guard.requested`` between epochs and resumed ends with parameters,
  EMA shadow and history bit-equal to an uninterrupted run's, with gradient
  accumulation windows that straddle the epochs; a run preempted mid-epoch
  restarts that epoch and logs each epoch once.
* Validation corruption: distinct per batch, identical across epochs.
* The zero-steps warning.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train import runner as jrunner
from pianobart_tpu_torch.compat.from_jax import init_lm
from pianobart_tpu_torch.models import tiny_config
from pianobart_tpu_torch.train.runner import PretrainRunner
from pianobart_tpu_torch.train.state import create_train_state
from pianobart_tpu_torch.utils.preemption import Preempted, PreemptionGuard
from tests.test_torch_checkpoint import _jax_state
from tests.test_torch_train import make_batch

torch.set_num_threads(2)

# valid accuracy per epoch: up, best at epoch 3, then down (patience 2)
VALID_ACC = [0.25, 0.5, 0.625, 0.5, 0.375, 0.25, 0.125]


def _fake_steps(to_array, advance, n_batches):
    """Train and eval step functions whose metrics are exact f32 values
    derived from the batch and the step count."""
    def train_step(state, batch, rng):
        s = int(np.asarray(batch)[..., 0].sum())
        m = {"loss": np.float32((s % 64) / 16 + 0.25),
             "field_acc": ((np.arange(8) + s) % 8 / 8).astype(np.float32),
             "grad_norm": np.float32((s % 32) / 4)}
        return advance(state), {k: to_array(v) for k, v in m.items()}

    def eval_step(state, batch, rng, w):
        s = int(np.asarray(batch)[..., 0].sum())
        epoch = int(state.step) // n_batches - 1
        acc = np.full(8, VALID_ACC[epoch], np.float32)
        acc[s % 8] += 0.125
        m = {"loss": np.float32((s % 32) / 8 * float(np.asarray(w).mean())),
             "field_acc": acc}
        return {k: to_array(v) for k, v in m.items()}

    return train_step, eval_step


def _events(path):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("t")
            rec.get("train", {}).pop("tokens_per_sec", None)
            out.append(rec)
    return out


def _lines(path):
    with open(path) as f:
        return [re.sub(r"(tok/s=|is )[0-9.]+", r"\1#", line) for line in f]


def test_events_match_jax_runner(tmp_path):
    """9 windows at batch 2 (4 steps an epoch, the 9th window dropped) in
    dispatches of 3 and 1, 7 validation windows (4 batches, the last padded
    at weight 0), patience 2, a logged schedule: the same events, best
    flags, ``early_stop`` and epoch lines from both runners, and the same
    ``meta.json`` history."""
    rng = np.random.default_rng(0)
    S = 8
    train = rng.integers(0, 50, (9, S, 8)).astype(np.int64)
    valid = rng.integers(0, 50, (7, S, 8)).astype(np.int64)
    lr_fn = lambda step: 1e-3 / (1 + step)

    def jadvance(st):
        return st.replace(step=st.step + 1)

    def padvance(st):
        st.step += 1
        return st

    jt, je = _fake_steps(jnp.asarray, jadvance, 4)
    pt, pe = _fake_steps(torch.as_tensor, padvance, 4)
    kw = dict(batch_size=2, patience=2, seed=5, steps_per_dispatch=3, lr_fn=lr_fn)
    jr = jrunner.PretrainRunner(_jax_state(), jax_tiny_config(), train, valid,
                                str(tmp_path / "j"), train_step_fn=jt,
                                eval_step_fn=je, **kw)
    state = create_train_state(init_lm(tiny_config(), device="cpu"))
    pr = PretrainRunner(state, tiny_config(), train, valid, str(tmp_path / "p"),
                        train_step_fn=pt, eval_step_fn=pe, **kw)
    jr.run(7)
    pr.run(7)
    got, want = _events(tmp_path / "p" / "metrics.jsonl"), _events(tmp_path / "j" / "metrics.jsonl")
    assert got == want
    assert [e["best"] for e in got if e["event"] == "epoch"] == [True, True, True,
                                                                 False, False]
    assert got[-1] == {"event": "early_stop", "epoch": 5, "patience": 2}
    assert _lines(tmp_path / "p" / "log") == _lines(tmp_path / "j" / "log")
    assert pr.ckpt.meta()["history"] == jr.ckpt.meta()["history"]
    assert pr.ckpt.meta()["best_step"] == jr.ckpt.meta()["best_step"] == 3


def _real_runner(save_dir, data, guard=None, **kw):
    cfg = tiny_config(encoder_layers=1, decoder_layers=1, dropout=0.1)
    state = create_train_state(init_lm(cfg, seed=0, device="cpu", train=True), 1e-3,
                               accum_steps=2, ema_decay=0.9, schedule="cosine",
                               warmup_steps=1, decay_steps=8)
    train, valid = data
    return PretrainRunner(state, cfg, train, valid, str(save_dir), batch_size=2,
                          seed=3, steps_per_dispatch=2, preempt=guard, **kw)


@pytest.fixture
def data():
    rng = np.random.default_rng(1)
    return make_batch(rng, 6, 32).astype(np.int64), make_batch(rng, 3, 32).astype(np.int64)


def _epochs(save_dir):
    return [e["epoch"] for e in _events(save_dir / "metrics.jsonl")
            if e["event"] == "epoch"]


def test_preempted_between_epochs_and_resumed_matches_uninterrupted(tmp_path, data):
    """3 epochs of 3 batches, accumulation windows of 2 (epoch 1 ends half a
    window in), EMA, cosine schedule, dropout 0.1.  The guard is set while
    epoch 1 validates: the run saves the safety slot at the top of epoch 2
    and raises; ``run(3, resume=True)`` on a fresh runner from the same
    initial weights finishes bit-equal to a run never interrupted."""
    ref = _real_runner(tmp_path / "ref", data)
    ref.run(3)

    guard = PreemptionGuard()
    first = _real_runner(tmp_path / "run", data, guard)
    valid_epoch = first.valid_epoch

    def flag_after_validation():
        out = valid_epoch()
        guard.requested = True
        return out

    first.valid_epoch = flag_after_validation
    with pytest.raises(Preempted, match="epoch 2"):
        first.run(3)
    meta = first.ckpt.meta()
    assert meta["safety"] == {"epoch": 1, "opt_step": 3} and meta["last_step"] == 1
    second = _real_runner(tmp_path / "run", data)
    second.run(3, resume=True)
    for a, b in zip(ref.state.model.parameters(), second.state.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(ref.state.ema, second.state.ema):
        assert torch.equal(a, b)
    assert second.state.step == ref.state.step == 9
    assert second.ckpt.meta()["history"] == ref.ckpt.meta()["history"]
    assert "safety" not in second.ckpt.meta()
    assert _epochs(tmp_path / "run") == _epochs(tmp_path / "ref") == [1, 2, 3]


def test_preempted_mid_epoch_restarts_the_epoch(tmp_path, data):
    """The guard set after epoch 2's first dispatch: a safety save every
    dispatch, exit after the dispatch, ``safety`` names epoch index 1; the
    resumed run restarts epoch 2 from the safety state and logs each epoch
    once."""
    guard = PreemptionGuard()
    run = _real_runner(tmp_path, data, guard, checkpoint_every_dispatches=1)
    echo = run.logger.step_echo

    def flag(step, metrics, every=50):
        echo(step, metrics, every)
        if run._cur_epoch == 1:
            guard.requested = True

    run.logger.step_echo = flag
    with pytest.raises(Preempted):
        run.run(3)
    assert run.ckpt.meta()["safety"] == {"epoch": 1, "opt_step": 5}
    resumed = _real_runner(tmp_path, data)
    resumed.run(3, resume=True)
    meta = resumed.ckpt.meta()
    assert [h["step"] for h in meta["history"]] == [1, 2, 3] and "safety" not in meta
    assert _epochs(tmp_path) == [1, 2, 3]
    assert resumed.state.step == 5 + 6


def test_valid_corruption_distinct_per_batch_same_across_epochs(tmp_path):
    """Identical windows in every validation batch: the batches' corruption
    (and so their accuracies) differ, and a second validation pass repeats
    the first exactly."""
    rng = np.random.default_rng(2)
    window = make_batch(rng, 1, 32).astype(np.int64)
    valid = np.repeat(window, 8, axis=0)
    run = _real_runner(tmp_path, (valid, valid))
    seeds = []
    real_eval = run.eval_step_fn

    def record(state, batch, gen, w):
        seeds.append(gen.initial_seed())
        from pianobart_tpu_torch.train.pretrain import pretrain_eval_step
        return pretrain_eval_step(state, batch, gen, w)

    assert real_eval is None
    run.eval_step_fn = record
    first, second = run.valid_epoch(), run.valid_epoch()
    assert len(set(seeds[:4])) == 4 and seeds[:4] == seeds[4:]
    assert first["loss"] == second["loss"]
    np.testing.assert_array_equal(first["field_acc"], second["field_acc"])
    run.eval_step_fn = None
    third = run.valid_epoch()
    assert third["loss"] == first["loss"]


def test_zero_steps_warning_matches_jax(tmp_path, capsys):
    """Fewer windows than the batch size: the JAX runner's warning, word for
    word, and an epoch of 0 steps."""
    rng = np.random.default_rng(3)
    train = rng.integers(0, 50, (3, 8, 8)).astype(np.int64)
    _, je = _fake_steps(jnp.asarray, lambda s: s, 1)
    _, pe = _fake_steps(torch.as_tensor, lambda s: s, 1)
    jr = jrunner.PretrainRunner(_jax_state(), jax_tiny_config(), train, train,
                                str(tmp_path / "j"), batch_size=4, eval_step_fn=je)
    pr = PretrainRunner(create_train_state(init_lm(tiny_config(), device="cpu")),
                        tiny_config(), train, train, str(tmp_path / "p"),
                        batch_size=4, eval_step_fn=pe)
    capsys.readouterr()
    assert jr.train_epoch()["steps"] == 0
    want = capsys.readouterr().err
    assert pr.train_epoch()["steps"] == 0
    got = capsys.readouterr().err
    assert got == want and got.startswith("WARNING: 0 train steps this epoch")
