"""The port's SupervisedRunner against the JAX package's, and its resume.

* Both runners driven by the same deterministic step function write the
  same ``metrics.jsonl`` events (train, valid and test metrics, the eval
  hook's means, the score, the best flags), the same epoch lines, the same
  ``meta.json`` history and ``test_outputs.npy``: a tied score refreshes
  ``best/`` (``>=``), more than ``patience`` epochs without a better one
  end the run with ``early_stop``; tail batches are padded at sample
  weight 0, so every sample counts once.  Step values are exact in f32 and
  every mean is over a power of two of batches, so the means agree
  exactly (see tests/test_torch_runner.py).
* On a tiny real classifier on the CPU (dropout 0.1, accumulation 2, EMA,
  cosine schedule) a run preempted between epochs and resumed ends
  bit-equal to an uninterrupted one, and validation runs on the EMA shadow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train import runner as jrunner
from pianobart_tpu_torch.compat.from_jax import init_model
from pianobart_tpu_torch.vocab import PAD
from pianobart_tpu_torch.models import SequenceClassification, tiny_config
from pianobart_tpu_torch.train.finetune import finetune_seq_step
from pianobart_tpu_torch.train.runner import SupervisedRunner
from pianobart_tpu_torch.train.state import create_train_state
from pianobart_tpu_torch.utils.preemption import Preempted, PreemptionGuard
from tests.test_torch_checkpoint import _jax_state
from tests.test_torch_runner import _events, _lines
from tests.test_torch_train import make_batch

torch.set_num_threads(2)

# valid accuracy per epoch: best, best, a tie (best again), then down
VALID_ACC = [0.25, 0.5, 0.5, 0.375, 0.25, 0.125, 0.125, 0.125]
N_TRAIN_BATCHES = 4


def _fake_step(to_array, advance, select):
    """A step whose metrics are exact f32 values derived from the batch,
    the weight and the step count: accuracy counts for ``scalar_acc``,
    field accuracies and greedy outputs for ``weighted_field_acc``."""
    def step(state, x, y, rng, train=True, weight=None):
        xs = np.asarray(x)
        w = np.ones(len(xs), np.float32) if weight is None else np.asarray(weight)
        s = int(xs[..., 0].sum())
        if train:
            acc = float((s % 8) / 8)
            m = {"loss": np.float32((s % 64) / 16 + 0.25),
                 "grad_norm": np.float32((s % 32) / 4)}
            state = advance(state)
        else:
            acc = VALID_ACC[int(state.step) // N_TRAIN_BATCHES - 1]
            m = {"loss": np.float32((s % 32) / 8 * float(w.mean()))}
        if select == "scalar_acc":
            m.update(acc_num=np.float32(acc * w.sum()), acc_den=np.float32(w.sum()),
                     pred=xs[:, 0, 0].astype(np.int64))
        else:
            fa = np.full(8, acc, np.float32)
            fa[s % 8] += 0.125
            m.update(field_acc=fa, outputs=xs.astype(np.int32),
                     attn_dec=np.ones(xs.shape[:2], np.float32))
        return state, {k: to_array(v) for k, v in m.items()}
    return step


def _hook(x, y, m):
    """Sees the real samples of an eval batch only."""
    return {"n": float(len(x)), "first": float(np.asarray(m["outputs"])[:, 0, 1].sum())}


@pytest.mark.parametrize("select", ["scalar_acc", "weighted_field_acc"])
def test_events_match_jax_runner(tmp_path, select):
    """8 train samples (4 batches of 2), 7 valid (the last of 4 batches
    padded), 3 test (2 batches, the last padded), patience 2, a logged
    schedule: events, lines, history, best step and test outputs agree;
    the run stops early after epoch 6."""
    rng = np.random.default_rng(0)
    S = 8
    X = [rng.integers(0, 50, (n, S, 8)).astype(np.int64) for n in (8, 7, 3)]
    Y = [rng.integers(0, 4, (n,)).astype(np.int64) for n in (8, 7, 3)]
    data = (*X, *Y)
    lr_fn = lambda step: 1e-3 / (1 + step)
    hook = _hook if select == "weighted_field_acc" else None

    def jadvance(st):
        return st.replace(step=st.step + 1)

    def padvance(st):
        st.step += 1
        return st

    kw = dict(batch_size=2, patience=2, seed=5, select=select, lr_fn=lr_fn,
              eval_hook=hook)
    jr = jrunner.SupervisedRunner(_jax_state(), jax_tiny_config(),
                                  _fake_step(jnp.asarray, jadvance, select), data,
                                  str(tmp_path / "j"), **kw)
    state = create_train_state(init_model(SequenceClassification, tiny_config(),
                                          device="cpu", class_num=4))
    pr = SupervisedRunner(state, tiny_config(),
                          _fake_step(torch.as_tensor, padvance, select), data,
                          str(tmp_path / "p"), **kw)
    jr.run(8)
    pr.run(8)
    got, want = (_events(tmp_path / "p" / "metrics.jsonl"),
                 _events(tmp_path / "j" / "metrics.jsonl"))
    assert got == want
    assert [e["best"] for e in got if e["event"] == "epoch"] == [
        True, True, True, False, False, False]
    assert got[-1] == {"event": "early_stop", "epoch": 6, "patience": 2}
    if hook is not None:
        assert got[0]["valid"]["n"] == 7 / 4 and got[0]["test"]["n"] == 3 / 2
    assert _lines(tmp_path / "p" / "log") == _lines(tmp_path / "j" / "log")
    assert pr.ckpt.meta()["history"] == jr.ckpt.meta()["history"]
    assert pr.ckpt.meta()["best_step"] == jr.ckpt.meta()["best_step"] == 3
    out = np.load(tmp_path / "p" / "test_outputs.npy")
    np.testing.assert_array_equal(out, np.load(tmp_path / "j" / "test_outputs.npy"))
    assert len(out) == 3


def _real_runner(save_dir, data, guard=None):
    cfg = tiny_config(encoder_layers=1, decoder_layers=1, dropout=0.1)
    model = init_model(SequenceClassification, cfg, seed=0, device="cpu",
                       train=True, class_num=3)
    state = create_train_state(model, 1e-3, accum_steps=2, ema_decay=0.9,
                               schedule="cosine", warmup_steps=1, decay_steps=8)
    return SupervisedRunner(state, cfg, finetune_seq_step, data, str(save_dir),
                            batch_size=2, patience=5, seed=3, preempt=guard)


@pytest.fixture
def data():
    rng = np.random.default_rng(1)
    X = [make_batch(rng, n, 32).astype(np.int64) for n in (5, 3, 2)]
    Y = [rng.integers(0, 3, (n,)).astype(np.int64) for n in (5, 3, 2)]
    return (*X, *Y)


def test_preempted_between_epochs_and_resumed_matches_uninterrupted(tmp_path, data):
    """3 epochs of 3 batches (the last padded at weight 0), accumulation
    windows of 2 straddling the epochs.  The guard is set while epoch 1's
    test split runs: the safety slot is saved at the top of epoch 2 and the
    run raises; ``run(3, resume=True)`` from the same initial weights ends
    with parameters, EMA shadow, history and test outputs bit-equal to a
    run never interrupted."""
    ref = _real_runner(tmp_path / "ref", data)
    ref.run(3)
    guard = PreemptionGuard()
    first = _real_runner(tmp_path / "run", data, guard)
    real_eval = first._eval_epoch

    def flag_after_test(X, y, collect_outputs=False):
        out = real_eval(X, y, collect_outputs)
        if collect_outputs:
            guard.requested = True
        return out

    first._eval_epoch = flag_after_test
    with pytest.raises(Preempted, match="epoch 2"):
        first.run(3)
    assert first.ckpt.meta()["safety"] == {"epoch": 1, "opt_step": 3}
    second = _real_runner(tmp_path / "run", data)
    second.run(3, resume=True)
    for a, b in zip(ref.state.model.parameters(), second.state.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(ref.state.ema, second.state.ema):
        assert torch.equal(a, b)
    assert second.state.step == ref.state.step == 9
    assert second.ckpt.meta()["history"] == ref.ckpt.meta()["history"]
    np.testing.assert_array_equal(np.load(tmp_path / "run" / "test_outputs.npy"),
                                  np.load(tmp_path / "ref" / "test_outputs.npy"))


def test_eval_uses_the_ema_shadow_and_keeps_the_state(tmp_path, data):
    """Validation runs on the EMA shadow (its loss is the shadow model's),
    and leaves the training parameters, the step and the train mode."""
    run = _real_runner(tmp_path, data)
    run.run(1)
    params = [p.clone() for p in run.state.model.parameters()]
    step = run.state.step
    run.state.model.train()
    va = run._eval_epoch(run.X_val, run.y_val)
    assert run.state.model.training and run.state.step == step
    assert all(torch.equal(a, b) for a, b in zip(params, run.state.model.parameters()))
    shadow = init_model(SequenceClassification, run.cfg, device="cpu", class_num=3)
    with torch.no_grad():
        for p, e in zip(shadow.parameters(), run.state.ema):
            p.copy_(e)
    x = torch.as_tensor(run.X_val)
    y = torch.as_tensor(run.y_val)
    mask = (x[..., 0] != PAD[0]).float()
    with torch.no_grad():
        logits = shadow.eval()(x, mask)
        assert not torch.equal(logits, run.state.model.eval()(x, mask))
    from pianobart_tpu_torch.train.objective import sequence_ce
    w = torch.tensor([1.0, 1.0])
    want = (sequence_ce(logits[:2], y[:2], w).item()
            + sequence_ce(torch.cat([logits[2:], logits[2:]]), torch.cat([y[2:], y[2:]]),
                          torch.tensor([1.0, 0.0])).item()) / 2
    np.testing.assert_allclose(va["loss"], want, rtol=1e-5)
