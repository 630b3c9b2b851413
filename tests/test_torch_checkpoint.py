"""The port's CheckpointManager against the JAX package's: one sequence of
epoch saves, safety saves and restores through both gives the same
``meta.json`` and keeps the same directories; the port's payload round trip
is bit-exact (model, AdamW moments and counts, EMA shadow, a partial
accumulation window); ``restore_params`` from a root and from a payload
directory; an empty directory raises; a pretrain checkpoint grafted onto a
classifier."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train import state as jst
from pianobart_tpu_torch.compat.from_jax import init_lm
from pianobart_tpu_torch.models import tiny_config
from pianobart_tpu_torch.train.pretrain import pretrain_step
from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
from tests.test_torch_train import make_batch

torch.set_num_threads(2)
CFG = dict(encoder_layers=1, decoder_layers=1)


def _jax_state():
    cfg = jax_tiny_config(**CFG)
    ids, ones = jnp.zeros((1, cfg.max_len, 8), jnp.int32), jnp.ones((1, cfg.max_len))
    params = nn.meta.unbox(JaxLM(cfg).init(jax.random.PRNGKey(0), ids, ids, ones,
                                           ones))["params"]
    return jst.TrainState.create(apply_fn=None, params=params,
                                 tx=jst.make_optimizer(1e-3))


def _metrics(i):
    acc = np.linspace(0.1, 0.8, 8, dtype=np.float32) * i / 10
    return {"weighted_acc": float(acc.mean()), "loss": 5.0 - i,
            "field_acc": acc}


# (kind, epoch-or-step, is_best, opt step): the runner's calls over a run
# with a safety save every dispatch, a preemption, and a resume
SEQUENCE = [("save", 1, True, 3), ("safety", 1, None, 5), ("save", 2, False, 6),
            ("save", 3, True, 9), ("safety", 3, None, 10), ("restore",),
            ("save", 4, False, 12), ("save", 5, False, 15), ("save", 6, True, 18),
            ("safety", 6, None, 19)]


def test_meta_and_kept_directories_match_jax(tmp_path):
    """The same calls through both managers (max_to_keep 3): equal
    ``meta.json`` after every call, the same entries in the directory, the
    same ``restore`` epochs (the pending safety slot first, then the last
    step, the best step, a named step)."""
    jstate = _jax_state()
    state = create_train_state(init_lm(tiny_config(**CFG), seed=0, device="cpu"), 1e-3)
    jm, pm = (jst.CheckpointManager(str(tmp_path / "j")),
              CheckpointManager(str(tmp_path / "p")))
    for call in SEQUENCE:
        if call[0] == "restore":
            _, j_epoch = jm.restore(jstate)
            _, p_epoch = pm.restore(state)
            assert p_epoch == j_epoch == 3
            continue
        kind, n, best, opt_step = call
        jstate = jstate.replace(step=opt_step)
        state.step = opt_step
        if kind == "save":
            jm.save(n, jstate, _metrics(n), is_best=best)
            pm.save(n, state, _metrics(n), is_best=best)
        else:
            jm.save_safety(jstate, n)
            pm.save_safety(state, n)
        assert pm.meta() == jm.meta(), call
        with open(tmp_path / "p" / "meta.json") as f, open(tmp_path / "j" / "meta.json") as g:
            assert json.load(f) == json.load(g)
        assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == ["best", "meta.json", "safety",
                                                  "step_4", "step_5", "step_6"]
    for kw, want in (({}, 6), ({"best": True}, 6), ({"step": 4}, 4)):
        if not kw:
            # the pending safety slot wins
            assert pm.restore(state)[1] == jm.restore(jstate)[1] == 6
            continue
        assert pm.restore(state, **kw)[1] == jm.restore(jstate, **kw)[1] == want


def _trained_state(seed, accum_steps=2, ema_decay=0.9, steps=3):
    cfg = tiny_config(**CFG, dropout=0.1)
    state = create_train_state(init_lm(cfg, seed=seed, device="cpu", train=True),
                               1e-3, accum_steps=accum_steps, ema_decay=ema_decay,
                               schedule="cosine", warmup_steps=1, decay_steps=8)
    batch = torch.from_numpy(make_batch(np.random.default_rng(seed), 2,
                                        cfg.max_len)).long()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        pretrain_step(state, batch, gen)
    return state, batch


def _flat_optimizer(opt):
    sd = opt.state_dict()
    return {(i, k): v for i, s in sd["state"].items() for k, v in s.items()}


def test_round_trip_is_bit_exact_mid_accumulation(tmp_path):
    """Saved 3 micro-steps into accumulation windows of 2 (one real update
    and half a window), restored into a state built from other weights: the
    model, every AdamW tensor, the shadow, the half window's gradients, the
    counts and the last norm come back bit for bit, and the next micro-steps
    of both states give bit-equal parameters."""
    state, batch = _trained_state(0)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save_safety(state, epoch=0)
    other, _ = _trained_state(1, steps=0)
    restored, epoch = mgr.restore(other)
    assert restored is other and epoch == 0 and other.step == state.step == 3
    for (k, a), b in zip(state.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k
    got, want = _flat_optimizer(other.optimizer), _flat_optimizer(state.optimizer)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(state.ema, other.ema):
        assert torch.equal(a, b)
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        assert p.grad is not None and torch.equal(p.grad, q.grad)
    assert torch.equal(state.grad_norm, other.grad_norm)
    # the optimizer still updates the model's own parameters
    assert all(p is q for p, q in zip(other.optimizer.param_groups[0]["params"],
                                      other.model.parameters()))
    for st in (state, other):
        gen = torch.Generator().manual_seed(5)
        for _ in range(3):
            pretrain_step(st, batch, gen)
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(state.ema, other.ema):
        assert torch.equal(a, b)
    assert not os.path.exists(tmp_path / "c" / "safety.tmp")


def test_restore_params_from_root_and_payload_dir(tmp_path):
    """Weights only, from a manager root (best, or the last step without
    ``best``) or a payload directory; the JAX manager resolves the same
    paths; an empty or missing checkpoint raises ``FileNotFoundError`` in
    both."""
    cfg = tiny_config(**CFG)
    mgr = CheckpointManager(str(tmp_path / "c"))
    saved = {}
    for step, seed in ((1, 3), (2, 4)):
        st = create_train_state(init_lm(cfg, seed=seed, device="cpu"))
        mgr.save(step, st, {"weighted_acc": 0.1 * (2 - step)}, is_best=step == 1)
        saved[step] = {k: v.clone() for k, v in st.model.state_dict().items()}
    for where, best, want in ((tmp_path / "c", True, 1), (tmp_path / "c", False, 2),
                              (tmp_path / "c" / "step_2", True, 2),
                              (tmp_path / "c" / "best", True, 1)):
        model = init_lm(cfg, seed=9, device="cpu")
        assert CheckpointManager(str(where)).restore_params(model, best=best) is model
        for k, v in model.state_dict().items():
            assert torch.equal(v, saved[want][k]), (where, k)
    for mgr_cls in (CheckpointManager, jst.CheckpointManager):
        with pytest.raises(FileNotFoundError, match="no checkpoint found"):
            mgr_cls(str(tmp_path / "empty"))._payload_path(True)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        CheckpointManager(str(tmp_path / "empty")).restore_params(init_lm(cfg, device="cpu"))
    bigger = init_lm(tiny_config(**CFG, d_model=128), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        CheckpointManager(str(tmp_path / "c")).restore_params(bigger)


def test_restore_params_grafts_a_trunk_into_a_classifier(tmp_path):
    """A pretrain checkpoint (trunk and LM head) onto a drawn classifier:
    the trunk is the checkpoint's, the head keeps its draw, the checkpoint's
    LM head is ignored; a model with no name in common raises, and one whose
    shared names differ in shape raises "size mismatch"."""
    from pianobart_tpu_torch.compat.from_jax import init_model
    from pianobart_tpu_torch.models import SequenceClassification
    cfg = tiny_config(**CFG)
    st = create_train_state(init_lm(cfg, seed=3, device="cpu"))
    CheckpointManager(str(tmp_path / "c")).save(1, st, {"weighted_acc": 0.1}, True)
    saved = st.model.state_dict()
    model = init_model(SequenceClassification, cfg, seed=4, device="cpu", class_num=3)
    drawn = {k: v.clone() for k, v in model.state_dict().items()}
    assert CheckpointManager(str(tmp_path / "c")).restore_params(model) is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k] if k.startswith("pianobart.") else drawn[k]), k
    with pytest.raises(ValueError, match="matches a parameter"):
        CheckpointManager(str(tmp_path / "c")).restore_params(torch.nn.Linear(2, 2))
    wider = init_model(SequenceClassification, tiny_config(**CFG, d_model=128),
                       device="cpu", class_num=3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        CheckpointManager(str(tmp_path / "c")).restore_params(wider)


def test_gc_sweeps_stale_tmp_and_keeps_best(tmp_path):
    """The ``*.tmp`` and ``*.old`` directories left by a killed save are
    swept at the next epoch save; the best step outlives ``max_to_keep``; ``best/`` shares the
    step's file, never rewritten in place."""
    state = create_train_state(init_lm(tiny_config(**CFG), device="cpu"))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    os.makedirs(tmp_path / "step_9.tmp")
    os.makedirs(tmp_path / "step_8.old")
    for step in range(1, 5):
        mgr.save(step, state, {"weighted_acc": 0.5 if step == 1 else 0.1},
                 is_best=step == 1)
    assert sorted(os.listdir(tmp_path)) == ["best", "meta.json", "step_1",
                                            "step_3", "step_4"]
    assert (tmp_path / "best" / "state.pt").read_bytes() == \
        (tmp_path / "step_1" / "state.pt").read_bytes()


def test_save_killed_while_removing_the_old_slot_leaves_a_whole_payload(
        tmp_path, monkeypatch):
    """The old slot is renamed aside before the new one takes its name, so a
    save killed while it removes the old slot (a second SIGTERM) leaves the
    new payload at ``safety/`` for ``--resume``; the next save sweeps the
    ``safety.old`` it left."""
    from pianobart_tpu_torch.train import state as st_mod
    state, _ = _trained_state(0)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save_safety(state, epoch=0)
    rmtree = st_mod.shutil.rmtree

    def killed(path, *a, **kw):
        if str(path).endswith("safety.old") and os.path.exists(path):
            raise KeyboardInterrupt
        return rmtree(path, *a, **kw)

    monkeypatch.setattr(st_mod.shutil, "rmtree", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save_safety(state, epoch=0)
    monkeypatch.setattr(st_mod.shutil, "rmtree", rmtree)
    assert os.path.exists(tmp_path / "c" / "safety" / "state.pt")
    assert os.path.exists(tmp_path / "c" / "safety.old")
    other, _ = _trained_state(1, steps=0)
    mgr.restore(other)
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    mgr.save(1, state, {"weighted_acc": 0.5}, is_best=True)
    assert sorted(os.listdir(tmp_path / "c")) == ["best", "meta.json", "step_1"]
