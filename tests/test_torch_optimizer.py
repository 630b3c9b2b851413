"""The port's optimizer against optax: learning-rate schedules step for step,
and a tiny LM's trajectory under a schedule, gradient accumulation and a
parameter EMA against the JAX package's ``make_optimizer`` over the same
micro-batches and corruption; the EMA shadow's own storage; the hint on a
resume with changed optimizer flags.

f32 on both sides, JAX at ``highest`` matmul precision (tests/conftest.py).
Each test states its tolerance."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pianobart_tpu import cli as jcli
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.ops.noise import corrupt_batch as jax_corrupt_batch
from pianobart_tpu.train import state as jst
from pianobart_tpu.train.pretrain import pretrain_step as jax_pretrain_step
from pianobart_tpu_torch import cli
from pianobart_tpu_torch.compat.from_jax import init_lm, lm_state_dict_from_jax
from pianobart_tpu_torch.models import PianoBartLM, tiny_config
from pianobart_tpu_torch.train.pretrain import _update
from pianobart_tpu_torch.train.state import (CheckpointManager, apply_gradients,
                                             create_train_state, ema_applied,
                                             get_ema_params, make_schedule)
from tests.test_torch_train import make_batch

torch.set_num_threads(2)

SCHEDULES = [("constant", 0, None), ("constant", 7, None), ("cosine", 0, 20),
             ("cosine", 5, 20), ("linear", 0, 20), ("linear", 4, 20)]


@pytest.mark.parametrize("name,warmup,decay", SCHEDULES)
def test_schedules_match_optax(name, warmup, decay):
    """Every count from 0 past the end: the port's float64 values against
    optax's f32 ones, rtol 1e-6 with atol 1e-10 (f32 rounding at the scale
    of the peak rate 1e-3: near the end of a cosine decay optax's f32
    cosine is off by ~1e-11 on a value of ~1e-5)."""
    mine = make_schedule(1e-3, name, warmup, decay)
    ref = jst.make_schedule(1e-3, name, warmup, decay)
    if name == "constant" and warmup == 0:
        assert mine == ref == 1e-3
        return
    for n in range(0, (decay or warmup) + 6):
        np.testing.assert_allclose(mine(n), float(ref(n)), rtol=1e-6, atol=1e-10,
                                   err_msg=f"count {n}")


def test_schedule_refusals_match_jax():
    for args in (("cosine", 0, None), ("linear", 5, 5), ("nope", 0, 9)):
        with pytest.raises(ValueError) as mine:
            make_schedule(1e-3, *args)
        with pytest.raises(ValueError) as ref:
            jst.make_schedule(1e-3, *args)
        assert str(mine.value) == str(ref.value)


def test_lr_fn_matches_jax():
    """``cli._make_lr_fn`` maps micro-steps to the next real update's rate."""
    for sched, warmup, accum in (("constant", 0, 1), ("cosine", 2, 2),
                                 ("linear", 0, 3), ("constant", 3, 2)):
        args = argparse.Namespace(lr_schedule=sched, warmup_steps=warmup,
                                  decay_steps=12, accum_steps=accum)
        mine, ref = cli._make_lr_fn(args, 1e-3), jcli._make_lr_fn(args, 1e-3)
        assert (mine is None) == (ref is None)
        for step in range(0, 40) if mine else ():
            np.testing.assert_allclose(mine(step), ref(step), rtol=1e-6, atol=1e-10)


LR = 1e-3
OPT = dict(schedule="cosine", warmup_steps=1, decay_steps=4, accum_steps=2,
           ema_decay=0.9)


def test_trajectory_matches_jax_under_schedule_accumulation_and_ema():
    """A tiny LM (d_model 64, 1+1 layers, S=32, B=2, dropout 0, plain
    attention) from the same weights over 6 micro-steps (3 real updates of
    2): each micro-batch gets the corruption JAX's ``pretrain_step`` draws
    for it.  Per micro-step the loss (rtol 1e-5), the reported grad norm
    (the last real update's; rtol 1e-5) and the learning rate of the last
    real update (rtol 1e-6).  At the end every parameter and every EMA entry
    to rtol 1e-5, with atol 1e-3 lr for the few elements whose gradient is
    round-off (the embedding rows a batch barely touches: Adam's step
    g/(|g|+eps) turns its summation order into up to ~3e-4 lr)."""
    kw = dict(encoder_layers=1, decoder_layers=1)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    B, S = 2, cfg.max_len
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, B, S) for _ in range(6)]
    ids, ones = jnp.zeros((B, S, 8), jnp.int32), jnp.ones((B, S))
    jparams = nn.meta.unbox(JaxLM(jcfg).init(jax.random.PRNGKey(0), ids, ids,
                                             ones, ones))["params"]
    jstate = jst.TrainState.create(apply_fn=JaxLM(jcfg).apply, params=jparams,
                                   tx=jst.make_optimizer(LR, **OPT))
    init = lm_state_dict_from_jax(jparams, jcfg)  # the JAX step donates jparams
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(init)
    state = create_train_state(model, LR, **OPT)
    sched = jst.make_schedule(LR, "cosine", 1, 4)
    key = jax.random.PRNGKey(7)
    gen = torch.Generator().manual_seed(0)
    for t, batch in enumerate(batches):
        rng_corrupt, _ = jax.random.split(jax.random.fold_in(key, t))
        corrupted, loss_mask = jax_corrupt_batch(rng_corrupt, jnp.asarray(batch), 0.15)
        jstate, jm = jax_pretrain_step(jstate, jnp.asarray(batch), key, jcfg, 0.15)
        m = _update(state, torch.from_numpy(batch.astype(np.int64)),
                    torch.from_numpy(np.asarray(corrupted).astype(np.int64)),
                    torch.from_numpy(np.array(loss_mask)), gen)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-5)
        real = (t + 1) // 2
        if real:
            np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                                       float(sched(real - 1)), rtol=1e-6, atol=1e-12)
    assert state.step == int(jstate.step) == 6
    assert int(state.optimizer.state[model.lm_head.proj.weight]["step"]) == 3
    want = lm_state_dict_from_jax(jstate.params, jcfg)
    want_ema = lm_state_dict_from_jax(jst.get_ema_params(jstate.opt_state), jcfg)
    got_ema = get_ema_params(state)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach(), want[name], rtol=1e-5,
                                   atol=1e-3 * LR, err_msg=name)
        np.testing.assert_allclose(got_ema[name], want_ema[name], rtol=1e-5,
                                   atol=1e-3 * LR, err_msg=name)
    moved = max((got_ema[n] - init[n]).abs().max().item() for n in got_ema)
    assert moved > 1e-4


def test_micro_steps_only_count():
    """Under accumulation a micro-step moves no parameter, moment or shadow
    and reports the last real update's norm; the real update averages the
    window."""
    cfg = tiny_config()
    model = init_lm(cfg, seed=0, device="cpu", train=True)
    state = create_train_state(model, 1e-2, accum_steps=2, ema_decay=0.5)
    w = model.lm_head.proj.weight
    w.grad = torch.ones_like(w)
    before = w.detach().clone()
    assert apply_gradients(state) is False
    assert torch.equal(w, before) and state.grad_norm is None
    assert not state.optimizer.state and torch.equal(state.ema[-2], before)
    w.grad += 3 * torch.ones_like(w)   # the window's second backward
    assert apply_gradients(state) is True
    # the mean gradient is 2 per element of this one parameter
    np.testing.assert_allclose(state.grad_norm.item(), 2 * w.numel() ** 0.5,
                               rtol=1e-6)
    assert state.step == 2 and not torch.equal(w, before)


def test_ema_shadow_has_its_own_storage():
    """The shadow starts as a real copy: other storage than each parameter,
    unchanged by an in-place change to the parameter, and still apart after
    the runner's evaluation swap."""
    model = init_lm(tiny_config(), seed=0, device="cpu", train=True)
    state = create_train_state(model, 1e-3, ema_decay=0.99)
    params = list(model.parameters())
    for p, e in zip(params, state.ema):
        assert p.data_ptr() != e.data_ptr() and torch.equal(p, e)
    ref = [e.clone() for e in state.ema]
    with torch.no_grad():
        for p in params:
            p.add_(1.0)
    for e, r in zip(state.ema, ref):
        assert torch.equal(e, r)
    with ema_applied(state):
        assert torch.equal(params[0], ref[0])
    for p, e, r in zip(params, state.ema, ref):
        assert p.data_ptr() != e.data_ptr()
        assert torch.equal(e, r) and torch.equal(p, r + 1.0)
    with pytest.raises(ValueError, match="ema_decay"):
        create_train_state(model, ema_decay=1.0)
    assert get_ema_params(create_train_state(model, 1e-3)) is None


@pytest.mark.parametrize("saved,resumed", [
    (dict(accum_steps=2), dict()), (dict(), dict(ema_decay=0.9)),
    (dict(), dict(schedule="constant", warmup_steps=3))])
def test_resume_with_changed_optimizer_flags_hints(tmp_path, saved, resumed):
    """A checkpoint written under other accumulation, EMA or schedule flags
    is refused with the JAX package's hint naming the flags."""
    cfg = tiny_config()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, create_train_state(init_lm(cfg, seed=0, device="cpu"), **saved),
             {"weighted_acc": 0.5}, is_best=True)
    other = create_train_state(init_lm(cfg, seed=1, device="cpu"), **resumed)
    with pytest.raises(ValueError, match="--accum_steps/--lr_schedule") as exc:
        mgr.restore(other)
    assert "does not match this run's optimizer" in str(exc.value)
