"""The port's pretrain path against the JAX package's: objective pieces, the
clip, the FLOP count, and the slice as a whole (two AdamW steps of a
flash-eligible model, fed the JAX corruption of each step), plus the port's
own step end to end on the CPU.

f32 on both sides, JAX at ``highest`` matmul precision (tests/conftest.py),
TF32 off on the torch side (CPU).  Each test states its tolerance.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pianobart_tpu import vocab as JV
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.ops.noise import corrupt_batch as jax_corrupt_batch
from pianobart_tpu.train import objective as jobj
from pianobart_tpu.train.pretrain import _forward_loss as jax_forward_loss
from pianobart_tpu.train.pretrain import batch_iterator as jax_batch_iterator
from pianobart_tpu.train.pretrain import pretrain_step as jax_pretrain_step
from pianobart_tpu.train.state import clip_by_global_norm_logged as jax_clip
from pianobart_tpu.train.state import create_train_state as jax_create_train_state
from pianobart_tpu.utils.flops import pretrain_step_flops as jax_flops
from pianobart_tpu_torch import vocab as V
from pianobart_tpu_torch.compat.from_jax import init_lm, lm_state_dict_from_jax
from pianobart_tpu_torch.models import PianoBartLM, tiny_config
from pianobart_tpu_torch.ops import flash as port_flash
from pianobart_tpu_torch.train import objective as obj
from pianobart_tpu_torch.train.pretrain import (_forward_loss, _update,
                                                batch_iterator,
                                                pretrain_eval_step,
                                                pretrain_multi_step,
                                                pretrain_step)
from pianobart_tpu_torch.train.state import (clip_by_global_norm_logged,
                                             create_train_state, get_grad_norm)
from pianobart_tpu_torch.utils.flops import (PEAK_BF16_H100, matmul_param_count,
                                             pretrain_step_flops, roofline_ms)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _unported_kernel_bounds():
    """``kernel_bounds.py``, the script beside chip_smoke.py, loaded by path."""
    spec = importlib.util.spec_from_file_location("kernel_bounds",
                                                  ROOT / "kernel_bounds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.unported_kernel_bounds()

LR = 2e-5


def make_batch(rng, B, S):
    """Clean pretrain windows: random content ids, bars ascending, EOS last."""
    x = np.zeros((B, S, 8), dtype=np.int32)
    for f in range(8):
        x[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    x[..., 0] = np.sort(x[..., 0], axis=1)
    x[:, -1] = V.EOS
    return x


@pytest.mark.parametrize("kind", ["full", "partial", "rows", "empty"])
def test_masked_field_ce_and_accuracy_match_jax(kind):
    """Loss, per-field losses and accuracies; ``rows`` is a (B, S) mask,
    ``empty`` hits the guard (every field 0).  Tolerance 1e-5 (f32 log-softmax
    summation order)."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    rng = np.random.default_rng(1)
    B, S = 2, 16
    logits = rng.standard_normal((B, S, cfg.total_vocab)).astype(np.float32)
    targets = make_batch(rng, B, S)
    mask = {"full": np.ones((B, S, 8)),
            "partial": (rng.random((B, S, 8)) < 0.3),
            "rows": (rng.random((B, S)) < 0.3),
            "empty": np.zeros((B, S, 8))}[kind].astype(np.float32)
    total, per = obj.masked_field_ce(torch.from_numpy(logits),
                                     torch.from_numpy(targets),
                                     torch.from_numpy(mask), cfg)
    jtotal, jper = jobj.masked_field_ce(jnp.asarray(logits), jnp.asarray(targets),
                                        jnp.asarray(mask), jcfg)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-5, atol=1e-6)
    acc = obj.masked_field_accuracy(torch.from_numpy(logits),
                                    torch.from_numpy(targets),
                                    torch.from_numpy(mask), cfg)
    jacc = jobj.masked_field_accuracy(jnp.asarray(logits), jnp.asarray(targets),
                                      jnp.asarray(mask), jcfg)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-6)
    np.testing.assert_allclose(obj.weighted_average_accuracy(acc, cfg).item(),
                               float(jobj.weighted_average_accuracy(jacc, jcfg)),
                               rtol=1e-6)
    if kind == "empty":
        assert total.item() == 0.0 and not per.any()


def test_shift_right_matches_jax():
    ids = np.arange(2 * 4 * 8).reshape(2, 4, 8)
    got = obj.shift_right(torch.from_numpy(ids), V.SOS)
    want = jobj.shift_right(jnp.asarray(ids), jnp.asarray(JV.SOS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [0.05, 5.0])
def test_clip_matches_optax_both_sides_of_the_limit(scale):
    """Global norm below 3.0 (untouched) and above (scaled to 3.0), against
    ``clip_by_global_norm_logged``; the returned norm is the pre-clip one.
    Tolerance 1e-6 relative (f32 sums in another order)."""
    rng = np.random.default_rng(2)
    shapes = [(16, 8), (8,), (3, 5, 7)]
    grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    params = [torch.zeros(s, requires_grad=True) for s in shapes]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_logged(params, 3.0)
    tx = jax_clip(3.0)
    jgrads = [jnp.asarray(g) for g in grads]
    clipped, jstate = tx.update(jgrads, tx.init(jgrads))
    np.testing.assert_allclose(norm.item(), float(jstate.grad_norm), rtol=1e-6)
    assert (norm.item() < 3.0) == (scale < 1.0)
    for p, c in zip(params, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6,
                                   atol=1e-7)


def test_flops_match_jax():
    """Same parameter count entering products and same model/hardware FLOPs
    as the JAX count over the same model's parameters."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    ids = jnp.zeros((1, jcfg.max_len, 8), jnp.int32)
    # unboxed as the train state holds them (boxed leaves hide their names)
    params = nn.meta.unbox(JaxLM(jcfg).init(jax.random.PRNGKey(0), ids, ids))
    sd = PianoBartLM(cfg, device="cpu").state_dict()
    assert pretrain_step_flops(sd, cfg, 4, 32) == jax_flops(params, jcfg, 4, 32)
    assert matmul_param_count(sd) < sum(t.numel() for t in sd.values())


def test_roofline_bound_takes_the_slower_side():
    """The bound is the larger of operations over the peak and bytes over
    HBM's rate, and says which.  Of the TPU kernels only L1 and L2 are left
    to port; each is K1's forward at B=32, S=1024: 2 products of 2*S*S*D
    FLOPs per (b, h), bound by operations (~0.139 ms)."""
    assert roofline_ms(PEAK_BF16_H100 * 1e-3, 1.0) == (1.0, "operations")
    ms, by = roofline_ms(1.0, 3.35e12 * 2e-3)
    assert by == "bytes" and abs(ms - 2.0) < 1e-12
    bounds = _unported_kernel_bounds()
    assert set(bounds) == {"L1", "L2"}
    assert bounds["L1"] == bounds["L2"] and bounds["L1"][2] == "operations"
    assert abs(bounds["L1"][1] - 1e3 * 4 * 1024**2 * 128 * 32 * 8
               / PEAK_BF16_H100) < 1e-9


def _two_steps_vs_jax(monkeypatch, B=2, S=256, dropout=0.0, **port_kw):
    """Two steps of JAX's ``pretrain_step`` and the port's, from the same
    weights, each fed JAX's corruption of the step (see
    :func:`test_pretrain_steps_match_jax` for what is checked).  ``port_kw``
    goes to the port's config only; the port's dropout draws from an
    explicit CPU generator."""
    monkeypatch.setenv("PBX_FLASH_INTERPRET", "1")
    kw = dict(d_model=256, num_heads=2, max_len=S, encoder_layers=1,
              decoder_layers=1, ffn_dim=256, use_flash_attention=True,
              dropout=dropout)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw, **port_kw)
    batch = make_batch(np.random.default_rng(0), B, S)
    ids, ones = jnp.zeros((B, S, 8), jnp.int32), jnp.ones((B, S))
    jstate = jax_create_train_state(JaxLM(jcfg), jcfg, jax.random.PRNGKey(0),
                                    (ids, ids, ones, ones), learning_rate=LR)
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(jstate.params, jcfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jbefore = lm_state_dict_from_jax(jstate.params, jcfg)
    state = create_train_state(model, LR)
    gen = torch.Generator().manual_seed(3)
    key = jax.random.PRNGKey(7)
    grad_fn = jax.jit(lambda p, c, m: jax.value_and_grad(
        jax_forward_loss, has_aux=True)(p, jstate.apply_fn, jnp.asarray(batch), c,
                                        m, jcfg, jax.random.PRNGKey(1), False))
    xb = torch.from_numpy(batch.astype(np.int64))
    for t in range(2):
        rng_corrupt, _ = jax.random.split(jax.random.fold_in(key, t))
        corrupted, loss_mask = jax_corrupt_batch(rng_corrupt, jnp.asarray(batch), 0.15)
        _, jgrads = grad_fn(jstate.params, corrupted, loss_mask)
        jstate, jm = jax_pretrain_step(jstate, jnp.asarray(batch), key, jcfg, 0.15)
        pc = torch.from_numpy(np.asarray(corrupted).astype(np.int64))
        pm = torch.from_numpy(np.array(loss_mask))
        state.optimizer.zero_grad(set_to_none=True)
        total, _ = _forward_loss(model, xb, pc, pm, gen)
        total.backward()
        for name, g in lm_state_dict_from_jax(jgrads, jcfg).items():
            np.testing.assert_allclose(dict(model.named_parameters())[name].grad,
                                       g, rtol=1e-4, atol=1e-7, err_msg=name)
        m = _update(state, xb, pc, pm, gen)
        assert set(m) == {"loss", "field_loss", "field_acc", "weighted_acc",
                          "grad_norm", "tokens"}
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["field_loss"].numpy(),
                                   np.asarray(jm["field_loss"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["field_acc"].numpy(), np.asarray(jm["field_acc"]))
    assert state.step == 2 and int(jstate.step) == 2
    after, jafter = model.state_dict(), lm_state_dict_from_jax(jstate.params, jcfg)
    for name in after:
        np.testing.assert_allclose(after[name] - before[name],
                                   jafter[name] - jbefore[name], rtol=0,
                                   atol=0.1 * LR, err_msg=name)


def test_pretrain_steps_match_jax(monkeypatch):
    """The slice as a whole.  A flash-eligible config (d_model 256, 2 heads
    of 128, 1+1 layers, FFN 256, S=256, B=2, f32, dropout 0): JAX runs its
    Pallas kernels in interpret mode, the port its flash Function (plain
    forward and backward on CPU).  Each step, JAX's ``corrupt_batch`` output
    from the key ``pretrain_step`` derives feeds the port's step.  Checked
    per step: loss and per-field loss (rtol 1e-5), every gradient against
    ``jax.grad`` of JAX's ``_forward_loss`` (|d| <= 1e-7 + 1e-4*|g|: f32
    summation order; some gradients, such as the key projection's bias, to
    which the softmax is invariant, are zero up to round-off), and the
    pre-clip grad norm (rtol 1e-5).  After two AdamW steps (lr 2e-5) every
    parameter's update agrees to 0.1 lr: Adam scales each element's step to
    about lr, and for gradients that are round-off, g/(|g| + eps) depends on
    that round-off."""
    _two_steps_vs_jax(monkeypatch)


def test_fused_tail_steps_match_jax(monkeypatch):
    """The fused-tail path: the same two steps with ``fused_dropout_ln`` on
    the port, so every sublayer tail (2 in the encoder layer, 3 in the
    decoder layer) runs the autograd Function of K4 (its plain versions on
    the CPU), against JAX's unfused tail (its fused gate needs a TPU).

    Both sides train at dropout 1e-9.  The uint8 dropouts of both packages
    then keep every element (threshold round(1e-9 * 256) = 0, scale 1), and
    K4 drops an element with probability 4 / 2^32 (threshold round(1e-9 *
    2^32) = 4; its keep scale rounds to 1.0 in f32).  The tails see 5 sites
    x 2 * 256 * 256 elements per forward, four forwards in all (the
    gradient check and the update of each of two steps, 2,621,440
    elements): a drop somewhere has probability 2.4e-3, and with these fixed
    seeds no element drops.  Same tolerances as the unfused test."""
    import pianobart_tpu_torch.models.bart as bart
    calls = []
    real = bart.dropout_add_ln
    monkeypatch.setattr(bart, "dropout_add_ln",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _two_steps_vs_jax(monkeypatch, dropout=1e-9, fused_dropout_ln=True)
    assert len(calls) == 5 * 4   # 5 tails per forward, 4 forwards


def test_long_context_steps_match_jax(monkeypatch):
    """The long-context path: the same two steps at S=2048, B=1 (the
    positions table is (2050, 256)).  There JAX's ``_bwd_impl`` takes the
    two-kernel backward ``_dq_call`` + ``_dkv_call`` (interpret mode) and the
    port's backward its K3a and K3b plain versions.  Same tolerances."""
    calls = []
    for name in ("flash_attention_dq", "flash_attention_dkv",
                 "flash_attention_bwd_reference"):
        real = getattr(port_flash, name)
        monkeypatch.setattr(port_flash, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    _two_steps_vs_jax(monkeypatch, B=1, S=2048)
    # 3 attentions per backward, 4 backwards (gradient check + update, x2)
    assert calls.count("flash_attention_dq") == calls.count("flash_attention_dkv") == 12
    assert "flash_attention_bwd_reference" not in calls


@pytest.fixture
def tiny_state():
    cfg = tiny_config(dropout=0.1)
    model = init_lm(cfg, seed=0, device="cpu", train=True)
    return cfg, create_train_state(model, learning_rate=1e-3)


def test_port_pretrain_step_end_to_end(tiny_state):
    """The port's own step on the CPU, dropout on: finite loss, the step
    counted, every metric present, parameters moved, the generator the only
    source of randomness (same seed, same loss)."""
    cfg, state = tiny_state
    B, S = 4, cfg.max_len
    batch = torch.from_numpy(make_batch(np.random.default_rng(3), B, S)).long()
    w0 = state.model.lm_head.proj.weight.detach().clone()
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_snapshot = state.optimizer.state_dict()
    state, m = pretrain_step(state, batch, torch.Generator().manual_seed(5))
    assert set(m) == {"loss", "field_loss", "field_acc", "weighted_acc",
                      "grad_norm", "tokens"}
    assert torch.isfinite(m["loss"]) and m["field_loss"].shape == (8,)
    assert m["field_acc"].shape == (8,) and 0.0 <= m["weighted_acc"].item() <= 1.0
    assert m["tokens"].item() == B * S and state.step == 1
    assert get_grad_norm(state) is m["grad_norm"] and m["grad_norm"].item() > 0
    assert not torch.equal(state.model.lm_head.proj.weight, w0)
    # replay from the same weights and seed: the same loss
    state.model.load_state_dict(snapshot)
    state.optimizer.load_state_dict(opt_snapshot)
    _, m2 = pretrain_step(state, batch, torch.Generator().manual_seed(5))
    assert m2["loss"].item() == m["loss"].item()
    state.model.load_state_dict(snapshot)
    _, m3 = pretrain_step(state, batch, torch.Generator().manual_seed(6))
    assert m3["loss"].item() != m["loss"].item()


def test_port_pretrain_multi_step(tiny_state):
    """K steps with one batch per step or one batch reused: per-step loss,
    accuracies and grad norms come back on the host, all finite."""
    cfg, state = tiny_state
    rng = np.random.default_rng(4)
    g = torch.Generator().manual_seed(0)
    per_step = torch.from_numpy(np.stack([make_batch(rng, 2, cfg.max_len)
                                          for _ in range(3)])).long()
    state, (losses, accs, norms) = pretrain_multi_step(state, per_step, g, n_steps=3)
    assert losses.shape == (3,) and accs.shape == (3, 8) and norms.shape == (3,)
    assert losses.device.type == "cpu" and torch.isfinite(losses).all()
    state, (losses, _, _) = pretrain_multi_step(state, per_step[0], g, n_steps=2)
    assert losses.shape == (2,) and state.step == 5
    with pytest.raises(ValueError):
        pretrain_multi_step(state, per_step, g, n_steps=2)


def test_batch_iterator_matches_jax():
    data = np.arange(10 * 4 * 8).reshape(10, 4, 8)
    for shuffle in (False, True):
        got = list(batch_iterator(data, 4, np.random.default_rng(0), shuffle=shuffle,
                                  drop_last=False))
        want = list(jax_batch_iterator(data, 4, np.random.default_rng(0),
                                       shuffle=shuffle, drop_last=False))
        assert len(got) == len(want) == 3
        for (b, w), (jb, jw) in zip(got, want):
            np.testing.assert_array_equal(b, jb)
            np.testing.assert_array_equal(w, jw)
    b, w = got[-1]
    assert b.shape == (4, 4, 8)
    np.testing.assert_array_equal(w, [1, 1, 0, 0])
    assert len(list(batch_iterator(data, 4, np.random.default_rng(0)))) == 2


def test_eval_step_sample_weight(tiny_state):
    """Weight-0 samples do not reach the loss: replacing their content leaves
    it unchanged; all-zero weights give 0.  The model's mode is restored."""
    cfg, state = tiny_state
    rng = np.random.default_rng(5)
    batch = make_batch(rng, 4, cfg.max_len)
    other = batch.copy()
    other[2:] = make_batch(rng, 2, cfg.max_len)
    half = torch.tensor([1.0, 1.0, 0.0, 0.0])

    def ev(x, w):
        return pretrain_eval_step(state, torch.from_numpy(x).long(),
                                  torch.Generator().manual_seed(0), w)

    m1, m2 = ev(batch, half), ev(other, half)
    assert state.model.training
    assert torch.isfinite(m1["loss"]) and m1["loss"].item() == m2["loss"].item()
    assert ev(batch, torch.ones(4))["loss"].item() != m1["loss"].item()
    assert ev(batch, torch.zeros(4))["loss"].item() == 0.0
