"""The port's finetune models and steps against the JAX package's.

* The heads (attention pooling, the sequence and token MLPs, the
  excitation gate) and both classifiers' logits on the same weights
  (rtol 1e-5).
* One train step of each finetune (composer, and composer with the L2 term
  and a weighted tail; velocity; melody with a weighted tail; the
  generation finetune in both decoder modes, the second with a weighted
  tail; the ablation with a weighted tail) from the same
  weights at dropout 0 (the heads' fixed 0.1 set to 0 on both sides): the
  loss (rtol 1e-5), every gradient before the clip (rtol 1e-4), the step's
  metrics, and each parameter's AdamW update (atol 0.1 * lr, as
  ``tests/test_torch_train.py``); then an eval step against JAX's, which
  leaves the parameters, the optimizer and the model's train/eval mode as
  it found them.
* The ablation's encoder ids, decoder ids and loss span bit-equal to
  JAX's ``_ablation_prepare``.

f32 on both sides, JAX at ``highest`` matmul precision (tests/conftest.py),
the torch side on the CPU.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu import vocab as JV
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import SequenceClassification as JaxSeq
from pianobart_tpu.models import TokenClassification as JaxTok
from pianobart_tpu.models import heads as jheads
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train import finetune as jft
from pianobart_tpu.train import generation as jgen
from pianobart_tpu.train.state import create_train_state as jax_create_train_state
from pianobart_tpu_torch.compat.from_jax import lm_state_dict_from_jax
from pianobart_tpu_torch.models import (PianoBartLM, SequenceClassification,
                                        TokenClassification, tiny_config)
from pianobart_tpu_torch.models import heads
from pianobart_tpu_torch.train import finetune as ft
from pianobart_tpu_torch.train import generation as gen
from pianobart_tpu_torch.train import state as state_mod
from pianobart_tpu_torch.train.state import create_train_state
from tests.test_torch_train import make_batch

torch.set_num_threads(2)
LR = 1e-4
B, S = 3, 32
# an FFN width of this file's own: the JAX steps are jitted per config, and a
# step traced elsewhere in the process with its heads' dropout on must not
# be reused here
LAYERS = dict(encoder_layers=1, decoder_layers=1, ffn_dim=96)
_FlaxDropout = fnn.Dropout


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _batch(rng, pad_from=(32, 20, 9)):
    """Octuple windows whose sample i is padded from row ``pad_from[i]``."""
    x = make_batch(rng, B, S)
    for i, p in enumerate(pad_from):
        x[i, p:] = JV.PAD
    return x.astype(np.int64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_heads_match_jax(dtype):
    """Pooling (no pad mask, softmax over the sequence in f32), the two
    MLPs in eval mode, the gate: the same outputs from the same weights.
    bf16 compute keeps the pooling's layers in f32, as flax promotes them
    (rtol 1e-5 in f32, 2e-2 in bf16)."""
    jdt, dt = {"f32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else dict(rtol=2e-2, atol=2e-2)
    jcfg, cfg = jax_tiny_config(dtype=jdt), tiny_config(dtype=dt)
    h = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    cases = [(jheads.SequenceClassifierHead(jcfg, 5),
              heads.SequenceClassifierHead(cfg, 5)),
             (jheads.TokenClassifierHead(jcfg, 5), heads.TokenClassifierHead(cfg, 5)),
             (jheads.AttentionPooling(), heads.AttentionPooling(cfg.d_model)),
             (jheads.Excitation(), heads.Excitation(cfg.d_model))]
    for jmod, mod in cases:
        jh = jnp.asarray(h, jdt)
        params = jmod.init(key, jh)["params"]
        mod.load_state_dict(lm_state_dict_from_jax(params, jcfg))
        want = np.asarray(jmod.apply({"params": params}, jh), np.float32)
        got = mod.eval()(_t(h).to(dt))
        assert got.dtype == (torch.float32 if isinstance(mod, heads.Excitation)
                             else dt)
        np.testing.assert_allclose(got.float().detach().numpy(), want, **tol,
                                   err_msg=type(mod).__name__)


def _models(kind, C=4):
    """(JAX module, sample args, port model, JAX config) of ``kind``."""
    velocity = kind == "velocity"
    jcfg = jax_tiny_config(**LAYERS, decoder_label_vocab=C + 1 if velocity else None)
    cfg = tiny_config(**LAYERS, decoder_label_vocab=C + 1 if velocity else None)
    ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
    if kind.startswith("seq"):
        return JaxSeq(jcfg, C), (ids, ones), SequenceClassification(cfg, C, device="cpu"), jcfg
    if kind.startswith(("velocity", "melody")):
        dec = jnp.zeros((1, S), jnp.int32) if velocity else ids
        return (JaxTok(jcfg, C + 1), (ids, dec, ones, ones),
                TokenClassification(cfg, C + 1, device="cpu"), jcfg)
    return JaxLM(jcfg), (ids, ids, ones, ones), PianoBartLM(cfg, device="cpu"), jcfg


@pytest.mark.parametrize("kind", ["seq", "velocity", "melody"])
def test_classifier_logits_match_jax(kind):
    """Both classifiers in eval mode (the sequence classifier's decoder fed
    the encoder's ids and mask; velocity's decoder reading label ids through
    the label embedding) on JAX's initial weights.  rtol 1e-5."""
    jmodel, sample, model, jcfg = _models(kind)
    params = jmodel.init(jax.random.PRNGKey(0), *sample)["params"]
    model.load_state_dict(lm_state_dict_from_jax(params, jcfg))
    rng = np.random.default_rng(2)
    x = _batch(rng)
    attn = (x[..., 0] != JV.PAD[0]).astype(np.float32)
    if kind == "seq":
        args = (x, attn)
    else:
        dec = rng.integers(0, 5, (B, S)) if kind == "velocity" else x
        args = (x, dec, attn, attn)
    want = jmodel.apply({"params": params}, *map(jnp.asarray, args))
    got = model.eval()(*map(_t, args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# kind: (JAX step, port step, keyword arguments of both, labels, weight)
STEPS = {
    "seq": (jft.finetune_seq_step, ft.finetune_seq_step, {}, "class", None),
    "seq_reg_tail": (jft.finetune_seq_step, ft.finetune_seq_step,
                     {"reg_weight": 1e-3}, "class", [1, 1, 0]),
    "velocity": (jft.finetune_token_step, ft.finetune_token_step,
                 {"velocity": True}, "token", None),
    "melody_tail": (jft.finetune_token_step, ft.finetune_token_step, {}, "token",
                    [1, 0, 1]),
    "gen_intro": (jgen.generation_step, gen.generation_step,
                  {"decoder_mode": "intro"}, "octuple", None),
    "gen_shifted_tail": (jgen.generation_step, gen.generation_step,
                         {"decoder_mode": "shifted"}, "octuple", [1, 1, 0]),
    "ablation_tail": (jgen.ablation_step, gen.ablation_step, {}, None, [0, 1, 1]),
}


@pytest.mark.parametrize("kind", list(STEPS))
def test_steps_match_jax(kind, monkeypatch):
    jstep, pstep, kw, labels, weight = STEPS[kind]
    # the heads' dropout (0.1, fixed in both packages) off on both sides
    monkeypatch.setattr(fnn, "Dropout", lambda rate, **kw: _FlaxDropout(0.0, **kw))
    monkeypatch.setattr(heads, "HEAD_DROPOUT", 0.0)
    jmodel, sample, model, jcfg = _models(kind)
    jstate = jax_create_train_state(jmodel, jcfg, jax.random.PRNGKey(0), sample,
                                    learning_rate=LR)
    # off the zero biases of the init: JAX's L2 term has a NaN gradient at
    # an all-zero parameter (test_l2_penalty_at_a_zero_parameter)
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    noise = np.random.default_rng(9)
    jstate = jstate.replace(params=jax.tree_util.tree_unflatten(tree, [
        p + 0.01 * noise.standard_normal(p.shape).astype(np.float32) for p in leaves]))
    jsd = lm_state_dict_from_jax(jstate.params, jcfg)
    model.load_state_dict(jsd)
    state = create_train_state(model, LR)
    rng = np.random.default_rng(5)
    x = _batch(rng)
    y = {"class": rng.integers(0, 4, (B,)), "token": rng.integers(0, 5, (B, S)),
         "octuple": _batch(rng, (31, 25, 12)), None: None}[labels]
    w = None if weight is None else np.asarray(weight, np.float32)
    key = jax.random.PRNGKey(3)

    def jcall(st, train):
        jw = None if w is None else jnp.asarray(w)
        if jstep is jgen.ablation_step:
            return jstep(st, jnp.asarray(x), key, jcfg, train=train, weight=jw)
        return jstep(st, jnp.asarray(x), jnp.asarray(y), key, jcfg, train=train,
                     weight=jw, **kw)

    def pcall(train):
        pw = None if w is None else _t(w)
        if pstep is gen.ablation_step:
            return pstep(state, _t(x), torch.Generator(), train=train, weight=pw)
        return pstep(state, _t(x), _t(y), torch.Generator(), train=train,
                     weight=pw, **kw)

    # the JAX gradients before the clip
    if kind.startswith("seq"):
        loss_fn = functools.partial(jft._seq_loss, apply_fn=jstate.apply_fn,
                                    x=jnp.asarray(x), y=jnp.asarray(y),
                                    w=None if w is None else jnp.asarray(w),
                                    cfg=jcfg, dropout_rng=key, deterministic=False,
                                    reg_weight=kw.get("reg_weight"))
    elif labels == "token":
        loss_fn = functools.partial(jft._token_loss, apply_fn=jstate.apply_fn,
                                    x=jnp.asarray(x), y=jnp.asarray(y),
                                    w=None if w is None else jnp.asarray(w),
                                    cfg=jcfg, velocity=kw.get("velocity", False),
                                    dropout_rng=key, deterministic=False,
                                    reg_weight=None)
    elif labels == "octuple":
        loss_fn = functools.partial(jgen._gen_loss, apply_fn=jstate.apply_fn,
                                    x=jnp.asarray(x), y=jnp.asarray(y),
                                    w=None if w is None else jnp.asarray(w),
                                    cfg=jcfg, decoder_mode=kw["decoder_mode"],
                                    dropout_rng=key, deterministic=False)
    else:
        loss_fn = functools.partial(jgen._ablation_loss, apply_fn=jstate.apply_fn,
                                    batch=jnp.asarray(x),
                                    w=None if w is None else jnp.asarray(w),
                                    cfg=jcfg, dropout_rng=key, deterministic=False)
    (_, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jstate.params)
    grads = {}
    real_apply = state_mod.apply_gradients

    def snapshot(st):
        grads.update({n: p.grad.clone() for n, p in st.model.named_parameters()})
        return real_apply(st)
    monkeypatch.setattr(state_mod, "apply_gradients", snapshot)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    jnew, jm = jcall(jstate, True)
    _, m = pcall(True)
    for name, g in lm_state_dict_from_jax(jgrads, jcfg).items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    for k in set(jm) - {"loss", "grad_norm"}:
        if k in ("field_loss", "field_acc"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]), err_msg=k)
    assert set(m) == set(jm)
    after, jafter = model.state_dict(), lm_state_dict_from_jax(jnew.params, jcfg)
    for name in after:
        np.testing.assert_allclose(after[name] - before[name], jafter[name] - jsd[name],
                                   rtol=0, atol=0.1 * LR, err_msg=name)

    # eval: JAX's eval metrics; the state as it was, in either mode
    for mode in (True, False):
        model.train(mode)
        params = {k: v.clone() for k, v in model.state_dict().items()}
        opt = state.optimizer.state_dict()
        moments = [(v["exp_avg"].clone(), v["step"].clone()) for v in opt["state"].values()]
        step = state.step
        _, jem = jcall(jnew, False)
        _, em = pcall(False)
        np.testing.assert_allclose(em["loss"].item(), float(jem["loss"]), rtol=1e-5)
        assert "grad_norm" not in em and "grad_norm" not in jem
        assert model.training == mode and state.step == step
        for k, v in model.state_dict().items():
            assert torch.equal(v, params[k]), k
        for (a, s), v in zip(moments, state.optimizer.state_dict()["state"].values()):
            assert torch.equal(a, v["exp_avg"]) and torch.equal(s, v["step"])


def test_ablation_prepare_bit_equal():
    """Encoder ids padded out from ``length // 2``, the ``<SOS>``-shifted
    decoder ids, and the loss span ``length//2 + 1 <= pos <= length`` (the
    reference's 1-indexing kept), on lengths 0, 1, odd, even and full."""
    x = make_batch(np.random.default_rng(4), 5, S).astype(np.int64)
    for i, length in enumerate((0, 1, 7, 16, S)):
        x[i, length:] = JV.PAD
    got = gen._ablation_prepare(_t(x))
    want = jgen._ablation_prepare(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_l2_penalty_at_a_zero_parameter():
    """The L2 term sums the unsquared norms of every parameter in f32 (the
    reference's ``finetune.py:241-243``), with the value of JAX's.  At an
    all-zero parameter (every bias at init) its gradient is 0, as the
    reference's ``torch.norm`` gives; JAX's ``jnp.linalg.norm`` gives NaN
    there, so a JAX finetune with ``--weight`` steps into NaN."""
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) - 2,
              "b": np.zeros(3, np.float32)}
    m = torch.nn.Module()
    for k, v in params.items():
        m.register_parameter(k, torch.nn.Parameter(_t(v)))
    got = ft._l2_penalty(m)
    want, jgrad = jax.value_and_grad(jft._l2_penalty)(
        {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    np.testing.assert_allclose(m.w.grad.numpy(), np.asarray(jgrad["w"]), rtol=1e-6)
    assert torch.equal(m.b.grad, torch.zeros(3))
    assert np.isnan(np.asarray(jgrad["b"])).all()
