"""The port's mesh train and eval steps (``train/pretrain_sp.py``) against
the JAX package's, and ``remat``.

JAX runs ``make_sp_pretrain_step`` on conftest's virtual CPU devices at
2x1x2 (ring attention over sp) and 1x2x2 (TP∘SP), with SGD(lr=1) so that
its gradients are ``params - new params`` (as ``tests/test_sp_train.py``
reads them), ``make_sp_eval_step`` at 2x1x2 with a zero-weighted tail row,
and ``jax.grad`` of the dense loss.  Four ranks are spawned over gloo on the
CPU (``parallel/launch.py``); each carries JAX's weights
(``compat/from_jax.py``) and takes JAX's corruption of the step through
``step.update`` / ``eval_step.evaluate``.  Tolerances as
``tests/test_sp_train.py``: loss rel 2e-5, gradients rtol 2e-4 / atol 2e-5,
eval accuracies rtol 1e-5 / atol 1e-6.  Dropout 0 in the comparisons; the
remat checks run at dropout 0.1.

JAX is imported inside the fixture: the spawned ranks import this module
and need torch only.
"""
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.parallel.launch import spawn

S, B = 128, 4
TINY = dict(max_len=S, d_model=128, num_heads=2, emb_size=16, dropout=0.0,
            encoder_layers=1, decoder_layers=1)


def _batch():
    from pianobart_tpu_torch import vocab as V
    rng = np.random.default_rng(2023)
    batch = np.zeros((B, S, 8), dtype=np.int32)
    for f in range(8):
        batch[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    return batch


def _mesh_cfg(base, shape):
    dp, tp, sp = shape
    if tp > 1:
        return base.replace(ring_axis="sp", ring_tp_axis="tp", ring_tp_size=tp)
    return base.replace(ring_axis="sp") if sp > 1 else base


def _flat_grads(model):
    """Every gradient, flattened in the order of the parameters' names."""
    grads = dict((n, p.grad) for n, p in model.named_parameters())
    return torch.cat([grads[n].reshape(-1) for n in sorted(grads)]).numpy()


def _sp_worker(rank, world, d):
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    from pianobart_tpu_torch.train.pretrain_sp import (make_sp_eval_step,
                                                       make_sp_pretrain_step)
    from pianobart_tpu_torch.train.state import TrainState
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    base = inp["cfg"]
    batch = torch.from_numpy(inp["batch"]).long()
    res = {}

    def model_for(cfg):
        model = PianoBartLM(cfg, device="cpu").train()
        model.load_state_dict(inp["sd"])
        # SGD(lr=1) after a clip that never scales: .grad keeps the
        # all-reduced gradients
        return TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0),
                          clip_norm=float("inf"))

    for shape in ((2, 1, 2), (1, 2, 2), (2, 1, 1), (1, 2, 1)):
        mesh = make_mesh(*shape)
        if mesh is None:       # 2x1x1 and 1x2x1 run on ranks 0 and 1
            continue
        cfg = _mesh_cfg(base, shape)
        state = model_for(cfg)
        step = make_sp_pretrain_step(cfg, mesh)
        c, m = (torch.from_numpy(x) for x in inp["train_corruption"])
        metrics = step.update(state, batch, c.long(), m, torch.Generator().manual_seed(0))
        res[shape] = (metrics["loss"].item(), _flat_grads(state.model))
    mesh = make_mesh(2, 1, 2)
    cfg = _mesh_cfg(base, (2, 1, 2))
    c, m = (torch.from_numpy(x) for x in inp["eval_corruption"])
    ev = make_sp_eval_step(cfg, mesh).evaluate(model_for(cfg), batch, c.long(), m)
    res["eval"] = {k: v.numpy() for k, v in ev.items()}
    # remat: the same step at dropout 0.1 from one seed, three ways
    for what in ("plain", "remat", "remat_ffn"):
        rcfg = cfg.replace(dropout=0.1, activation_dropout=0.1,
                           remat=what == "remat", remat_ffn=what == "remat_ffn")
        state = TrainState(init_lm(rcfg, seed=1, device="cpu", train=True),
                           torch.optim.SGD([torch.zeros(1)], lr=0.0))
        step = make_sp_pretrain_step(rcfg, mesh)
        _, metrics = step(state, batch, torch.Generator().manual_seed(5))
        res[what] = (metrics["loss"].item(), _flat_grads(state.model))
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps in the parent, then the four ranks; returns JAX's
    results and each rank's."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as nn
    from pianobart_tpu import vocab as JV
    from pianobart_tpu.models import PianoBartLM, tiny_config
    from pianobart_tpu.ops.noise import corrupt_batch
    from pianobart_tpu.parallel.mesh import make_mesh
    from pianobart_tpu.train.objective import masked_field_ce, shift_right
    from pianobart_tpu.train.pretrain_sp import make_sp_eval_step, make_sp_pretrain_step
    from pianobart_tpu.train.state import TrainState
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax

    d = tmp_path_factory.mktemp("sp_train")
    base = tiny_config(**TINY)
    batch = jnp.asarray(_batch())
    key, ekey = jax.random.PRNGKey(3), jax.random.PRNGKey(11)
    ids, ones = jnp.zeros((2, S, 8), jnp.int32), jnp.ones((2, S))
    params = nn.meta.unbox(PianoBartLM(base).init(key, ids, ids, ones, ones))["params"]
    def flat(tree):
        sd = lm_state_dict_from_jax(tree, base)
        return np.concatenate([sd[n].numpy().ravel() for n in sorted(sd)])
    want = {}
    for shape in ((2, 1, 2), (1, 2, 2)):
        mesh = make_mesh(*shape, devices=jax.devices()[:4])
        cfg = _mesh_cfg(base, shape)
        st = TrainState.create(apply_fn=None, params=jax.tree.map(jnp.copy, params),
                               tx=optax.sgd(1.0))
        st, m = make_sp_pretrain_step(cfg, mesh, 0.15)(st, batch, key)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params, st.params)
        want[shape] = (float(m["loss"]), flat(grads))
    # the corruption those steps drew (step 0), and the dense loss on it
    rngc, _ = jax.random.split(jax.random.fold_in(key, 0))
    corrupted, loss_mask = corrupt_batch(rngc, batch, 0.15)
    dec = shift_right(batch, jnp.asarray(JV.SOS, jnp.int32))
    enc_mask = (corrupted[..., 0] != JV.PAD[0]).astype(jnp.float32)
    dec_mask = (dec[..., 0] != JV.PAD[0]).astype(jnp.float32)

    def dense_loss(p):
        fused = PianoBartLM(base).apply({"params": p}, corrupted, dec, enc_mask,
                                        dec_mask, True)
        return masked_field_ce(fused, batch, loss_mask, base)[0]

    loss, grads = jax.jit(jax.value_and_grad(dense_loss))(params)
    want[2, 1, 1] = want[1, 2, 1] = (float(loss), flat(grads))
    weight = jnp.asarray([1.0, 1.0, 1.0, 0.0])
    st = TrainState.create(apply_fn=None, params=params, tx=optax.sgd(1.0))
    want["eval"] = make_sp_eval_step(_mesh_cfg(base, (2, 1, 2)),
                                     make_mesh(2, 1, 2, devices=jax.devices()[:4]),
                                     0.15)(st, batch, ekey, weight)
    ec, em = corrupt_batch(jax.random.split(ekey)[0], batch, 0.15)
    torch.save({"cfg": config_from_jax(base), "batch": np.asarray(batch),
                "sd": lm_state_dict_from_jax(params, base),
                "train_corruption": (np.array(corrupted), np.array(loss_mask)),
                "eval_corruption": (np.array(ec), np.array(em * weight[:, None, None]))},
               d / "inputs.pt")
    spawn(_sp_worker, 4, (str(d),), threads=1)
    return want, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)]


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (2, 1, 1), (1, 2, 1)],
                         ids=["sp_2x1x2", "tp_sp_1x2x2", "dp_2x1x1", "tp_1x2x1"])
def test_mesh_step_matches_jax(runs, shape):
    """Loss and the all-reduced gradients of one step on every rank of the
    mesh against JAX's sp step (2x1x2, 1x2x2) or dense step (2x1x1; and
    1x2x1, the tp heads on a ring of one, where JAX's CLI takes its dense
    GSPMD step) on the same weights and corruption."""
    want, ranks = runs
    wloss, wgrads = want[shape]
    n = 4 if shape[2] == 2 else 2
    for res in ranks[:n]:
        loss, grads = res[shape]
        assert loss == pytest.approx(wloss, rel=2e-5)
        np.testing.assert_allclose(grads, wgrads, rtol=2e-4, atol=2e-5)
    for res in ranks[n:]:
        assert shape not in res


def test_mesh_eval_step_matches_jax(runs):
    """The eval twin at 2x1x2 with one zero-weighted tail row."""
    want, ranks = runs
    w = want["eval"]
    for res in ranks:
        got = res["eval"]
        assert float(got["loss"]) == pytest.approx(float(w["loss"]), rel=2e-5)
        np.testing.assert_allclose(got["field_acc"], np.asarray(w["field_acc"]),
                                   rtol=1e-5, atol=1e-6)
        assert float(got["weighted_acc"]) == pytest.approx(float(w["weighted_acc"]),
                                                           rel=1e-5)


@pytest.mark.parametrize("what", ["remat", "remat_ffn"])
def test_remat_on_the_ring_equals_the_plain_step(runs, what):
    """At dropout 0.1 from one seed, the ring step with every layer (or
    every FFN) recomputed gives the plain step's loss and gradients, bit for
    bit: the recompute replays the dropout bits and the ring's rotations."""
    _, ranks = runs
    for res in ranks:
        assert res[what][0] == res["plain"][0]
        np.testing.assert_array_equal(res[what][1], res["plain"][1])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_tail"])
@pytest.mark.parametrize("what", ["remat", "remat_ffn"])
def test_remat_grads_equal_the_plain_ones(what, fused):
    """One process, no mesh: a training forward and backward at dropout 0.1
    (and activation dropout 0.1; with the fused tail, K4's plain versions and
    their per-site seeds) with ``remat`` or ``remat_ffn`` gives the plain
    model's loss and gradients bit for bit, and the recomputed modules ran
    twice."""
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import tiny_config
    from pianobart_tpu_torch.ops.noise import corrupt_batch
    from pianobart_tpu_torch.train.pretrain import _forward_loss
    cfg = tiny_config(d_model=128, num_heads=2, dropout=0.1, activation_dropout=0.1,
                      encoder_layers=2, decoder_layers=2, fused_dropout_ln=fused)
    batch = torch.from_numpy(_batch()[:2, :32]).long()
    out = []
    for c in (cfg, cfg.replace(**{what: True})):
        model = init_lm(c, seed=0, device="cpu", train=True)
        calls = []
        for mod in (model.pianobart.encoder.layers[0], model.pianobart.decoder.layers[1].ffn):
            real = mod.forward
            mod.forward = lambda *a, _r=real, _m=mod, **k: calls.append(_m) or _r(*a, **k)
        gen = torch.Generator().manual_seed(9)
        corrupted, mask = corrupt_batch(batch, gen)
        loss, _ = _forward_loss(model, batch, corrupted, mask, gen)
        loss.backward()
        out.append((loss.item(), _flat_grads(model), len(calls)))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    # forward once each; remat recomputes the layer (its FFN inside it), or
    # remat_ffn the FFN alone
    assert out[0][2] == 2 and out[1][2] == (4 if what == "remat" else 3)


def _flagship_worker(rank, world, d):
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    from pianobart_tpu_torch.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu_torch.train.state import TrainState
    inp = torch.load(os.path.join(d, "flagship.pt"), weights_only=False)
    cfg = _mesh_cfg(inp["cfg"], (1, 1, 2))
    model = PianoBartLM(cfg, device="cpu").train()
    model.load_state_dict(inp["sd"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0),
                       clip_norm=float("inf"))
    c, m = (torch.from_numpy(x) for x in inp["corruption"])
    metrics = make_sp_pretrain_step(cfg, make_mesh(1, 1, 2)).update(
        state, torch.from_numpy(inp["batch"]).long(), c.long(), m,
        torch.Generator().manual_seed(0))
    torch.save((metrics["loss"].item(), _flat_grads(model)),
               os.path.join(d, f"flagship{rank}.pt"))


@pytest.mark.slow
def test_flagship_width_ring_step_matches_jax(tmp_path):
    """The flagship's widths (d_model 1024, 8 heads of 128, FFN 2048,
    embeddings 256) at one layer a side, S=512 over a 1x1x2 ring (shards of
    256 rows, the kernels' shape), B=2: loss and gradients against JAX's
    ``make_sp_pretrain_step``, the tolerances above."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import linen as nn
    from pianobart_tpu.models import PianoBartConfig, PianoBartLM
    from pianobart_tpu.ops.noise import corrupt_batch
    from pianobart_tpu.parallel.mesh import make_mesh
    from pianobart_tpu.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu.train.state import TrainState
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax
    base = PianoBartConfig(encoder_layers=1, decoder_layers=1, max_len=512, dropout=0.0)
    batch = jnp.asarray(_batch()[:2, :64].repeat(8, axis=1))
    key = jax.random.PRNGKey(4)
    ids, ones = jnp.zeros((2, 512, 8), jnp.int32), jnp.ones((2, 512))
    params = nn.meta.unbox(PianoBartLM(base).init(key, ids, ids, ones, ones))["params"]
    st = TrainState.create(apply_fn=None, params=jax.tree.map(jnp.copy, params),
                           tx=optax.sgd(1.0))
    st, m = make_sp_pretrain_step(_mesh_cfg(base, (1, 1, 2)),
                                  make_mesh(1, 1, 2, devices=jax.devices()[:2]),
                                  0.15)(st, batch, key)
    grads = lm_state_dict_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                                params, st.params), base)
    corrupted, loss_mask = corrupt_batch(jax.random.split(jax.random.fold_in(key, 0))[0],
                                         batch, 0.15)
    torch.save({"cfg": config_from_jax(base), "batch": np.asarray(batch),
                "sd": lm_state_dict_from_jax(params, base),
                "corruption": (np.array(corrupted), np.array(loss_mask))},
               tmp_path / "flagship.pt")
    spawn(_flagship_worker, 2, (str(tmp_path),), threads=2)
    want = np.concatenate([grads[n].numpy().ravel() for n in sorted(grads)])
    for r in range(2):
        loss, got = torch.load(tmp_path / f"flagship{r}.pt", weights_only=False)
        assert loss == pytest.approx(float(m["loss"]), rel=2e-5)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
