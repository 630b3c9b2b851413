"""The port's parameter placement under tp (``parallel/mesh.py:shard_params``)
against the JAX package's ``shard_params``: which leaves are cut and on
which dim, the slices' values, one AdamW step over a sharded 1x2x2 mesh,
the storage each rank keeps, and checkpoints that stay whole.

JAX runs in the parent on conftest's virtual CPU devices: the layout and the
slices come from ``param_shardings`` / ``shard_params`` at 1x2x1 and 1x2x2
(the leaves mapped to the port's names through ``compat/from_jax.py``); the
step is ``make_sp_pretrain_step`` at 1x2x2 on a ``TrainState`` built from
``shard_params``' output with ``make_optimizer`` (AdamW after the 3.0 clip),
and again with SGD(lr=1) for its gradients (``params - new params``, as
``tests/test_torch_sp_train.py`` reads them), clipped as the clip scales
them.  Four ranks are then spawned over gloo on the CPU
(``parallel/launch.py``); each carries JAX's weights, cuts them with the
port's ``shard_params`` and takes JAX's corruption of the step through
``step.update``.

Tolerances: the loss rel 2e-5 and the gradients rtol 2e-4 / atol 2e-5, as
``tests/test_torch_sp_train.py``; the pre-clip norm rel 2e-5, as a loss;
the parameters after the step and both AdamW moments rtol 1e-5 with atol
1e-3 lr as ``tests/test_torch_optimizer.py`` (the second moment's atol
times the gradient's largest magnitude, its scale).  As there, an element
whose gradient is round-off moves by Adam's ``g / (|g| + eps)`` of that
round-off: where JAX's gradient lies within the gradient comparison's atol
of 0, its parameter is held to the 2 lr one step can move it at most.
Slices and checkpoints compare exactly.

JAX is imported inside the fixtures and tests: the spawned ranks import
this module and need torch only.
"""
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.parallel.launch import spawn

S, B = 128, 4
LR = 1e-3
TINY = dict(max_len=S, d_model=128, num_heads=2, emb_size=16, dropout=0.0,
            encoder_layers=1, decoder_layers=1)


def _batch():
    from pianobart_tpu_torch import vocab as V
    rng = np.random.default_rng(2024)
    batch = np.zeros((B, S, 8), dtype=np.int32)
    for f in range(8):
        batch[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    return batch


def _mesh_cfg(base, shape):
    dp, tp, sp = shape
    if tp > 1:
        return base.replace(ring_axis="sp", ring_tp_axis="tp", ring_tp_size=tp)
    return base.replace(ring_axis="sp") if sp > 1 else base


# ---------------------------------------------------------------------------
# The layout and the slices, without processes
# ---------------------------------------------------------------------------

def _jax_models():
    """(name, JAX model, its init arguments, the port's class and kwargs)."""
    import jax.numpy as jnp
    from pianobart_tpu import models as jm
    from pianobart_tpu_torch import models as pm
    base = jm.tiny_config(**TINY)
    ids, ones = jnp.zeros((2, S, 8), jnp.int32), jnp.ones((2, S))
    vel = base.replace(decoder_label_vocab=8)
    return [("lm", base, jm.PianoBartLM(base), (ids, ids, ones, ones), pm.PianoBartLM, {}),
            ("sequence", base, jm.SequenceClassification(base, 8), (ids, ones),
             pm.SequenceClassification, {"class_num": 8}),
            ("velocity", vel, jm.TokenClassification(vel, 8),
             (ids, jnp.zeros((2, S), jnp.int32), ones, ones),
             pm.TokenClassification, {"class_num": 8})]


def _jax_tp_dims(variables, mesh, cfg):
    """Port name -> the torch dim JAX's ``param_shardings`` puts on tp: each
    leaf replaced by its coordinates along its tp dim (-1 everywhere when
    it has none), carried through ``lm_state_dict_from_jax``'s names and
    transposes; the tp dim is the one along which the marks vary."""
    import jax
    from flax import linen as nn
    from pianobart_tpu.parallel.mesh import param_shardings
    from pianobart_tpu_torch.compat.from_jax import lm_state_dict_from_jax
    shardings = param_shardings(variables, mesh)["params"]
    unboxed = nn.meta.unbox(variables)["params"]

    def mark(leaf, sharding):
        shape = np.shape(leaf)
        dims = [i for i, a in enumerate(sharding.spec)
                if a == "tp" or (isinstance(a, tuple) and "tp" in a)]
        if not dims:
            return np.full(shape, -1.0, np.float32)
        return np.indices(shape)[dims[0]].astype(np.float32)

    marks = lm_state_dict_from_jax(jax.tree.map(mark, unboxed, shardings), cfg)
    out = {}
    for name, t in marks.items():
        a = t.numpy()
        if a.min() >= 0:
            out[name] = next(i for i in range(a.ndim) if (np.diff(a, axis=i) != 0).any())
    return out


@pytest.mark.parametrize("which", ["lm", "sequence", "velocity"])
def test_layout_matches_jax_param_shardings(which):
    """The port's ``tp_layout`` of ``PianoBartLM``, the sequence classifier
    and the velocity token classifier (its ``LabelEmbedding`` decoder input)
    names exactly the leaves JAX's ``param_shardings`` puts on tp at 1x2x1,
    with the same dims in the port's layout; the classifier heads and the
    label embedding (whose ``table`` shares a name with the octuple
    table's) stay whole."""
    import jax
    from pianobart_tpu.parallel.mesh import make_mesh
    from pianobart_tpu_torch.compat.from_jax import config_from_jax
    from pianobart_tpu_torch.parallel.mesh import tp_layout
    name, jcfg, jmodel, args, cls, kw = next(m for m in _jax_models() if m[0] == which)
    variables = jmodel.init(jax.random.PRNGKey(0), *args)
    want = _jax_tp_dims(variables, make_mesh(1, 2, 1, devices=jax.devices()[:2]), jcfg)
    model = cls(config_from_jax(jcfg), device="meta", **kw)
    got = tp_layout(model)
    assert got == want
    assert set(got) <= set(model.state_dict())
    # 4 weights an attention, 2 an FFN, the shared octuple table, the LM head
    n_attn = 4 * (jcfg.encoder_layers + 2 * jcfg.decoder_layers)
    n_ffn = 2 * (jcfg.encoder_layers + jcfg.decoder_layers)
    assert len(got) == n_attn + n_ffn + 1 + (which == "lm")
    assert not any(n.startswith("head.") or "label" in n or n.endswith(".bias")
                   for n in got)


def test_name_traps_stay_whole():
    """The squeeze-excitation gate's ``fc1``/``fc2`` and the label
    embedding's ``table`` share names with sharded leaves; matched by their
    module's class, they are not cut."""
    from pianobart_tpu_torch.models import tiny_config
    from pianobart_tpu_torch.models.embedding import LabelEmbedding
    from pianobart_tpu_torch.models.heads import Excitation
    from pianobart_tpu_torch.parallel.mesh import tp_layout
    cfg = tiny_config(decoder_label_vocab=8)
    gate = torch.nn.Module()
    gate.ffn = Excitation(64)
    gate.embed = LabelEmbedding(cfg)
    assert tp_layout(gate) == {}


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 2, 2)], ids=["1x2x1", "1x2x2"])
def test_slices_equal_jax_shards_bit_for_bit(shape):
    """Every JAX device's ``addressable_shards`` data of ``shard_params``'
    output, in the port's names and layout, equals bit for bit the port's
    pure slice (``shard_state_dict``, no processes) at that device's tp
    coordinate; the leaves JAX replicates are the whole tensor."""
    import jax
    from flax import linen as nn
    from pianobart_tpu.parallel.mesh import make_mesh, shard_params
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import shard_state_dict, tp_layout
    _, jcfg, jmodel, args, _, _ = _jax_models()[0]
    variables = jmodel.init(jax.random.PRNGKey(1), *args)
    mesh = make_mesh(*shape, devices=jax.devices()[:shape[1] * shape[2]])
    placed, _ = shard_params(variables, mesh)
    whole = lm_state_dict_from_jax(nn.meta.unbox(variables), jcfg)
    dims = tp_layout(PianoBartLM(config_from_jax(jcfg), device="meta"))
    coord = {d.id: t for t in range(shape[1]) for d in mesh.devices[0, t]}
    for device in mesh.devices.flat:
        t = coord[device.id]

        def shard_of(leaf):
            return np.asarray(next(s.data for s in leaf.addressable_shards
                                   if s.device == device))

        got = lm_state_dict_from_jax(jax.tree.map(shard_of, placed["params"]), jcfg)
        want = shard_state_dict(whole, dims, shape[1], t)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                          err_msg=f"{name} at tp {t}")


def test_shard_slice_refuses_an_indivisible_dim():
    """A dim tp does not divide is refused, naming the leaf."""
    from pianobart_tpu_torch.parallel.mesh import shard_slice
    with pytest.raises(ValueError, match="fc1.weight"):
        shard_slice(torch.zeros(6, 4), 4, 0, 0, "fc1.weight")
    assert shard_slice(torch.arange(8.0).reshape(2, 4), 2, 1, 1).tolist() == [[2, 3], [6, 7]]


# ---------------------------------------------------------------------------
# One AdamW step, storage, checkpoints: four gloo ranks
# ---------------------------------------------------------------------------

def _named(model, table):
    return {n: table[p].detach().clone() for n, p in model.named_parameters()}


def _worker(rank, world, d):
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import (make_mesh, shard_params,
                                                   sharded_dims)
    from pianobart_tpu_torch.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    base = inp["cfg"]
    batch = torch.from_numpy(inp["batch"]).long()
    c, m = (torch.from_numpy(x) for x in inp["corruption"])
    res = {}
    for shape in ((1, 2, 2), (2, 1, 1), (1, 1, 2)):
        mesh = make_mesh(*shape)
        if mesh is None:       # 2x1x1 and 1x1x2 run on ranks 0 and 1
            continue
        cfg = _mesh_cfg(base, shape)
        model = PianoBartLM(cfg, device="cpu").train()
        model.load_state_dict(inp["sd"])
        shard_params(model, mesh)
        state = create_train_state(model, LR)
        metrics = make_sp_pretrain_step(cfg, mesh).update(
            state, batch, c.long(), m, torch.Generator().manual_seed(0))
        opt = state.optimizer.state
        res[shape] = {
            "coords": mesh.coords, "dims": sharded_dims(model),
            # each gradient owns its storage (a gathered weight's slice of
            # the whole gradient is a copy)
            "grad_storage": {n: p.grad.untyped_storage().nbytes()
                             == p.grad.numel() * p.grad.element_size()
                             for n, p in model.named_parameters()},
            "loss": metrics["loss"].item(), "norm": metrics["grad_norm"].item(),
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "mu": _named(model, {p: opt[p]["exp_avg"] for p in opt}),
            "nu": _named(model, {p: opt[p]["exp_avg_sq"] for p in opt}),
            "counts": (sum(p.numel() for p in model.parameters()),
                       sum(s["exp_avg"].numel() + s["exp_avg_sq"].numel()
                           for s in opt.values()))}
    # remat at 1x2x2 and dropout 0.1: the recompute gathers the FFN's and
    # the LM head's shards again, in the same order on every rank
    mesh = make_mesh(1, 2, 2)
    for what in ("plain", "remat", "remat_ffn"):
        rcfg = _mesh_cfg(base, (1, 2, 2)).replace(
            dropout=0.1, activation_dropout=0.1, remat=what == "remat",
            remat_ffn=what == "remat_ffn")
        model = PianoBartLM(rcfg, device="cpu").train()
        model.load_state_dict(inp["sd"])
        state = create_train_state(shard_params(model, mesh), 0.0)
        _, metrics = make_sp_pretrain_step(rcfg, mesh)(state, batch,
                                                       torch.Generator().manual_seed(5))
        res[what] = (metrics["loss"].item(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    # checkpoints at 1x2x1: two real updates and half a window (accumulation
    # 2) with an EMA shadow, saved; then a fresh sharded state restored
    mesh = make_mesh(1, 2, 1)
    if mesh is not None:
        cfg = _mesh_cfg(base, (1, 2, 1))
        step = make_sp_pretrain_step(cfg, mesh)
        ckpt = CheckpointManager(os.path.join(d, "ckpt"), writer=mesh.rank == 0,
                                 barrier=mesh.barrier, tp=mesh.axis("tp"))

        def fresh():
            model = PianoBartLM(cfg, device="cpu").train()
            model.load_state_dict(inp["sd"])
            return create_train_state(shard_params(model, mesh), LR, accum_steps=2,
                                      ema_decay=0.9)

        state = fresh()
        for i in range(5):
            step(state, batch, torch.Generator().manual_seed(i))
        ckpt.save(3, state, {"weighted_acc": 0.5}, True)

        def held(st):
            opt = st.optimizer.state
            return {"params": {n: p.detach().clone()
                               for n, p in st.model.named_parameters()},
                    "mu": _named(st.model, {p: opt[p]["exp_avg"] for p in opt}),
                    "nu": _named(st.model, {p: opt[p]["exp_avg_sq"] for p in opt}),
                    "ema": {n: e.clone() for (n, _), e in
                            zip(st.model.named_parameters(), st.ema)},
                    "grads": {n: p.grad.clone() for n, p in st.model.named_parameters()},
                    "step": st.step}

        res["ckpt_saved"] = held(state)
        back, _ = ckpt.restore(fresh())
        res["ckpt_restored"] = held(back)
        res["ckpt_coords"] = mesh.coords
        res["ckpt_dims"] = sharded_dims(back.model)
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's AdamW and SGD steps at 1x2x2 in the parent, then the four
    ranks; returns JAX's results (in the port's names and layout) and each
    rank's."""
    import jax
    import jax.numpy as jnp
    import optax
    from pianobart_tpu.models import PianoBartLM, tiny_config
    from pianobart_tpu.ops.noise import corrupt_batch
    from pianobart_tpu.parallel.mesh import make_mesh, shard_params
    from pianobart_tpu.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu.train.state import TrainState, _find_state, make_optimizer
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax

    d = tmp_path_factory.mktemp("tp_shard")
    base = tiny_config(**TINY)
    cfg = _mesh_cfg(base, (1, 2, 2))
    batch = jnp.asarray(_batch())
    key = jax.random.PRNGKey(7)
    ids, ones = jnp.zeros((2, S, 8), jnp.int32), jnp.ones((2, S))
    variables = PianoBartLM(base).init(key, ids, ids, ones, ones)
    mesh = make_mesh(1, 2, 2, devices=jax.devices()[:4])

    def port(tree):
        return lm_state_dict_from_jax(jax.tree.map(np.asarray, tree), base)

    def placed():   # the steps donate their state: a copy each
        return shard_params(jax.tree.map(jnp.copy, variables), mesh)[0]["params"]

    whole = port(placed())
    st = TrainState.create(apply_fn=None, params=placed(), tx=make_optimizer(LR))
    st, m = make_sp_pretrain_step(cfg, mesh, 0.15)(st, batch, key)
    adam = _find_state(st.opt_state, optax.ScaleByAdamState)
    sgd = TrainState.create(apply_fn=None, params=placed(), tx=optax.sgd(1.0))
    sgd, _ = make_sp_pretrain_step(cfg, mesh, 0.15)(sgd, batch, key)
    norm = float(m["grad_norm"])
    scale = 1.0 if norm < 3.0 else 3.0 / norm
    grads = {n: (whole[n] - g) * scale for n, g in port(sgd.params).items()}
    want = {"loss": float(m["loss"]), "norm": norm, "grads": grads,
            "params": port(st.params), "mu": port(adam.mu), "nu": port(adam.nu)}
    corrupted, loss_mask = corrupt_batch(jax.random.split(jax.random.fold_in(key, 0))[0],
                                         batch, 0.15)
    torch.save({"cfg": config_from_jax(base), "batch": np.asarray(batch), "sd": whole,
                "corruption": (np.array(corrupted), np.array(loss_mask))},
               d / "inputs.pt")
    spawn(_worker, 4, (str(d),), threads=1)
    return d, want, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _slice(t, dims, name, coords):
    from pianobart_tpu_torch.parallel.mesh import shard_slice
    return shard_slice(t, 2, coords["tp"], dims[name], name) if name in dims else t


@pytest.mark.parametrize("what", ["loss_and_norm", "grads", "moments", "params"])
def test_adamw_step_at_1x2x2_matches_jax(runs, what):
    """One AdamW step at 1x2x2 on each of the four ranks against JAX's step
    on ``shard_params``' placement: the loss and the pre-clip norm, and each
    rank's shards of the clipped gradients, of both moments and of the
    parameters after the step against the slice of JAX's at the rank's tp
    coordinate (tolerances in the module's docstring)."""
    _, want, ranks = runs
    for res in ranks:
        got = res[1, 2, 2]
        dims, coords = got["dims"], got["coords"]
        if what == "loss_and_norm":
            assert got["loss"] == pytest.approx(want["loss"], rel=2e-5)
            assert got["norm"] == pytest.approx(want["norm"], rel=2e-5)
            continue
        for name, w in want[what if what != "moments" else "mu"].items():
            w = _slice(w, dims, name, coords).numpy()
            if what == "grads":
                np.testing.assert_allclose(got["grads"][name], w, rtol=2e-4, atol=2e-5,
                                           err_msg=name)
            elif what == "params":
                g = np.abs(_slice(want["grads"][name], dims, name, coords).numpy())
                sure = g > 2e-5
                np.testing.assert_allclose(got["params"][name].numpy()[sure], w[sure],
                                           rtol=1e-5, atol=1e-3 * LR, err_msg=name)
                np.testing.assert_allclose(got["params"][name].numpy()[~sure],
                                           w[~sure], rtol=0, atol=2 * LR, err_msg=name)
            else:
                np.testing.assert_allclose(got["mu"][name], w, rtol=1e-5,
                                           atol=1e-3 * LR, err_msg=name)
                nu = _slice(want["nu"][name], dims, name, coords).numpy()
                g = np.abs(_slice(want["grads"][name], dims, name, coords).numpy()).max()
                np.testing.assert_allclose(got["nu"][name], nu, rtol=1e-5,
                                           atol=1e-3 * LR * g, err_msg=name)


@pytest.mark.parametrize("what", ["remat", "remat_ffn"])
def test_remat_over_tp_shards_equals_the_plain_step(runs, what):
    """At 1x2x2 and dropout 0.1 from one seed, the step with every layer (or
    every FFN) recomputed, whose recompute gathers the sharded weights over
    tp again, gives the plain step's loss and gradient shards bit for bit
    on every rank."""
    _, _, ranks = runs
    for res in ranks:
        assert res[what][0] == res["plain"][0]
        for name, g in res["plain"][1].items():
            torch.testing.assert_close(res[what][1][name], g, rtol=0, atol=0)


def test_storage_counts(runs):
    """After the step each rank of the tp=2 mesh holds the replicated
    parameters whole and half of each sharded one, AdamW's two moments of
    the same, and gradients each in storage of its own size (none a view
    that keeps a whole gathered gradient alive); at 2x1x1 and 1x1x2 every
    rank holds the whole model."""
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import tp_layout
    d, want, ranks = runs
    whole = want["params"]
    cfg = torch.load(d / "inputs.pt", weights_only=False)["cfg"]
    layout = tp_layout(PianoBartLM(cfg, device="meta"))
    sharded = sum(whole[n].numel() for n in layout)
    total = sum(t.numel() for t in whole.values())
    assert 0 < sharded < total
    for res in ranks:
        assert res[1, 2, 2]["counts"] == (total - sharded // 2, 2 * (total - sharded // 2))
        assert set(res[1, 2, 2]["dims"]) == set(layout)
        assert all(res[1, 2, 2]["grad_storage"].values())
    for shape in ((2, 1, 1), (1, 1, 2)):
        for res in ranks[:2]:
            assert res[shape]["counts"] == (total, 2 * total)
            assert res[shape]["dims"] == {}
        for res in ranks[2:]:
            assert shape not in res


def test_checkpoint_is_whole_and_restores_the_shards(runs):
    """At 1x2x1 over two ranks, rank 0's ``state.pt`` holds whole tensors
    (the model's entries, both moments, the EMA shadow and the open
    window's gradients at the dense shapes), each rank's slice of which is
    what that rank held when it saved; a single-rank ``CheckpointManager``
    restores it into a whole model; and a fresh sharded state restored at
    1x2x1 holds each rank's shards of the parameters, moments, EMA and
    window exactly."""
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
    d, want, ranks = runs
    cfg = torch.load(d / "inputs.pt", weights_only=False)["cfg"]
    payload = torch.load(d / "ckpt" / "step_3" / "state.pt", weights_only=True)
    model = PianoBartLM(cfg, device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert {n: t.shape for n, t in payload["model"].items()} == shapes
    names = list(shapes)
    opt = payload["optimizer"]["state"]
    for res in ranks[:2]:
        saved, back = res["ckpt_saved"], res["ckpt_restored"]
        dims, coords = res["ckpt_dims"], res["ckpt_coords"]
        assert back["step"] == saved["step"] == 5
        file = {"params": payload["model"],
                "mu": {n: opt[i]["exp_avg"] for i, n in enumerate(names)},
                "nu": {n: opt[i]["exp_avg_sq"] for i, n in enumerate(names)},
                "ema": dict(zip(names, payload["ema"])),
                "grads": dict(zip(names, payload["accum"]["grads"]))}
        for what, entries in file.items():
            for name, t in entries.items():
                assert t.shape == shapes[name], (what, name)
                torch.testing.assert_close(_slice(t, dims, name, coords),
                                           saved[what][name], rtol=0, atol=0)
                torch.testing.assert_close(back[what][name], saved[what][name],
                                           rtol=0, atol=0)
    # a single-rank run takes the file as it is
    state = create_train_state(PianoBartLM(cfg, device="cpu"), LR, accum_steps=2,
                               ema_decay=0.9)
    state, epoch = CheckpointManager(str(d / "ckpt")).restore(state)
    assert epoch == 3 and state.step == 5
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), payload["model"][name], rtol=0, atol=0)
