"""The port's mesh finetune steps (``train/finetune_sp.py``) and the mesh
``SupervisedRunner`` against the JAX package's dense steps and the port's
single-rank runner.

JAX runs in the parent: each step (composer, velocity, melody, the
generation finetune in ``shifted`` mode, the ablation) once dense with
SGD(lr=1), so that its gradients are ``params - new params`` (as
``tests/test_torch_sp_train.py`` reads them), its eval twin with a tail
batch whose last two rows weigh 0, the composer step with the L2 term, and
the composer and velocity steps under a 2x2x1 mesh of conftest's virtual
CPU devices as the JAX CLI runs them (``with mesh,
nn.logical_axis_rules(LOGICAL_RULES)``, parameters placed by
``shard_params``, batches by ``put_batch_fn``).  Four ranks are then spawned
over gloo on the CPU (``parallel/launch.py``); each carries JAX's weights
and runs every step at 2x1x1, 1x2x1, 1x1x2, 2x1x2 and 1x2x2 (under tp with
the parameters placed by ``shard_params``, the gradient shards gathered
whole before they are compared), the L2 step at 2x1x2 and 1x2x2, and (ranks
0 and 1) a two-epoch ``SupervisedRunner`` at 2x1x1 whose
files the parent holds against the single-rank runner's (rank 2, meanwhile).

Dropout 0 on both sides, with the heads' fixed 0.1 patched to 0 as
``tests/test_torch_finetune.py`` does.  Tolerances as
``tests/test_torch_sp_train.py``: loss rel 2e-5, gradients rtol 2e-4 / atol
2e-5; the eval twins' ``acc_num``, ``acc_den`` and predictions exactly,
field accuracies rtol 1e-5 / atol 1e-6.

JAX is imported inside the fixture: the spawned ranks import this module
and need torch only.
"""
import json
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.parallel.launch import spawn

S, B, C = 64, 4, 4
TINY = dict(max_len=S, d_model=64, num_heads=2, emb_size=16, ffn_dim=80, dropout=0.0,
            encoder_layers=1, decoder_layers=1)
MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 1, 2), (1, 2, 2))
MESH_IDS = ["dp_2x1x1", "tp_1x2x1", "sp_1x1x2", "dp_sp_2x1x2", "tp_sp_1x2x2"]
# kind: (labels, train weight); every eval twin weighs the last two rows 0,
# which at dp=2 are all of dp rank 1's
KINDS = {"composer": ("class", None), "velocity": ("token", None),
         "melody": ("token", [1, 1, 0, 0]), "generation": ("octuple", None),
         "ablation": (None, [1, 0, 1, 1])}
EVAL_WEIGHT = [1.0, 1.0, 0.0, 0.0]
REG = 1e-3


def _batch(rng, pad_from):
    """Octuple windows, sample i padded from row ``pad_from[i]``."""
    from pianobart_tpu_torch import vocab as V
    x = np.zeros((B, S, 8), dtype=np.int64)
    for f in range(8):
        x[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    for i, p in enumerate(pad_from):
        x[i, p:] = V.PAD
    return x


def _inputs():
    rng = np.random.default_rng(2023)
    x = _batch(rng, (S, 40, 23, 50))
    return {"x": x, "class": rng.integers(0, C, (B,)),
            "token": rng.integers(0, C + 1, (B, S)),
            "octuple": _batch(rng, (S - 3, 45, 30, S)), None: None}


def _mesh_cfg(base, shape):
    dp, tp, sp = shape
    if tp > 1:
        return base.replace(ring_axis="sp", ring_tp_axis="tp", ring_tp_size=tp)
    return base.replace(ring_axis="sp") if sp > 1 else base


def _flat(sd):
    return np.concatenate([np.asarray(sd[n]).ravel() for n in sorted(sd)])


def _port_model(kind, cfg):
    from pianobart_tpu_torch.models import (PianoBartLM, SequenceClassification,
                                            TokenClassification)
    if kind == "composer":
        return SequenceClassification(cfg, C, device="cpu")
    if kind in ("velocity", "melody"):
        return TokenClassification(cfg, C + 1, device="cpu")
    return PianoBartLM(cfg, device="cpu")


def _port_step(kind, cfg, mesh, reg_weight=None):
    """The mesh step of ``kind`` as ``step(state, x, y, gen, train, weight)``."""
    from pianobart_tpu_torch.train import finetune_sp as fsp
    if kind == "composer":
        return fsp.make_sp_seq_step(cfg, mesh, reg_weight)
    if kind in ("velocity", "melody"):
        return fsp.make_sp_token_step(cfg, mesh, kind == "velocity")
    if kind == "generation":
        return fsp.make_sp_generation_step(cfg, mesh, "shifted")
    step = fsp.make_sp_ablation_step(cfg, mesh)
    return lambda st, x, y, g, train, weight: step(st, x, g, train=train, weight=weight)


def _sgd_state(model):
    from pianobart_tpu_torch.train.state import TrainState
    # SGD(lr=1) after a clip that never scales: .grad keeps the summed
    # gradients
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0),
                      clip_norm=float("inf"))


def _host(m):
    return {k: v.detach().cpu().numpy() for k, v in m.items()}


def _runner_data():
    """8 train windows (two batches of 4), 5 valid (the second batch 1 real
    row and 3 pads: dp rank 1 holds pads only), 6 test (2 real, 2 pads)."""
    rng = np.random.default_rng(7)
    X = np.concatenate([_batch(rng, rng.integers(S // 4, S + 1, B)) for _ in range(5)])[:19]
    y = rng.integers(0, C, len(X))
    return (X[:8], X[8:13], X[13:], y[:8], y[8:13], y[13:])


def _run_runner(d, mesh=None, put_batch=None):
    """A two-epoch composer run at dropout 0 into ``d``; returns the eval
    hook's calls and the best/ saves this process made."""
    from pianobart_tpu_torch.models import heads
    from pianobart_tpu_torch.train import state as state_mod
    from pianobart_tpu_torch.train.finetune import finetune_seq_step
    from pianobart_tpu_torch.train.finetune_sp import make_sp_seq_step
    from pianobart_tpu_torch.train.runner import SupervisedRunner
    inp = torch.load(os.path.join(os.path.dirname(d), "inputs.pt"), weights_only=False)
    cfg = inp["cfg"]["composer"]
    model = _port_model("composer", cfg).train()
    model.load_state_dict(inp["sd"]["composer"])
    state = state_mod.create_train_state(model, 1e-3)
    step = finetune_seq_step if mesh is None else make_sp_seq_step(cfg, mesh)
    hooks, saves = [], []
    real_save = state_mod.CheckpointManager._save

    def save(self, step_, st, metrics, is_best):
        saves.append(is_best)
        return real_save(self, step_, st, metrics, is_best)

    state_mod.CheckpointManager._save = save
    head_dropout, heads.HEAD_DROPOUT = heads.HEAD_DROPOUT, 0.0
    try:
        SupervisedRunner(state, cfg, step, _runner_data(), d, batch_size=4,
                         patience=3, seed=5,
                         eval_hook=lambda x, y, m: hooks.append(len(x)) or {"n": len(x)},
                         put_batch=put_batch, mesh=mesh).run(2)
    finally:
        state_mod.CheckpointManager._save = real_save
        heads.HEAD_DROPOUT = head_dropout
    return hooks, saves


def _worker(rank, world, d):
    from pianobart_tpu_torch.models import heads
    from pianobart_tpu_torch.parallel.mesh import (gather_state_dict, make_mesh,
                                                   put_batch_fn, shard_params,
                                                   sharded_dims)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    heads.HEAD_DROPOUT = 0.0
    data = {k: None if v is None else torch.from_numpy(v).long()
            for k, v in inp["data"].items()}
    ew = torch.tensor(EVAL_WEIGHT)
    res = {}

    def run(kind, shape, mesh, reg_weight=None):
        cfg = _mesh_cfg(inp["cfg"][kind], shape)
        labels, w = KINDS[kind]
        model = _port_model(kind, cfg).train()
        model.load_state_dict(inp["sd"][kind])
        state = _sgd_state(shard_params(model, mesh))
        step = _port_step(kind, cfg, mesh, reg_weight)
        x, y = data["x"], data.get(labels)
        out = {}
        if reg_weight is None:     # the eval twin, on the same weights
            _, em = step(state, x, y, None, train=False, weight=ew)
            out["eval"] = _host(em)
        _, m = step(state, x, y, torch.Generator().manual_seed(0), train=True,
                    weight=None if w is None else torch.tensor(w, dtype=torch.float32))
        # a tp shard's gradient gathered whole
        grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()},
                                  sharded_dims(model), mesh.axis("tp"))
        out["loss"], out["grads"] = m["loss"].item(), _flat(grads)
        out["metrics"] = sorted(m)
        return out

    for shape in MESHES:
        mesh = make_mesh(*shape)
        if mesh is None:       # 2x1x1, 1x2x1 and 1x1x2 run on ranks 0 and 1
            continue
        for kind in KINDS:
            res[kind, shape] = run(kind, shape, mesh)
        if shape == (2, 1, 2):
            res["reg"] = run("composer", shape, mesh, REG)
        if shape == (1, 2, 2):
            res["reg_tp"] = run("composer", shape, mesh, REG)
    mesh = make_mesh(2, 1, 1)
    if mesh is not None:
        res["runner"] = _run_runner(os.path.join(d, "mesh_run"), mesh, put_batch_fn(mesh))
    elif rank == 2:     # the single-rank runner, the mesh runner's reference
        res["runner"] = _run_runner(os.path.join(d, "dense_run"))
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps in the parent, then the four ranks; returns JAX's
    results, each rank's, and the runners' directory."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax
    from pianobart_tpu.models import PianoBartLM as JaxLM
    from pianobart_tpu.models import SequenceClassification as JaxSeq
    from pianobart_tpu.models import TokenClassification as JaxTok
    from pianobart_tpu.models import tiny_config as jax_tiny_config
    from pianobart_tpu.parallel.mesh import (LOGICAL_RULES, make_mesh, put_batch_fn,
                                             shard_params)
    from pianobart_tpu.train import finetune as jft
    from pianobart_tpu.train import generation as jgen
    from pianobart_tpu.train.state import TrainState
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax

    d = tmp_path_factory.mktemp("finetune_mesh")
    data = _inputs()
    real_dropout = fnn.Dropout
    want, cfgs, sds = {}, {}, {}
    with pytest.MonkeyPatch.context() as mp:
        # the heads' dropout (0.1, fixed in both packages) off on both sides
        mp.setattr(fnn, "Dropout", lambda rate, **kw: real_dropout(0.0, **kw))
        for kind, (labels, w) in KINDS.items():
            jcfg = jax_tiny_config(**TINY, decoder_label_vocab=(
                C + 1 if kind == "velocity" else None))
            ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
            if kind == "composer":
                model, sample = JaxSeq(jcfg, C), (ids, ones)
            elif kind in ("velocity", "melody"):
                dec = jnp.zeros((1, S), jnp.int32) if kind == "velocity" else ids
                model, sample = JaxTok(jcfg, C + 1), (ids, dec, ones, ones)
            else:
                model, sample = JaxLM(jcfg), (ids, ids, ones, ones)
            variables = model.init(jax.random.PRNGKey(0), *sample)
            # off the zero biases of the init: JAX's L2 term has a NaN
            # gradient at an all-zero parameter
            leaves, tree = jax.tree_util.tree_flatten(fnn.meta.unbox(variables)["params"])
            noise = np.random.default_rng(9)
            params = jax.tree_util.tree_unflatten(tree, [
                p + 0.01 * noise.standard_normal(p.shape).astype(np.float32)
                for p in leaves])
            cfgs[kind] = config_from_jax(jcfg)
            sds[kind] = lm_state_dict_from_jax(params, jcfg)
            x, y = jnp.asarray(data["x"]), (None if labels is None
                                            else jnp.asarray(data[labels]))
            key = jax.random.PRNGKey(3)

            def call(p, train, weight, reg=None, place=lambda a: a):
                st = TrainState.create(apply_fn=model.apply,
                                       params=jax.tree.map(jnp.copy, p),
                                       tx=optax.sgd(1.0))
                jw = None if weight is None else place(jnp.asarray(weight, jnp.float32))
                if kind == "composer":
                    new, m = jft.finetune_seq_step(st, place(x), place(y), key, jcfg,
                                                   reg_weight=reg, train=train, weight=jw)
                elif kind in ("velocity", "melody"):
                    new, m = jft.finetune_token_step(st, place(x), place(y), key, jcfg,
                                                     velocity=kind == "velocity",
                                                     train=train, weight=jw)
                elif kind == "generation":
                    new, m = jgen.generation_step(st, place(x), place(y), key, jcfg,
                                                  decoder_mode="shifted", train=train,
                                                  weight=jw)
                else:
                    new, m = jgen.ablation_step(st, place(x), key, jcfg, train=train,
                                                weight=jw)
                m = {k: np.asarray(v) for k, v in m.items()}
                if not train:
                    return m
                grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                     p, new.params)
                return float(m["loss"]), _flat(lm_state_dict_from_jax(grads, jcfg))

            want[kind] = call(params, True, w)
            want[kind, "eval"] = call(params, False, EVAL_WEIGHT)
            if kind == "composer":
                want["reg"] = call(params, True, w, REG)
            if kind in ("composer", "velocity"):
                mesh = make_mesh(2, 2, 1, devices=jax.devices()[:4])
                _, shardings = shard_params(variables, mesh)
                with mesh, fnn.logical_axis_rules(LOGICAL_RULES):
                    want[kind, "jax_2x2x1"] = call(
                        jax.device_put(params, shardings["params"]), True, w,
                        place=put_batch_fn(mesh))
    torch.save({"cfg": cfgs, "sd": sds, "data": {k: v for k, v in data.items()
                                                  if k is not None}},
               d / "inputs.pt")
    spawn(_worker, 4, (str(d),), threads=1)
    return want, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)], d


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_step_matches_jax_dense_step(runs, shape, kind):
    """Loss and the all-reduced gradients of one train step, on every rank
    of the mesh, against JAX's dense step on the same weights and batch."""
    want, ranks, _ = runs
    wloss, wgrads = want[kind]
    n = int(np.prod(shape))
    for res in ranks[:n]:
        got = res[kind, shape]
        assert got["loss"] == pytest.approx(wloss, rel=2e-5)
        np.testing.assert_allclose(got["grads"], wgrads, rtol=2e-4, atol=2e-5)
        assert "pred" not in got["metrics"] and "outputs" not in got["metrics"]
    for res in ranks[n:]:
        assert (kind, shape) not in res


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_mesh_eval_step_matches_jax(runs, shape, kind):
    """The eval twin on a tail batch whose last two rows weigh 0 (at dp=2,
    every row of dp rank 1): the loss, ``acc_num``/``acc_den`` or the field
    accuracies, and the predictions gathered in sample order on every
    rank, against JAX's eval step."""
    want, ranks, _ = runs
    w = want[kind, "eval"]
    for res in ranks[:int(np.prod(shape))]:
        got = res[kind, shape]["eval"]
        assert set(got) == set(w)
        assert float(got["loss"]) == pytest.approx(float(w["loss"]), rel=2e-5)
        for k in set(w) - {"loss"}:
            if k in ("field_loss", "field_acc"):
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], w[k], err_msg=k)


def test_l2_term_enters_once(runs):
    """``--weight`` at 2x1x2: the L2 term's value and gradient counted once
    over the four ranks' summed objective, as JAX's dense step has them."""
    want, ranks, _ = runs
    wloss, wgrads = want["reg"]
    assert wloss != pytest.approx(want["composer"][0], rel=1e-4)
    for res in ranks:
        assert res["reg"]["loss"] == pytest.approx(wloss, rel=2e-5)
        np.testing.assert_allclose(res["reg"]["grads"], wgrads, rtol=2e-4, atol=2e-5)


def test_l2_term_over_tp_shards(runs):
    """``--weight`` at 1x2x2, with the parameters placed by ``shard_params``:
    each sharded parameter's norm is the whole parameter's (gathered over
    tp), its gradient this rank's slice of the whole one, as JAX's dense
    step has them."""
    want, ranks, _ = runs
    wloss, wgrads = want["reg"]
    for res in ranks:
        assert res["reg_tp"]["loss"] == pytest.approx(wloss, rel=2e-5)
        np.testing.assert_allclose(res["reg_tp"]["grads"], wgrads, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["composer", "velocity"])
def test_jax_cli_mesh_step_matches(runs, kind):
    """JAX's step under a 2x2x1 mesh, run as its CLI runs it, gives its dense
    step's loss and gradients, and so the port's mesh steps'."""
    want, ranks, _ = runs
    jloss, jgrads = want[kind, "jax_2x2x1"]
    assert jloss == pytest.approx(want[kind][0], rel=2e-5)
    np.testing.assert_allclose(jgrads, want[kind][1], rtol=2e-4, atol=2e-5)
    got = ranks[0][kind, (2, 1, 1)]
    assert got["loss"] == pytest.approx(jloss, rel=2e-5)
    np.testing.assert_allclose(got["grads"], jgrads, rtol=2e-4, atol=2e-5)


def _events(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == "epoch"]


def test_mesh_runner_matches_single_rank_runner(runs):
    """Two epochs of ``SupervisedRunner`` at 2x1x1 against the single-rank
    runner at dropout 0: the same scores, best flags and metrics in
    ``metrics.jsonl``, the same ``test_outputs.npy``; rank 0 alone ran the
    eval hook (on the real samples of the global batch) and wrote the
    checkpoints, ``best/`` once an epoch as the single-rank run did."""
    _, ranks, d = runs
    want, got = _events(d / "dense_run"), _events(d / "mesh_run")
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert g["best"] == w["best"]
        assert g["score"] == pytest.approx(w["score"], rel=1e-6)
        for split in ("valid", "test"):
            assert g[split]["acc"] == w[split]["acc"]
            assert g[split]["n"] == w[split]["n"]
            assert g[split]["loss"] == pytest.approx(w[split]["loss"], rel=2e-5)
        assert g["train"]["loss"] == pytest.approx(w["train"]["loss"], rel=2e-5)
    np.testing.assert_array_equal(np.load(d / "mesh_run" / "test_outputs.npy"),
                                  np.load(d / "dense_run" / "test_outputs.npy"))
    assert np.load(d / "mesh_run" / "test_outputs.npy").shape == (6,)
    (hooks0, saves0), (hooks1, saves1), (dense_hooks, dense_saves) = (
        ranks[r]["runner"] for r in range(3))
    assert hooks0 == dense_hooks == [4, 1, 4, 2] * 2 and hooks1 == []
    assert saves0 == dense_saves and saves1 == []
    meta = json.loads((d / "mesh_run" / "meta.json").read_text())
    assert (d / "mesh_run" / "best" / "state.pt").exists()
    assert meta["best_step"] == json.loads(
        (d / "dense_run" / "meta.json").read_text())["best_step"]
    assert "runner" not in ranks[3]
