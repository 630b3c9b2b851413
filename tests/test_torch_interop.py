"""Reference-checkpoint interop of the port against the JAX package's.

* JAX weights written in the reference layout by the JAX exporters
  (``export_lm``, ``export_trunk``, ``export_sequence_classifier``,
  ``export_token_classifier``) into a ``.ckpt``, read back by the port's
  ``import_checkpoint`` (the kind detected): the port's logits equal JAX's
  (rtol 1e-5).
* The port's exporters give the JAX exporters' key set and tensors, with
  and without ``strict_ref``.
* ``convert-ckpt`` and ``export-ckpt`` of both CLIs give equal tensors;
  the orbax chain (JAX ``CheckpointManager.save`` -> JAX ``export-ckpt``
  -> the port's loader) gives JAX's logits.
* ``restore_ema_params``: ``export-ckpt --ema`` of both CLIs on the same
  shadow gives equal files; without an EMA both raise.
* A trunk-only checkpoint into a classifier grafts the trunk and leaves the
  head as drawn.

f32 on both sides, JAX at ``highest`` matmul precision (tests/conftest.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from pianobart_tpu import cli as jcli
from pianobart_tpu import vocab as JV
from pianobart_tpu.compat import torch_export as jexport
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import SequenceClassification as JaxSeq
from pianobart_tpu.models import TokenClassification as JaxTok
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train import state as jst
from pianobart_tpu_torch import cli
from pianobart_tpu_torch.compat import torch_export as pexport
from pianobart_tpu_torch.compat.from_jax import init_model, lm_state_dict_from_jax
from pianobart_tpu_torch.compat.torch_import import import_checkpoint
from pianobart_tpu_torch.decode import load_inference_model
from pianobart_tpu_torch.models import (PianoBartLM, SequenceClassification,
                                        TokenClassification, tiny_config)
from pianobart_tpu_torch.train.state import (CheckpointManager, create_train_state,
                                             graft_)
from tests.test_torch_train import make_batch

torch.set_num_threads(2)
S = 32
DIMS = dict(encoder_layers=1, decoder_layers=1, emb_size=256)  # the CLIs' width
# the CLIs' model flags for the same dims; the JAX CLI's also take the
# compute type (f32: the exported files hold f32), the port's checkpoint
# commands copy f32 parameters and take none
FLAGS = ["--hs", "64", "--layers", "1", "--heads", "4", "--ffn_dims", "128",
         "--max_seq_len", str(S)]
JAX_FLAGS = FLAGS + ["--dtype", "f32"]
C = 4


def _cfgs(kind):
    lab = C + 1 if kind == "velocity" else None
    return (jax_tiny_config(**DIMS, decoder_label_vocab=lab),
            tiny_config(**DIMS, decoder_label_vocab=lab))


def _jax_model(kind, seed=0):
    """(JAX module, its params, its config) of kind ``lm``, ``seq``,
    ``melody`` or ``velocity``."""
    jcfg, _ = _cfgs(kind)
    ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
    if kind == "seq":
        jm, sample = JaxSeq(jcfg, C), (ids, ones)
    elif kind in ("melody", "velocity"):
        dec = jnp.zeros((1, S), jnp.int32) if kind == "velocity" else ids
        jm, sample = JaxTok(jcfg, C + 1), (ids, dec, ones, ones)
    else:
        jm, sample = JaxLM(jcfg), (ids, ids, ones, ones)
    params = fnn.meta.unbox(jm.init(jax.random.PRNGKey(seed), *sample))["params"]
    return jm, params, jcfg


def _port_model(kind, cfg):
    if kind == "seq":
        return SequenceClassification(cfg, C, device="cpu")
    if kind in ("melody", "velocity"):
        return TokenClassification(cfg, C + 1, device="cpu")
    return PianoBartLM(cfg, device="cpu")


def _inputs(kind, seed=1):
    rng = np.random.default_rng(seed)
    x = make_batch(rng, 2, S).astype(np.int64)
    x[1, 20:] = JV.PAD
    attn = (x[..., 0] != JV.PAD[0]).astype(np.float32)
    if kind == "seq":
        return (x, attn)
    dec = rng.integers(0, C + 1, (2, S)) if kind == "velocity" else x
    return (x, dec, attn, attn)


def _logits(model, args):
    with torch.no_grad():
        return model.eval()(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()


EXPORTERS = {"lm": "export_lm", "seq": "export_sequence_classifier",
             "melody": "export_token_classifier", "velocity": "export_token_classifier"}


@pytest.mark.parametrize("kind", list(EXPORTERS) + ["trunk"])
def test_reference_checkpoint_into_the_port_gives_jax_logits(kind, tmp_path):
    """The JAX exporter's file, through the port's importer with the kind
    detected from the keys, loads the port model strictly (a trunk: every
    ``pianobart.*`` entry, beside JAX's LM head) and gives JAX's logits."""
    jm, params, jcfg = _jax_model("lm" if kind == "trunk" else kind)
    _, cfg = _cfgs(kind)
    path = str(tmp_path / "ref.ckpt")
    if kind == "trunk":
        sd = jexport.export_trunk(params["pianobart"], jcfg)
    else:
        sd = getattr(jexport, EXPORTERS[kind])(params, jcfg)
    jexport.save_torch_checkpoint(sd, path)
    got = import_checkpoint(path, cfg)
    want = lm_state_dict_from_jax(params, jcfg)
    if kind == "trunk":
        # the trunk's entries, the LM head taken from JAX's weights
        assert set(got) == {k for k in want if k.startswith("pianobart.")}
        got = {**got, "lm_head.proj.weight": want["lm_head.proj.weight"],
               "lm_head.proj.bias": want["lm_head.proj.bias"]}
        kind = "lm"
    model = _port_model(kind, cfg)
    model.load_state_dict(got)      # strict: every entry, nothing more
    args = _inputs(kind)
    np.testing.assert_allclose(_logits(model, args),
                               np.asarray(jm.apply({"params": params},
                                                   *map(jnp.asarray, args))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strict_ref", [False, True])
@pytest.mark.parametrize("kind", list(EXPORTERS) + ["trunk"])
def test_exporters_match_jax(kind, strict_ref):
    """Same keys, equal tensors, on the same weights."""
    _, params, jcfg = _jax_model("lm" if kind == "trunk" else kind)
    _, cfg = _cfgs(kind)
    psd = lm_state_dict_from_jax(params, jcfg)
    if kind == "trunk":
        want = jexport.export_trunk(params["pianobart"], jcfg, strict_ref=strict_ref)
        got = pexport.export_trunk(psd, cfg, strict_ref=strict_ref)
    else:
        name = EXPORTERS[kind]
        want = getattr(jexport, name)(params, jcfg, strict_ref=strict_ref)
        got = getattr(pexport, name)(psd, cfg, strict_ref=strict_ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _jax_cli(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def _ckpt_tensors(path):
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


def _assert_same_files(a, b):
    ta, tb = _ckpt_tensors(a), _ckpt_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_orbax_chain_and_both_clis_convert_and_export_alike(tmp_path):
    """JAX ``CheckpointManager.save`` -> JAX ``export-ckpt`` -> the port's
    loader gives JAX's logits; ``convert-ckpt`` of that file by both CLIs
    holds the same weights; ``export-ckpt`` of both conversions (also
    ``--trunk_only --strict_ref``) writes equal files."""
    jm, params, jcfg = _jax_model("lm", seed=4)
    _, cfg = _cfgs("lm")
    jstate = jst.TrainState.create(apply_fn=jm.apply, params=params,
                                   tx=jst.make_optimizer())
    jst.CheckpointManager(str(tmp_path / "orbax")).save(
        1, jstate, {"weighted_acc": 0.5}, is_best=True)
    ref = str(tmp_path / "jax.ckpt")
    _jax_cli(["export-ckpt", "--ckpt", str(tmp_path / "orbax"), "--output", ref] + JAX_FLAGS)
    model = load_inference_model(cfg, ref, device="cpu")
    args = _inputs("lm")
    np.testing.assert_allclose(_logits(model, args),
                               np.asarray(jm.apply({"params": params},
                                                   *map(jnp.asarray, args))),
                               rtol=1e-5, atol=1e-6)

    _jax_cli(["convert-ckpt", "--ckpt", ref, "--output", str(tmp_path / "jconv")] + JAX_FLAGS)
    assert cli.main(["convert-ckpt", "--ckpt", ref, "--output",
                     str(tmp_path / "pconv")] + FLAGS) == 0
    jparams = jst.CheckpointManager(str(tmp_path / "jconv")).restore_params(params)
    pparams = CheckpointManager(str(tmp_path / "pconv")).params()
    for k, v in lm_state_dict_from_jax(jparams, jcfg).items():
        assert torch.equal(pparams[k], v), k
    meta = CheckpointManager(str(tmp_path / "pconv")).meta()
    assert meta == jst.CheckpointManager(str(tmp_path / "jconv")).meta()
    for extra in ([], ["--trunk_only", "--strict_ref"]):
        j, p = str(tmp_path / "j_out.ckpt"), str(tmp_path / "p_out.ckpt")
        _jax_cli(["export-ckpt", "--ckpt", str(tmp_path / "jconv"), "--output", j]
                 + JAX_FLAGS + extra)
        assert cli.main(["export-ckpt", "--ckpt", str(tmp_path / "pconv"), "--output",
                         p] + FLAGS + extra) == 0
        _assert_same_files(j, p)


def test_export_ema_matches_jax_and_no_ema_raises(tmp_path):
    """One AdamW step with an EMA shadow in JAX; the port's checkpoint
    holding the same shadow; ``export-ckpt --ema`` of both writes equal
    files, and ``restore_ema_params`` grafts the shadow.  Without an EMA
    both managers raise ``FileNotFoundError``."""
    jm, params, jcfg = _jax_model("lm", seed=5)
    _, cfg = _cfgs("lm")
    jstate = jst.TrainState.create(apply_fn=jm.apply, params=params,
                                   tx=jst.make_optimizer(1e-2, ema_decay=0.5))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.1), params)
    jstate = jstate.apply_gradients(grads=grads)
    jst.CheckpointManager(str(tmp_path / "j")).save(1, jstate, {"weighted_acc": 0.1},
                                                    is_best=True)
    jema = jst.CheckpointManager(str(tmp_path / "j")).restore_ema_params(params)
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(jstate.params, jcfg))
    state = create_train_state(model, ema_decay=0.5)
    shadow = lm_state_dict_from_jax(jema, jcfg)
    for e, (name, _) in zip(state.ema, model.named_parameters()):
        e.copy_(shadow[name])
    CheckpointManager(str(tmp_path / "p")).save(1, state, {"weighted_acc": 0.1}, True)
    fresh = init_model(PianoBartLM, cfg, seed=3, device="cpu")
    CheckpointManager(str(tmp_path / "p")).restore_ema_params(fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, shadow[k]), k
    j, p = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
    _jax_cli(["export-ckpt", "--ema", "--ckpt", str(tmp_path / "j"), "--output", j]
             + JAX_FLAGS)
    assert cli.main(["export-ckpt", "--ema", "--ckpt", str(tmp_path / "p"),
                     "--output", p] + FLAGS) == 0
    _assert_same_files(j, p)

    jst.CheckpointManager(str(tmp_path / "jn")).save(
        1, jst.TrainState.create(apply_fn=jm.apply, params=params,
                                 tx=jst.make_optimizer()), {}, True)
    CheckpointManager(str(tmp_path / "pn")).save(1, create_train_state(model), {}, True)
    with pytest.raises(FileNotFoundError, match="not trained with --ema_decay"):
        jst.CheckpointManager(str(tmp_path / "jn")).restore_ema_params(params)
    with pytest.raises(FileNotFoundError, match="not trained with --ema_decay"):
        CheckpointManager(str(tmp_path / "pn")).restore_ema_params(model)


@pytest.mark.parametrize("form", ["reference", "port"])
def test_trunk_into_a_classifier_grafts_only_the_trunk(form, tmp_path):
    """A trunk-only reference file, or a pretrain checkpoint of the port
    (trunk and LM head), grafted onto a drawn classifier as ``finetune
    --ckpt`` does: every trunk tensor is the checkpoint's, the head keeps
    its draw; a checkpoint sharing no name raises."""
    _, params, jcfg = _jax_model("lm", seed=6)
    _, cfg = _cfgs("seq")
    trunk = {k: v for k, v in lm_state_dict_from_jax(params, jcfg).items()
             if k.startswith("pianobart.")}
    if form == "reference":
        path = str(tmp_path / "trunk.ckpt")
        jexport.save_torch_checkpoint(jexport.export_trunk(params["pianobart"], jcfg),
                                      path)
    else:
        path = str(tmp_path / "pretrain")
        lm = PianoBartLM(cfg, device="cpu")
        lm.load_state_dict(lm_state_dict_from_jax(params, jcfg))
        CheckpointManager(path).save(1, create_train_state(lm), {}, True)
    model = init_model(SequenceClassification, cfg, seed=2, device="cpu",
                       class_num=C)
    drawn = {k: v.clone() for k, v in model.state_dict().items()}

    class Args:
        ckpt, nopretrain = path, False
    assert cli._load_init_ckpt(model, Args) is model
    for k, v in model.state_dict().items():
        assert torch.equal(v, trunk[k] if k.startswith("pianobart.") else drawn[k]), k
    with pytest.raises(ValueError, match="matches a parameter"):
        graft_(model, {"lm_head.proj.bias": torch.zeros(3)}, "other")
