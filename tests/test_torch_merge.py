"""Model merging of the port against the JAX package's.

* Every method of ``merge/methods.py`` on the same weights (a JAX LM and
  two perturbed copies, carried across by ``lm_state_dict_from_jax``):
  average, task arithmetic and the magnitude mask to rtol 1e-6, TIES with
  the same kept set to rtol 1e-6, the Fisher weights (JAX's template head
  passed across) to rtol 1e-4 and the Fisher merge to 1e-5, the RegMean
  Grams (every Dense found, keys mapped) to 1e-5 and the RegMean merge to
  1e-4.
* The random DARE mask by distribution: the kept fraction within 4 sigma
  of the binomial, survivors exactly x/(1-p), different masks across
  models, the delta format adding the pretrained weights back exactly.
* Both CLIs' ``merge`` on the same reference ``.ckpt`` files (written by
  the JAX exporters) give ``.msgpack`` trees that agree for every
  deterministic method; each package loads the other's file (and its own)
  with JAX's logits, through every entry point that takes ``--ckpt``; the
  refusals.

f32 on both sides, JAX at ``highest`` matmul precision (tests/conftest.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from pianobart_tpu import merge as jm
from pianobart_tpu import vocab as JV
from pianobart_tpu.compat import torch_export as jexport
from pianobart_tpu.merge import cli as jmerge_cli
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import SequenceClassification as JaxSeq
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.train.state import load_merged_msgpack as jax_load_merged
from pianobart_tpu_torch import cli
from pianobart_tpu_torch import merge as pm
from pianobart_tpu_torch.compat.from_jax import (init_lm, init_model,
                                                 lm_state_dict_from_jax)
from pianobart_tpu_torch.decode import load_inference_model
from pianobart_tpu_torch.merge import cli as pmerge_cli
from pianobart_tpu_torch.models import TokenClassification, tiny_config
from pianobart_tpu_torch.serve.app import GenerationService
from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
from tests.test_torch_train import make_batch

torch.set_num_threads(2)
S = 32
# one layer each; the fusion Dense takes 8 * 16 inputs, fewer than the 256
# rows of the statistics' data, so its RegMean system is well posed
DIMS = dict(encoder_layers=1, decoder_layers=1)
JCFG, CFG = jax_tiny_config(**DIMS), tiny_config(**DIMS)
T = "pianobart."


def _init(module, *sample, seed=0):
    return fnn.meta.unbox(module.init(jax.random.PRNGKey(seed), *sample))["params"]


def _lm_params(seed=0):
    ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
    return _init(JaxLM(JCFG), ids, ids, ones, ones, seed=seed)


def _perturbed(params, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)


@pytest.fixture(scope="module")
def weights():
    """JAX trees (pretrained, two finetunes) and their port trunks."""
    pre = jax.tree.map(np.asarray, _lm_params(0))
    fins = [_perturbed(pre, 1), _perturbed(pre, 2)]
    port = [_trunk(lm_state_dict_from_jax(p, JCFG)) for p in [pre] + fins]
    return {"jax": [pre] + fins, "port": port}


def _trunk(sd):
    return {k[len(T):]: v for k, v in sd.items() if k.startswith(T)}


def _port_of(jax_trunk):
    """A JAX trunk tree (or a tree of its shape) in the port's names."""
    return _trunk(lm_state_dict_from_jax({"pianobart": jax_trunk}, JCFG))


def _assert_close(port, jax_trunk, rtol, atol=0.0):
    want = _port_of(jax_trunk)
    assert set(port) == set(want)
    for k in want:
        np.testing.assert_allclose(port[k].double().numpy(), want[k].double().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("method", ["average", "task_arithmetic", "magnitude_delta",
                                    "magnitude_finetuned"])
def test_deterministic_methods_match_jax(weights, method):
    (jpre, *jfins), (ppre, *pfins) = ([p["pianobart"] for p in weights["jax"]],
                                      weights["port"])
    if method == "average":
        got, want = pm.average_merging(pfins), jm.average_merging(jfins)
    elif method == "task_arithmetic":
        got = pm.task_arithmetic(ppre, pfins, 0.7)
        want = jm.task_arithmetic(jpre, jfins, 0.7)
    else:
        fmt = method.split("_")[1] + "_weight"
        got = pm.mask_model_weights(pfins[0], ppre, fmt, 0.8, True, "magnitude")
        want = jm.mask_model_weights(jfins[0], jpre, fmt, 0.8, True, "magnitude")
    _assert_close(got, want, rtol=1e-6)


@pytest.mark.parametrize("rate,scaling", [(0.8, 1.0), (0.5, 0.7), (0.0, 1.0)])
def test_ties_matches_jax(weights, rate, scaling):
    """The same entries survive the trim and the sign election; the merged
    values agree to rtol 1e-6, and to 1e-8 absolute where pre + delta
    cancels to near zero (JAX adds and divides in float64, the port in
    float32)."""
    (jpre, *jfins), (ppre, *pfins) = ([p["pianobart"] for p in weights["jax"]],
                                      weights["port"])
    got = pm.ties_merging(ppre, pfins, rate, scaling)
    want = _port_of(jm.ties_merging(jpre, jfins, rate, scaling))
    for k in want:
        kept_got = (got[k].double() - ppre[k].double()) != 0
        kept_want = (want[k].double() - ppre[k].double()) != 0
        assert torch.equal(kept_got, kept_want), k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=k)
    n_kept = sum(int(((got[k] - ppre[k]) != 0).sum()) for k in got)
    total = sum(v.numel() for v in got.values())
    assert 0 < n_kept < total if rate > 0 else n_kept > 0.9 * total


def test_ties_sign_election_and_majority():
    """The JAX package's case: both positive -> their mean; a zero sum ->
    the majority sign keeps the positive entry."""
    pre = {"w": torch.zeros(4)}
    m1 = {"w": torch.tensor([1.0, -1.0, 2.0, 0.0])}
    m2 = {"w": torch.tensor([3.0, 1.0, -0.5, 0.0])}
    out = pm.ties_merging(pre, [m1, m2], param_value_mask_rate=0.0)
    want = jm.ties_merging({"w": np.zeros(4)}, [{"w": m1["w"].numpy()},
                                                 {"w": m2["w"].numpy()}], 0.0)
    np.testing.assert_allclose(out["w"].numpy(), want["w"], rtol=1e-6)
    assert out["w"][0] == 2.0 and out["w"][1] == 1.0 and out["w"][2] == 2.0


def _batches(seed=3, n=8):
    """Pretrain windows in batches of 4, two of them with a pad tail."""
    rng = np.random.default_rng(seed)
    x = make_batch(rng, n, S).astype(np.int64)
    x[1, 20:] = JV.PAD
    x[5, 9:] = JV.PAD
    return [x[i:i + 4] for i in range(0, n, 4)]


@pytest.fixture(scope="module")
def jax_head():
    """JAX's seed-0 template LM head, in the port's names."""
    return lm_state_dict_from_jax({"lm_head": jmerge_cli._lm_template(JCFG)["lm_head"]},
                                  JCFG)


@pytest.fixture(scope="module")
def fishers(weights, jax_head):
    """Fisher weights of both finetunes from both packages."""
    batches = _batches()
    jtr = [p["pianobart"] for p in weights["jax"][1:]]
    jf = [jm.compute_fisher_weights(jmerge_cli._lm_grad_fn(JCFG, t), t, batches)
          for t in jtr]
    grad_fn = pmerge_cli._lm_grad_fn(CFG, jax_head, "cpu")
    pf = [pm.compute_fisher_weights(grad_fn, t, batches) for t in weights["port"][1:]]
    return jf, pf


def test_fisher_weights_match_jax(fishers):
    """Squared LM-loss gradients over the real rows, averaged over the
    batches in float64, under JAX's template head (rtol 1e-4)."""
    jf, pf = fishers
    for j, p in zip(jf, pf):
        want = _port_of(j)
        assert set(p) == set(want)
        for k in want:
            assert p[k].dtype == torch.float64
            np.testing.assert_allclose(p[k].numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-10, err_msg=k)
        assert max(float(v.max()) for v in p.values()) > 1e-5


@pytest.mark.parametrize("normalize", [True, False])
def test_fisher_merging_matches_jax(weights, fishers, normalize):
    jf, _ = fishers
    jtr = [p["pianobart"] for p in weights["jax"][1:]]
    got = pm.fisher_merging(weights["port"][1:], [_port_of(f) for f in jf],
                            normalize=normalize)
    want = jm.fisher_merging(jtr, jf, normalize=normalize)
    assert all(v.dtype == torch.float32 for v in got.values())
    _assert_close(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def grams(weights):
    batches = _batches()
    jg = [jmerge_cli._trunk_grams(JCFG, p["pianobart"], batches)
          for p in weights["jax"][1:]]
    pg = [pmerge_cli._trunk_grams(CFG, t, batches, "cpu") for t in weights["port"][1:]]
    return jg, pg


def _gram_key(jax_path):
    """``encoder/layers_0/self_attn/q_proj/kernel`` -> the port's name."""
    parts = jax_path.split("/")
    parts = [p.replace("layers_", "layers.") for p in parts[:-1]] + ["weight"]
    return ".".join(parts)


def test_regmean_grams_match_jax(grams, weights):
    """Every Dense of the trunk is found, and its input Gram agrees (rtol
    1e-5 of the Gram's largest entry: the inputs differ by f32 rounding)."""
    jg, pg = grams
    n_dense = sum(1 for k, v in weights["port"][0].items()
                  if k.endswith(".weight") and v.dim() == 2)
    for j, p in zip(jg, pg):
        assert {_gram_key(k) for k in j} == set(p)
        assert len(p) == n_dense
        for k, v in j.items():
            assert p[_gram_key(k)].dtype == torch.float64
            np.testing.assert_allclose(p[_gram_key(k)].numpy(), v, rtol=1e-5,
                                       atol=1e-5 * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("reduce", [1.0, 0.5])
def test_regmean_merging_matches_jax(grams, weights, reduce):
    """W* = (sum G)^-1 sum G W in float64 on the port's transposed
    weights; everything else averaged (rtol 1e-4)."""
    jg, _ = grams
    jtr = [p["pianobart"] for p in weights["jax"][1:]]
    port_grams = [{_gram_key(k): torch.from_numpy(np.asarray(v)) for k, v in g.items()}
                  for g in jg]
    got = pm.regmean_merging(weights["port"][1:], port_grams, reduce)
    want = jm.regmean_merging(jtr, jg, reduce)
    _assert_close(got, want, rtol=1e-4, atol=1e-7)


def test_regmean_falls_back_to_the_mean_on_a_singular_system():
    w = [{"lin.weight": torch.randn(3, 4, dtype=torch.float64)} for _ in range(2)]
    g = [{"lin.weight": torch.zeros(4, 4, dtype=torch.float64)} for _ in range(2)]
    out = pm.regmean_merging(w, g)
    want = jm.regmean_merging([{"lin": {"kernel": m["lin.weight"].numpy().T}} for m in w],
                              [{"lin/kernel": x["lin.weight"].numpy()} for x in g])
    np.testing.assert_allclose(out["lin.weight"].numpy(), want["lin"]["kernel"].T)


# ------------------------------------------------------------ random DARE
def test_random_mask_by_distribution():
    """Bernoulli drops at rate p: the kept fraction within 4 sigma of the
    binomial, survivors exactly x/(1-p)."""
    p, n = 0.8, 200 * 300
    x = torch.randn(200, 300)
    out = pm.mask_tensor(x, p, True, "random", torch.Generator().manual_seed(0))
    kept = out != 0
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(int(kept.sum()) - n * (1 - p)) <= 4 * sigma
    assert torch.equal(out[kept], x[kept] / (1 - p))
    plain = pm.mask_tensor(x, p, False, "random", torch.Generator().manual_seed(0))
    assert torch.equal(plain[kept], x[kept]) and torch.equal(plain != 0, kept)


def test_random_mask_differs_across_models_and_adds_back_exactly(weights):
    """``seed=i`` per model gives each its own mask; the delta format adds
    the pretrained weights back: a dropped entry is the pretrained one
    exactly, a kept one pre + delta/(1-p)."""
    pre, a, b = weights["port"]
    ma = pm.mask_model_weights(a, pre, "delta_weight", 0.8, True, "random", seed=0)
    mb = pm.mask_model_weights(b, pre, "delta_weight", 0.8, True, "random", seed=1)
    again = pm.mask_model_weights(a, pre, "delta_weight", 0.8, True, "random", seed=0)
    same_mask, entries = 0, 0
    for k in pre:
        assert torch.equal(ma[k], again[k])
        dropped_a, dropped_b = ma[k] == pre[k], mb[k] == pre[k]
        delta = a[k] - pre[k]
        torch.testing.assert_close(ma[k][~dropped_a], (pre[k] + delta / 0.2)[~dropped_a],
                                   rtol=0, atol=0)
        same_mask += int((dropped_a == dropped_b).sum())
        entries += pre[k].numel()
    # two independent 80% masks agree on 0.8^2 + 0.2^2 = 68% of the entries
    assert abs(same_mask / entries - 0.68) < 0.02


# -------------------------------------------------------------------- CLIs
C = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory, weights):
    """Reference .ckpt files written by the JAX exporters: the pretrained
    LM, two finetuned LMs, a composer classifier over the first finetune's
    trunk, a velocity finetune; and pretrain windows for --data."""
    root = tmp_path_factory.mktemp("merge")
    pre, f1, f2 = weights["jax"]
    paths = {}
    for name, params in (("pre", pre), ("gen1", f1), ("gen2", f2)):
        paths[name] = str(root / f"{name}.ckpt")
        jexport.save_torch_checkpoint(jexport.export_lm(params, JCFG), paths[name])
    ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
    seq = _init(JaxSeq(JCFG, C), ids, ones, seed=5)
    seq = {**jax.tree.map(np.asarray, seq), "pianobart": f1["pianobart"]}
    paths["cls"] = str(root / "cls.ckpt")
    jexport.save_torch_checkpoint(jexport.export_sequence_classifier(seq, JCFG),
                                  paths["cls"])
    # a velocity finetune of the port: its trunk reads labels through a
    # LabelEmbedding (a reference .ckpt of it imports as a plain trunk)
    vel = init_model(TokenClassification, CFG.replace(decoder_label_vocab=C + 1),
                     seed=6, device="cpu", class_num=C + 1)
    paths["vel"] = str(root / "vel")
    CheckpointManager(paths["vel"]).save(1, create_train_state(vel), {}, is_best=True)
    data = np.concatenate(_batches(seed=7, n=12))
    paths["data"] = str(root / "windows.npy")
    np.save(paths["data"], data)
    paths["root"] = root
    return paths


def _merge_argv(files, method, out, *extra, models=("gen1", "gen2"), pretrained="pre"):
    argv = ["merge", "--models", *[files[m] for m in models], "--method", method,
            "--output", out, "--data", files["data"], "--num_examples", "10", *extra]
    if pretrained:
        argv += ["--pretrained", files[pretrained]]
    return argv


def _run_jax(argv, monkeypatch):
    from pianobart_tpu import cli as jcli
    monkeypatch.setattr(jmerge_cli, "PianoBartConfig", lambda: JCFG)
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


def _run_port(argv, monkeypatch, head):
    monkeypatch.setattr(pmerge_cli, "_template_head", lambda cfg: head)
    args = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    return pmerge_cli.run_merge(args, CFG)


def _read(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


CLI_CASES = {
    "average_merging": ([], 1e-6),
    "task_arithmetic": (["--scaling_coefficient", "0.7"], 1e-6),
    "ties_merging": (["--param_value_mask_rate", "0.6"], 1e-6),
    "magnitude_average": (["--mask_strategy", "magnitude"], 1e-6),
    "magnitude_ties": (["--mask_strategy", "magnitude", "--mask_apply_method",
                        "ties_merging"], 1e-6),
    "fisher_merging": ([], 1e-5),
    "regmean_merging": ([], 1e-4),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_merge_clis_agree(case, files, jax_head, monkeypatch, tmp_path):
    """Both packages' ``merge`` on the same files: the same tree (flax
    layout, keys and shapes), values within the method's tolerance relative
    to each entry and to the leaf's largest magnitude (the data-aware
    methods' statistics differ by f32 rounding, which a solve carries to
    entries near zero); the port's leaves are float32."""
    extra, rtol = CLI_CASES[case]
    method = case if not case.startswith("magnitude") else "mask_merging"
    jout, pout = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    _run_jax(_merge_argv(files, method, jout, *extra), monkeypatch)
    assert _run_port(_merge_argv(files, method, pout, *extra), monkeypatch,
                     jax_head) == pout
    want, got = _flat(_read(jout)), _flat(_read(pout))
    assert set(got) == set(want) and all(k.startswith("pianobart/") for k in got)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                   atol=rtol * np.abs(want[k]).max(), err_msg=k)


def _jax_logits(path, x, mask):
    """JAX's LM from a merged file, grafted onto its template as ``pbx
    serve``/``demo`` load it."""
    params = jax_load_merged(path, jmerge_cli._lm_template(JCFG))
    return np.asarray(JaxLM(JCFG).apply({"params": params}, jnp.asarray(x),
                                        jnp.asarray(x), jnp.asarray(mask),
                                        jnp.asarray(mask)))


@pytest.fixture(scope="module")
def merged_files(files, jax_head, tmp_path_factory):
    """TIES merges with ``--head_from gen1`` by both packages."""
    mp = pytest.MonkeyPatch()
    try:
        root = tmp_path_factory.mktemp("merged")
        out = {"jax": str(root / "jax.msgpack"), "port": str(root / "port.msgpack")}
        extra = ["--head_from", files["gen1"]]
        _run_jax(_merge_argv(files, "ties_merging", out["jax"], *extra), mp)
        _run_port(_merge_argv(files, "ties_merging", out["port"], *extra), mp, jax_head)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_file(writer, merged_files):
    """A merged file with its head loads into the port through every entry
    point that takes ``--ckpt`` (``load_inference_model``: ``eval-gen``,
    ``demo``; the service: ``serve``; ``_load_init_ckpt``: ``finetune``,
    ``pretrain``) with the logits of JAX's model loaded from the same file
    (rtol 1e-5), and JAX's loader takes the port's file."""
    path = merged_files[writer]
    rng = np.random.default_rng(11)
    x = make_batch(rng, 2, S).astype(np.int64)
    mask = np.ones((2, S), np.float32)
    want = _jax_logits(path, x, mask)
    svc = GenerationService(cfg=CFG, ckpt=path, device="cpu")
    svc._ensure()

    class Args:
        ckpt, nopretrain = path, False
    models = {"load_inference_model": load_inference_model(CFG, path, device="cpu"),
              "service": svc.model,
              "_load_init_ckpt": cli._load_init_ckpt(init_lm(CFG, seed=9, device="cpu"),
                                                     Args)}
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for name, model in models.items():
        with torch.no_grad():
            got = model.eval()(xt, xt, mt, mt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)
    assert set(_read(path)) == {"pianobart", "lm_head"}


def test_head_from_bundles_the_donor_head(merged_files, files):
    """``--head_from`` bundles the LM head of that checkpoint exactly (f32)."""
    from pianobart_tpu_torch.compat.torch_import import import_checkpoint
    donor = import_checkpoint(files["gen1"], CFG)
    got = lm_state_dict_from_jax({"lm_head": _read(merged_files["port"])["lm_head"]}, CFG)
    assert set(got) == {k for k in donor if k.startswith("lm_head.")}
    for k, v in got.items():
        assert torch.equal(v, donor[k].float()), k


@pytest.mark.parametrize("method,extra", [
    ("task_arithmetic", []), ("ties_merging", []),
    ("mask_merging", ["--mask_apply_method", "ties_merging"])])
def test_merge_refuses_without_pretrained(method, extra, files, jax_head,
                                          monkeypatch, tmp_path):
    """Methods that subtract a base model need --pretrained: both packages
    raise with the same words before writing anything."""
    out = str(tmp_path / "m.msgpack")
    argv = _merge_argv(files, method, out, *extra, pretrained=None)
    with pytest.raises(SystemExit, match="--pretrained") as jexc:
        _run_jax(argv, monkeypatch)
    with pytest.raises(SystemExit, match="--pretrained") as pexc:
        _run_port(argv, monkeypatch, jax_head)
    assert str(pexc.value) == str(jexc.value)
    assert not (tmp_path / "m.msgpack").exists()


def test_merge_refuses_mismatched_trunks_and_a_headless_donor(files, jax_head,
                                                              monkeypatch, tmp_path):
    """A velocity finetune (its label decoder) beside an LM trunk raises a
    clear error; ``--head_from`` a classifier, which has no LM head, raises
    with JAX's words."""
    out = str(tmp_path / "m.msgpack")
    with pytest.raises(SystemExit, match="trunks differ"):
        _run_port(_merge_argv(files, "average_merging", out, models=("gen1", "vel")),
                  monkeypatch, jax_head)
    with pytest.raises(SystemExit, match="does not carry this head"):
        _run_port(_merge_argv(files, "average_merging", out, "--head_from",
                              files["cls"]), monkeypatch, jax_head)
    assert not (tmp_path / "m.msgpack").exists()
    # the classifier's trunk itself merges: only its head is not an LM's
    assert _run_port(_merge_argv(files, "average_merging", out,
                                 models=("gen1", "cls")), monkeypatch, jax_head) == out


def test_merge_cli_takes_the_jax_flags():
    """The JAX parser's flags and defaults, ``--use_weight_rescale`` as a
    BooleanOptionalAction, plus ``--device``."""
    from pianobart_tpu import cli as jcli
    argv = ["merge", "--models", "a", "b"]
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") is None
    assert {k: v for k, v in got.items() if k != "fn"} == \
        {k: v for k, v in want.items() if k != "fn"}
    assert cli.build_parser().parse_args(argv + ["--no-use_weight_rescale"]
                                         ).use_weight_rescale is False
