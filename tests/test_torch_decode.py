"""The port's decode loop and sampler against the JAX package's.

Greedy decode (top_p = 1 on every field) must match JAX token for token at
tiny f32 (logits agree to ~1e-6, far below the gaps argmax decides on).
Sampling uses different random streams, so it is compared by distribution:
total-variation distance < 0.08 on the p=0.9 fields over 4000 draws, and
exact greedy picks on the p=1 fields (as tests/test_decode.py does).
"""
import jax
import numpy as np
import pytest
import torch

from pianobart_tpu.decode import generate as jax_generate
from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu.ops.sampling import sample_octuple as jax_sample_octuple
from pianobart_tpu_torch import vocab as V
from pianobart_tpu_torch.compat.from_jax import lm_state_dict_from_jax
from pianobart_tpu_torch.decode import generate
from pianobart_tpu_torch.models import PianoBartLM, tiny_config
from pianobart_tpu_torch.ops.sampling import (DEFAULT_TEMPERATURE,
                                              DEFAULT_TOP_P, greedy_octuple,
                                              sample_octuple)

torch.set_num_threads(2)

GREEDY = (1.0,) * 8


@pytest.fixture(scope="module")
def lm():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30, (2, jcfg.max_len, 8)).astype(np.int32)
    mask = np.ones((2, jcfg.max_len), np.float32)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0), ids, ids, mask, mask)
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(params, jcfg))
    return jcfg, params, model.eval()


@pytest.mark.parametrize("seed,B,force_full", [(0, 2, False), (0, 2, True),
                                               (5, 3, False)])
def test_greedy_decode_matches_jax(lm, seed, B, force_full):
    jcfg, params, model = lm
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 30, (B, jcfg.max_len, 8)).astype(np.int32)
    ids[-1, jcfg.max_len - 5:] = np.asarray(V.PAD)      # a padded tail
    want = np.asarray(jax_generate(params, ids, cfg=jcfg, top_p=GREEDY,
                                   force_full=force_full))
    got = generate(model, torch.from_numpy(ids), top_p=GREEDY,
                   force_full=force_full, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    content = ~(got == np.asarray(V.PAD)).all(-1)
    if force_full:
        assert content.all()
    else:   # an early stop: some rows written, the rest left as PAD rows
        assert 0 < content.sum(1).min() and content.sum(1).max() < jcfg.max_len


def test_sample_octuple_matches_jax_by_distribution(lm):
    jcfg = lm[0]
    cfg = tiny_config()
    logits = np.random.default_rng(7).standard_normal((1, cfg.total_vocab)) * 2.0
    logits = logits.astype(np.float32)
    N = 4000
    gen = torch.Generator().manual_seed(1)
    got = sample_octuple(gen, torch.from_numpy(np.repeat(logits, N, 0)), cfg,
                         DEFAULT_TEMPERATURE, DEFAULT_TOP_P).numpy()
    want = np.asarray(jax_sample_octuple(
        jax.random.PRNGKey(2), np.repeat(logits, N, 0), jcfg,
        DEFAULT_TEMPERATURE, DEFAULT_TOP_P))
    assert got.shape == (N, 8) and got.dtype == np.int32
    for f in (3, 4, 7):                                     # the p=0.9 fields
        a = np.bincount(got[:, f], minlength=cfg.field_sizes[f]) / N
        b = np.bincount(want[:, f], minlength=cfg.field_sizes[f]) / N
        tv = 0.5 * np.abs(a - b).sum()
        assert tv < 0.08, (f, tv)
    greedy = greedy_octuple(torch.from_numpy(logits), cfg).numpy()[0]
    for f in (0, 1, 2, 5, 6):                               # p=1 -> greedy
        assert (got[:, f] == greedy[f]).all()
        assert (want[:, f] == greedy[f]).all()


def test_max_steps_beyond_window_raises(lm):
    model = lm[2]
    ids = torch.zeros((1, model.cfg.max_len, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds"):
        generate(model, ids, max_steps=model.cfg.max_len + 1, device="cpu")


def test_generate_refuses_a_device_the_model_is_not_on(lm):
    model = lm[2]
    ids = torch.zeros((1, model.cfg.max_len, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="lives on"):
        generate(model, ids, device="meta")
