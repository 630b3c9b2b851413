"""The port's PianoBartLM against the JAX package's, weights carried across
with ``lm_state_dict_from_jax``.

Tolerance 1e-4 (rtol and atol), f32: both sides compute in f32 (JAX at
``highest`` matmul precision) and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu_torch.compat.from_jax import lm_state_dict_from_jax
from pianobart_tpu_torch.models import PianoBartLM, tiny_config
from pianobart_tpu_torch.ops import flash as port_flash

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _ids(rng, B, S):
    return rng.integers(0, 30, (B, S, 8)).astype(np.int32)


def _carry(jax_params, jcfg, cfg):
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(lm_state_dict_from_jax(jax_params, jcfg))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    rng = np.random.default_rng(0)
    ids = _ids(rng, 2, jcfg.max_len)
    mask = np.ones((2, jcfg.max_len), np.float32)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(0), ids, ids, mask, mask)
    return jcfg, cfg, params, _carry(params, jcfg, cfg)


def test_state_dict_covers_every_parameter(tiny):
    """The carried state dict names every parameter, and every parameter
    lives in ``param_dtype`` whatever the compute dtype, as flax's
    ``Dense(dtype, param_dtype)`` and ``LayerNorm`` keep them."""
    jcfg, cfg, params, model = tiny
    sd = lm_state_dict_from_jax(params, jcfg)
    assert set(sd) == set(model.state_dict())
    bf = PianoBartLM(cfg.replace(dtype=torch.bfloat16), device="cpu")
    bf.load_state_dict(sd)
    assert {p.dtype for p in bf.parameters()} == {torch.float32}
    assert bf.pianobart.encoder.layers[0].final_layer_norm.weight.dtype == torch.float32
    assert bf.pianobart.embed.table.dtype == torch.float32
    assert bf.lm_head.proj.weight.dtype == torch.float32
    assert bf.pianobart.decoder.embed_positions.embedding.dtype == torch.float32


def test_bf16_compute_keeps_f32_weights_and_computes_in_bf16(tiny):
    """f32 weights under bf16 compute: activations come out bf16, the
    gradients land on the f32 weights, and an AdamW-sized step of 2e-5 on a
    0.02-sized weight survives (it would round away in a bf16 weight)."""
    jcfg, cfg, params, _ = tiny
    bf = PianoBartLM(cfg.replace(dtype=torch.bfloat16), device="cpu")
    bf.load_state_dict(lm_state_dict_from_jax(params, jcfg))
    ids = torch.from_numpy(_ids(np.random.default_rng(4), 2, cfg.max_len))
    logits = bf(ids, ids)
    assert logits.dtype == torch.bfloat16
    logits.float().square().mean().backward()
    w = bf.lm_head.proj.weight
    assert w.grad is not None and w.grad.dtype == torch.float32
    assert (torch.tensor(0.02) + 2e-5) != 0.02
    assert (torch.tensor(0.02, dtype=torch.bfloat16) + 2e-5).item() == \
        torch.tensor(0.02, dtype=torch.bfloat16).item()


def test_serving_config_keeps_bf16_weights(monkeypatch):
    """The serving default is bf16 weights under bf16 compute, so the decode
    step casts nothing; a bf16-param model holds every parameter in bf16."""
    from pianobart_tpu_torch.compat import from_jax
    from pianobart_tpu_torch.serve.app import GenerationService
    seen = []
    monkeypatch.setattr(from_jax, "init_lm", lambda cfg, *a, **k: seen.append(cfg))
    GenerationService(device="cpu")._ensure()
    assert (seen[0].dtype, seen[0].param_dtype) == (torch.bfloat16, torch.bfloat16)
    serve = PianoBartLM(tiny_config(dtype=torch.bfloat16,
                                    param_dtype=torch.bfloat16), device="cpu")
    assert {p.dtype for p in serve.parameters()} == {torch.bfloat16}


def test_tiny_logits_match_jax(tiny):
    jcfg, cfg, params, model = tiny
    rng = np.random.default_rng(1)
    B, S = 2, jcfg.max_len
    enc, dec = _ids(rng, B, S), _ids(rng, B, S)
    emask = np.ones((B, S), np.float32)
    emask[1, S - 7:] = 0.0
    dmask = np.ones((B, S), np.float32)
    dmask[0, S - 3:] = 0.0
    want = JaxLM(jcfg).apply(params, enc, dec, emask, dmask)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (enc, dec, emask, dmask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_eligible_encoder_matches_jax(monkeypatch):
    """d_model 256, 2 heads of 128, S=256: every encoder self-attention is
    flash-eligible.  JAX runs its Pallas kernel in interpret mode; the port
    takes the flash dispatch, whose wrapper runs the plain version on CPU."""
    monkeypatch.setenv("PBX_FLASH_INTERPRET", "1")
    kw = dict(d_model=256, num_heads=2, max_len=256, encoder_layers=1,
              decoder_layers=1, ffn_dim=512, use_flash_attention=True)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    rng = np.random.default_rng(2)
    B, S = 2, 256
    ids = _ids(rng, B, S)
    mask = np.ones((B, S), np.float32)
    mask[1, S - 40:] = 0.0
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.PRNGKey(1), ids, ids, mask, mask)
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                    method=JaxLM.encode)
    model = _carry(params, jcfg, cfg)
    calls = []
    real = port_flash.flash_attention_reference
    monkeypatch.setattr(port_flash, "flash_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    assert len(calls) == cfg.encoder_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_incremental_decode_matches_full_forward(tiny):
    """KV-cached decode_step, step by step == the teacher-forced forward
    (the port's own counterpart of tests/test_decode.py)."""
    _, cfg, _, model = tiny
    rng = np.random.default_rng(3)
    B, S = 2, cfg.max_len
    enc = torch.from_numpy(_ids(rng, B, S))
    dec = torch.from_numpy(_ids(rng, B, S))
    mask = torch.ones(B, S)
    with torch.no_grad():
        full = model(enc, dec, mask, mask)
        enc_out = model.encode(enc, mask)
        cache = model.build_cache(enc_out, B, S)
        steps = []
        for i in range(S):
            logits, cache = model.decode_step(dec[:, i:i + 1], enc_out, mask,
                                              cache, i)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(steps, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_embedding_gradient_is_the_same_every_run():
    """The tables' gradients on the CPU are bit-equal from run to run with
    several threads (``models/embedding.py:_rows``): a batch of 4 x 1024
    windows repeats ids across 32,768 rows, where an index's backward adds
    them with atomic adds in an order that changes between runs; the
    label table too."""
    from pianobart_tpu_torch.models.embedding import LabelEmbedding, OctupleEmbedding
    cfg = tiny_config()
    rng = np.random.default_rng(12)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for module, ids in (
                (OctupleEmbedding(cfg, device="cpu"),
                 torch.from_numpy(_ids(rng, 4, 1024)).long()),
                (LabelEmbedding(cfg.replace(decoder_label_vocab=16), device="cpu"),
                 torch.from_numpy(rng.integers(0, 16, (64, 1024))).long())):
            torch.nn.init.normal_(module.table)
            grads = []
            for _ in range(8):
                module.zero_grad()
                module(ids).square().sum().backward()
                grads.append(module.table.grad.clone())
            assert all(torch.equal(grads[0], g) for g in grads[1:]), type(module).__name__
    finally:
        torch.set_num_threads(threads)
