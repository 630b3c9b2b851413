"""The port's fused dropout + residual + LayerNorm (``ops/fused_ln.py``, K4)
against the JAX package's ``dropout_add_ln`` run in interpret mode, as
tests/test_fused_ln.py runs it: both sides take the reference's host bits
(``_host_bits``), the port's plain version through ``bits=``.  Plus the
port's own Philox generator, the autograd Function on the CPU and the
model's switch.

Tolerances: f32 rtol/atol 1e-5 (f32 summation order and rsqrt only); bf16
outputs within one bf16 step of each element (the f32 results round to
bf16 on both sides, and may round apart where they differ by an ulp), plus
1e-6 for entries near 0, where ``xhat * gamma + beta`` cancels terms of
order 1 and the f32 ulps of those terms are all that is left.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.ops.fused_ln import _host_bits
from pianobart_tpu.ops.fused_ln import _keep_scale as jax_keep_scale
from pianobart_tpu.ops.fused_ln import _threshold as jax_threshold
from pianobart_tpu.ops.fused_ln import dropout_add_ln as jax_dropout_add_ln
from pianobart_tpu.ops.fused_ln import fused_eligible as jax_fused_eligible
from pianobart_tpu_torch.models import tiny_config
from pianobart_tpu_torch.models.bart import ResidualDropoutLN
from pianobart_tpu_torch.ops import fused_ln as F

torch.set_num_threads(2)

B, S, D = 2, 128, 256
SEED = 7
TOL = dict(rtol=1e-5, atol=1e-5)
# (dtype, rate, D): D = 256 at (B, S) rows; the rows K4 splits across warps
# on the card (D > 1024) at 128 rows, as (1, 128, D)
CASES = [(np.float32, 0.1, D), (jnp.bfloat16, 0.1, D), (np.float32, 0.0, D),
         (np.float32, 0.1, 1152), (jnp.bfloat16, 0.1, 1152),
         (np.float32, 0.1, 2048), (jnp.bfloat16, 0.1, 2048)]
CASE_IDS = ["f32", "bf16", "rate0", "f32-D1152", "bf16-D1152", "f32-D2048",
            "bf16-D2048"]


def _shape(d):
    return (B, S, d) if d == D else (1, 128, d)


def _inputs(dtype, seed=0, d=D):
    B, S, D = _shape(d)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    res = rng.standard_normal((B, S, D)).astype(np.float32)
    gamma = np.linspace(0.5, 1.5, D, dtype=np.float32)
    beta = np.linspace(-0.2, 0.2, D, dtype=np.float32)
    jh, jr = (jnp.asarray(x, dtype=dtype) for x in (h, res))
    th, tr = (torch.from_numpy(np.array(x.astype(jnp.float32))) for x in (jh, jr))
    if dtype == jnp.bfloat16:
        th, tr = th.to(torch.bfloat16), tr.to(torch.bfloat16)
    return (jh, jr, jnp.asarray(gamma), jnp.asarray(beta)), \
        (th, tr, torch.from_numpy(gamma), torch.from_numpy(beta))


def _host(seed, d=D):
    B, S, D = _shape(d)
    return torch.from_numpy(np.asarray(_host_bits(jnp.uint32(seed), B * S, D))
                            .astype(np.int64))


def _assert_close(got, want, dtype, name):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    if dtype == jnp.bfloat16:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= step + 1e-6).all(), \
            f"{name}: max|d| {np.abs(got - want).max():.3e}"
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def test_quantisation_matches_jax():
    for rate in (0.0, 1e-9, 0.1, 0.5):
        assert F.threshold(rate) == jax_threshold(rate)
        assert F.keep_scale(rate) == jax_keep_scale(rate)


@pytest.mark.parametrize("dtype,rate,d", CASES, ids=CASE_IDS)
def test_forward_matches_jax(dtype, rate, d):
    """The plain K4a fed the reference's bits == JAX's dropout_add_ln."""
    jargs, targs = _inputs(dtype, d=d)
    want = jax_dropout_add_ln(*jargs, jnp.uint32(SEED), rate)
    out, mean, rstd = F.dropout_add_ln_reference(*targs, None, rate,
                                                 bits=_host(SEED, d))
    shape = _shape(d)
    assert out.dtype == targs[0].dtype and out.shape == shape
    assert mean.shape == rstd.shape == (shape[0] * shape[1],)
    _assert_close(out, want, dtype, "out")


@pytest.mark.parametrize("dtype,rate,d", CASES, ids=CASE_IDS)
def test_backward_matches_jax_vjp(dtype, rate, d):
    """The plain K4b fed the reference's bits == jax.vjp of JAX's
    dropout_add_ln (its Pallas backward in interpret mode): dh, dres,
    dgamma, dbeta.  dgamma and dbeta are f32 sums over 256 rows: 1e-5 in
    f32; in the bf16 case 1e-4 relative (the same bf16 inputs, f32 sums of
    terms of both signs in another order)."""
    jargs, targs = _inputs(dtype, seed=1, d=d)
    dout = np.random.default_rng(2).standard_normal(_shape(d)).astype(np.float32)
    jdout = jnp.asarray(dout, dtype=dtype)
    _, vjp = jax.vjp(lambda h, r, g, b: jax_dropout_add_ln(
        h, r, g, b, jnp.uint32(SEED), rate), *jargs)
    want = vjp(jdout)
    bits = _host(SEED, d)
    _, mean, rstd = F.dropout_add_ln_reference(*targs, None, rate, bits=bits)
    tdout = torch.from_numpy(np.array(jdout.astype(jnp.float32))).to(targs[0].dtype)
    got = F.dropout_add_ln_bwd_reference(targs[0], targs[1], targs[2], mean, rstd,
                                         tdout, None, rate, bits=bits)
    for name, a, b in zip(("dh", "dres"), got[:2], want[:2]):
        assert a.dtype == targs[0].dtype
        _assert_close(a, b, dtype, name)
    tol = TOL if dtype == np.float32 else dict(rtol=1e-4, atol=1e-4)
    for name, a, b in zip(("dgamma", "dbeta"), got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)


def test_near_constant_large_rows_stay_finite():
    """The rows of tests/test_fused_ln.py whose unclamped f32 variance falls
    below -eps: both packages stay finite, and the port's variance is
    clamped at 0 (rstd <= eps^-1/2).  Their values are f32 round-off of a
    1e5 mean, which each side sums in its own order, so only finiteness is
    compared."""
    rng = np.random.default_rng(66)
    res = (1e5 + rng.normal(0, 0.1, (B, S, D))).astype(np.float32)
    h = np.zeros((B, S, D), np.float32)
    gamma, beta = np.ones(D, np.float32), np.zeros(D, np.float32)
    want = jax_dropout_add_ln(jnp.asarray(h), jnp.asarray(res), jnp.asarray(gamma),
                              jnp.asarray(beta), jnp.uint32(3), 0.0)
    out, _, rstd = F.dropout_add_ln_reference(
        *(torch.from_numpy(x) for x in (h, res, gamma, beta)), 3, 0.0)
    assert np.isfinite(np.asarray(want)).all()
    assert torch.isfinite(out).all() and torch.isfinite(rstd).all()
    assert rstd.max().item() <= F.LN_EPS ** -0.5 * (1 + 1e-6)


@pytest.mark.parametrize("shape", [
    (32, 1024, 1024), (2, 128, 256), (1, 128, 128), (3, 128, 256), (4, 96, 128),
    (32, 1024, 1000), (1, 100, 1024), (256, 64), (100, 128), (2, 2048, 1024),
    (2, 64, 1152), (1, 128, 2048)])
def test_fused_eligible_matches_jax(shape):
    assert F.fused_eligible(shape) == jax_fused_eligible(shape)


def test_philox_bits_deterministic_and_seeded():
    a = F.philox_bits(SEED, 64, 256)
    assert a.dtype == torch.int64 and a.shape == (64, 256)
    assert int(a.min()) >= 0 and int(a.max()) < 2 ** 32
    assert torch.equal(a, F.philox_bits(torch.tensor([SEED]), 64, 256))
    assert (a != F.philox_bits(SEED + 1, 64, 256)).float().mean() > 0.99
    assert (a != F.philox_bits(SEED + 2 ** 32, 64, 256)).float().mean() > 0.99


def test_philox_keep_fraction():
    """Over 2^20 elements the keep fraction at rate 0.1 lies within 5 sigma
    of 1 - t / 2^32, and survivors scaled by keep_scale average to 1."""
    n, d = 1024, 1024
    t = F.threshold(0.1)
    p = 1.0 - t / 2.0 ** 32
    keep = F.philox_bits(123, n, d) >= t
    frac = keep.double().mean().item()
    assert abs(frac - p) <= 5 * (p * (1 - p) / (n * d)) ** 0.5
    assert abs(frac * F.keep_scale(0.1) - 1.0) < 5e-3


def test_philox_bits_do_not_depend_on_blocking():
    """Rows 37..100 made alone equal the same rows of the whole."""
    whole = F.philox_bits(SEED, 160, 384)
    assert torch.equal(F.philox_bits(SEED, 64, 384, row0=37), whole[37:101])


def test_autograd_function_on_cpu_gives_the_plain_backward():
    """dropout_add_ln on CPU tensors: K4a's and K4b's plain versions, with
    the Philox bits of its seed, and no kernel launch counted."""
    _, (h, r, g, b) = _inputs(np.float32, seed=3)
    seed = torch.tensor([2 ** 40 + 11])
    leaves = [x.clone().requires_grad_() for x in (h, r, g, b)]
    dout = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, D))
                            .astype(np.float32))
    f0, b0 = F.dropout_add_ln_fwd.launches, F.dropout_add_ln_bwd.launches
    out = F.dropout_add_ln(*leaves, seed, 0.1)
    assert type(out.grad_fn).__name__ == "_DropoutAddLNBackward"
    out.backward(dout)
    want, mean, rstd = F.dropout_add_ln_reference(h, r, g, b, seed, 0.1)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    grads = F.dropout_add_ln_bwd_reference(h, r, g, mean, rstd, dout, seed, 0.1)
    for name, leaf, w in zip(("dh", "dres", "dgamma", "dbeta"), leaves, grads):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0, msg=name)
    assert (F.dropout_add_ln_fwd.launches, F.dropout_add_ln_bwd.launches) == (f0, b0)
    # the keep decisions are the seed's Philox bits
    keep = F.philox_bits(seed, B * S, D) >= F.threshold(0.1)
    assert torch.equal(leaves[0].grad.reshape(-1, D) != 0, keep)


@pytest.mark.parametrize("fused,train,rate,rows,expect", [
    (True, True, 0.1, 128, True), (False, True, 0.1, 128, False),
    (True, False, 0.1, 128, False), (True, True, 0.0, 128, False),
    (True, True, 0.1, 96, False)])
def test_model_switch(fused, train, rate, rows, expect, monkeypatch):
    """ResidualDropoutLN takes dropout_add_ln exactly where the reference's
    gate (minus its TPU test) would: the switch on, training, a nonzero rate
    and an eligible shape; a seed per call drawn from the generator."""
    import pianobart_tpu_torch.models.bart as bart
    calls = []
    real = bart.dropout_add_ln
    monkeypatch.setattr(bart, "dropout_add_ln",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    cfg = tiny_config(d_model=128, dropout=rate, fused_dropout_ln=fused)
    mod = ResidualDropoutLN(cfg, device="cpu").train(train)
    x = torch.randn(1, rows, 128)
    gen = torch.Generator().manual_seed(0)
    out = mod(x, torch.randn(1, rows, 128), gen)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert bool(calls) == expect
    if expect:
        assert calls[0].dtype == torch.int64 and calls[0].shape == (1,)
        mod(x, x, gen)
        assert not torch.equal(calls[0], calls[1])


@pytest.mark.parametrize("d", [8320, 16384])
def test_model_refuses_a_fused_tail_wider_than_the_kernel_on_cuda(d, monkeypatch):
    """The reference's gate takes its kernel at any 128-multiple D, K4 on
    the card only up to MAX_D.  So a wider fused model is refused when it is
    built on CUDA (before anything is allocated there, so this runs without
    a card); on the CPU it builds and takes the plain K4."""
    import pianobart_tpu_torch.models.bart as bart
    assert d > F.MAX_D and jax_fused_eligible((1, 128, d))
    cfg = tiny_config(d_model=d, dropout=0.1, fused_dropout_ln=True)
    with pytest.raises(ValueError, match=f"MAX_D = {F.MAX_D}"):
        ResidualDropoutLN(cfg, device="cuda")
    calls = []
    real = bart.dropout_add_ln
    monkeypatch.setattr(bart, "dropout_add_ln",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    mod = ResidualDropoutLN(cfg, device="cpu").train()
    x = torch.randn(1, 128, d)
    out = mod(x, torch.randn(1, 128, d), torch.Generator().manual_seed(0))
    assert len(calls) == 1 and torch.isfinite(out).all()


def test_fused_tail_equals_unfused_at_a_tiny_rate():
    """At rate 1e-9 neither dropout drops an element here (K4's threshold is
    4 / 2^32 over 32,768 elements; the uint8 one is 0), so the fused and the
    unfused tails compute the same LayerNorm: f32, 1e-5."""
    cfg = tiny_config(d_model=256, dropout=1e-9)
    mods = [ResidualDropoutLN(cfg.replace(fused_dropout_ln=f), device="cpu").train()
            for f in (True, False)]
    rng = np.random.default_rng(9)
    x, h = (torch.from_numpy(rng.standard_normal((1, 128, 256)).astype(np.float32))
            for _ in range(2))
    outs = [m(x, h, torch.Generator().manual_seed(1)) for m in mods]
    torch.testing.assert_close(outs[0], outs[1], **TOL)
