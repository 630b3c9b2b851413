"""The port's flash attention (plain versions + CPU dispatch, forward and
backward) against the JAX package's Pallas kernels run in interpret mode, as
tests/test_flash.py runs them, and the plain attention path against
``_xla_attention``.

Tolerance 2e-5 (rtol and atol) in f32: both sides compute in f32 and differ
only in summation order.  The bf16 test states its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.ops.attention import _build_bias as jax_build_bias
from pianobart_tpu.ops.attention import _xla_attention
from pianobart_tpu.ops.flash import _bwd_fused_call as jax_bwd_fused_call
from pianobart_tpu.ops.flash import _delta as jax_delta
from pianobart_tpu.ops.flash import _dkv_call as jax_dkv_call
from pianobart_tpu.ops.flash import _dq_call as jax_dq_call
from pianobart_tpu.ops.flash import _fused_eligible as jax_fused_eligible
from pianobart_tpu.ops.flash import _fwd as jax_fwd
from pianobart_tpu.ops.flash import flash_attention as jax_flash_attention
from pianobart_tpu_torch.ops import attention as port_attention
from pianobart_tpu_torch.ops import flash as port_flash

torch.set_num_threads(2)

B, S, H, D = 2, 256, 2, 128
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[1, S - 40:] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_reference_matches_jax_kernel(causal, use_mask):
    """flash_attention_reference == the Pallas _fwd kernel: O and lse."""
    q, k, v, mask = _inputs()
    m = mask if use_mask else None
    j_out, j_lse, _ = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if m is None else jnp.asarray(m),
                              causal, 128, 128)
    t_out, t_lse = port_flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if m is None else torch.from_numpy(m), causal)
    np.testing.assert_allclose(t_out.numpy().reshape(B, S, H * D),
                               np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_cpu_dispatch_matches_jax_flash(causal, use_mask, monkeypatch):
    """dot_product_attention on CPU tensors takes the flash dispatch (the
    wrapper then runs the plain version) and equals the JAX flash_attention."""
    q, k, v, mask = _inputs(seed=1)
    m = mask if use_mask else None
    calls = []
    real = port_flash.flash_attention_reference
    monkeypatch.setattr(port_flash, "flash_attention_reference",
                        lambda *a: calls.append(1) or real(*a))
    launches = port_flash.flash_attention_fwd.launches
    out = port_attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_mask=None if m is None else torch.from_numpy(m), causal=causal)
    expect = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 None if m is None else jnp.asarray(m), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)
    assert calls == [1]
    # the plain version is not a kernel launch
    assert port_flash.flash_attention_fwd.launches == launches


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_flash_grad_matches_jax_vjp(causal, use_mask):
    """The gradient of the port's flash_attention (autograd Function; on CPU
    its backward runs flash_attention_bwd_reference) equals jax.vjp of the
    JAX flash_attention, whose backward is the fused Pallas kernel K2 in
    interpret mode.  f32, tolerance 2e-5: summation order only."""
    q, k, v, mask = _inputs(seed=3)
    m = mask if use_mask else None
    dout = np.random.default_rng(4).standard_normal((B, S, H, D)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention(
            q_, k_, v_, None if m is None else jnp.asarray(m), causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = port_flash.flash_attention_bwd.launches
    got_out = port_flash.flash_attention(
        tq, tk, tv, None if m is None else torch.from_numpy(m), causal)
    got_out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), **TOL)
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}",
                                   **TOL)
    # the plain version is not a kernel launch
    assert port_flash.flash_attention_bwd.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_bwd_reference_matches_jax_kernel(causal, use_mask):
    """flash_attention_bwd_reference == the Pallas _bwd_fused_call (K2) on
    the same q, k, v, O, lse and dO.  f32, tolerance 2e-5."""
    q, k, v, mask = _inputs(seed=5)
    m = mask if use_mask else None
    dout = np.random.default_rng(6).standard_normal((B, S, H, D)).astype(np.float32)
    out, lse, (qf, kf, vf, maskf) = jax_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m), causal, None, None)
    dof = jnp.asarray(dout).reshape(B, S, H * D)
    want = jax_bwd_fused_call(qf, kf, vf, maskf, dof, lse,
                              jax_delta(dof, out, H), causal, None, None, H)
    got = port_flash.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if m is None else torch.from_numpy(m), causal,
        torch.from_numpy(np.array(out)).reshape(B, S, H, D),
        torch.from_numpy(np.array(lse)), torch.from_numpy(dout))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy().reshape(B, S, H * D), np.asarray(b),
                                   err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_delta_matches_jax(dtype):
    """flash_attention_delta on the CPU (its plain version) == JAX's _delta,
    rowsum(dO * O) in f32 from inputs of either type, (B, H, S)."""
    rng = np.random.default_rng(9)
    dout, out = (np.asarray(jnp.asarray(rng.standard_normal((B, S, H, D)), dtype))
                 .astype(np.float32) for _ in range(2))
    want = jax_delta(jnp.asarray(dout, dtype).reshape(B, S, H * D),
                     jnp.asarray(out, dtype).reshape(B, S, H * D), H)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = port_flash.flash_attention_delta(torch.from_numpy(dout).to(tdt),
                                           torch.from_numpy(out).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _k3_case(causal, use_mask, Sl=128, blk=32):
    """Multi-block inputs for the two-kernel backward: JAX's forward at
    blocks of ``blk`` gives O and lse, and ``_delta`` the external delta."""
    rng = np.random.default_rng(8)
    q, k, v = ((rng.standard_normal((B, Sl, H, D)) * s).astype(np.float32)
               for s in (0.3, 0.3, 1.0))
    mask = np.ones((B, Sl), np.float32)
    mask[1, Sl - 24:] = 0.0
    m = mask if use_mask else None
    dout = rng.standard_normal((B, Sl, H, D)).astype(np.float32)
    out, lse, (qf, kf, vf, maskf) = jax_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if m is None else jnp.asarray(m), causal, blk, blk)
    dof = jnp.asarray(dout).reshape(B, Sl, H * D)
    delta = jax_delta(dof, out, H)
    jax_args = (qf, kf, vf, maskf, dof, lse, delta, causal, blk, blk, H)
    port_args = (*(torch.from_numpy(x) for x in (q, k, v)),
                 None if m is None else torch.from_numpy(m), causal,
                 torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta)),
                 torch.from_numpy(dout))
    return jax_args, port_args, Sl


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_dq_reference_matches_jax_kernel(causal, use_mask):
    """flash_attention_dq (CPU: its plain version, K3a's) == the Pallas
    _dq_call in interpret mode over a 4 x 4 grid of 32-row blocks, from the
    same external lse and delta.  f32, tolerance 2e-5; no launch counted."""
    jax_args, port_args, Sl = _k3_case(causal, use_mask)
    want = jax_dq_call(*jax_args)
    before = port_flash.flash_attention_dq.launches
    got = port_flash.flash_attention_dq(*port_args)
    np.testing.assert_allclose(got.numpy().reshape(B, Sl, H * D), np.asarray(want),
                               **TOL)
    assert port_flash.flash_attention_dq.launches == before


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_dkv_reference_matches_jax_kernel(causal, use_mask):
    """flash_attention_dkv (CPU: K3b's plain version) == the Pallas
    _dkv_call in interpret mode, as above."""
    jax_args, port_args, Sl = _k3_case(causal, use_mask)
    want = jax_dkv_call(*jax_args)
    before = port_flash.flash_attention_dkv.launches
    got = port_flash.flash_attention_dkv(*port_args)
    for name, a, b in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy().reshape(B, Sl, H * D), np.asarray(b),
                                   err_msg=name, **TOL)
    assert port_flash.flash_attention_dkv.launches == before


@pytest.mark.parametrize("sq", [256, 1024, 1152, 2048])
@pytest.mark.parametrize("skv", [256, 1024, 1152, 2048])
def test_fused_eligible_matches_jax(sq, skv):
    """The backward picks K2 exactly where the reference's _bwd_impl picks
    its single-block kernel."""
    assert port_flash._fused_eligible(sq, skv) == jax_fused_eligible(sq, skv,
                                                                     None, None)


def test_long_backward_takes_the_two_kernels(monkeypatch):
    """At S=2048 flash_attention_bwd runs K3a's then K3b's plain versions
    (not K2's) on CPU tensors, and their sum is K2's plain backward."""
    rng = np.random.default_rng(9)
    Sl = 2048
    q, k, v, dout = (torch.from_numpy((rng.standard_normal((1, Sl, 1, D)) * 0.3)
                                      .astype(np.float32)) for _ in range(4))
    out, lse = port_flash.flash_attention_reference(q, k, v, None, True)
    calls = []
    for name in ("flash_attention_dq_reference", "flash_attention_dkv_reference",
                 "flash_attention_bwd_reference"):
        real = getattr(port_flash, name)
        monkeypatch.setattr(port_flash, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    got = port_flash.flash_attention_bwd(q, k, v, None, True, out, lse, dout)
    assert calls == ["flash_attention_dq_reference", "flash_attention_dkv_reference"]
    want = port_flash.flash_attention_bwd_reference(q, k, v, None, True, out, lse,
                                                    dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_flash_attention_differentiates_through_the_function():
    """With grad on, flash_attention goes through the autograd Function (K1
    forward, K2 backward); under no_grad it runs the forward alone."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs())
    out = port_flash.flash_attention(q.requires_grad_(), k, v, mask)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    with torch.no_grad():
        assert port_flash.flash_attention(q, k, v, mask).grad_fn is None


@pytest.mark.parametrize("shape,bias,eligible", [
    ((2, 256, 2, 128), False, True),
    ((2, 1024, 8, 128), False, True),
    ((2, 128, 2, 128), False, False),     # too short
    ((2, 320, 2, 128), False, False),     # not a 128 multiple
    ((2, 256, 2, 64), False, False),      # head width the kernel lacks
    ((2, 256, 2, 256), False, True),      # the kernels' second width, as the reference's rule
    ((2, 256, 2, 128), True, False),      # extra bias
    ((2, 256, 2, 384), False, True),      # a cluster of 3 CTAs, as the reference's rule
    ((2, 256, 2, 4224), False, False),    # past MAX_HEAD_DIM of either type: not ported yet
    ((2, 256, 2, 1152), False, True),     # f32: a cluster of 9 CTAs, a non-portable size
])
def test_flash_eligibility(shape, bias, eligible):
    q = torch.zeros(shape)
    b = torch.zeros(shape[0], shape[2], shape[1], shape[1]) if bias else None
    assert port_attention._flash_eligible(q, q, b) is eligible


def test_plain_attention_matches_reference_on_ineligible_shape():
    """The plain path (-1e9 bias) and the flash plain version agree where
    no row is fully masked."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(seed=2))
    q, k, v = (x[:, :, :, :64] for x in (q, k, v))
    for causal in (False, True):
        out = port_attention.dot_product_attention(q, k, v, mask, causal)
        ref, _ = port_flash.flash_attention_reference(q, k, v, mask, causal)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_plain_attention_bf16_decode_matches_xla_attention():
    """A decode-shaped bf16 call (Sq=1, Skv=512, pad tail) of the plain path
    against ``_xla_attention``.  The scores are f32 products of the bf16
    operands on both sides (``preferred_element_type=f32``), so the logits
    agree to f32 summation order (1e-5); the bf16 outputs then agree within
    one bf16 step of each element.  (With the product rounded to bf16
    before the softmax, some outputs differ by more than one step.)"""
    rng = np.random.default_rng(7)
    Bd, Skv, Hd = 2, 512, 8
    q = (rng.standard_normal((Bd, 1, Hd, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((Bd, Skv, Hd, D)).astype(np.float32)
    v = rng.standard_normal((Bd, Skv, Hd, D)).astype(np.float32)
    mask = np.ones((Bd, Skv), np.float32)
    mask[1, Skv - 100:] = 0.0
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    want = np.asarray(_xla_attention(jq, jk, jv, jnp.asarray(mask), False, None,
                                     0.0, True, None)).astype(np.float32)
    got = port_attention.dot_product_attention(
        tq, tk, tv, kv_mask=torch.from_numpy(mask)).float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()
    want_logits = (jnp.einsum("bqhd,bkhd->bhqk", jq, jk,
                              preferred_element_type=jnp.float32)
                   + jax_build_bias(jnp.asarray(mask), False, 1, Skv, jnp.float32))
    got_logits = port_attention._plain_logits(tq, tk, torch.from_numpy(mask),
                                              False, None)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-6, atol=1e-5)
