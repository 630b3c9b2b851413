"""The port's flash forward (plain version + CPU dispatch) against the JAX
package's Pallas kernel run in interpret mode, as tests/test_flash.py runs it.

Tolerance 2e-5 (rtol and atol), f32: both sides compute in f32 and differ
only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_fwd_refuses_requires_grad():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(RuntimeError, match="forward-only"):
        port_flash.flash_attention_fwd(q.requires_grad_(), k, v, mask)


@pytest.mark.parametrize("shape,bias,eligible", [
    ((2, 256, 2, 128), False, True),
    ((2, 1024, 8, 128), False, True),
    ((2, 128, 2, 128), False, False),     # too short
    ((2, 320, 2, 128), False, False),     # not a 128 multiple
    ((2, 256, 2, 64), False, False),      # head width the kernel lacks
    ((2, 256, 2, 256), False, False),
    ((2, 256, 2, 128), True, False),      # extra bias
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
