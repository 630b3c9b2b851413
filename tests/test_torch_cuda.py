"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip where no CUDA device is present.  On a machine with an H100 and
the CUDA toolkit, run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so they run where only PyTorch is installed.
"""
import pytest
import torch

from pianobart_tpu_torch.ops.flash import (flash_attention,
                                           flash_attention_bwd,
                                           flash_attention_bwd_reference,
                                           flash_attention_fwd,
                                           flash_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, B=2, S=256, H=2, D=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, device=dev, generator=g) * D ** -0.5
    k = torch.randn(B, S, H, D, device=dev, generator=g)
    v = torch.randn(B, S, H, D, device=dev, generator=g)
    mask = torch.ones(B, S, device=dev)
    mask[1, S - 40:] = 0.0
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


# bf16: P and O are rounded to bf16 in the kernel (2^-9 relative each);
# f32: summation order and expf only.
TOL = {torch.bfloat16: (1e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_flash_kernel_matches_reference(cuda, dtype, causal, use_mask):
    q, k, v, mask = _inputs(cuda, dtype)
    m = mask if use_mask else None
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, m, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, m, causal)
    atol, rtol, ltol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views of one fused (B, S, 3, H, D) projection: no copies."""
    B, S, H, D = 2, 256, 2, 128
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out, _ = flash_attention_fwd(q, k, v)
    ref, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, D=64)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, k, v)
    q, k, v, _ = _inputs(cuda, torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v)


# K2 per element: |d| <= atol*max|ref| + rtol*|ref|, and ||d|| <= ntol*||ref||.
# bf16: the kernel rounds P and dS to bf16 as product operands and dQ/dK/dV
# to bf16 at the end (2^-9 relative each) where the plain version keeps f32.
# dQ = dS K sums terms of both signs (rows of dS sum to zero), so an entry
# can be far smaller than the terms whose rounding it carries: the absolute
# part scales with the tensor's largest entry.  f32: summation order only.
BWD_TOL = {torch.bfloat16: (1e-2, 1e-2, 1e-2), torch.float32: (1e-5, 1e-5, 1e-5)}


def assert_bwd_close(got, want, dtype):
    atol, rtol, ntol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        a, b = a.float(), b.float()
        d = (a - b).abs()
        assert bool((d <= atol * b.abs().max() + rtol * b.abs()).all()), \
            f"{name}: max|d| {d.max().item():.3e}"
        assert (d.norm() <= ntol * b.norm()).item(), name


def _bwd_case(dev, dtype, causal, use_mask, **kw):
    q, k, v, mask = _inputs(dev, dtype, **kw)
    m = mask if use_mask else None
    out, lse = flash_attention_fwd(q, k, v, m, causal)
    g = torch.Generator(device=dev).manual_seed(7)
    dout = torch.randn(out.shape, device=dev, generator=g).to(dtype)
    return q, k, v, m, out, lse, dout


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_flash_bwd_kernel_matches_reference(cuda, dtype, causal, use_mask):
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, use_mask)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, m, causal, out, lse, dout)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, m, causal, out, lse, dout)
    assert_bwd_close(got, want, dtype)


def test_flash_bwd_kernel_reads_strided_inputs(cuda):
    """q/k/v as views of one fused (B, S, 3, H, D) projection, dO a view
    too: the kernel reads them through their strides."""
    B, S, H, D = 2, 256, 2, 128
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out, lse = flash_attention_fwd(q, k, v, None, True)
    dout = torch.randn(B, S, 2, H, D, device=cuda, dtype=torch.bfloat16)[:, :, 0]
    got = flash_attention_bwd(q, k, v, None, True, out, lse, dout)
    want = flash_attention_bwd_reference(q, k, v, None, True, out, lse, dout)
    assert_bwd_close(got, want, torch.bfloat16)


def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, D=64)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, k, v, None, False, q, lse, q)


def test_flash_autograd_runs_both_kernels(cuda):
    """flash_attention's gradient goes through K1 then K2, once each."""
    q, k, v, mask = (x.requires_grad_() if x.is_floating_point() and x.dim() == 4
                     else x for x in _inputs(cuda, torch.bfloat16))
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    flash_attention(q, k, v, mask, True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))
