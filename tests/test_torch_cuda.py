"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip where no CUDA device is present.  On a machine with an H100 and
the CUDA toolkit, run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so they run where only PyTorch is installed.
"""
import pytest
import torch

from pianobart_tpu_torch.ops.flash import (flash_attention_fwd,
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
