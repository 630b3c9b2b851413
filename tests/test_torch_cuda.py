"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip where no CUDA device is present.  On a machine with an H100 and
the CUDA toolkit, run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so they run where only PyTorch is installed.
"""
import math

import pytest
import torch

from pianobart_tpu_torch.ops import fused_ln as F
from pianobart_tpu_torch.ops.flash import (_delta, flash_attention,
                                           flash_attention_bwd,
                                           flash_attention_delta,
                                           flash_attention_bwd_reference,
                                           flash_attention_dkv,
                                           flash_attention_dkv_reference,
                                           flash_attention_dq,
                                           flash_attention_dq_reference,
                                           flash_attention_fwd,
                                           flash_attention_reference,
                                           flash_attention_split,
                                           flash_attention_split_reference)
from pianobart_tpu_torch.scripts import kernel_lab as lab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, B=2, S=256, H=2, D=128, seed=0, Skv=None):
    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, device=dev, generator=g) * D ** -0.5
    k = torch.randn(B, Skv, H, D, device=dev, generator=g)
    v = torch.randn(B, Skv, H, D, device=dev, generator=g)
    mask = torch.ones(B, Skv, device=dev)
    mask[B - 1, Skv - 40:] = 0.0
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


# bf16: P and O are rounded to bf16 in the kernel (2^-9 relative each);
# f32: the kernel's products are 3xTF32 (hi.hi' + hi.lo' + lo.hi', about
# 2^-22 relative, as close as f32's own rounding), its exp2 the ex2.approx
# of the score-domain difference, and it sums in another order.
TOL = {torch.bfloat16: (1e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}
DTYPES = [torch.bfloat16, torch.float32]


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


# (B, H) = (2, 2): a few CTAs; (12, 8): more CTAs than the card has SMs
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 192, 320, False), (2, 2, 192, 320, True), (12, 8, 192, 320, False),
    (12, 8, 192, 320, True), (1, 2, 2048, 2048, True), (1, 2, 256, 256, False)],
    ids=["192x320", "192x320-causal", "192x320-wide", "192x320-causal-wide",
         "2048-causal", "B1"])
def test_flash_kernel_matches_reference_at_more_shapes(cuda, B, H, Sq, Skv, causal, dtype):
    """Lengths that are multiples of 64 but not of the kernel's 128-row
    tiles (a ragged last q tile, and a ragged kv tile for bf16's 128 kv
    rows), the long context, one sample."""
    q, k, v, mask = _inputs(cuda, dtype, B=B, H=H, S=Sq, Skv=Skv)
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[dtype]
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H", [(2, 2), (12, 8)], ids=["small", "wide"])
@pytest.mark.parametrize("Skv", [256, 320])
def test_flash_kernel_fully_masked_sample(cuda, Skv, B, H, dtype):
    """Sample 0 with every key masked, non-causal: as in the plain version,
    O is the mean of v over the Skv keys (a zero-filled key past Skv in a
    ragged tile takes no part) and lse is the -1e30 sentinel plus log Skv."""
    q, k, v, mask = _inputs(cuda, dtype, B=B, H=H, S=Skv)
    mask[0] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, False)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, False)
    atol, rtol, ltol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)
    mean_v = v[0].float().mean(0).expand_as(out[0])
    torch.testing.assert_close(out[0].float(), mean_v, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits (no atomics)."""
    q, k, v, mask = _inputs(cuda, dtype, S=1024)
    a = flash_attention_fwd(q, k, v, mask, False)
    b = flash_attention_fwd(q, k, v, mask, False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_takes_an_unaligned_int_mask(cuda, dtype):
    """An int32 mask that starts off a 16-byte boundary (the kernel loads it
    by TMA) gives what the same mask aligned gives."""
    q, k, v, mask = _inputs(cuda, dtype)
    B, S = mask.shape
    shifted = torch.zeros(B * S + 1, dtype=torch.int32, device=cuda)[1:].view(B, S)
    shifted.copy_(mask)
    assert shifted.data_ptr() % 16
    got = flash_attention_fwd(q, k, v, shifted, True)
    want = flash_attention_fwd(q, k, v, mask, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_reads_strided_inputs(cuda, dtype):
    """q/k/v as views of one fused (B, S, 3, H, D) projection: no copies
    (f32: the prep reads them through their strides)."""
    B, S, H, D = 2, 256, 2, 128
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=dtype)
    q, k, v = qkv.unbind(2)
    out, _ = flash_attention_fwd(q, k, v)
    ref, _ = flash_attention_reference(q, k, v)
    atol, rtol, _ = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


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
# part scales with the tensor's largest entry.  f32: 3xTF32 products (about
# 2^-22 relative), ex2.approx and summation order.
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


def _bwd(kernel, q, k, v, m, causal, out, lse, dout):
    """(dq, dk, dv) of the kernels and of their plain versions: "K2" through
    flash_attention_bwd's one entry, "K3" through K3a and K3b (which take
    any length) with the delta the backward computes."""
    if kernel == "K2":
        got = flash_attention_bwd(q, k, v, m, causal, out, lse, dout)
        return got, flash_attention_bwd_reference(q, k, v, m, causal, out, lse, dout)
    args = (q, k, v, m, causal, lse, _delta(dout, out), dout)
    got = (flash_attention_dq(*args), *flash_attention_dkv(*args))
    return got, (flash_attention_dq_reference(*args),
                 *flash_attention_dkv_reference(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_bwd_kernel_reads_strided_inputs(cuda, kernel, dtype):
    """q/k/v as views of one fused (B, S, 3, H, D) projection, dO a view
    too: the kernels (f32: the prep) read them through their strides.  q
    pre-scaled by D**-0.5, as the kernels' callers hand it over."""
    B, S, H, D = 2, 256, 2, 128
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=dtype)
    qkv[:, :, 0] *= D ** -0.5
    q, k, v = qkv.unbind(2)
    out, lse = flash_attention_fwd(q, k, v, None, True)
    dout = torch.randn(B, S, 2, H, D, device=cuda, dtype=dtype)[:, :, 0]
    got, want = _bwd(kernel, q, k, v, None, True, out, lse, dout)
    assert_bwd_close(got, want, dtype)


# (B, H) = (2, 2): a few CTAs; (12, 8): more CTAs than the card has SMs
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 192, 320, False), (2, 2, 192, 320, True), (2, 2, 320, 192, False),
    (2, 2, 320, 192, True), (12, 8, 320, 320, False), (12, 8, 320, 320, True),
    (1, 2, 64, 64, True)],
    ids=["192x320", "192x320-causal", "320x192", "320x192-causal", "320-wide",
         "320-causal-wide", "64-causal"])
def test_flash_bwd_kernels_at_more_shapes(cuda, kernel, B, H, Sq, Skv, causal, dtype):
    """Lengths that are multiples of 64 but not of the bf16 kernels' 128
    fixed rows (a CTA whose second warpgroup lies wholly past S), Sq != Skv
    both ways, and one tile."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, True,
                                           B=B, H=H, S=Sq, Skv=Skv)
    got, want = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
    assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("Skv", [256, 320])
def test_flash_bwd_kernel_fully_masked_sample(cuda, kernel, Skv, dtype):
    """Sample 0 with every key masked, non-causal: its lse is the -1e30
    sentinel, so P is 1 on every key (not 0, and no overflow of the
    exponent) as in the plain backward, whose gradients the kernels give."""
    q, k, v, mask = _inputs(cuda, dtype, S=Skv)
    mask[0] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, False)
    assert (lse[0] == -1e30).all()
    dout = torch.randn(out.shape, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(7)
                       ).to(dtype)
    got, want = _bwd(kernel, q, k, v, mask, False, out, lse, dout)
    assert_bwd_close(got, want, dtype)
    assert all(bool(g[0].float().abs().max() > 0) for g in got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_bwd_kernel_is_deterministic(cuda, kernel, dtype):
    """Two backward calls on the same inputs give the same bits (no
    atomics)."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, True, True, S=1024)
    a, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    b, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_bwd_kernel_takes_an_unaligned_int_mask(cuda, kernel, dtype):
    """An int32 mask that starts off a 16-byte boundary (the kernels load it
    by TMA) gives what the same mask aligned gives."""
    q, k, v, mask, out, lse, dout = _bwd_case(cuda, dtype, False, True)
    B, S = mask.shape
    shifted = torch.zeros(B * S + 1, dtype=torch.int32, device=cuda)[1:].view(B, S)
    shifted.copy_(mask)
    assert shifted.data_ptr() % 16
    got, _ = _bwd(kernel, q, k, v, shifted, False, out, lse, dout)
    want, _ = _bwd(kernel, q, k, v, mask, False, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, D=64)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, k, v, None, False, q, lse, q)


@pytest.mark.parametrize("strided", [False, True], ids=["packed", "views"])
@pytest.mark.parametrize("S", [256, 320])
def test_tf32_split_kernel_matches_reference(cuda, S, strided):
    """The f32 kernels' prep against its plain version, bit for bit: hi
    rounded to tf32 by the same bit rule, lo = x - hi, the transposed planes
    in the fragment order; natural and transposed alone and together."""
    B, H, D = 2, 3, 128
    g = torch.Generator(device=cuda).manual_seed(5)
    both = torch.randn(B, S, 2, H, D, device=cuda, generator=g) * 10.0
    x = both[:, :, 1] if strided else both[:, :, 1].contiguous()
    before = flash_attention_split.launches
    for natural, transposed in [(True, False), (False, True), (True, True)]:
        got = flash_attention_split(x, natural, transposed)
        want = flash_attention_split_reference(x, natural, transposed)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    torch.cuda.synchronize()
    assert flash_attention_split.launches == before + 3


def test_f32_attention_runs_the_split_kernel(cuda):
    """An f32 flash_attention forward and backward: K1 and K2 once each,
    the prep once before each (Q, K, V; then Q, K, V, dO in one launch)."""
    q, k, v, mask = (x.requires_grad_() if x.dim() == 4 else x
                     for x in _inputs(cuda, torch.float32))
    counters = (flash_attention_fwd, flash_attention_bwd, flash_attention_split)
    before = [c.launches for c in counters]
    out = flash_attention(q, k, v, mask, True)
    assert flash_attention_split.launches - before[2] == 1
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 2]
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_flash_autograd_runs_both_kernels(cuda):
    """flash_attention's gradient goes through K1 then K2, once each."""
    q, k, v, mask = (x.requires_grad_() if x.is_floating_point() and x.dim() == 4
                     else x for x in _inputs(cuda, torch.bfloat16))
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    flash_attention(q, k, v, mask, True).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_k3_kernels_match_reference(cuda, dtype, causal, use_mask):
    """K3a and K3b at S=2048 (B=2, H=2) against their plain versions, from
    the forward's lse and the delta the backward computes."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, use_mask, S=2048)
    delta = _delta(dout, out)
    q0, k0 = flash_attention_dq.launches, flash_attention_dkv.launches
    dq = flash_attention_dq(q, k, v, m, causal, lse, delta, dout)
    dk, dv = flash_attention_dkv(q, k, v, m, causal, lse, delta, dout)
    torch.cuda.synchronize()
    assert (flash_attention_dq.launches - q0, flash_attention_dkv.launches - k0) == (1, 1)
    want = (flash_attention_dq_reference(q, k, v, m, causal, lse, delta, dout),
            *flash_attention_dkv_reference(q, k, v, m, causal, lse, delta, dout))
    assert_bwd_close((dq, dk, dv), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("strided", [False, True], ids=["packed", "views"])
def test_delta_kernel_matches_reference(cuda, dtype, strided):
    """delta = rowsum(dO * O) against its plain version, on packed tensors
    and on views of a wider (B, S, 2, H, D) tensor; f32 sums in another
    order (16 lanes of 8 products, then a tree)."""
    B, S, H, D = 3, 320, 2, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    both = torch.randn(B, S, 2, H, D, device=cuda, generator=g).to(dtype)
    dout, out = both.unbind(2) if strided else (both[:, :, 0].contiguous(),
                                                both[:, :, 1].contiguous())
    before = flash_attention_delta.launches
    got = flash_attention_delta(dout, out)
    torch.cuda.synchronize()
    assert flash_attention_delta.launches == before + 1
    assert got.shape == (B, H, S) and got.dtype == torch.float32
    torch.testing.assert_close(got, _delta(dout, out), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("S,counts", [(1024, (1, 0, 0)), (2048, (0, 1, 1))])
def test_backward_picks_k2_or_k3(cuda, S, counts):
    """flash_attention's gradient moves only K2's count at S=1024 and only
    K3a's and K3b's at S=2048, as the reference's _bwd_impl picks."""
    q, k, v, mask = (x.requires_grad_() if x.dim() == 4 else x
                     for x in _inputs(cuda, torch.bfloat16, S=S))
    before = (flash_attention_bwd.launches, flash_attention_dq.launches,
              flash_attention_dkv.launches)
    flash_attention(q, k, v, mask, True).float().square().sum().backward()
    torch.cuda.synchronize()
    after = (flash_attention_bwd.launches, flash_attention_dq.launches,
             flash_attention_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == counts
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_k3_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.bfloat16, S=2048, D=64)
    rows = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_dq(q, k, v, None, False, rows, rows, q)
    q, k, v, _ = _inputs(cuda, torch.bfloat16, S=2048)
    with pytest.raises(ValueError, match="delta"):
        flash_attention_dkv(q, k, v, None, False, rows, rows[:, :, :64], q)


# ---- head width 256 (--heads 4): the same checks at D=256, same tolerances.
# bf16: K1's D=256 kernel (128-row kv tiles through half-D slots, the
# consumer warpgroups in ping-pong) and the backward's D=256 wgmma kernels;
# f32: the 3xTF32 wgmma kernels run as CTA pairs, one per
# 128-column half of the head, over the prep's planes (one prep launch a
# K1, K2, K3a or K3b call).
# Skv 64 past a multiple of 128 (192, 576: a ragged last kv tile of the
# bf16 kernel's 128 rows) and the decode buckets B = 1 and 8 at S=1024
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 256, 256, False), (2, 2, 256, 256, True), (2, 2, 192, 320, False),
    (2, 2, 192, 320, True), (12, 4, 320, 320, True), (1, 2, 2048, 2048, True),
    (2, 2, 192, 192, False), (2, 3, 576, 576, True), (2, 2, 320, 576, False),
    (1, 4, 1024, 1024, False), (8, 4, 1024, 1024, False)],
    ids=["256", "256-causal", "192x320", "192x320-causal", "320-causal-wide",
         "2048-causal", "192", "576-causal", "320x576", "decode-B1", "decode-B8"])
def test_flash_kernel_d256_matches_reference(cuda, B, H, Sq, Skv, causal, dtype):
    q, k, v, mask = _inputs(cuda, dtype, B=B, H=H, S=Sq, Skv=Skv, D=256)
    f0, s0 = flash_attention_fwd.launches, flash_attention_split.launches
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0, flash_attention_split.launches - s0) == (
        1, int(dtype == torch.float32))
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[dtype]
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Skv", [256, 320])
def test_flash_kernel_d256_fully_masked_sample(cuda, Skv, dtype):
    q, k, v, mask = _inputs(cuda, dtype, S=Skv, D=256)
    mask[0] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, False)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, False)
    atol, rtol, ltol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 256, 256, False), (2, 2, 256, 256, True), (2, 2, 192, 320, True),
    (2, 2, 320, 192, False), (12, 4, 320, 320, True), (1, 2, 64, 64, True)],
    ids=["256", "256-causal", "192x320-causal", "320x192", "320-causal-wide",
         "64-causal"])
def test_flash_bwd_kernels_d256_match_reference(cuda, kernel, B, H, Sq, Skv, causal,
                                                dtype):
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, True,
                                           B=B, H=H, S=Sq, Skv=Skv, D=256)
    s0 = flash_attention_split.launches
    got, want = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
    torch.cuda.synchronize()
    preps = (1 if kernel == "K2" else 2) if dtype == torch.float32 else 0
    assert flash_attention_split.launches == s0 + preps
    assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_d256_running_max_moves(cuda, causal):
    """Keys whose scores outgrow every earlier tile's by far (the last kv
    tile's keys scaled by 4): the bf16 D=256 kernel moves its running max
    (and rescales O) past the first tile, against the plain version."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16, S=576, D=256)
    k[:, 512:] *= 4
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_d256_reads_a_tp_rank_s_projections(cuda, causal):
    """q, k, v as the last of two tp ranks makes them at --heads 4 in bf16
    (2 of 4 heads from ``tp_slice``'d projections of one activation; S=320,
    a ragged q and kv tile): K1's D=256 bf16 kernel against its plain
    version."""
    import torch.nn.functional as F
    from pianobart_tpu_torch.ops.ring import tp_slice
    from pianobart_tpu_torch.parallel.mesh import single_device_mesh
    B, S, H, D, tp = 2, 320, 4, 256, 2
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(B, S, H * D, device=cuda, generator=g).bfloat16()
    n, start = H // tp * D, (tp - 1) * (H // tp) * D
    ax = single_device_mesh("cuda").axis("tp")

    def proj():
        w = torch.randn(H * D, H * D, device=cuda, generator=g) * (H * D) ** -0.5
        b = torch.randn(H * D, device=cuda, generator=g) * 0.1
        return F.linear(x, tp_slice(w, start, n, 0, ax).bfloat16(),
                        tp_slice(b, start, n, 0, ax).bfloat16()).view(B, S, H // tp, D)

    q, k, v = proj() * D ** -0.5, proj(), proj()
    mask = torch.ones(B, S, device=cuda)
    mask[-1, S - 40:] = 0.0
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_bwd_kernels_d256_fully_masked_sample_and_strides(cuda, kernel, dtype):
    """Sample 0 wholly masked (P = 1 on every key), q/k/v as views of one
    fused projection and dO a view: the D=256 kernels read the strides."""
    B, S, H, D = 2, 320, 2, 256
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=dtype)
    qkv[:, :, 0] *= D ** -0.5
    q, k, v = qkv.unbind(2)
    mask = torch.ones(B, S, device=cuda)
    mask[0] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, False)
    assert (lse[0] == -1e30).all()
    dout = torch.randn(B, S, 2, H, D, device=cuda, dtype=dtype)[:, :, 0]
    got, want = _bwd(kernel, q, k, v, mask, False, out, lse, dout)
    assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_kernels_d256_are_deterministic(cuda, kernel, dtype):
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, True, True, S=1024, D=256)
    o2, l2 = flash_attention_fwd(q, k, v, m, True)
    assert torch.equal(out, o2) and torch.equal(lse, l2)
    a, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    b, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if dtype == torch.float32:
        # the pair: q, k, v and dO whose two 128-column halves are equal give
        # O, dQ, dK and dV whose halves are equal to the bit only if both
        # CTAs of a pair hold the same P and dS (their S and dP sums)
        def twin(x):
            return torch.cat([x[..., :128], x[..., :128]], -1).contiguous()
        q, k, v, dout = (twin(x) for x in (q, k, v, dout))
        out, lse = flash_attention_fwd(q, k, v, m, True)
        got, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
        for name, x in zip(("o", "dq", "dk", "dv"), (out, *got)):
            assert torch.equal(x[..., :128], x[..., 128:]), name


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("B,H,S,causal", [
    (2, 2, 320, False), (2, 2, 320, True), (1, 1, 64, False), (1, 1, 64, True),
    (1, 1, 128, True)],
    ids=["320", "320-causal", "one-pair", "one-pair-causal", "one-pair-128-causal"])
def test_f32_pair_kernels_d256_odd_tiles_and_one_pair(cuda, kernel, B, H, S, causal):
    """The f32 CTA pairs at D=256 over an odd number of 64-row tiles (S=320:
    K1's last 128-row pair half past S) and on a grid of one pair (B = H = 1,
    one tile), against the plain versions."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, torch.float32, causal, True, B=B, H=H,
                                           S=S, D=256)
    if kernel == "K1":
        ref, ref_lse = flash_attention_reference(q, k, v, m, causal)
        atol, rtol, ltol = TOL[torch.float32]
        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)
        return
    got, want = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
    assert_bwd_close(got, want, torch.float32)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_pair_kernels_d256_read_a_tp_rank_s_projections(cuda, kernel, causal):
    """q, k, v as the last of two tp ranks makes them at --heads 4 (2 of 4
    heads): views of ``tp_slice``'d projections of one activation, at their
    strides; the pairs' K1 and backward against the plain versions."""
    import torch.nn.functional as F
    from pianobart_tpu_torch.ops.ring import tp_slice
    from pianobart_tpu_torch.parallel.mesh import single_device_mesh
    B, S, H, D, tp = 2, 256, 4, 256, 2
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(B, S, H * D, device=cuda, generator=g)
    n, start = H // tp * D, (tp - 1) * (H // tp) * D
    ax = single_device_mesh("cuda").axis("tp")

    def proj():
        w = torch.randn(H * D, H * D, device=cuda, generator=g) * (H * D) ** -0.5
        b = torch.randn(H * D, device=cuda, generator=g) * 0.1
        return F.linear(x, tp_slice(w, start, n, 0, ax), tp_slice(b, start, n, 0, ax)).view(
            B, S, H // tp, D)

    q, k, v = proj() * D ** -0.5, proj(), proj()
    mask = torch.ones(B, S, device=cuda)
    mask[-1, S - 40:] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[torch.float32]
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)
    dout = torch.randn(B, S, H // tp, D, device=cuda, generator=g)
    got, want = _bwd(kernel, q, k, v, mask, causal, out, lse, dout)
    assert_bwd_close(got, want, torch.float32)


# The bf16 backward at D=256: dK/dV with S^T computed once and P^T handed
# between the warpgroups (64 kv rows a CTA); dQ with 128 q rows a CTA, 64 a
# warpgroup, K and V through a ring of three slots.
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("S,causal,masked", [
    (1024, False, False), (2048, True, False), (320, False, True), (320, True, False)],
    ids=["1024", "2048-causal", "320-masked", "320-causal"])
def test_bf16_d256_backward_is_deterministic(cuda, kernel, S, causal, masked):
    """dQ, dK and dV of the D=256 bf16 kernels are the same bits on every
    call (no atomics; the handoffs through shared memory order nothing)."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, torch.bfloat16, causal, True, S=S, D=256)
    if masked:
        m[0] = 0.0
        out, lse = flash_attention_fwd(q, k, v, m, causal)
    runs = [_bwd(kernel, q, k, v, m, causal, out, lse, dout)[0] for _ in range(3)]
    for got in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], got))


# (B, H, Sq, Skv): an odd number of 64-row blocks (the dQ kernel's last CTA
# with its second warpgroup past S), one block, Sq != Skv both ways, causal
# (a dQ warpgroup that waits for and releases the tile past its diagonal)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (1, 1, 64, 64, False), (1, 1, 64, 64, True), (2, 2, 192, 192, True),
    (2, 2, 320, 320, False), (3, 2, 448, 448, True), (2, 2, 192, 320, False),
    (2, 2, 320, 192, True), (2, 3, 576, 576, True)],
    ids=["64", "64-causal", "192-causal", "320", "448-causal", "192x320", "320x192-causal",
         "576-causal"])
def test_bf16_d256_backward_odd_blocks(cuda, kernel, B, H, Sq, Skv, causal):
    q, k, v, m, out, lse, dout = _bwd_case(cuda, torch.bfloat16, causal, True, B=B, H=H,
                                           S=Sq, Skv=Skv, D=256)
    got, want = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
    assert_bwd_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_d256_backward_reads_a_tp_rank_s_projections(cuda, kernel, causal):
    """q, k, v as the last of two tp ranks makes them at --heads 4 in bf16
    (2 of 4 heads from ``tp_slice``'d projections, an odd number of fixed
    blocks): the D=256 bf16 backward against its plain versions."""
    import torch.nn.functional as F
    from pianobart_tpu_torch.ops.ring import tp_slice
    from pianobart_tpu_torch.parallel.mesh import single_device_mesh
    B, S, H, D, tp = 2, 320, 4, 256, 2
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(B, S, H * D, device=cuda, generator=g).bfloat16()
    n, start = H // tp * D, (tp - 1) * (H // tp) * D
    ax = single_device_mesh("cuda").axis("tp")

    def proj():
        w = torch.randn(H * D, H * D, device=cuda, generator=g) * (H * D) ** -0.5
        b = torch.randn(H * D, device=cuda, generator=g) * 0.1
        return F.linear(x, tp_slice(w, start, n, 0, ax).bfloat16(),
                        tp_slice(b, start, n, 0, ax).bfloat16()).view(B, S, H // tp, D)

    q, k, v = proj() * D ** -0.5, proj(), proj()
    mask = torch.ones(B, S, device=cuda)
    mask[-1, S - 40:] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    dout = torch.randn(B, S, H // tp, D, device=cuda, generator=g).bfloat16()
    got, want = _bwd(kernel, q, k, v, mask, causal, out, lse, dout)
    assert_bwd_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_and_split_kernels_d256_match_reference(cuda, dtype):
    B, S, H, D = 3, 320, 2, 256
    g = torch.Generator(device=cuda).manual_seed(3)
    both = torch.randn(B, S, 2, H, D, device=cuda, generator=g).to(dtype)
    dout, out = both.unbind(2)
    got = flash_attention_delta(dout, out)
    torch.testing.assert_close(got, _delta(dout, out), atol=1e-4, rtol=1e-5)
    if dtype == torch.float32:
        for a, b in zip(flash_attention_split(out, True, True),
                        flash_attention_split_reference(out, True, True)):
            assert torch.equal(a, b)


def test_flash_autograd_d256_runs_the_kernels(cuda):
    """flash_attention's gradient at D=256: K1 then delta and K2 (S=1024),
    or delta, K3a and K3b (S=2048), once each, in both types; in f32 one
    prep launch before each of K1, K2, K3a and K3b."""
    counters = (flash_attention_fwd, flash_attention_delta, flash_attention_bwd,
                flash_attention_dq, flash_attention_dkv, flash_attention_split)
    for dtype in DTYPES:
        f32 = dtype == torch.float32
        for S, want in ((1024, [1, 1, 1, 0, 0, 2 * f32]), (2048, [1, 1, 0, 1, 1, 3 * f32])):
            q, k, v, mask = (x.requires_grad_() if x.dim() == 4 else x
                             for x in _inputs(cuda, dtype, S=S, D=256))
            before = [c.launches for c in counters]
            flash_attention(q, k, v, mask, True).float().square().sum().backward()
            torch.cuda.synchronize()
            assert [c.launches - b for c, b in zip(counters, before)] == want
            assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_flash_kernels_refuse_head_width_384(cuda):
    """D=384 is taken now (a cluster of three CTAs: one launch, no refusal),
    and so is 2176 in bf16 (nine CTAs); the kernels refuse the widths they
    still lack, past their type's MAX_HEAD_DIM (f32 2176, bf16 4224: the
    message states the type's range) and off the 128 grid."""
    for d, dtype in ((384, torch.bfloat16), (2176, torch.bfloat16)):
        q, k, v, _ = _inputs(cuda, dtype, D=d)
        before = flash_attention_fwd.launches
        flash_attention_fwd(q, k, v)
        flash_attention_delta(q, q)
        torch.cuda.synchronize()
        assert flash_attention_fwd.launches == before + 1
    for d, dtype, top in ((2176, torch.float32, 2048), (4224, torch.bfloat16, 4096),
                          (320, torch.bfloat16, 4096)):
        q, k, v, _ = _inputs(cuda, dtype, D=d)
        with pytest.raises(ValueError, match=f"head_dim a multiple of 128 up to {top}"):
            flash_attention_fwd(q, k, v)
        with pytest.raises(ValueError, match=f"up to {top}"):
            flash_attention_delta(q, q)


def _ln_case(dev, dtype, N=256, D=1024, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(N, D, device=dev, generator=g).to(dtype)
    res = torch.randn(N, D, device=dev, generator=g).to(dtype)
    gamma = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    beta = 0.1 * torch.randn(D, device=dev, generator=g)
    dout = torch.randn(N, D, device=dev, generator=g).to(dtype)
    seed_t = torch.tensor([2 ** 40 + 3], dtype=torch.int64, device=dev)
    return h, res, gamma, beta, dout, seed_t


def test_fused_tail_wider_than_the_kernel_raises_on_the_card(cuda):
    """A ``fused_dropout_ln`` model at d_model 8320 (65 heads of 128, 1+1
    layers, S=128) is wider than K4's MAX_D: building it on the card raises,
    and a tail built on the CPU and moved to the card raises in the kernel's
    input check.  No route takes the unfused tail in K4's place."""
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.models.bart import ResidualDropoutLN
    cfg = PianoBartConfig(d_model=8320, num_heads=65, encoder_layers=1,
                          decoder_layers=1, ffn_dim=128, max_len=128,
                          dtype=torch.bfloat16, fused_dropout_ln=True)
    assert cfg.d_model > F.MAX_D and F.fused_eligible((2, 128, cfg.d_model))
    with pytest.raises(ValueError, match=f"MAX_D = {F.MAX_D}"):
        init_lm(cfg, seed=0, device=cuda, train=True)
    tail = ResidualDropoutLN(cfg, device="cpu").to(cuda).train()
    h = torch.randn(2, 128, cfg.d_model, device=cuda, dtype=torch.bfloat16)
    f0 = F.dropout_add_ln_fwd.launches
    with pytest.raises(ValueError, match=f"D <= {F.MAX_D}"):
        tail(h, h, torch.Generator(device=cuda).manual_seed(0))
    assert F.dropout_add_ln_fwd.launches == f0


# K4 against its plain version fed the same Philox bits.  f32: rsqrtf and
# summation order only.  bf16: the outputs round to bf16 on both sides and
# can round apart by one step (2^-8 relative); dgamma/dbeta are f32 sums of
# the same products in another order.
LN_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [256, 1024, 1152, 2048, 8192])
def test_fused_ln_kernels_match_reference(cuda, dtype, D):
    """D <= 1024: a row per warp; 1152, 2048: a row across 2 warps; 8192:
    across all 8 warps of a CTA."""
    h, res, gamma, beta, dout, seed = _ln_case(cuda, dtype, D=D)
    f0, b0 = F.dropout_add_ln_fwd.launches, F.dropout_add_ln_bwd.launches
    out, mean, rstd = F.dropout_add_ln_fwd(h, res, gamma, beta, seed, 0.1)
    grads = F.dropout_add_ln_bwd(h, res, gamma, mean, rstd, dout, seed, 0.1)
    torch.cuda.synchronize()
    assert (F.dropout_add_ln_fwd.launches - f0, F.dropout_add_ln_bwd.launches - b0) == (1, 1)
    bits = F.philox_bits(seed, *h.shape)
    keep = bits >= F.threshold(0.1)
    assert torch.equal(grads[0] != 0, keep), "keep decisions differ"
    r_out, r_mean, r_rstd = F.dropout_add_ln_reference(h, res, gamma, beta, seed,
                                                       0.1, bits=bits)
    r_grads = F.dropout_add_ln_bwd_reference(h, res, gamma, r_mean, r_rstd, dout,
                                             seed, 0.1, bits=bits)
    atol, rtol = LN_TOL[dtype]
    torch.testing.assert_close(mean, r_mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, r_rstd, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), r_out.float(), atol=atol, rtol=rtol)
    for name, a, b in zip(("dh", "dres", "dgamma", "dbeta"), grads, r_grads):
        assert a.dtype == b.dtype, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.parametrize("d", [1152, 2048, 8192])
def test_fused_tail_trains_past_1024_on_the_card(cuda, d):
    """A ``fused_dropout_ln`` model wider than one warp's row (1+1 layers of
    heads of 128, S=128) builds on the card and takes a pretrain step
    through K4a and K4b at all 5 tails."""
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.train.pretrain import pretrain_step
    from pianobart_tpu_torch.train.state import create_train_state
    cfg = PianoBartConfig(d_model=d, num_heads=d // 128, encoder_layers=1,
                          decoder_layers=1, ffn_dim=256, max_len=128,
                          dtype=torch.bfloat16, fused_dropout_ln=True)
    st = create_train_state(init_lm(cfg, seed=0, device=cuda, train=True))
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, V.TOKEN_BOUNDARY[f], (1, 128)) for f in range(8)], -1)
    x[0, -1] = V.EOS
    f0, b0 = F.dropout_add_ln_fwd.launches, F.dropout_add_ln_bwd.launches
    _, metrics = pretrain_step(st, torch.as_tensor(x, device=cuda),
                               torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert (F.dropout_add_ln_fwd.launches - f0, F.dropout_add_ln_bwd.launches - b0) == (5, 5)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())


def test_fused_ln_autograd_runs_both_kernels(cuda):
    h, res, gamma, beta, dout, seed = _ln_case(cuda, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (h, res, gamma, beta)]
    f0, b0 = F.dropout_add_ln_fwd.launches, F.dropout_add_ln_bwd.launches
    F.dropout_add_ln(*leaves, seed, 0.1).backward(dout)
    torch.cuda.synchronize()
    assert (F.dropout_add_ln_fwd.launches - f0, F.dropout_add_ln_bwd.launches - b0) == (1, 1)
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_fused_ln_kernels_refuse_what_they_do_not_take(cuda):
    h, res, gamma, beta, dout, seed = _ln_case(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        F.dropout_add_ln_fwd(h[:100], res[:100], gamma, beta, seed, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        F.dropout_add_ln_fwd(h.t(), res.t(), gamma[:256], beta[:256], seed, 0.1)
    with pytest.raises(ValueError, match="seed"):
        F.dropout_add_ln_fwd(h, res, gamma, beta, seed.cpu(), 0.1)
    with pytest.raises(ValueError, match="gamma"):
        F.dropout_add_ln_fwd(h, res, gamma.half(), beta, seed, 0.1)
    with pytest.raises(TypeError):
        F.dropout_add_ln_fwd(h.half(), res.half(), gamma, beta, seed, 0.1)
    with pytest.raises(ValueError, match="rate"):
        F.dropout_add_ln_fwd(h, res, gamma, beta, seed, 1.0)


# L1 and L2 (the kernel lab) against their plain versions.  P rounded to bf16
# (L1 without upcast): K1's bf16 tolerance.  P split into two bf16 halves
# (L1 with upcast, L2): both sides keep ~16 bits of P or more and round O to
# bf16 once, so they differ by one bf16 step of O at most (2^-7 relative),
# plus 1e-4 for entries near zero.  lse: K1's 1e-3, in the plain version's
# units; under exp2 with the f32 log2(e), lse * ln 2 also equals K1's
# natural lse.
LAB_VARIANTS = ([("kt_fwd", dict(upcast=u, exp2=e)) for u in (False, True)
                 for e in (False, True)]
                + [("hl_fwd", dict(exp2=e)) for e in (False, True)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name,kw", LAB_VARIANTS,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for n, kw in LAB_VARIANTS])
def test_lab_kernels_match_reference(cuda, name, kw, causal):
    q, k, v, mask = _inputs(cuda, torch.bfloat16)
    fn, ref = getattr(lab, f"{name}_lse"), getattr(lab, f"{name}_reference")
    counter = getattr(lab, name)
    before = counter.launches
    out, lse = fn(q, k, v, mask, causal, **kw)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    r_out, r_lse = ref(q, k, v, mask, causal, **kw)
    split = kw.get("upcast", True)
    atol, rtol = (1e-4, 2.0 ** -7) if split else (1e-2, 1e-2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), r_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    if kw["exp2"] and split:
        _, nat = flash_attention_reference(q, k, v, mask, causal)
        torch.testing.assert_close(lse * math.log(2.0), nat, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,kw", LAB_VARIANTS,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for n, kw in LAB_VARIANTS])
def test_lab_kernels_fully_masked_rows(cuda, name, kw):
    """Sample 0 with every key masked (O is the mean of v, lse the -1e30
    sentinel plus log S, as in the plain version), sample 1 with its first
    kv tile masked (the sentinel's max gives way to the first kept key)."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16)
    mask[0] = 0.0
    mask[1, :80] = 0.0
    out, lse = getattr(lab, f"{name}_lse")(q, k, v, mask, False, **kw)
    r_out, r_lse = getattr(lab, f"{name}_reference")(q, k, v, mask, False, **kw)
    atol, rtol = (1e-4, 2.0 ** -7) if kw.get("upcast", True) else (1e-2, 1e-2)
    torch.testing.assert_close(out.float(), r_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    mean_v = v[0].float().mean(0).expand_as(out[0])
    torch.testing.assert_close(out[0].float(), mean_v, atol=atol, rtol=rtol)


def test_lab_kernels_read_strided_inputs(cuda):
    """q/k/v as views of one fused (B, S, 3, H, D) projection."""
    B, S, H, D = 2, 256, 2, 128
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    for fn, ref in ((lab.kt_fwd_lse, lab.kt_fwd_reference),
                    (lab.hl_fwd_lse, lab.hl_fwd_reference)):
        out, _ = fn(q, k, v, None, True)
        want, _ = ref(q, k, v, None, True)
        torch.testing.assert_close(out.float(), want.float(), atol=1e-4, rtol=2.0 ** -7)


def test_kt_attention_is_the_kernel_alone(cuda):
    """kt_fwd_lse = the transpose, then kt_attention: the same bits."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16)
    B, S, H, D = k.shape
    kt = k.reshape(B, S, H * D).transpose(1, 2).contiguous()
    got = lab.kt_attention(q, kt, v, mask, True, upcast=False, exp2=True)
    want = lab.kt_fwd_lse(q, k, v, mask, True, upcast=False, exp2=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="kt"):
        lab.kt_attention(q, kt.transpose(1, 2), v, mask)


def test_lab_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.float32)
    for fn in (lab.kt_fwd, lab.hl_fwd):
        with pytest.raises(TypeError, match="bf16"):
            fn(q, k, v, None)
    q, k, v, _ = _inputs(cuda, torch.bfloat16, D=64)
    for fn in (lab.kt_fwd, lab.hl_fwd):
        with pytest.raises(ValueError, match="head_dim"):
            fn(q, k, v, None)


def test_lab_main_runs_on_the_card(cuda):
    """The lab's program at a small shape: its checks against K1 pass and
    every kernel of it launches."""
    before = (lab.kt_fwd.launches, lab.hl_fwd.launches, flash_attention_fwd.launches)
    res = lab.main(device=cuda, kt=True, B=2, S=256, H=2)
    after = (lab.kt_fwd.launches, lab.hl_fwd.launches, flash_attention_fwd.launches)
    assert all(a > b for a, b in zip(after, before))
    assert all(e < 0.05 for e in res["checks"].values()) and len(res["checks"]) == 4
    assert all(t > 0 for s in res["sweeps"] for t in s.values())


# The lab's instances of K1's kernel template <KT, SPLIT_P>, by variant:
# kt_fwd upcast=False <true, false>, kt_fwd upcast=True <true, true>, hl_fwd
# <false, true>.  Tolerances as for LAB_VARIANTS above.
LAB_IDS = [f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for n, kw in LAB_VARIANTS]


def _lab_tol(kw):
    return (1e-4, 2.0 ** -7) if kw.get("upcast", True) else (1e-2, 1e-2)


@pytest.mark.parametrize("Sq,Skv", [(320, 320), (192, 320)])
@pytest.mark.parametrize("name,kw", LAB_VARIANTS, ids=LAB_IDS)
def test_lab_kernels_at_ragged_shapes(cuda, name, kw, Sq, Skv):
    """Lengths of 64 past a multiple of K1's 128-row tiles: the last q tile
    stores only its rows below Sq, the last kv tile's keys past Skv arrive
    as TMA's zeros (under KT a whole 64-key box of them) and take p = 0."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16, S=Sq, Skv=Skv, seed=3)
    out, lse = getattr(lab, f"{name}_lse")(q, k, v, mask, False, **kw)
    r_out, r_lse = getattr(lab, f"{name}_reference")(q, k, v, mask, False, **kw)
    atol, rtol = _lab_tol(kw)
    assert out.shape == q.shape and lse.shape == (2, 2, Sq)
    torch.testing.assert_close(out.float(), r_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    if kw["exp2"] and kw.get("upcast", True):
        _, nat = flash_attention_reference(q, k, v, mask, False)
        torch.testing.assert_close(lse * math.log(2.0), nat, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,kw", LAB_VARIANTS, ids=LAB_IDS)
def test_lab_kernels_fully_masked_rows_at_a_ragged_length(cuda, name, kw):
    """test_lab_kernels_fully_masked_rows at Skv = 320, every instance: the
    sentinel's c = 0 and the lse left at -1e30 plus log also where the last
    kv tile is ragged (its zero-filled keys take p = 0, not 1)."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16, S=320)
    mask[0] = 0.0
    mask[1, :80] = 0.0
    out, lse = getattr(lab, f"{name}_lse")(q, k, v, mask, False, **kw)
    r_out, r_lse = getattr(lab, f"{name}_reference")(q, k, v, mask, False, **kw)
    atol, rtol = _lab_tol(kw)
    torch.testing.assert_close(out.float(), r_out.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    mean_v = v[0].float().mean(0).expand_as(out[0])
    torch.testing.assert_close(out[0].float(), mean_v, atol=atol, rtol=rtol)


@pytest.mark.parametrize("upcast", [False, True])
def test_kt_attention_reads_a_padded_kt(cuda, upcast):
    """K^T as a slice of a (B, H*D, Skv + 64) buffer: its d rows 64 keys
    apart beyond Skv, read through the tensor map's strides; the same bits
    as from a packed K^T."""
    q, k, v, mask = _inputs(cuda, torch.bfloat16, S=320)
    B, S, H, D = k.shape
    packed = k.reshape(B, S, H * D).transpose(1, 2).contiguous()
    buf = torch.full((B, H * D, S + 64), float("nan"), dtype=k.dtype, device=cuda)
    buf[..., :S] = packed
    padded = buf[..., :S]
    assert padded.stride() == (H * D * (S + 64), S + 64, 1)
    got = lab.kt_attention(q, padded, v, mask, False, upcast=upcast)
    want = lab.kt_attention(q, packed, v, mask, False, upcast=upcast)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    r_out, _ = lab.kt_fwd_reference(q, k, v, mask, False, upcast=upcast)
    atol, rtol = _lab_tol(dict(upcast=upcast))
    torch.testing.assert_close(got[0].float(), r_out.float(), atol=atol, rtol=rtol)


# -- the finetune path and checkpoint loading on the card -------------------

def _flash_cfg(**kw):
    from pianobart_tpu_torch.models import tiny_config
    return tiny_config(d_model=256, num_heads=2, max_len=256, encoder_layers=1,
                       decoder_layers=1, ffn_dim=256, use_flash_attention=True,
                       dtype=torch.bfloat16, **kw)


def _counts():
    return (flash_attention_fwd.launches, flash_attention_delta.launches,
            flash_attention_bwd.launches)


@pytest.mark.parametrize("task", ["seq", "velocity", "generation"])
def test_finetune_step_launches_k1_delta_k2_per_attention(cuda, task):
    """A train step of a flash-eligible model runs K1, the delta kernel and
    K2 once per attention (3 here: encoder, decoder self, cross), an eval
    step K1 alone; the loss is finite."""
    from pianobart_tpu_torch.compat.from_jax import init_model
    from pianobart_tpu_torch.models import (PianoBartLM, SequenceClassification,
                                            TokenClassification)
    from pianobart_tpu_torch.train.finetune import (finetune_seq_step,
                                                    finetune_token_step)
    from pianobart_tpu_torch.train.generation import generation_step
    from pianobart_tpu_torch.train.state import create_train_state
    B, S = 2, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 4, (B, S, 8), device=cuda, generator=g)
    if task == "seq":
        model = init_model(SequenceClassification, _flash_cfg(), device=cuda,
                           train=True, class_num=4)
        y = torch.randint(0, 4, (B,), device=cuda, generator=g)
        step = finetune_seq_step
    elif task == "velocity":
        model = init_model(TokenClassification, _flash_cfg(decoder_label_vocab=5),
                           device=cuda, train=True, class_num=5)
        y = torch.randint(0, 4, (B, S), device=cuda, generator=g)
        step = lambda *a, **k: finetune_token_step(*a, velocity=True, **k)
    else:
        model = init_model(PianoBartLM, _flash_cfg(), device=cuda, train=True)
        y = torch.randint(0, 4, (B, S, 8), device=cuda, generator=g)
        step = generation_step
    state = create_train_state(model)
    before = _counts()
    _, m = step(state, x, y, g, train=True)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 3, 3]
    assert torch.isfinite(m["loss"]).item()
    before = _counts()
    step(state, x, y, None, train=False)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]


def test_loading_both_forms_on_the_card(cuda, tmp_path):
    """A checkpoint directory and the same weights as a reference ``.ckpt``
    load onto the card (built on the meta device), every tensor equal to
    the source's, and give the same logits (|diff| 0)."""
    from pianobart_tpu_torch.compat import torch_export
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.decode import load_inference_model
    from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
    cfg = _flash_cfg()
    model = init_lm(cfg, seed=5, device="cpu")
    CheckpointManager(str(tmp_path / "run")).save(1, create_train_state(model), {}, True)
    torch_export.save_torch_checkpoint(torch_export.export_lm(model.state_dict(), cfg),
                                       str(tmp_path / "ref.ckpt"))
    x = torch.randint(0, 4, (2, 256, 8), device=cuda)
    mask = torch.ones(2, 256, device=cuda)
    logits = []
    for path in (str(tmp_path / "run"), str(tmp_path / "ref.ckpt")):
        loaded = load_inference_model(cfg, path, device=cuda)
        for k, v in loaded.state_dict().items():
            assert v.device.type == "cuda" and torch.equal(v.cpu(), model.state_dict()[k]), k
        before = flash_attention_fwd.launches
        with torch.no_grad():
            logits.append(loaded(x, x, mask, mask))
        assert flash_attention_fwd.launches == before + 3
    assert torch.equal(logits[0], logits[1])


def test_fisher_batch_launches_the_f32_kernels(cuda):
    """One Fisher batch of ``merge`` (the LM loss's gradient with respect
    to the trunk, f32 compute): K1, the delta kernel and K2 once per
    attention, the f32 prep before each K1 and K2; RegMean's trunk forward
    K1 and the prep once per attention.  The gradients are finite and the
    head takes none."""
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.merge import cli as merge_cli
    cfg = _flash_cfg().replace(dtype=torch.float32)
    lm = init_lm(cfg, seed=2, device="cpu")
    trunk = {k: v.to(cuda) for k, v in lm.pianobart.state_dict().items()}
    head = {f"lm_head.{k}": v for k, v in lm.lm_head.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    batch = torch.randint(0, 4, (4, 256, 8), generator=g).numpy()
    grad_fn = merge_cli._lm_grad_fn(cfg, head, cuda)
    before, split = _counts(), flash_attention_split.launches
    grads = grad_fn(trunk, batch)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [3, 3, 3]
    assert flash_attention_split.launches - split == 6
    assert set(grads) == set(trunk) and all(torch.isfinite(v).all() for v in grads.values())
    before, split = _counts(), flash_attention_split.launches
    grams = merge_cli._trunk_grams(cfg, trunk, [batch], cuda)
    assert [a - b for a, b in zip(_counts(), before)] == [3, 0, 0]
    assert flash_attention_split.launches - split == 3
    assert all(v.dtype == torch.float64 and v.is_cuda for v in grams.values())


def test_merged_msgpack_loads_on_the_card(cuda, tmp_path):
    """A merged ``.msgpack`` loads onto the card (built on the meta
    device), every tensor the file's, with the logits of the same weights
    loaded from a checkpoint directory (|diff| 0)."""
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.decode import load_inference_model
    from pianobart_tpu_torch.merge.cli import save_merged
    from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state
    cfg = _flash_cfg()
    model = init_lm(cfg, seed=6, device="cpu")
    save_merged(model.state_dict(), str(tmp_path / "m.msgpack"))
    CheckpointManager(str(tmp_path / "run")).save(1, create_train_state(model), {}, True)
    x = torch.randint(0, 4, (2, 256, 8), device=cuda)
    mask = torch.ones(2, 256, device=cuda)
    logits = []
    for path in (str(tmp_path / "m.msgpack"), str(tmp_path / "run")):
        loaded = load_inference_model(cfg, path, device=cuda)
        for k, v in loaded.state_dict().items():
            assert v.is_cuda and torch.equal(v.cpu(), model.state_dict()[k]), k
        with torch.no_grad():
            logits.append(loaded(x, x, mask, mask))
    assert torch.equal(logits[0], logits[1])


def test_trace_with_memory_on_the_card(cuda, tmp_path):
    """``trace(with_memory=True)`` around a K1 launch writes a Chrome trace
    naming the kernel and a memory snapshot."""
    import json
    import os

    from pianobart_tpu_torch.utils.profiling import MEMORY_FILE, TRACE_FILE, trace
    q, k, v, mask = _inputs(cuda, torch.bfloat16)
    with trace(str(tmp_path)):
        flash_attention_fwd(q, k, v, mask, False)
        torch.cuda.synchronize()
    with open(tmp_path / TRACE_FILE) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("flash_fwd_wgmma_kernel" in n for n in names), sorted(names)[:20]
    assert os.path.getsize(tmp_path / MEMORY_FILE) > 0


def test_kth_smallest_on_the_card_picks_numpys_element(cuda):
    """The card's sort picks the element the host's ``kthvalue`` (and
    ``np.partition``) picks, ties and all."""
    import numpy as np

    from pianobart_tpu_torch.merge.methods import _kth_smallest
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-50, 50, (3001, 7), generator=g).float() / 7
    for k in (1, 2, 17, 10503, x.numel()):
        want = np.partition(x.abs().numpy().ravel(), k - 1)[k - 1]
        assert _kth_smallest(x.abs().to(cuda), k).item() == want
        assert _kth_smallest(x.abs(), k).item() == want


def test_merges_on_the_card_equal_the_host(cuda):
    """The deterministic merges compute on the card what they compute on
    the host, entry for entry: average, task arithmetic, TIES and both DARE
    formats of the magnitude mask with its 1/(1-p) rescale."""
    from pianobart_tpu_torch.merge import methods as M
    g = torch.Generator().manual_seed(3)
    shapes = {"a.weight": (64, 48), "a.bias": (64,), "b.weight": (33, 64)}
    pre = {k: torch.randn(s, generator=g) * 0.02 for k, s in shapes.items()}
    fins = [{k: v + torch.randn(v.shape, generator=g) * 1e-3 for k, v in pre.items()}
            for _ in range(3)]

    def on(dev):
        p = {k: v.to(dev) for k, v in pre.items()}
        f = [{k: v.to(dev) for k, v in m.items()} for m in fins]
        return [M.average_merging(f), M.task_arithmetic(p, f, 0.7),
                M.ties_merging(p, f, 0.6, 0.9),
                M.mask_model_weights(f[0], p, "delta_weight", 0.8, True, "magnitude"),
                M.mask_model_weights(f[1], None, "finetuned_weight", 0.7, True, "magnitude")]
    names = ("average", "task arithmetic", "TIES", "magnitude mask (delta)",
             "magnitude mask (weights)")
    for name, card, host in zip(names, on(cuda), on("cpu")):
        for k, v in host.items():
            assert torch.equal(card[k].cpu(), v), (name, k)


# ---------------------------------------------------------------------------
# The ring (ops/ring.py): K1, delta, K2 and K3 with the merged lse
# ---------------------------------------------------------------------------

def _ring_rank(rank, world, out_dir, S, dtype_name):
    """One rank of a two-rank ring on cuda:0 (over gloo, blocks staged
    through the host): the kernels' ring and the plain ring on this rank's
    shard, their outputs and gradients, and the kernels' launches."""
    import os
    from pianobart_tpu_torch.ops.ring import ring_attention, ring_attention_reference
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, 1, world, device=dev)
    ax = mesh.axis("sp")
    q, k, v, mask = _inputs(dev, getattr(torch, dtype_name), B=2, S=S, H=2)
    mask[0, S - S // 2 - 8:] = 0.0            # sample 0's last shard all padding
    g = torch.Generator(device=dev).manual_seed(3)
    dout = torch.randn(q.shape, device=dev, generator=g).to(q.dtype)
    res = {}
    for causal in (False, True):
        for tag, fn in (("kernels", ring_attention), ("plain", ring_attention_reference)):
            before = (flash_attention_fwd.launches, flash_attention_bwd.launches,
                      flash_attention_dq.launches, flash_attention_dkv.launches)
            ql, kl, vl = (mesh.cols(x).detach().clone().requires_grad_() for x in (q, k, v))
            o = fn(ql, kl, vl, mesh.cols(mask), causal, ax)
            o.backward(mesh.cols(dout))
            torch.cuda.synchronize()
            after = (flash_attention_fwd.launches, flash_attention_bwd.launches,
                     flash_attention_dq.launches, flash_attention_dkv.launches)
            res[causal, tag] = ([t.detach().cpu() for t in (o, ql.grad, kl.grad, vl.grad)],
                                tuple(a - b for a, b in zip(after, before)))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [512, 4096], ids=["K2", "K3"])
def test_ring_kernels_with_merged_lse_match_the_plain_ring(cuda, tmp_path, S, dtype):
    """Two ranks share the card: every visible block runs K1, and its
    gradients come from the merged lse and the delta of the merged output
    through K2 (local shard 256 rows) or K3a and K3b (2048 rows), against
    the plain ring on the same shards, a wholly padded key shard included,
    at the kernels' own tolerances (the output's as K1's, the gradients' as
    K2's)."""
    from pianobart_tpu_torch.parallel.launch import spawn
    spawn(_ring_rank, 2, (str(tmp_path), S, str(dtype).split(".")[1]))
    for rank in range(2):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        for causal in (False, True):
            (got, launches), (want, none) = res[causal, "kernels"], res[causal, "plain"]
            blocks = 1 + rank if causal else 2
            k2 = blocks if S == 512 else 0
            assert launches == (blocks, k2, blocks - k2, blocks - k2) and none == (0,) * 4
            atol, rtol, _ = TOL[dtype]
            assert torch.isfinite(got[0]).all()
            torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol, rtol=rtol)
            assert_bwd_close(got[1:], want[1:], dtype)


def test_ring_refuses_shards_the_kernels_do_not_take(cuda):
    """A local shard of 192 rows on CUDA raises; the ring never falls back
    to plain attention."""
    from pianobart_tpu_torch.ops.ring import ring_attention
    from pianobart_tpu_torch.parallel.mesh import single_device_mesh
    q, k, v, mask = _inputs(cuda, torch.bfloat16, S=192)
    with pytest.raises(ValueError, match="local shards the flash kernels take"):
        ring_attention(q, k, v, mask, False, single_device_mesh(cuda).axis("sp"))


def test_nccl_refuses_more_ranks_than_cards(cuda, monkeypatch):
    """``init_from_env`` with nccl and more local ranks than cards raises
    before any process group exists (NCCL would say "Duplicate GPU")."""
    from pianobart_tpu_torch.parallel.mesh import init_from_env
    n = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(n))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n))
    with pytest.raises(ValueError, match="one rank per card"):
        init_from_env(f"1x1x{n}", "nccl")
    assert not torch.distributed.is_initialized()


# Head widths 384 .. 2048: every kernel as clusters that sum S and dP across
# the cluster through each other's shared memory, of D/128 CTAs (one per 128
# columns of the head; 9 .. 16 past 1024, the card's non-portable sizes) but
# the bf16 ones' (K1 and the backward), of ceil(D/256) CTAs of their D=256
# designs (640: three CTAs, the last one's upper half past D; 1024: four,
# summed in two pair rounds; 1152: five, the last one's upper half past D;
# 2048: eight, in three pair rounds); past 2048 bf16 alone (f32 stops there):
# 2176, nine CTAs, the last one's upper half past D; 3072, twelve; 4096,
# sixteen, the card's largest cluster; the same tolerances as at D = 128.
WIDE_DS = [384, 512, 640, 1024, 1152, 1536, 2048]
WIDE_BF16_DS = [2176, 3072, 4096]
WIDE_CASES = ([(D, dtype) for D in WIDE_DS for dtype in DTYPES]
              + [(D, torch.bfloat16) for D in WIDE_BF16_DS])


@pytest.mark.parametrize("D,dtype", WIDE_CASES)
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 256, 256, False), (2, 2, 256, 256, True), (2, 2, 192, 320, False),
    (3, 2, 320, 320, True), (1, 1, 64, 64, False)],
    ids=["256", "256-causal", "192x320", "320-causal", "one-cluster"])
def test_flash_kernel_wide_matches_reference(cuda, B, H, Sq, Skv, causal, D, dtype):
    q, k, v, mask = _inputs(cuda, dtype, B=B, H=H, S=Sq, Skv=Skv, D=D)
    f0, s0 = flash_attention_fwd.launches, flash_attention_split.launches
    out, lse = flash_attention_fwd(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches - f0, flash_attention_split.launches - s0) == (
        1, int(dtype == torch.float32))
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal)
    atol, rtol, ltol = TOL[dtype]
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=ltol, rtol=0)


@pytest.mark.parametrize("D,dtype", WIDE_CASES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("B,H,Sq,Skv,causal", [
    (2, 2, 256, 256, False), (2, 2, 256, 256, True), (2, 2, 192, 320, True),
    (2, 2, 320, 192, False), (1, 1, 64, 64, True)],
    ids=["256", "256-causal", "192x320-causal", "320x192", "one-cluster"])
def test_flash_bwd_kernels_wide_match_reference(cuda, kernel, D, B, H, Sq, Skv, causal,
                                                dtype):
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, True,
                                           B=B, H=H, S=Sq, Skv=Skv, D=D)
    counters = (flash_attention_bwd, flash_attention_dq, flash_attention_dkv,
                flash_attention_split)
    before = [c.launches for c in counters]
    got, want = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
    torch.cuda.synchronize()
    preps = (1 if kernel == "K2" else 2) if dtype == torch.float32 else 0
    want_counts = [1, 0, 0, preps] if kernel == "K2" else [0, 1, 1, preps]
    assert [c.launches - b for c, b in zip(counters, before)] == want_counts
    assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_kernels_wide_fully_masked_sample_and_strides(cuda, kernel, dtype):
    """Sample 0 wholly masked (P = 1 on every key), q/k/v as views of one
    fused projection and dO a view: the D=512 clusters read the strides."""
    B, S, H, D = 2, 320, 2, 512
    qkv = torch.randn(B, S, 3, H, D, device=cuda, dtype=dtype)
    qkv[:, :, 0] *= D ** -0.5
    q, k, v = qkv.unbind(2)
    mask = torch.ones(B, S, device=cuda)
    mask[0] = 0.0
    out, lse = flash_attention_fwd(q, k, v, mask, False)
    assert (lse[0] == -1e30).all()
    ref, ref_lse = flash_attention_reference(q, k, v, mask, False)
    atol, rtol, ltol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    dout = torch.randn(B, S, 2, H, D, device=cuda, dtype=dtype)[:, :, 0]
    got, want = _bwd(kernel, q, k, v, mask, False, out, lse, dout)
    assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("D,dtype", [(D, dtype) for D in (384, 512) for dtype in DTYPES]
                         + [(D, torch.bfloat16) for D in WIDE_BF16_DS])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flash_kernels_wide_are_deterministic(cuda, kernel, D, dtype):
    """Two runs give the same bits, and every CTA of a cluster holds the
    same sums: q, k, v and dO whose D/128 column blocks are equal give O,
    dQ, dK and dV whose blocks are equal to the bit only if every CTA holds
    the same P and dS (the lse rank 0 stores is then every CTA's)."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, True, True, S=1024, D=D)
    o2, l2 = flash_attention_fwd(q, k, v, m, True)
    assert torch.equal(out, o2) and torch.equal(lse, l2)
    a, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    b, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    n = D // 128

    def twin(x):
        return torch.cat([x[..., :128]] * n, -1).contiguous()

    q, k, v, dout = (twin(x) for x in (q, k, v, dout))
    out, lse = flash_attention_fwd(q, k, v, m, True)
    got, _ = _bwd(kernel, q, k, v, m, True, out, lse, dout)
    for name, x in zip(("o", "dq", "dk", "dv"), (out, *got)):
        for r in range(1, n):
            assert torch.equal(x[..., :128], x[..., 128 * r:128 * (r + 1)]), (name, r)


@pytest.mark.parametrize("D,dtype", [(D, dtype) for D in (384, 512, 640, 768, 1024, 1152, 2048)
                                     for dtype in DTYPES]
                         + [(D, torch.bfloat16) for D in WIDE_BF16_DS])
@pytest.mark.parametrize("S,causal", [(320, False), (320, True), (1024, False)],
                         ids=["320", "320-causal", "1024"])
def test_redesigned_wide_kernels_twin_blocks_and_determinism(cuda, D, S, causal, dtype):
    """bf16 K1 and the bf16 backward (both clusters of ceil(D/256) CTAs of
    their D=256 designs: a pair at 384 and 512, three CTAs at 640 and 768,
    four at 1024, five at 1152 (``cluster_sum``), eight at 2048 (three pair
    rounds), nine at 2176, twelve at 3072 and sixteen at 4096, the last
    one's upper half past D at 384, 640, 1152 and 2176), the f32
    K1 (D/128 CTAs, each consumer warpgroup summing its own score tile: pair
    rounds at 512, 1024 and 2048 (16 CTAs, a non-portable cluster),
    ``cluster_sum`` at 384, 640, 768 and 1152 (9 CTAs)) and the
    f32 backward (two warpgroups a CTA on alternate 32-row swept tiles,
    flushing into dQ, dK and dV in one order): two runs of K1, K2 and K3 give
    the same bits, and q, k, v and dO whose 128-column blocks are equal give
    O, dQ, dK and dV whose blocks are equal to the bit, which holds only if
    every CTA of a cluster holds the same P and dS, its warpgroups' flushes
    land whole, and a partial CTA adds nothing past D."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, dtype, causal, True, S=S, D=D)
    o2, l2 = flash_attention_fwd(q, k, v, m, causal)
    assert torch.equal(out, o2) and torch.equal(lse, l2)
    for kernel in ("K2", "K3"):
        a, _ = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
        b, _ = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), kernel
    n = D // 128

    def twin(x):
        return torch.cat([x[..., :128]] * n, -1).contiguous()

    q, k, v, dout = (twin(x) for x in (q, k, v, dout))
    out, lse = flash_attention_fwd(q, k, v, m, causal)
    for kernel in ("K2", "K3"):
        got, _ = _bwd(kernel, q, k, v, m, causal, out, lse, dout)
        for name, x in zip(("o", "dq", "dk", "dv"), (out, *got)):
            for r in range(1, n):
                assert torch.equal(x[..., :128], x[..., 128 * r:128 * (r + 1)]), (kernel, name, r)


@pytest.mark.parametrize("D", [384, 640, 896, 1152, 2176, 3968])
def test_wide_bf16_backward_repeats_its_bits_with_a_zero_filled_cta(cuda, D):
    """The bf16 dQ and dK/dV kernels at a width whose last CTA's upper half
    lies past D (that CTA loads half the bytes and runs ahead of its peers)
    give the same bits over ten calls at a causal shape with many clusters
    in flight: each exchange's region is read before the peer may write it
    again (``hopper.cuh:fence_cta``; without it the D=384 dQ moved run to
    run there)."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, torch.bfloat16, True, True,
                                           B=8, H=4, S=1024, D=D)
    args = (q, k, v, m, True, lse, _delta(dout, out), dout)
    dq0 = flash_attention_dq(*args)
    dk0, dv0 = flash_attention_dkv(*args)
    for _ in range(10):
        assert torch.equal(flash_attention_dq(*args), dq0)
        dk, dv = flash_attention_dkv(*args)
        assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


@pytest.mark.parametrize("D", [384, 512, 640, 1024, 1152, 1920, 2048])
def test_wide_f32_kernels_repeat_their_bits(cuda, D):
    """The f32 K1 (each consumer warpgroup summing its own score tile across
    the cluster: ``cluster_sum`` at 384, 640, 1152 and 1920, pair rounds at
    512, 1024 and 2048) and the f32 dQ and dK/dV kernels (``cluster_sum`` of
    S and dP at every n, its owners packed 4 bits a chunk up to rank 15 at
    2048, each thread's reads of a region fenced before it is given back)
    give the same bits over ten calls at a causal shape with many clusters in
    flight."""
    q, k, v, m, out, lse, dout = _bwd_case(cuda, torch.float32, True, True,
                                           B=8, H=2, S=1024, D=D)
    args = (q, k, v, m, True, lse, _delta(dout, out), dout)
    dq0 = flash_attention_dq(*args)
    dk0, dv0 = flash_attention_dkv(*args)
    for _ in range(10):
        o, l = flash_attention_fwd(q, k, v, m, True)
        assert torch.equal(o, out) and torch.equal(l, lse)
        assert torch.equal(flash_attention_dq(*args), dq0)
        dk, dv = flash_attention_dkv(*args)
        assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


def test_bf16_clusters_of_9_to_16_are_held(cuda):
    """Every bf16 cluster kernel at D = 2176 .. 4096 runs as ceil(D/256) =
    9 .. 16 CTAs, sizes past the card's portable 8 that it must be allowed
    (``hopper.cuh:max_active_clusters``): the card holds at least one such
    cluster of each at every size."""
    import ctypes
    from pianobart_tpu_torch.ops.build import build_kernel
    for lib, which in (("flash_fwd", 0), ("flash_bwd", 1), ("flash_bwd", 0)):
        for D in range(2176, 4097, 256):
            n = ctypes.c_int(0)
            active = build_kernel(lib).pbt_cluster_occupancy(D, 1, which, ctypes.byref(n))
            assert n.value == (D + 255) // 256 and active > 0, (lib, which, D, n.value, active)
        n = ctypes.c_int(0)
        assert build_kernel(lib).pbt_cluster_occupancy(2176, 0, which, ctypes.byref(n)) == 0


def test_f32_clusters_of_16_are_held(cuda):
    """Every f32 cluster kernel at D = 2048 runs as 16 CTAs, a size past the
    card's portable 8 that it must be allowed (``hopper.cuh:
    max_active_clusters``): the card holds at least one such cluster of each
    (``cudaOccupancyMaxActiveClusters`` > 0), and of the bf16 ones at 8."""
    import ctypes
    from pianobart_tpu_torch.ops.build import build_kernel
    for lib, which in (("flash_fwd", 0), ("flash_bwd", 1), ("flash_bwd", 0)):
        for dtype, want in ((0, 16), (1, 8)):
            n = ctypes.c_int(0)
            active = build_kernel(lib).pbt_cluster_occupancy(2048, dtype, which,
                                                             ctypes.byref(n))
            assert n.value == want and active > 0, (lib, which, dtype, n.value, active)


@pytest.mark.parametrize("D,dtype", WIDE_CASES)
def test_delta_and_split_kernels_wide_match_reference(cuda, D, dtype):
    """delta (a warp a row past D = 256) against its plain version on views
    of a wider tensor, and in f32 the prep (8 rows a CTA, of half the columns
    past D = 1024) bit for bit."""
    B, S, H = 2, 320, 2
    g = torch.Generator(device=cuda).manual_seed(3)
    both = torch.randn(B, S, 2, H, D, device=cuda, generator=g).to(dtype)
    dout, out = both.unbind(2)
    before = flash_attention_delta.launches
    got = flash_attention_delta(dout, out)
    torch.cuda.synchronize()
    assert flash_attention_delta.launches == before + 1
    torch.testing.assert_close(got, _delta(dout, out), atol=1e-4, rtol=1e-5)
    if dtype == torch.float32:
        for natural, transposed in [(True, False), (False, True), (True, True)]:
            for a, b in zip(flash_attention_split(out, natural, transposed),
                            flash_attention_split_reference(out, natural, transposed)):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)

