"""The 3xTF32 recipe of the port's f32 attention kernels, emulated in
PyTorch on the CPU (``ops/flash.py``: ``flash_attention_split`` and its
plain version).

Each f32 operand x is split into hi = x rounded to tf32 and lo = x - hi,
and a product is taken as hi.hi' + hi.lo' + lo.hi' on tensor cores that
read tf32 (10 mantissa bits).  A product of two tf32 values is exact in
f32, so an f32 ``matmul`` of tf32-valued planes emulates one pass; the
tensor cores drop lo's own low 13 bits, emulated here by truncating them.
Held to the kernels' f32 tolerances against an f32 ``matmul`` (K1's 1e-4,
the backward's 1e-5 of max|ref| and of ||ref||), and one tf32 pass must
land at least 10x further off: the numeric choice, settled before the card.
"""
import numpy as np
import pytest
import torch

from pianobart_tpu_torch.ops.flash import (flash_attention_split,
                                           flash_attention_split_reference)

ORDER = [0, 2, 4, 6, 1, 3, 5, 7]    # an A fragment's k order within each 8


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _truncate_tf32(x):
    """What the tensor cores read of an f32 value: its low 13 bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _three_pass(a, b):
    """a @ b.T as the kernels take it: hi.hi' + hi.lo' + lo.hi'."""
    ah, al = flash_attention_split_reference(a[None, :, None])[0][:, 0, 0]
    bh, bl = flash_attention_split_reference(b[None, :, None])[0][:, 0, 0]
    al, bl = _truncate_tf32(al), _truncate_tf32(bl)
    return ah @ bh.T + ah @ bl.T + al @ bh.T


def _one_pass(a, b):
    ah = flash_attention_split_reference(a[None, :, None])[0][0, 0, 0]
    bh = flash_attention_split_reference(b[None, :, None])[0][0, 0, 0]
    return ah @ bh.T


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_split_is_exact(scale):
    """hi has its low 13 bits clear, hi + lo == x exactly, and |lo| is at
    most half a tf32 ulp of x."""
    x = _x((2, 64, 3, 128), 0) * scale
    nat, tr = flash_attention_split_reference(x, True, True)
    hi, lo = nat
    assert nat.shape == (2, 2, 3, 64, 128) and tr.shape == (2, 2, 3, 128, 64)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi + lo, x.permute(0, 2, 1, 3))
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def test_transposed_planes_run_in_the_fragment_order():
    """tr holds, within each 8 positions of S, rows 0 2 4 6 1 3 5 7: the k
    order in which hopper.cuh:split_acc_tf32 hands an accumulator's columns
    to an A fragment.  A contraction in that order on both sides is P V."""
    S = 64
    v = _x((1, S, 1, 128), 1)
    nat, tr = flash_attention_split_reference(v, True, True)
    perm = torch.tensor([g + ORDER[i] for g in range(0, S, 8) for i in range(8)])
    assert torch.equal(tr, nat.transpose(3, 4)[..., perm])
    p = _x((64, S), 2)
    full = tr[0, 0, 0] + tr[1, 0, 0]                 # (128, S) in fragment order
    torch.testing.assert_close(p[:, perm] @ full.T, p @ v[0, :, 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("what", ["scores", "pv"])
def test_three_tf32_passes_keep_f32_accuracy(what):
    """At an attention product's shape (128 rows x 128 keys x D = 128):
    scores S = Q K^T with Q pre-scaled, or O = P V with P a softmax row.
    Within K1's 1e-4 + 1e-4|ref| and the backward's 1e-5 max|ref| +
    1e-5|ref| and 1e-5 ||ref|| of an f32 matmul; one tf32 pass at least 10x
    further from the exact product than three."""
    if what == "scores":
        a, b = _x((128, 128), 3) * 128 ** -0.5, _x((128, 128), 4)
    else:
        a = torch.softmax(_x((128, 128), 5) * 3, dim=-1)
        b = _x((128, 128), 6).T.contiguous()        # V^T: rows are D, keys along
    ref = a @ b.T
    exact = (a.double() @ b.double().T)
    got = _three_pass(a, b)
    d = (got - ref).abs()
    assert bool((d <= 1e-4 + 1e-4 * ref.abs()).all())
    assert bool((d <= 1e-5 * ref.abs().max() + 1e-5 * ref.abs()).all())
    assert d.norm() <= 1e-5 * ref.norm()
    err3 = (got.double() - exact).norm()
    err1 = (_one_pass(a, b).double() - exact).norm()
    assert err1 >= 10 * err3, (err1.item(), err3.item())


def test_split_on_the_cpu_is_the_plain_version():
    """flash_attention_split on a CPU tensor: the plain version, no launch
    counted; natural or transposed planes only where asked for."""
    x = _x((1, 128, 2, 128), 7)
    before = flash_attention_split.launches
    for natural, transposed in [(True, False), (False, True), (True, True)]:
        got = flash_attention_split(x, natural, transposed)
        want = flash_attention_split_reference(x, natural, transposed)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)
    assert flash_attention_split.launches == before
