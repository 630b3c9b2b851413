"""The wide heads' redesigned kernels (head widths 384 .. 1024): how each
splits the head's columns across a cluster and sums the scores, modelled in
plain PyTorch on the CPU and held against the JAX package's Pallas kernels
in interpret mode.

* bf16 K1 (``csrc/flash_fwd_d256.cuh:flash_fwd_d256_wgmma_kernel<true>``):
  clusters of ceil(D/256) CTAs of the D=256 design, each on 256 columns of
  the head; where D is not a multiple of 256 the last CTA's upper 128
  columns lie past D and arrive as zeros (TMA's fill).  Each CTA's partial
  S = Q K^T over its columns is an f32 sum of bf16 products; a pair adds
  the two (``hopper.cuh:pair_sum``: in either order, the same sum), four
  CTAs (p0 + p1) + (p2 + p3) (two pair rounds), three in rank order
  (``cluster_sum``), so every CTA holds the same S.  Then the D=256 kernel's schedule:
  kv tiles of 128 rows, tiles above a q tile's diagonal skipped, the
  running max moved only when a row's max grows past 2^8, p = 1 on a row
  with no kept key so far, P rounded to bf16 per tile, O column block by
  column block, O = acc / l, lse = m + ln l.
* bf16 backward (``csrc/flash_bwd.cu:flash_bwd_d256_wgmma_kernel<DKV, true>``):
  clusters of ceil(D/256) CTAs of the D=256 design on 256 columns each
  (zeros past D), the partials of S^T and dP^T (S and dP) summed as K1's;
  then the D=256 kernels' schedule (``tests/test_torch_bf16_d256_bwd.py``):
  dK/dV over 64 fixed kv rows and swept q tiles of 64 from the diagonal's
  (causal), P^T in f32 handed to dS^T = P^T (dP^T - delta), dV += P^T dO and
  dK += dS^T Q tile by tile; dQ over 64 fixed q rows a warpgroup and swept
  kv tiles to its diagonal's, dQ += dS K; P^T, dS^T and dS rounded to bf16
  as product operands.
* f32 K1 (``csrc/flash_fwd.cu:flash_fwd_wide_tf32_kernel``): clusters of
  D/128 CTAs, each CTA's partial S three tf32 passes on its 128 columns of
  the prep's planes; each consumer warpgroup sums its score tile across the
  cluster, by pair rounds at n = 4 and 8 (``hopper.cuh:pair_sum``: in
  round i each CTA adds the sum of rank ^ 2^i to its own,
  so ((p0 + p1) + (p2 + p3)) + ...) and in rank order at n = 3, 5, 6, 7
  (``cluster_sum``).  Then the D=128 kernel's schedule: q tiles of 128
  rows, kv tiles of 64 up to the q tile's last row's (causal), p = 1 on a
  row with no kept key so far, the running max moved only when a row's max
  grows past 2^8 (the D=256 kernel's softmax), P split into hi and lo for
  three tf32 passes of P V, O = acc / l, lse = m + ln l.
* f32 backward (``csrc/flash_bwd.cu:flash_bwd_wide_tf32_kernel<DKV>``):
  clusters of D/128 CTAs, each CTA's products three tf32 passes on its 128
  columns of the prep's planes (``tests/test_torch_f32_d256.py``'s
  arithmetic), S^T and dP^T (S and dP) the partials summed in rank order.
  Per fixed tile of 64 rows the swept tiles are 32 rows, warpgroup 0 taking
  the even ones and warpgroup 1 the odd ones, each accumulating its own and
  flushing at the end of each window of 8 swept tiles (4 of its own), in a
  fixed order per accumulator: dV warpgroup 0's chain then 1's, dK 1's then
  0's, dQ's first 64 columns 0's then 1's and its last 64 1's then 0's; the
  first chain of the first window is stored, every later one added; a
  warpgroup without a tile there adds nothing.  Causal tiles wholly masked
  are skipped as the kernels skip them.

Inputs: (B, S, H) = (1, 320, 2) at D = 384, 512, 640 and 1024 (S=320: ten
swept tiles of 32, so two flush windows, and two and a half kv tiles of
128), and 768 for the f32 K1 (n = 6), with a pad tail, causal and not; bf16
inputs as their bf16 values in f32 to both sides.  Tolerances: the f32 K1,
and bf16 K1 with P kept in f32, within
``tests/test_torch_head_wide.py``'s f32 forward rows (rtol = atol = 2e-5,
summation order); bf16 K1 with P rounded to bf16 as the kernel rounds it, within
the card's bf16 tolerance (``tests/test_torch_cuda.py:TOL``: |dO| <=
1e-2 + 1e-2 |O|, |dlse| <= 1e-3).  The backward's dQ, dK and dV within
1.5e-6 of their norm (``tests/test_torch_f32_d256.py``'s 1.3e-6 at D=256,
with room for sums over four times the columns).  The bf16 backward with
f32 operands within ``tests/test_torch_bf16_d256_bwd.py``'s 2e-5 (summation
order; the absolute part times the tensor's largest entry), with bf16 operands within the card's bf16 backward tolerance
(``chip_smoke.py``'s ``[flash_bwd]``: |d| <= 1e-2 max|ref| + 1e-2 |ref| per
element, ||d|| <= 1e-2 ||ref||).
"""
import functools

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.ops import flash as port_flash

torch.set_num_threads(2)

B, S, H = 1, 320, 2
WIDTHS = [384, 512, 640, 1024]
NEG_INF = -1e30
LOG2E = 1.4426950408889634
K1_COLS = 256         # head columns a bf16 K1 CTA holds
BN = 128              # K1's kv rows a tile
BM = 128              # K1's q rows a CTA
F_COLS = 128          # head columns an f32 backward CTA holds
FIX = 64              # the backward's fixed rows a CTA
TR = 32               # the backward's swept rows a tile
FLUSH = 4             # a warpgroup's tiles a chain
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = (1e-2, 1e-2, 1e-3)
BWD_TOL = 1.5e-6
BF16_BWD_TOL = (1e-2, 1e-2, 1e-2)
TILE = 64             # the bf16 backward's swept rows, and fixed rows a warpgroup
F_BN = 64             # the f32 K1's kv rows a tile
F32_K1_WIDTHS = [384, 512, 640, 768, 1024]   # n = 3, 4, 5, 6, 8


def _inputs(D, seed, bf16=False):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[-1, S - 40:] = 0.0
    if bf16:
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    return q, k, v, mask


@functools.lru_cache(maxsize=None)
def _jax_fwd(D, causal, bf16):
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _fwd
    q, k, v, mask = _inputs(D, D + causal, bf16)
    out, lse, flat = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                          causal, None, None)
    return (q, k, v, mask), out, lse, flat


def _cluster_sum(parts):
    """The CTAs' partial products summed as the kernels sum them: a pair in
    one round, four CTAs (p0 + p1) + (p2 + p3), three in rank order."""
    if len(parts) == 4:
        return (parts[0] + parts[1]) + (parts[2] + parts[3])
    s = torch.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def _k1_model(inputs, causal, rounded):
    """bf16 K1's clusters: (out (B, S, H, D), lse (B, H, S)) in f32."""
    q, k, v, mask = inputs
    D = q.shape[-1]
    n = -(-D // K1_COLS)
    pad = n * K1_COLS - D                        # columns past D: TMA's zeros
    Q, K, V = (torch.nn.functional.pad(torch.from_numpy(x), (0, pad)).permute(0, 2, 1, 3)
               for x in (q, k, v))               # (B, H, S, n * 256)
    n_kv = -(-S // BN)
    kpad = n_kv * BN - S                         # the ragged last kv tile
    K = torch.nn.functional.pad(K, (0, 0, 0, kpad))
    V = torch.nn.functional.pad(V, (0, 0, 0, kpad))
    keep_key = torch.nn.functional.pad(torch.from_numpy(mask) != 0, (0, kpad))
    op = (lambda x: x.bfloat16().float()) if rounded else (lambda x: x)

    def scores(rows, cols):
        return _cluster_sum([Q[:, :, rows, r * K1_COLS:(r + 1) * K1_COLS]
                             @ K[:, :, cols, r * K1_COLS:(r + 1) * K1_COLS].transpose(-1, -2)
                             for r in range(n)])

    out = torch.zeros(B, H, S, n * K1_COLS)
    lse = torch.zeros(B, H, S)
    for q0 in range(0, S, BM):
        rows = torch.arange(q0, min(q0 + BM, S))
        tiles = min(n_kv, q0 // BN + 1) if causal else n_kv
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), n * K1_COLS)
        for j in range(tiles):
            cols = torch.arange(j * BN, (j + 1) * BN)
            keep = keep_key[:, None, None, cols]
            if causal:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = torch.where(keep, scores(rows, cols), torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            move = (m_new - m) * LOG2E > 8.0
            corr = torch.where(move, torch.exp2((m - m_new) * LOG2E), 1.0)
            m_new = torch.where(move, m_new, m)
            c = torch.where(m_new == NEG_INF, 0.0, LOG2E)
            p = torch.exp2(s * c - m_new * c)
            p = torch.where(cols < S, p, 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + op(p) @ V[:, :, cols]
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        out[:, :, rows] = acc / l_safe
        lse[:, :, rows] = (m + torch.log(l_safe))[..., 0]
    return out[..., :D].permute(0, 2, 1, 3).numpy(), lse.numpy()


@pytest.mark.parametrize("rounded", [False, True], ids=["f32-P", "bf16-P"])
@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("D", WIDTHS)
def test_bf16_k1_clusters_of_256_columns_match_jax(D, causal, rounded):
    """K1's partial scores over 256-column CTAs (zeros past D), summed in rank
    order, through the D=256 schedule == the Pallas ``_fwd`` at width D."""
    inputs, j_out, j_lse, _ = _jax_fwd(D, causal, True)
    out, lse = _k1_model(inputs, causal, rounded)
    j_out = np.asarray(j_out).reshape(B, S, H, D)
    if rounded:
        atol, rtol, ltol = BF16_TOL
        np.testing.assert_allclose(out, j_out, atol=atol, rtol=rtol)
        np.testing.assert_allclose(lse, np.asarray(j_lse), atol=ltol, rtol=0)
    else:
        np.testing.assert_allclose(out, j_out, **TOL)
        np.testing.assert_allclose(lse, np.asarray(j_lse), **TOL)


@functools.lru_cache(maxsize=None)
def _jax_bf16_bwd(D, causal, kernel):
    """bf16 inputs (as f32), dO, JAX's lse and delta, and (dq, dk, dv) of
    the Pallas ``_bwd_fused_call`` (K2) or ``_dq_call`` and ``_dkv_call``
    (K3), each (B, S, H*D)."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _dkv_call, _dq_call
    inputs, out, lse, (qf, kf, vf, maskf) = _jax_fwd(D, causal, True)
    dout = torch.from_numpy(np.random.default_rng(D).standard_normal(
        (B, S, H, D)).astype(np.float32)).bfloat16().float().numpy()
    dof = jnp.asarray(dout).reshape(B, S, H * D)
    delta = _delta(dof, out, H)
    args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, H)
    want = _bwd_fused_call(*args) if kernel == "K2" else (_dq_call(*args), *_dkv_call(*args))
    return inputs, dout, np.array(lse), np.array(delta), tuple(np.asarray(x) for x in want)


def _bf16_bwd_model(inputs, dout, lse, delta, causal, rounded):
    """The bf16 dK/dV and dQ kernels' clusters past D=256: (dq, dk, dv), each
    (B, S, H*D) f32."""
    q, k, v, mask = inputs
    D = q.shape[-1]
    n = -(-D // K1_COLS)
    pad = n * K1_COLS - D                        # columns past D: TMA's zeros
    Q, K, V, dO = (torch.nn.functional.pad(torch.from_numpy(x), (0, pad)).permute(0, 2, 1, 3)
                   for x in (q, k, v, dout))     # (B, H, S, n * 256)
    lse, delta = torch.from_numpy(lse), torch.from_numpy(delta)
    keep = (torch.from_numpy(mask) != 0)[:, None, None, :].expand(B, 1, S, S)
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool).tril()
    op = (lambda x: x.bfloat16().float()) if rounded else (lambda x: x)

    def over_d(a, b):                            # a b^T, each CTA on its 256 columns
        return _cluster_sum([a[..., r * K1_COLS:(r + 1) * K1_COLS]
                             @ b[..., r * K1_COLS:(r + 1) * K1_COLS].transpose(-1, -2)
                             for r in range(n)])

    def rows(i):
        return slice(i * TILE, (i + 1) * TILE)

    nt = S // TILE
    dq, dk, dv = (torch.zeros(B, H, S, n * K1_COLS) for _ in range(3))
    for f in range(nt):
        fr = rows(f)
        # dK/dV of kv rows fr over q tiles from the diagonal's on (causal)
        acc_dk, acc_dv = (torch.zeros(B, H, TILE, n * K1_COLS) for _ in range(2))
        for i in range(f if causal else 0, nt):
            qr = rows(i)
            kept = keep[:, :, qr, fr].transpose(-1, -2)
            pt = torch.exp2((torch.where(kept, over_d(K[:, :, fr], Q[:, :, qr]), NEG_INF)
                             - lse[:, :, None, qr]) * LOG2E)     # warpgroup 0, handed over
            dst = pt * (over_d(V[:, :, fr], dO[:, :, qr]) - delta[:, :, None, qr])
            acc_dv = acc_dv + op(pt) @ dO[:, :, qr]
            acc_dk = acc_dk + op(dst) @ Q[:, :, qr]
        dk[:, :, fr], dv[:, :, fr] = acc_dk, acc_dv
        # dQ of q rows fr (one warpgroup's) over kv tiles to its diagonal's
        acc_dq = torch.zeros(B, H, TILE, n * K1_COLS)
        for i in range(f + 1 if causal else nt):
            kr = rows(i)
            p = torch.exp2((torch.where(keep[:, :, fr, kr], over_d(Q[:, :, fr], K[:, :, kr]),
                                        NEG_INF) - lse[:, :, fr, None]) * LOG2E)
            ds = op(p * (over_d(dO[:, :, fr], V[:, :, kr]) - delta[:, :, fr, None]))
            acc_dq = acc_dq + ds @ K[:, :, kr]
        dq[:, :, fr] = acc_dq
    return tuple(x[..., :D].permute(0, 2, 1, 3).reshape(B, S, H * D).numpy()
                 for x in (dq, dk, dv))


@pytest.mark.parametrize("rounded", [False, True], ids=["f32-operands", "bf16-operands"])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("D", WIDTHS)
def test_bf16_backward_clusters_of_256_columns_match_jax(D, causal, kernel, rounded):
    """The bf16 dK/dV and dQ kernels past D=256 (partial S^T and dP^T over
    256-column CTAs, zeros past D, summed as the kernels sum them, then the
    D=256 schedule) == the Pallas ``_bwd_fused_call`` (K2) or ``_dq_call``
    and ``_dkv_call`` (K3) from the same lse and delta: within 2e-5 with f32
    operands, within the card's bf16 tolerance with P^T, dS^T and dS
    rounded to bf16 as the kernels round them."""
    inputs, dout, lse, delta, want = _jax_bf16_bwd(D, causal, kernel)
    got = _bf16_bwd_model(inputs, dout, lse, delta, causal, rounded)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        if not rounded:
            # the absolute part scales with the tensor's largest entry: the
            # first causal rows' dQ (tens, at D=1024) sums terms of that size
            atol = TOL["atol"] * np.abs(b).max()
            np.testing.assert_allclose(a, b, rtol=TOL["rtol"], atol=atol, err_msg=name)
            continue
        atol, rtol, ntol = BF16_BWD_TOL
        d = np.abs(a - b)
        assert (d <= atol * np.abs(b).max() + rtol * np.abs(b)).all(), (name, d.max())
        assert np.linalg.norm(d) <= ntol * np.linalg.norm(b), name


def _planes(x):
    """(hi, lo), each (B, H, S, D), the prep's planes; lo as the tensor cores
    read it (its low 13 bits dropped)."""
    hi, lo = port_flash.flash_attention_split_reference(torch.from_numpy(x))[0]
    return hi, (lo.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """An f32 accumulator split in registers (hopper.cuh:split_acc_tf32)."""
    hi = port_flash._tf32_round(x)
    lo = x - hi
    return hi, (lo.view(torch.int32) & -0x2000).view(torch.float32)


def _x3(a, b):
    """a @ b as three tf32 passes, the small terms first."""
    (ah, al), (bh, bl) = a, b
    return al @ bh + ah @ bl + ah @ bh


def _cols(planes, r):
    return tuple(p[..., r * F_COLS:(r + 1) * F_COLS] for p in planes)


def _cluster_scores(a, b, n):
    """A B^T over D: each CTA's 3xTF32 partial on its 128 columns, summed in
    rank order."""
    s = 0.0
    for r in range(n):
        s = s + _x3(_cols(a, r), tuple(x.transpose(-1, -2) for x in _cols(b, r)))
    return s


def _pair_rounds(parts):
    """Each CTA's sum after the pair rounds (``hopper.cuh:pair_round``): in
    round i CTA r adds the sum of rank r ^ 2^i to its own (``v += w``)."""
    sums = list(parts)
    step = 1
    while step < len(sums):
        sums = [sums[r] + sums[r ^ step] for r in range(len(sums))]
        step *= 2
    return sums


def _rank_order(parts):
    """``cluster_sum``'s sum: from zero, the parts in rank order."""
    s = torch.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def _f32_k1_scores(qp, kp, n):
    """S = Q K^T over D as the f32 K1's clusters hold it: each CTA's 3xTF32
    partial on its 128 columns, summed by pair rounds at n = 4 and 8 (every
    CTA's sum checked equal) and in rank order otherwise."""
    parts = [_x3(_cols(qp, r), tuple(x.transpose(-1, -2) for x in _cols(kp, r)))
             for r in range(n)]
    if n not in (4, 8):
        return _rank_order(parts)
    sums = _pair_rounds(parts)
    assert all(torch.equal(x, sums[0]) for x in sums)
    return sums[0]


def _f32_k1_model(q, k, v, mask, causal):
    """The f32 K1's clusters past D=256: (out (B, S, H, D), lse (B, H, S))."""
    D = q.shape[-1]
    qp, kp, vp = _planes(q), _planes(k), _planes(v)        # (B, H, S, D) each
    s_all = _f32_k1_scores(qp, kp, D // F_COLS)
    keep_key = torch.from_numpy(mask) != 0
    out, lse = torch.zeros(B, H, S, D), torch.zeros(B, H, S)
    for q0 in range(0, S, BM):
        rows = torch.arange(q0, min(q0 + BM, S))
        tiles = min(S // F_BN, (q0 + BM - 1) // F_BN + 1) if causal else S // F_BN
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), D)
        for j in range(tiles):
            cols = torch.arange(j * F_BN, (j + 1) * F_BN)
            keep = keep_key[:, None, None, cols]
            if causal:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = torch.where(keep, s_all[:, :, rows][..., cols], NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            move = (m_new - m) * LOG2E > 8.0                # the max moves past 2^8 only
            corr = torch.where(move, torch.exp2((m - m_new) * LOG2E), 1.0)
            m_new = torch.where(move, m_new, m)
            c = torch.where(m_new == NEG_INF, 0.0, LOG2E)   # no kept key yet: p = 1
            p = torch.exp2(s * c - m_new * c)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + _x3(_split(p), tuple(x[:, :, cols] for x in vp))
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        out[:, :, rows] = acc / l_safe
        lse[:, :, rows] = (m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("D", F32_K1_WIDTHS)
def test_f32_k1_clusters_of_128_columns_match_jax(D, causal):
    """The f32 K1's arithmetic past D=256 (3xTF32 partials over 128-column
    CTAs summed by pair rounds at n = 4 and 8 and in rank order at n = 3,
    5, 6, then the D=128 schedule with the lazily moved max and P split for
    three passes of P V) == the Pallas ``_fwd`` at width D."""
    inputs, j_out, j_lse, _ = _jax_fwd(D, causal, False)
    out, lse = _f32_k1_model(*inputs, causal)
    np.testing.assert_allclose(out, np.asarray(j_out).reshape(B, S, H, D), **TOL)
    np.testing.assert_allclose(lse, np.asarray(j_lse), **TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pair_rounds_give_every_cta_the_same_bits(n):
    """Each CTA adds its pair-round peer's sum to its own, so CTA r holds
    its own order of the operands of every addition; all end with the bits
    of ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), for 64 x 64
    partial score tiles drawn from a seed, of magnitudes 1e-3 .. 1e3 (so
    that the order of the additions shows: rank order gives other bits)."""
    rng = np.random.default_rng(100 + n)
    parts = [torch.from_numpy((rng.standard_normal((64, 64))
                               * 10.0 ** rng.integers(-3, 4, (64, 64))).astype(np.float32))
             for _ in range(n)]
    sums = _pair_rounds(parts)
    for x in sums[1:]:
        assert torch.equal(x, sums[0])
    tree = parts
    while len(tree) > 1:
        tree = [tree[2 * i] + tree[2 * i + 1] for i in range(len(tree) // 2)]
    assert torch.equal(sums[0], tree[0])
    assert torch.equal(sums[0], _rank_order(parts)) == (n == 2)


def _windows(parts, first=0):
    """The per-tile products of one fixed tile (in swept order) as the two
    warpgroups flush them: window by window, warpgroup ``first``'s chain,
    then the other's."""
    out = None
    for w in range(max(1, -(-len(parts) // (2 * FLUSH)))):
        for wg in (first, 1 - first):
            chain = None
            for x in parts[2 * FLUSH * w + wg:2 * FLUSH * (w + 1):2]:
                chain = x if chain is None else chain + x
            if chain is not None:
                out = chain if out is None else out + chain
    return out


def _bwd_model(q, k, v, mask, causal, lse, delta, dout):
    """The f32 dK/dV and dQ kernels' clusters: (dq, dk, dv), each (B, S, H, D)."""
    D = q.shape[-1]
    n = D // F_COLS
    qp, kp, vp, op = _planes(q), _planes(k), _planes(v), _planes(dout)
    keep = (torch.from_numpy(mask) != 0)[:, None, None, :].expand(B, 1, S, S)
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, _cluster_scores(qp, kp, n), NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (_cluster_scores(op, vp, n) - delta[..., None])
    dq, dk, dv = (torch.zeros(B, H, S, D) for _ in range(3))
    for f0 in range(0, S, FIX):
        fr = slice(f0, f0 + FIX)
        dkv_tiles = range(f0 // TR if causal else 0, S // TR)   # q tiles at or past the kv rows
        dq_tiles = range(0, min(S // TR, (f0 + FIX - 1) // TR + 1) if causal else S // TR)
        for r in range(n):
            cols = slice(r * F_COLS, (r + 1) * F_COLS)

            def tile(x, i):
                return tuple(t[..., i * TR:(i + 1) * TR, :] for t in _cols(x, r))

            rows = [slice(i * TR, (i + 1) * TR) for i in dkv_tiles]
            dv[..., fr, cols] = _windows([_x3(_split(p[..., i, fr].transpose(-1, -2)),
                                              tile(op, t)) for i, t in zip(rows, dkv_tiles)], 0)
            dk[..., fr, cols] = _windows([_x3(_split(ds[..., i, fr].transpose(-1, -2)),
                                              tile(qp, t)) for i, t in zip(rows, dkv_tiles)], 1)
            dsk = [_x3(_split(ds[..., fr, i * TR:(i + 1) * TR]), tile(kp, i)) for i in dq_tiles]
            for half in (0, 1):
                cut = slice(64 * half, 64 * (half + 1))
                dq[..., fr, r * F_COLS + 64 * half:r * F_COLS + 64 * (half + 1)] = _windows(
                    [x[..., cut] for x in dsk], half)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("D", WIDTHS)
def test_f32_backward_clusters_and_warpgroup_windows_match_jax(D, causal, kernel):
    """The f32 dK/dV and dQ kernels' arithmetic past D=256 (3xTF32 partials
    over 128-column CTAs summed in rank order, 32-row swept tiles split
    between two warpgroups, their chains flushed window by window) == the
    Pallas ``_bwd_fused_call`` (K2) or ``_dq_call`` and ``_dkv_call`` (K3),
    from the same lse and delta."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _dkv_call, _dq_call
    _, out, lse, (qf, kf, vf, maskf) = _jax_fwd(D, causal, False)
    q, k, v, mask = _inputs(D, D + causal)
    dout = np.random.default_rng(D).standard_normal((B, S, H, D)).astype(np.float32)
    dof = jnp.asarray(dout).reshape(B, S, H * D)
    delta = _delta(dof, out, H)
    args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, H)
    want = _bwd_fused_call(*args) if kernel == "K2" else (_dq_call(*args), *_dkv_call(*args))
    got = _bwd_model(q, k, v, mask, causal, torch.from_numpy(np.array(lse)),
                     torch.from_numpy(np.array(delta)), dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = _rel(a.numpy().reshape(B, S, H * D), b)
        assert rel <= BWD_TOL, (name, rel)


@pytest.mark.parametrize("n_tiles,first,chains", [
    (2, 0, [[0], [1]]), (8, 0, [[0, 2, 4, 6], [1, 3, 5, 7]]),
    (10, 0, [[0, 2, 4, 6], [1, 3, 5, 7], [8], [9]]),
    (10, 1, [[1, 3, 5, 7], [0, 2, 4, 6], [9], [8]]),
    (9, 1, [[1, 3, 5, 7], [0, 2, 4, 6], [8]])])
def test_flush_windows_order_the_warpgroups(n_tiles, first, chains):
    """``_windows`` sums chain by chain in the kernel's order (warpgroup
    ``first``'s window, then the other's), each chain its warpgroup's tiles
    of the window: held against the sums written out, bit for bit."""
    parts = [torch.tensor([1.0 + 2.0 ** (-20 + i)]) for i in range(n_tiles)]
    want = None
    for chain in chains:
        c = parts[chain[0]]
        for i in chain[1:]:
            c = c + parts[i]
        want = c if want is None else want + c
    assert torch.equal(_windows(parts, first), want)
