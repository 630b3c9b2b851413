"""The f32 attention kernels at head width 256 (``--heads 4 --dtype f32``),
their arithmetic modelled in plain PyTorch on the CPU and held against the
JAX package's Pallas kernels in interpret mode.

On the card each f32 kernel at D=256 runs as a pair of CTAs, one per
128-column half of the head (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``:
``flash_*_tf32_kernel`` at DW=256).  The model here follows that arithmetic:

* the operands are the prep's planes, ``flash_attention_split_reference``
  at D=256 (hi = x rounded to tf32, lo = x - hi);
* each half's products are lo.hi' + hi.lo' + hi.hi', each pass over tf32
  values (the tensor cores drop lo's own low 13 bits), summed in f32;
* S = Q K^T and dP = dO V^T, which run over all of D, are the sum of the two
  halves' partials, as the pair adds them through each other's shared
  memory; O, dQ, dK and dV are computed half by half;
* the forward's online softmax runs over kv tiles of 64 rows with P split
  into hi and lo for O += P V; the backward's accumulators take one swept
  tile of 64 rows at a time and go to the output every ``T_FLUSH`` = 2
  tiles (``flash_bwd.cu:T_FLUSH``), causal tiles wholly masked skipped as
  the kernels skip them.

Tolerances: K1's O and lse within 2.5e-6 and K2's and K3's gradients within
1.3e-6 of their norm, the errors f32 kernels at this width showed on the
card against the plain versions, at (B, S, H, D) = (2, 128, 2, 256).  A
last case checks that the wrappers at D=256 f32 hand the kernels the
prep's planes.
"""
import numpy as np
import pytest
import torch

from pianobart_tpu_torch.ops import flash as port_flash

torch.set_num_threads(2)

B, S, H, D = 2, 128, 2, 256
HALF = 128            # the columns of D one CTA of a pair holds
TILE = 64             # kv tiles (forward), swept tiles (backward)
T_FLUSH = 2           # swept tiles an accumulator runs before it is flushed
NEG_INF = -1e30
K1_TOL = 2.5e-6       # max |d| of O and lse
BWD_TOL = 1.3e-6      # ||d|| / ||ref|| of dQ, dK, dV


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * D ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[-1, S - 40:] = 0.0
    return q, k, v, mask


def _planes(x):
    """(hi, lo), each (B, H, S, D), from the prep's plain version; lo as
    the tensor cores read it (its low 13 bits dropped)."""
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


def _half(planes, c):
    return tuple(p[..., c * HALF:(c + 1) * HALF] for p in planes)


def _t(planes):
    return tuple(p.transpose(-1, -2) for p in planes)


def _pair_scores(a, b):
    """A B^T over D, each CTA its half, the pair's partials summed."""
    return sum(_x3(_half(a, c), _t(_half(b, c))) for c in range(2))


def _keep(mask, causal):
    keep = torch.ones(B, 1, S, S, dtype=torch.bool)
    keep = keep & (torch.from_numpy(mask) != 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool).tril()
    return keep


def _model_fwd(q, k, v, mask, causal):
    """K1's pair: O (B, S, H, D) and lse (B, H, S)."""
    qp, kp, vp = _planes(q), _planes(k), _planes(v)
    s_all = torch.where(_keep(mask, causal), _pair_scores(qp, kp), NEG_INF)
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros(B, H, S, 1)
    o = [torch.zeros(B, H, S, HALF) for _ in range(2)]
    for j in range(S // TILE):
        s = s_all[..., j * TILE:(j + 1) * TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        live = m_new != NEG_INF                  # no kept key yet: p = 1
        p = torch.where(live, torch.exp(s - m_new), torch.ones_like(s))
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        pv = _split(p)
        for c in range(2):
            vt = tuple(x[..., j * TILE:(j + 1) * TILE, :] for x in _half(vp, c))
            o[c] = o[c] * corr + _x3(pv, vt)
    l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.cat([x / l for x in o], -1).permute(0, 2, 1, 3)
    return out, (m + torch.log(l))[..., 0]


def _flushed(parts):
    """Per-tile products summed as a kernel's accumulator: T_FLUSH tiles a
    chain, each chain added to the output."""
    out = None
    for i in range(0, len(parts), T_FLUSH):
        acc = parts[i]
        for x in parts[i + 1:i + T_FLUSH]:
            acc = acc + x
        out = acc if out is None else out + acc
    return out


def _model_bwd(q, k, v, mask, causal, lse, delta, dout):
    """The dK/dV and dQ kernels' pairs: (dq, dk, dv), each (B, S, H, D)."""
    qp, kp, vp, op = _planes(q), _planes(k), _planes(v), _planes(dout)
    s = torch.where(_keep(mask, causal), _pair_scores(qp, kp), NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (_pair_scores(op, vp) - delta[..., None])
    n = S // TILE
    dq, dk, dv = (torch.zeros(B, H, S, D) for _ in range(3))
    for f in range(n):                            # fixed tile: kv rows for dK/dV, q for dQ
        fr = slice(f * TILE, (f + 1) * TILE)
        dkv_tiles = range(f if causal else 0, n)  # q tiles at or past the kv rows
        dq_tiles = range(0, f + 1 if causal else n)
        for c in range(2):
            cols = slice(c * HALF, (c + 1) * HALF)

            def tile(x, i):
                return tuple(t[..., i * TILE:(i + 1) * TILE, :] for t in _half(x, c))

            pt = [_x3(_split(p[..., i * TILE:(i + 1) * TILE, fr].transpose(-1, -2)),
                      tile(op, i)) for i in dkv_tiles]
            dst = [_x3(_split(ds[..., i * TILE:(i + 1) * TILE, fr].transpose(-1, -2)),
                       tile(qp, i)) for i in dkv_tiles]
            dsk = [_x3(_split(ds[..., fr, i * TILE:(i + 1) * TILE]), tile(kp, i))
                   for i in dq_tiles]
            dv[..., fr, cols] = _flushed(pt)
            dk[..., fr, cols] = _flushed(dst)
            dq[..., fr, cols] = _flushed(dsk)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def _jax_fwd(q, k, v, mask, causal):
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _fwd
    return _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal,
                None, None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("causal", [False, True])
def test_pair_forward_matches_jax(causal):
    """K1's arithmetic at D=256 (two halves, S summed across the pair,
    3xTF32, online softmax over 64-key tiles) == the Pallas ``_fwd``."""
    q, k, v, mask = _inputs(0)
    j_out, j_lse, _ = _jax_fwd(q, k, v, mask, causal)
    out, lse = _model_fwd(q, k, v, mask, causal)
    err_o = np.abs(out.numpy().reshape(B, S, H * D) - np.asarray(j_out)).max()
    err_l = np.abs(lse.numpy() - np.asarray(j_lse)).max()
    assert err_o <= K1_TOL and err_l <= K1_TOL, (err_o, err_l)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("causal", [False, True])
def test_pair_backward_matches_jax(kernel, causal):
    """The dK/dV and dQ kernels' arithmetic at D=256 (S and dP summed across
    the pair, 3xTF32, accumulators flushed every T_FLUSH tiles) == the
    Pallas ``_bwd_fused_call`` (K2) or ``_dq_call`` and ``_dkv_call`` (K3),
    from the same lse and delta."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _dkv_call, _dq_call
    q, k, v, mask = _inputs(3)
    dout = np.random.default_rng(4).standard_normal((B, S, H, D)).astype(np.float32)
    out, lse, (qf, kf, vf, maskf) = _jax_fwd(q, k, v, mask, causal)
    dof = jnp.asarray(dout).reshape(B, S, H * D)
    delta = _delta(dof, out, H)
    args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, H)
    if kernel == "K2":
        want = _bwd_fused_call(*args)
    else:
        want = (_dq_call(*args), *_dkv_call(*args))
    got = _model_bwd(q, k, v, mask, causal, torch.from_numpy(np.array(lse)),
                     torch.from_numpy(np.array(delta)), dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rel = _rel(a.numpy().reshape(B, S, H * D), b)
        assert rel <= BWD_TOL, (name, rel)


class _Asked(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_at_d256_ask_for_the_prep(monkeypatch, dtype):
    """On the kernel path (a CUDA tensor's; forced here for CPU tensors) K1,
    K2, K3a and K3b at D=256 f32 first ask the prep for Q's and K's natural
    planes and V's transposed ones (K1), or the four operands' natural
    planes and the transposed ones their entry reads (K2: q, k, dO; K3a: k;
    K3b: q, dO), as at D=128; bf16 asks for none."""
    asked = []

    def split_launch(specs):
        asked.append([(x.shape[-1], nat, tr) for x, nat, tr in specs])
        raise _Asked

    def build_kernel(name):
        raise _Asked

    monkeypatch.setattr(port_flash, "use_kernel", lambda x, what: True)
    monkeypatch.setattr(port_flash, "_split_launch", split_launch)
    monkeypatch.setattr(port_flash, "build_kernel", build_kernel)
    q, k, v, _ = (torch.from_numpy(x).to(dtype) for x in _inputs(5))
    rows = torch.zeros(B, H, S)
    calls = [lambda: port_flash.flash_attention_fwd(q, k, v),
             lambda: port_flash.flash_attention_bwd(q, k, v, None, False, q, rows, q, rows),
             lambda: port_flash.flash_attention_dq(q, k, v, None, False, rows, rows, q),
             lambda: port_flash.flash_attention_dkv(q, k, v, None, False, rows, rows, q)]
    for call in calls:
        with pytest.raises(_Asked):
            call()
    if dtype == torch.bfloat16:
        assert asked == []
        return
    nat = (D, True, False)
    assert asked == [
        [nat, nat, (D, False, True)],
        [(D, True, True), (D, True, True), nat, (D, True, True)],
        [nat, (D, True, True), nat, nat],
        [(D, True, True), nat, nat, (D, True, True)]]
