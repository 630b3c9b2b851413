"""The bf16 attention backward at head width 256 (``--heads 4``), its
schedule modelled in plain PyTorch on the CPU and held against the JAX
package's Pallas kernels in interpret mode.

On the card the bf16 backward at D=256 is two kernels,
``csrc/flash_bwd.cu:flash_bwd_d256_wgmma_kernel<DKV>``, two consumer
warpgroups that both read every swept tile of 64 rows.  The model here
follows their arithmetic tile by tile:

* dK/dV (one CTA per 64 kv rows, swept q tiles in order, causal tiles
  wholly above the diagonal skipped): warpgroup 0 computes S^T = K Q^T and
  P^T in f32 (``exp2`` of the score-domain difference times log2 e) and
  hands P^T over; warpgroup 1 computes dP^T = V dO^T and forms dS^T = P^T
  (dP^T - delta) from that f32 P^T; dV += P^T dO and dK += dS^T Q with P^T
  and dS^T rounded to bf16 as product operands, accumulated in f32 tile by
  tile;
* dQ (one CTA per 128 q rows, 64 a warpgroup, swept kv tiles in order, a
  warpgroup's causal tiles past its diagonal skipped): S, P, dP and
  dS = P (dP - delta) of the warpgroup's rows, dS rounded to bf16, and
  dQ += dS K over every tile in f32.

The inputs are bf16 values (B, S, H, D) = (2, 320, 2, 256), handed to both
sides as f32 so that JAX's kernels, which compute in f32 on the CPU, see
exactly what the card's kernels read: five tiles of 64 (an odd count: the
dQ kernel's last CTA has a warpgroup past S), causal, not causal, and a
wholly masked sample.  Tolerances: with the
operand rounding left out, the schedule (tiles, skips, the handed P^T)
equals JAX's single pass within ``tests/test_torch_head256.py``'s
backward tolerance (rtol = atol = 2e-5, summation order; for the wholly
masked sample, whose P is 1 on every key, the absolute part scales with
the tensor's largest entry, as its sums do); with it, within
the bf16 backward tolerance of the card tests (``tests/test_torch_cuda.py:
BWD_TOL``: |d| <= 1e-2 max|ref| + 1e-2 |ref|, ||d|| <= 1e-2 ||ref||), the
2^-9 rounding of P^T, dS^T and dS that the card's kernels apply.
"""
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

B, S, H, D = 2, 320, 2, 256
TILE = 64             # fixed rows a warpgroup, swept rows a tile
NEG_INF = -1e30
LOG2E = 1.4426950408889634
TOL = dict(rtol=2e-5, atol=2e-5)   # test_torch_head256.py's backward rows
BF16_TOL = (1e-2, 1e-2, 1e-2)      # test_torch_cuda.py's BWD_TOL[bfloat16]
CASES = {"plain": (False, False), "causal": (True, False), "masked": (False, True)}


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(masked):
    rng = np.random.default_rng(21)
    q = _bf16((rng.standard_normal((B, S, H, D)) * D ** -0.5).astype(np.float32))
    k = _bf16(rng.standard_normal((B, S, H, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((B, S, H, D)).astype(np.float32))
    dout = _bf16(rng.standard_normal((B, S, H, D)).astype(np.float32))
    mask = np.ones((B, S), np.float32)
    mask[-1, S - 40:] = 0.0
    if masked:
        mask[0] = 0.0      # every key of sample 0: its lse is the -1e30 sentinel
    return q, k, v, dout, mask


@functools.lru_cache(maxsize=None)
def _jax_case(kernel, case):
    """Inputs, JAX's lse and delta, and (dq, dk, dv) of the Pallas
    ``_bwd_fused_call`` (K2) or ``_dq_call`` and ``_dkv_call`` (K3), each
    (B, S, H*D) f32."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _dkv_call, _dq_call, _fwd
    causal, masked = CASES[case]
    q, k, v, dout, mask = _inputs(masked)
    out, lse, (qf, kf, vf, maskf) = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(mask), causal, None, None)
    dof = jnp.asarray(dout).reshape(B, S, H * D)
    delta = _delta(dof, out, H)
    args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, H)
    want = _bwd_fused_call(*args) if kernel == "K2" else (_dq_call(*args), *_dkv_call(*args))
    return ((q, k, v, dout, mask), np.array(lse), np.array(delta),
            tuple(np.asarray(x) for x in want))


def _keep(mask, causal):
    """(B, 1, Sq, Skv): key kept for the row."""
    keep = (torch.from_numpy(mask) != 0)[:, None, None, :].expand(B, 1, S, S)
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool).tril()
    return keep


def _model(inputs, lse, delta, causal, rounded):
    """The two kernels' schedule: (dq, dk, dv), each (B, S, H, D) f32."""
    q, k, v, dout, mask = inputs
    Q, K, V, dO = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v, dout))
    lse, delta = torch.from_numpy(lse), torch.from_numpy(delta)
    keep = _keep(mask, causal)
    op = (lambda x: x.bfloat16().float()) if rounded else (lambda x: x)
    n = S // TILE
    dq, dk, dv = (torch.zeros(B, H, S, D) for _ in range(3))

    def rows(i):
        return slice(i * TILE, (i + 1) * TILE)

    for f in range(n):
        fr = rows(f)
        # dK/dV of kv rows fr over q tiles from the diagonal's on (causal)
        acc_dk, acc_dv = torch.zeros(B, H, TILE, D), torch.zeros(B, H, TILE, D)
        for i in range(f if causal else 0, n):
            qr = rows(i)
            st = K[:, :, fr] @ Q[:, :, qr].transpose(-1, -2)                 # warpgroup 0
            kept = keep[:, :, qr, fr].transpose(-1, -2)
            pt = torch.exp2((torch.where(kept, st, NEG_INF) - lse[:, :, None, qr]) * LOG2E)
            dpt = V[:, :, fr] @ dO[:, :, qr].transpose(-1, -2)               # warpgroup 1
            dst = pt * (dpt - delta[:, :, None, qr])                        # the f32 P^T handed over
            acc_dv = acc_dv + op(pt) @ dO[:, :, qr]
            acc_dk = acc_dk + op(dst) @ Q[:, :, qr]
        dk[:, :, fr], dv[:, :, fr] = acc_dk, acc_dv
        # dQ of q rows fr (one warpgroup's) over kv tiles up to its diagonal's
        acc_dq = torch.zeros(B, H, TILE, D)
        for i in range(f + 1 if causal else n):
            kr = rows(i)
            s = Q[:, :, fr] @ K[:, :, kr].transpose(-1, -2)
            p = torch.exp2((torch.where(keep[:, :, fr, kr], s, NEG_INF)
                            - lse[:, :, fr, None]) * LOG2E)
            dp = dO[:, :, fr] @ V[:, :, kr].transpose(-1, -2)
            ds = op(p * (dp - delta[:, :, fr, None]))
            acc_dq = acc_dq + ds @ K[:, :, kr]
        dq[:, :, fr] = acc_dq
    return tuple(x.permute(0, 2, 1, 3).reshape(B, S, H * D).numpy() for x in (dq, dk, dv))


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rounded", [False, True], ids=["f32-operands", "bf16-operands"])
def test_d256_bf16_schedule_matches_jax(kernel, case, rounded):
    """The D=256 bf16 kernels' schedule == the Pallas ``_bwd_fused_call``
    (K2) or ``_dq_call`` and ``_dkv_call`` (K3) from the same lse and delta:
    within 2e-5 with f32 operands (the tiling, the causal skips and the
    handed-over P^T change nothing but the order of sums),
    within the card's bf16 tolerance with P^T, dS^T and dS rounded to bf16 as
    the kernels round them."""
    inputs, lse, delta, want = _jax_case(kernel, case)
    causal, masked = CASES[case]
    if masked:
        assert (lse[0] == NEG_INF).all()
    got = _model(inputs, lse, delta, causal, rounded)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        if not rounded:
            # the wholly masked sample's P is 1 on every key, so its sums run
            # over terms of a few hundred: their f32 order moves an entry by
            # that scale, not the entry's own
            atol = TOL["atol"] * (np.abs(b).max() if masked else 1.0)
            np.testing.assert_allclose(a, b, rtol=TOL["rtol"], atol=atol, err_msg=name)
            continue
        atol, rtol, ntol = BF16_TOL
        d = np.abs(a - b)
        assert (d <= atol * np.abs(b).max() + rtol * np.abs(b)).all(), (name, d.max())
        assert np.linalg.norm(d) <= ntol * np.linalg.norm(b), name
