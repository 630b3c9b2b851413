"""The bf16 attention forward (K1) at head width 256 (``--heads 4``), its
schedule modelled in plain PyTorch on the CPU and held against the JAX
package's Pallas ``_fwd`` in interpret mode.

On the card K1's bf16 forward at D=256 is
``csrc/flash_fwd_d256.cuh:flash_fwd_d256_wgmma_kernel``: one CTA per 128 q
rows, kv tiles of 128 rows streamed through half-D slots, the two consumer
warpgroups (64 rows each) in ping-pong.  The ping-pong orders the products
and changes no arithmetic; the model here follows that arithmetic tile by
tile:

* kv tiles of 128 rows; under causal, the tiles wholly above a q tile's
  diagonal are skipped (a q tile of 128 rows at q0 runs tiles 0 .. q0/128);
* a ragged last tile: keys past Skv arrive as zeros with a zero mask and
  take p = 0;
* S = Q K^T in f32, masked keys at the finite -1e30, the running max m
  kept in the score domain and moved only when a row's max grows by more
  than 2^8 (in log2 units 8), p = 2^(s log2 e - m log2 e) (so p < 2^8), and
  p = 1 on a row with no kept key so far (the kernel's factor 0 in place of
  log2 e there);
* l summed from the f32 p, O and l rescaled by 2^((m_old - m_new) log2 e)
  when m moves, O += P V with P rounded to bf16 per tile (the operand
  rounding);
* O = acc / l with l == 0 taken as 1, lse = m + ln l.

The inputs are bf16 values, handed to both sides as f32 so that JAX's kernel,
which computes in f32 on the CPU, sees what the card's kernel reads: (B, S,
H, D) = (2, 320, 2, 256), two and a half kv tiles, and Sq x Skv = 192 x 320;
plain, causal and a wholly masked sample (every key of sample 0 masked).
Tolerances: with P kept in f32, the schedule (tiles, skips, rescaling points)
equals JAX's single pass within ``tests/test_torch_head256.py``'s forward
tolerance (rtol = atol = 2e-5, summation order); with P rounded to bf16 as
the kernel rounds it, within the card's bf16 tolerance of ``[flash]`` and
``tests/test_torch_cuda.py:TOL`` (|dO| <= 1e-2 + 1e-2 |O|, |dlse| <= 1e-3).
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

B, H, D = 2, 2, 256
BN = 128              # kv rows a tile
BM = 128              # q rows a CTA
NEG_INF = -1e30
LOG2E = 1.4426950408889634
TOL = dict(rtol=2e-5, atol=2e-5)     # test_torch_head256.py's forward rows
BF16_TOL = (1e-2, 1e-2, 1e-3)        # test_torch_cuda.py's TOL[bfloat16]
SHAPES = {"320": (320, 320), "192x320": (192, 320)}
# causal, a wholly masked sample, keys of the last tile scaled by 4 (their
# scores outgrow the running max by more than 2^8: it moves past tile 0)
CASES = {"plain": (False, False, False), "causal": (True, False, False),
         "masked": (False, True, False), "growing": (False, False, True)}
SOURCE = os.path.join(os.path.dirname(__file__), os.pardir, "pianobart_tpu_torch", "csrc",
                      "flash_fwd_d256.cuh")


def _bf16(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def _inputs(Sq, Skv, masked, growing):
    rng = np.random.default_rng(18)
    q = _bf16((rng.standard_normal((B, Sq, H, D)) * D ** -0.5).astype(np.float32))
    k = _bf16(rng.standard_normal((B, Skv, H, D)).astype(np.float32))
    if growing:
        k[:, (Skv - 1) // BN * BN:] *= 4.0
    v = _bf16(rng.standard_normal((B, Skv, H, D)).astype(np.float32))
    mask = np.ones((B, Skv), np.float32)
    mask[-1, Skv - 40:] = 0.0
    if masked:
        mask[0] = 0.0      # every key of sample 0: p = 1 on every key, lse -1e30
    return q, k, v, mask


@functools.lru_cache(maxsize=None)
def _jax_case(shape, case):
    """Inputs, then JAX's out (B, Sq, H, D) and lse (B, H, Sq)."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _fwd
    causal, masked, growing = CASES[case]
    Sq, Skv = SHAPES[shape]
    q, k, v, mask = _inputs(Sq, Skv, masked, growing)
    out, lse, _ = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                       causal, None, None)
    return (q, k, v, mask), np.asarray(out).reshape(B, Sq, H, D), np.asarray(lse)


def _model(inputs, causal, rounded):
    """The kernel's schedule: (out (B, Sq, H, D), lse (B, H, Sq)) in f32,
    and the number of (row, tile) steps past a row's first tile at which its
    running max moved."""
    q, k, v, mask = inputs
    Sq, Skv = q.shape[1], k.shape[1]
    Q, K, V = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v))   # (B, H, S, D)
    n_kv = -(-Skv // BN)
    pad = n_kv * BN - Skv                       # the ragged last tile: TMA's zeros
    K = torch.nn.functional.pad(K, (0, 0, 0, pad))
    V = torch.nn.functional.pad(V, (0, 0, 0, pad))
    keep_key = torch.nn.functional.pad(torch.from_numpy(mask) != 0, (0, pad))   # (B, n_kv*BN)
    op = (lambda x: x.bfloat16().float()) if rounded else (lambda x: x)
    out = torch.zeros(B, H, Sq, D)
    lse = torch.zeros(B, H, Sq)
    moves = 0
    for q0 in range(0, Sq, BM):
        rows = torch.arange(q0, min(q0 + BM, Sq))
        n = min(n_kv, q0 // BN + 1) if causal else n_kv
        m = torch.full((B, H, len(rows), 1), NEG_INF)
        l = torch.zeros(B, H, len(rows), 1)
        acc = torch.zeros(B, H, len(rows), D)
        for j in range(n):
            cols = torch.arange(j * BN, (j + 1) * BN)
            s = Q[:, :, rows] @ K[:, :, cols].transpose(-1, -2)
            keep = keep_key[:, None, None, cols]
            if causal:
                keep = keep & (rows[:, None] >= cols[None, :])
            s = torch.where(keep, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            move = (m_new - m) * LOG2E > 8.0
            corr = torch.where(move, torch.exp2((m - m_new) * LOG2E), 1.0)
            m_new = torch.where(move, m_new, m)
            if j:
                moves += int(move.sum())
            c = torch.where(m_new == NEG_INF, 0.0, LOG2E)
            p = torch.exp2(s * c - m_new * c)
            p = torch.where(cols < Skv, p, 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + op(p) @ V[:, :, cols]
            m = m_new
        l_safe = torch.where(l == 0, 1.0, l)
        out[:, :, rows] = acc / l_safe
        lse[:, :, rows] = (m + torch.log(l_safe))[..., 0]
    return out.permute(0, 2, 1, 3).numpy(), lse.numpy(), moves


def test_model_follows_the_kernel_source():
    """The model's tile sizes are the kernel's (``K1W_BN``, ``K1_BM``)."""
    src = open(SOURCE).read()
    assert int(re.search(r"K1W_BN = (\d+);", src).group(1)) == BN
    assert int(re.search(r"K1W_D = (\d+);", src).group(1)) == D
    common = open(os.path.join(os.path.dirname(SOURCE), "flash_fwd_bf16.cuh")).read()
    assert re.search(r"K1_WG = (\d+);", common).group(1) == "2" and "K1_BM = 64 * K1_WG" in common


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("rounded", [False, True], ids=["f32-P", "bf16-P"])
def test_d256_bf16_fwd_schedule_matches_jax(shape, case, rounded):
    """The D=256 bf16 forward's schedule == the Pallas ``_fwd`` on the same
    inputs: within 2e-5 with P in f32 (the 128-row tiles, the causal skips
    and the rescaling points change nothing but the order of sums), within
    the card's bf16 tolerance with P rounded to bf16 as the kernel rounds it."""
    inputs, want_out, want_lse = _jax_case(shape, case)
    causal, masked, growing = CASES[case]
    if masked:
        assert (want_lse[0] == NEG_INF).all()
    out, lse, moves = _model(inputs, causal, rounded)
    assert (moves > 0) == growing
    assert np.isfinite(out).all() and np.isfinite(lse).all()
    if not rounded:
        np.testing.assert_allclose(out, want_out, **TOL)
        np.testing.assert_allclose(lse, want_lse, **TOL)
        return
    atol, rtol, ltol = BF16_TOL
    d = np.abs(out - want_out)
    assert (d <= atol + rtol * np.abs(want_out)).all(), d.max()
    assert np.abs(lse - want_lse).max() <= ltol
