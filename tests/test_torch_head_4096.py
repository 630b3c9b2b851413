"""Head widths 2176 to 4096 in bf16 (``--hs 4096 --heads 1`` is D=4096): the
port's flash path against the JAX package's, whose Pallas kernels take any
lane-aligned head width and run here in interpret mode, as
``tests/test_torch_head_xwide.py`` runs them at 1152 .. 2048.  On the card
the bf16 kernels run these widths as clusters of ceil(D/256) = 9 .. 16 CTAs
(the card's non-portable sizes); the f32 ones stop at 2048 (16 CTAs of 128
columns), so an f32 model this wide takes the plain attention path.  On the
CPU the wrappers run the plain versions, which are what these tests hold
against JAX.

* The width rule by type: ``_flash_eligible`` takes bf16 up to 4096 and f32
  up to 2048; the ring refuses a CUDA shard past its type's range, naming
  it; a cluster the card cannot hold raises with its size, width and type.
* K1 and K2: the port's plain versions (what its wrappers run on CPU
  tensors) against ``_fwd`` and ``_bwd_fused_call`` at D = 2176 and 4096,
  causal or not, with a pad mask, bf16 and f32; K3a and K3b against
  ``_dq_call`` and ``_dkv_call`` at D = 2176 with S = 1152; delta against
  ``_delta`` at 4096.  f32 within 2e-5 (summation order, as at D=128); bf16
  within the card's bf16 tolerances (both sides compute in f32 from the same
  bf16 values and round the outputs to bf16 at the end).  dO is scaled by
  (128/D)^0.5 as q is, so that dP = dO V^T has the magnitude it has at
  D = 128.
* ``dot_product_attention`` at D=4096 in bf16 against JAX's
  ``flash_attention`` and its vjp, within the bf16 tolerances.
* The ring: ``ring_attention`` on two gloo ranks at D=2176 in bf16 against
  ``ring_attention_sharded`` on two of conftest's virtual devices: the output
  within the bf16 tolerances, the gradients within the card's bf16 backward
  rule (``chip_smoke.py``'s [flash_bwd]: 1e-2 of the tensor's largest entry
  plus 1e-2 of the entry), as each side sums per-block gradients that were
  rounded to bf16, and a sum that cancels keeps their rounding.
* The slice small: d_model 2176, one head of 2176, 1+1 layers, FFN 256,
  S=256, B=2, dropout 0, JAX's weights through ``compat/from_jax.py`` and
  JAX's corruption: the port's dense ``_forward_loss`` and gradients against
  ``jax.grad`` of JAX's, in bf16 compute (every attention through the flash
  Function; loss within 1e-2 relative, each parameter group's gradients
  within 5e-2 in norm, ``chip_smoke.py``'s bf16 gradient tolerance) and in
  f32 (the plain attention path here, JAX's flash kernels there;
  ``tests/test_torch_train.py``'s tolerances).

JAX is imported inside the tests: the spawned ranks import this module and
need torch only.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.ops import attention as port_attention
from pianobart_tpu_torch.ops import flash as port_flash
from pianobart_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

B, S, H = 2, 256, 1
TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 outputs: one bf16 rounding of the same f32 result on both sides
TOL_BF16 = dict(rtol=1e-2, atol=1e-2)


def _inputs(D, seed=0, b=B, s=S, h=H):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, D)) * 0.3 * (128 / D) ** 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, h, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, s, h, D)).astype(np.float32)
    mask = np.ones((b, s), np.float32)
    mask[-1, s - 40:] = 0.0
    return q, k, v, mask


def _dout(D, seed, b=B, s=S, h=H):
    """dO at the magnitude of ``_inputs``' q: (128/D)^0.5 of a unit normal."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, D)) * (128 / D) ** 0.5).astype(np.float32)


def _bf16(*xs):
    """The values bf16 holds, as f32 numpy (both packages get the same)."""
    return [torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in xs]


def _t(*xs, dtype=torch.float32):
    return [None if x is None else torch.from_numpy(np.array(x)).to(dtype) for x in xs]


def _jdt(dtype):
    import jax.numpy as jnp
    return jnp.float32 if dtype == "f32" else jnp.bfloat16


def _tdt(dtype):
    return torch.float32 if dtype == "f32" else torch.bfloat16


def _tol(dtype):
    return TOL if dtype == "f32" else TOL_BF16


# ---------------------------------------------------------- the width rule
@pytest.mark.parametrize("d,dtype,eligible", [
    (2048, "f32", True), (2176, "f32", False), (4096, "f32", False),
    (2176, "bf16", True), (3072, "bf16", True), (4096, "bf16", True),
    (4224, "bf16", False), (4160, "bf16", False)])
def test_width_rule_by_type(d, dtype, eligible):
    """bf16 takes every multiple of 128 up to 4096 (clusters of up to 16
    CTAs of 256 columns), f32 up to 2048 (16 CTAs of 128); the rest takes
    the plain path."""
    assert port_flash.head_dims(_tdt(dtype))[-1] == (2048 if dtype == "f32" else 4096)
    q = torch.zeros(1, 256, 1, d, dtype=_tdt(dtype))
    assert port_attention._flash_eligible(q, q, None) is eligible


def test_ring_refuses_past_each_type_s_widths():
    """The ring's width check takes bf16 D=4096 on a CUDA shard and refuses
    bf16 4224 and f32 2176 with their type's range in the message; the check
    comes before any device work, so stand-ins that say they are on CUDA
    show it here."""
    from pianobart_tpu_torch.ops import ring as port_ring
    taken = SimpleNamespace(is_cuda=True, shape=(B, S, H, 4096), dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_ring, "_ring", lambda *a: "ring")
        assert port_ring.ring_attention(taken, taken, taken, None, False, None) == "ring"
    for d, dtype, top in ((4224, torch.bfloat16, 4096), (2176, torch.float32, 2048)):
        wider = SimpleNamespace(is_cuda=True, shape=(B, S, H, d), dtype=dtype)
        with pytest.raises(ValueError, match=f"{str(dtype)[6:]} head width a multiple of "
                                             f"128 up to {top}"):
            port_ring.ring_attention(wider, wider, wider, None, False, None)


def test_a_bf16_cluster_of_16_the_card_cannot_hold_raises():
    """The C entries' code for a cluster the card cannot schedule (2000 + its
    size, ``hopper.cuh:launch_cluster``) raises with the size, the width and
    the type's range at the bf16 kernels' 16 CTAs of D=4096: no fallback."""
    with pytest.raises(RuntimeError, match="cluster of 16 CTAs.*head width 4096 needs in "
                                           "bfloat16 .*up to 4096"):
        port_flash._raise_for("flash_fwd", 2016, 4096, torch.bfloat16)


# --------------------------------------------------- K1, K2, K3, delta
CASES = [(d, dtype, causal) for d in (2176, 4096) for dtype in ("f32", "bf16")
         for causal in (False, True)]


@pytest.mark.parametrize("d,dtype,causal", CASES)
def test_fwd_reference_matches_jax_kernel(d, dtype, causal):
    """flash_attention_fwd on CPU tensors (K1's plain version) == the Pallas
    ``_fwd`` at head width d, with a pad mask: O and lse."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _fwd
    q, k, v, mask = _inputs(d, seed=d + causal)
    if dtype == "bf16":
        q, k, v = _bf16(q, k, v)
    jdt = _jdt(dtype)
    j_out, j_lse, _ = _fwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                           jnp.asarray(mask), causal, 128, 128)
    before = port_flash.flash_attention_fwd.launches
    t_out, t_lse = port_flash.flash_attention_fwd(*_t(q, k, v, dtype=_tdt(dtype)),
                                                  torch.from_numpy(mask), causal)
    assert t_out.dtype == _tdt(dtype)
    np.testing.assert_allclose(t_out.float().numpy().reshape(B, S, H * d),
                               np.asarray(j_out, np.float32), **_tol(dtype))
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)
    assert port_flash.flash_attention_fwd.launches == before


@pytest.mark.parametrize("d,dtype,causal", CASES)
def test_bwd_reference_matches_jax_kernel(d, dtype, causal):
    """flash_attention_bwd on CPU tensors (K2's plain version, delta
    included) == the Pallas ``_bwd_fused_call`` at head width d on the same
    q, k, v, O, lse and dO."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _fwd
    q, k, v, mask = _inputs(d, seed=d + 5 + causal)
    dout = _dout(d, 6)
    if dtype == "bf16":
        q, k, v, dout = _bf16(q, k, v, dout)
    jdt = _jdt(dtype)
    out, lse, (qf, kf, vf, maskf) = _fwd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask),
        causal, None, None)
    dof = jnp.asarray(dout, jdt).reshape(B, S, H * d)
    want = _bwd_fused_call(qf, kf, vf, maskf, dof, lse, _delta(dof, out, H), causal,
                           None, None, H)
    before = port_flash.flash_attention_bwd.launches
    tdt = _tdt(dtype)
    got = port_flash.flash_attention_bwd(
        *_t(q, k, v, dtype=tdt), torch.from_numpy(mask), causal,
        torch.from_numpy(np.array(out, np.float32)).to(tdt).reshape(B, S, H, d),
        torch.from_numpy(np.array(lse)), *_t(dout, dtype=tdt))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy().reshape(B, S, H * d),
                                   np.asarray(b, np.float32), err_msg=f"d{name}",
                                   **_tol(dtype))
    assert port_flash.flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype,causal", [("bf16", False), ("bf16", True), ("f32", True)])
def test_dq_dkv_reference_match_jax_kernels(dtype, causal):
    """flash_attention_dq and flash_attention_dkv on CPU tensors (K3a's and
    K3b's plain versions) == the Pallas ``_dq_call`` and ``_dkv_call`` at
    Sq = Skv = 1152 (past the single 1024-row block, so the reference's
    ``_bwd_impl`` takes them), B = H = 1, head width 2176, from the same
    external lse and delta."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _delta, _dkv_call, _dq_call, _fwd
    d, Sl = 2176, 1152
    q, k, v, mask = _inputs(d, seed=8 + causal, b=1, s=Sl, h=1)
    dout = _dout(d, 9, b=1, s=Sl, h=1)
    if dtype == "bf16":
        q, k, v, dout = _bf16(q, k, v, dout)
    jdt, tdt = _jdt(dtype), _tdt(dtype)
    out, lse, (qf, kf, vf, maskf) = _fwd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(mask),
        causal, None, None)
    dof = jnp.asarray(dout, jdt).reshape(1, Sl, d)
    delta = _delta(dof, out, 1)
    jax_args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, 1)
    port_args = (*_t(q, k, v, dtype=tdt), torch.from_numpy(mask), causal,
                 *_t(lse, delta), *_t(dout, dtype=tdt))
    assert not port_flash._fused_eligible(Sl, Sl)
    dq = port_flash.flash_attention_dq(*port_args)
    assert dq.dtype == tdt
    np.testing.assert_allclose(dq.float().numpy().reshape(1, Sl, d),
                               np.asarray(_dq_call(*jax_args), np.float32), err_msg="dq",
                               **_tol(dtype))
    for name, a, b in zip(("dk", "dv"), port_flash.flash_attention_dkv(*port_args),
                          _dkv_call(*jax_args)):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy().reshape(1, Sl, d),
                                   np.asarray(b, np.float32), err_msg=name, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_delta_matches_jax(dtype):
    """flash_attention_delta on CPU tensors == JAX's ``_delta`` at head width
    4096, rowsum(dO * O) in f32 from inputs of either type, (B, H, S); dO at
    the scale of the other tests', so that the sum has its D = 128 size."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _delta
    d = 4096
    out = np.random.default_rng(d).standard_normal((B, S, H, d)).astype(np.float32)
    dout = _dout(d, d + 1)
    if dtype == "bf16":
        dout, out = _bf16(dout, out)
    jdt = _jdt(dtype)
    want = _delta(jnp.asarray(dout, jdt).reshape(B, S, H * d),
                  jnp.asarray(out, jdt).reshape(B, S, H * d), H)
    got = port_flash.flash_attention_delta(*_t(dout, out, dtype=_tdt(dtype)))
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax_flash_in_bf16(causal):
    """dot_product_attention on bf16 CPU tensors routes D=4096 to
    flash_attention (its plain versions here) and equals JAX's
    ``flash_attention`` on the same bf16 values (Pallas K1, then K2 in
    interpret mode): output and q, k, v gradients, within the bf16
    tolerances."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import flash_attention as jax_flash_attention
    d = 4096
    q, k, v, mask = _inputs(d, seed=3 + causal)
    dout = _dout(d, 4)
    q, k, v, dout = _bf16(q, k, v, dout)
    bf = jnp.bfloat16
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, jnp.asarray(mask), causal),
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf))
    want = vjp(jnp.asarray(dout, bf))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v, dtype=torch.bfloat16))
    got = port_attention.dot_product_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                                               causal=causal)
    assert type(got.grad_fn).__name__ == "_FlashAttentionBackward"
    got.backward(*_t(dout, dtype=torch.bfloat16))
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(out, np.float32),
                               **TOL_BF16)
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   err_msg=f"d{name}", **TOL_BF16)


# ---------------------------------------------------------------- the ring
RING_SP = 2
RING_D = 2176
RING_CASES = {"non_causal": False, "causal": True}


def _ring_inputs(i):
    q, k, v, m = _inputs(RING_D, 30 + i, h=1)
    return (*_bf16(q, k, v), m)


def _ring_worker(rank, world, out_dir):
    """Each case on this rank's shard in bf16: output and q/k/v gradients of
    sum(o * sin(o)) (in f32) through ``ring_attention`` (its blocks take the
    plain versions of K1, delta, K2 on the CPU)."""
    from pianobart_tpu_torch.ops.ring import ring_attention
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1, world)
    ax = mesh.axis("sp")
    res = {}
    for i, (name, causal) in enumerate(RING_CASES.items()):
        q, k, v, m = _ring_inputs(i)
        ql, kl, vl = (mesh.cols(torch.from_numpy(x)).to(torch.bfloat16).requires_grad_()
                      for x in (q, k, v))
        o = ring_attention(ql, kl, vl, mesh.cols(torch.from_numpy(m)), causal, ax)
        of = o.float()
        (of * torch.sin(of)).sum().backward()
        res[name] = [t.detach().float() for t in (o, ql.grad, kl.grad, vl.grad)]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def port_ring(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring_4096"))
    spawn(_ring_worker, RING_SP, (out,), threads=1)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(RING_SP)]
    return {name: [torch.cat([r[name][j] for r in ranks], dim=1).numpy()
                   for j in range(4)] for name in RING_CASES}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_jax_in_bf16(port_ring, name):
    """The port's ring at sp=2, D=2176 in bf16 (one head, shards of 128 rows)
    against ``ring_attention_sharded`` on the same bf16 values: the output
    within the bf16 tolerances, the gradients within 1e-2 of their largest
    entry plus 1e-2 of each (each block's gradient is rounded to bf16 before
    the blocks are summed, on both sides)."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.ops.ring import ring_attention_sharded
    from pianobart_tpu.parallel.mesh import make_mesh
    causal = RING_CASES[name]
    q, k, v, m = _ring_inputs(list(RING_CASES).index(name))
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    mesh = make_mesh(dp=1, tp=1, sp=RING_SP, devices=jax.devices()[:RING_SP])

    def loss(q, k, v):
        o = ring_attention_sharded(q, k, v, jnp.asarray(m), causal=causal, mesh=mesh)
        of = o.astype(jnp.float32)
        return (of * jnp.sin(of)).sum(), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    got = port_ring[name]
    np.testing.assert_allclose(got[0], np.asarray(out, np.float32), **TOL_BF16)
    for g, want, which in zip(got[1:], grads, "qkv"):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(g, want, rtol=1e-2, atol=1e-2 * np.abs(want).max(),
                                   err_msg=f"d{which} ({name})")


# ------------------------------------------------------ the slice, small
SLICE = dict(d_model=2176, num_heads=1, max_len=256, encoder_layers=1, decoder_layers=1,
             ffn_dim=256, use_flash_attention=True, dropout=0.0)
SLICE_B = 2


def _slice_batch():
    from pianobart_tpu_torch import vocab as V
    rng = np.random.default_rng(4096)
    x = np.zeros((SLICE_B, SLICE["max_len"], 8), dtype=np.int32)
    for f in range(8):
        x[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], x.shape[:2])
    x[..., 0] = np.sort(x[..., 0], axis=1)
    x[:, -1] = V.EOS
    return x


def _group(name):
    """The parameter group of a state-dict name: a layer's attention, FFN or
    norms, else the top-level module."""
    parts = name.split(".")
    if "layers" in parts:
        sub = parts[parts.index("layers") + 2]
        kind = "norm" if "norm" in sub else sub
        return f"{parts[parts.index('layers') - 1]}.{kind}"
    return ".".join(parts[:2])


@pytest.fixture(scope="module", params=["bf16", "f32"])
def slice_runs(request):
    """JAX's dense loss and gradients (its Pallas kernels in interpret mode,
    ``PBX_FLASH_INTERPRET=1``) on one corruption of the batch, in the
    param's compute type, and the port's dense ``_forward_loss`` on the same
    weights and corruption; f32 weights on both sides."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.models import PianoBartLM as JaxLM
    from pianobart_tpu.models import tiny_config as jax_tiny_config
    from pianobart_tpu.ops.noise import corrupt_batch
    from pianobart_tpu.train.pretrain import _forward_loss as jax_forward_loss
    from pianobart_tpu.train.state import create_train_state as jax_create_train_state
    from pianobart_tpu_torch.compat.from_jax import lm_state_dict_from_jax
    from pianobart_tpu_torch.models import PianoBartLM, tiny_config
    from pianobart_tpu_torch.train.pretrain import _forward_loss

    dtype = request.param
    jcfg = jax_tiny_config(**SLICE, dtype=_jdt(dtype))
    cfg = tiny_config(**SLICE, dtype=_tdt(dtype))
    assert cfg.head_dim == 2176
    batch = _slice_batch()
    Sl = SLICE["max_len"]
    ids, ones = jnp.zeros((SLICE_B, Sl, 8), jnp.int32), jnp.ones((SLICE_B, Sl))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PBX_FLASH_INTERPRET", "1")
        jstate = jax_create_train_state(JaxLM(jcfg), jcfg, jax.random.PRNGKey(0),
                                        (ids, ids, ones, ones), learning_rate=2e-5)
        corrupted, loss_mask = corrupt_batch(jax.random.PRNGKey(7), jnp.asarray(batch),
                                             0.15)
        (jloss, _), jgrads = jax.jit(lambda p: jax.value_and_grad(
            jax_forward_loss, has_aux=True)(p, jstate.apply_fn, jnp.asarray(batch),
                                            corrupted, loss_mask, jcfg,
                                            jax.random.PRNGKey(1), False))(jstate.params)
    sd = lm_state_dict_from_jax(jstate.params, jcfg)
    want = {n: g.float().numpy() for n, g in lm_state_dict_from_jax(jgrads, jcfg).items()}
    model = PianoBartLM(cfg, device="cpu").train()
    model.load_state_dict(sd)
    xb = torch.from_numpy(batch.astype(np.int64))
    pc = torch.from_numpy(np.asarray(corrupted).astype(np.int64))
    pm = torch.from_numpy(np.array(loss_mask))
    launches = port_flash.flash_attention_fwd.launches
    calls = []
    real = port_flash.flash_attention_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash, "flash_attention_reference",
                   lambda *a: calls.append(1) or real(*a))
        total, _ = _forward_loss(model, xb, pc, pm, torch.Generator().manual_seed(3))
        total.backward()
    grads = {n: p.grad.float().numpy() for n, p in model.named_parameters()}
    return (dtype, float(jloss), want, total.item(), grads, len(calls),
            port_flash.flash_attention_fwd.launches - launches)


def test_slice_dense_step_matches_jax(slice_runs):
    """The port's dense loss and every gradient at head width 2176 (one head
    at d_model 2176, 1+1 layers) against ``jax.grad`` of JAX's
    ``_forward_loss``.  bf16 compute: each of the 3 attentions of the forward
    (encoder self, decoder self, cross) went through the flash dispatch (its
    plain version on the CPU, no launch counted); both sides round to bf16
    at different places, so the loss within 1e-2 relative and each parameter
    group's gradients within 5e-2 in norm.  f32: past the f32 kernels' 2048
    the port takes the plain attention path (no flash dispatch) where JAX
    runs its kernels; loss rtol 1e-5, |d| <= 1e-7 + 1e-4*|g| (f32 summation
    order; ``tests/test_torch_train.py``'s bounds)."""
    dtype, jloss, want, loss, grads, n_flash, launched = slice_runs
    assert set(grads) == set(want) and launched == 0
    if dtype == "f32":
        assert n_flash == 0
        assert loss == pytest.approx(jloss, rel=1e-5)
        for name, g in want.items():
            np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-7, err_msg=name)
        return
    assert n_flash == 3
    assert loss == pytest.approx(jloss, rel=1e-2)
    groups = {}
    for name, g in want.items():
        d, r = groups.get(_group(name), (0.0, 0.0))
        groups[_group(name)] = (d + float(np.square(grads[name] - g).sum()),
                                r + float(np.square(g).sum()))
    rel = {k: (d / r) ** 0.5 for k, (d, r) in groups.items() if r > 0}
    assert max(rel.values()) <= 5e-2, rel
