"""Head widths 384 to 1024 (``--heads 2`` at d_model 1024 is D=512): the
port's flash path against the JAX package's, whose Pallas kernels take any
lane-aligned head width and run here in interpret mode, as
``tests/test_torch_flash.py`` runs them at 128.  On the card these widths run
as clusters of D/128 CTAs; on the CPU the wrappers run the plain versions,
which are what these tests hold against JAX.

* The width rule: ``_flash_eligible`` takes every multiple of 128 up to
  its type's ``MAX_HEAD_DIM``, 2048 in f32 and 4096 in bf16, and no other
  width (``tests/test_torch_head_xwide.py`` holds the widths past 1024,
  ``tests/test_torch_head_4096.py`` those past 2048).
* K1, K2, K3a, K3b and delta: the port's plain versions (what its wrappers
  run on CPU tensors) against ``_fwd``, ``_bwd_fused_call``, ``_dq_call``,
  ``_dkv_call`` and ``_delta`` at D = 384 and 512 (K1 and delta also at
  1024), causal or not, with a pad mask.  f32 within 2e-5 (summation order,
  as at D=128).  bf16 inputs: JAX's kernels here compute in f32 from the
  bf16 values as the plain versions do, and both round O and the gradients
  to bf16 at the end, so they agree within the card's bf16 tolerances
  (``chip_smoke.py``'s [flash]: 1e-2 + 1e-2 |ref|; lse and delta, f32 from
  the same products, within 2e-5).
* The tf32 split's planes at D = 384, 512 and 1024: hi + lo is the input
  exactly, natural and transposed.
* ``dot_product_attention`` at D=384 against JAX's ``flash_attention`` and
  its vjp.
* The ring: ``ring_attention`` on two gloo ranks at D=384 against
  ``ring_attention_sharded`` on two of conftest's virtual devices, at
  ``tests/test_torch_ring.py``'s tolerances (3e-5 forward, 4e-4 gradients).
* The slice small: d_model 768, two heads of 384, 2+2 layers, FFN 1024,
  S=256, B=2, f32, dropout 0, JAX's weights through ``compat/from_jax.py``
  and JAX's corruption: the port's dense ``_forward_loss`` and gradients
  against ``jax.grad`` of JAX's (``tests/test_torch_train.py``'s
  tolerances), and a 1x1x2 mesh step on two gloo ranks against the same
  JAX dense step (``tests/test_torch_sp_train.py``'s).

JAX is imported inside the tests: the spawned ranks import this module and
need torch only.
"""
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.ops import attention as port_attention
from pianobart_tpu_torch.ops import flash as port_flash
from pianobart_tpu_torch.parallel.launch import spawn

torch.set_num_threads(2)

B, S, H = 2, 256, 2
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


WIDTH_CASES = ([(d, ok, "f32") for d, ok in (
    (128, True), (256, True), (384, True), (512, True), (768, True), (1024, True),
    (320, False), (1152, True), (2048, True), (2176, False), (4096, False))]
    + [(2176, True, "bf16"), (4096, True, "bf16"), (4224, False, "bf16")])


@pytest.mark.parametrize("d,eligible,dtype", WIDTH_CASES,
                         ids=[f"{d}-{ok}" + ("-bf16" if dt == "bf16" else "")
                              for d, ok, dt in WIDTH_CASES])
def test_width_rule(d, eligible, dtype):
    """``_flash_eligible`` takes every multiple of 128 up to q's type's
    MAX_HEAD_DIM (2048 in f32, 4096 in bf16) and no other width, as
    :data:`HEAD_DIMS` lists them."""
    assert port_flash.MAX_HEAD_DIM == {torch.float32: 2048, torch.bfloat16: 4096}
    assert port_flash.HEAD_DIMS[torch.float32] == tuple(range(128, 2049, 128))
    assert port_flash.HEAD_DIMS[torch.bfloat16] == tuple(range(128, 4097, 128))
    q = torch.zeros(1, 256, 1, d, dtype=_tdt(dtype))
    assert port_attention._flash_eligible(q, q, None) is eligible


FWD_CASES = [(384, "f32", False), (384, "f32", True), (512, "f32", False),
             (512, "f32", True), (384, "bf16", True), (512, "bf16", False),
             (1024, "f32", True), (1024, "bf16", False)]


@pytest.mark.parametrize("d,dtype,causal", FWD_CASES)
def test_fwd_reference_matches_jax_kernel(d, dtype, causal):
    """flash_attention_fwd on CPU tensors (K1's plain version) == the Pallas
    ``_fwd`` at head width d, with a pad mask: O and lse."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _fwd
    q, k, v, mask = _inputs(d, seed=d)
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
                               np.asarray(j_out, np.float32),
                               **(TOL if dtype == "f32" else TOL_BF16))
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)
    assert port_flash.flash_attention_fwd.launches == before


BWD_CASES = [(384, "f32", False), (384, "f32", True), (512, "f32", True),
             (384, "bf16", True), (512, "bf16", False)]


@pytest.mark.parametrize("d,dtype,causal", BWD_CASES)
def test_bwd_reference_matches_jax_kernel(d, dtype, causal):
    """flash_attention_bwd on CPU tensors (K2's plain version, delta
    included) == the Pallas ``_bwd_fused_call`` at head width d on the same
    q, k, v, O, lse and dO."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _fwd
    q, k, v, mask = _inputs(d, seed=d + 5)
    dout = np.random.default_rng(6).standard_normal((B, S, H, d)).astype(np.float32)
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
                                   **(TOL if dtype == "f32" else TOL_BF16))
    assert port_flash.flash_attention_bwd.launches == before


@pytest.mark.parametrize("d,causal", [(384, False), (384, True), (512, True)])
def test_dq_dkv_reference_match_jax_kernels(d, causal):
    """flash_attention_dq and flash_attention_dkv on CPU tensors (K3a's and
    K3b's plain versions) == the Pallas ``_dq_call`` and ``_dkv_call`` at
    Sq = Skv = 1152 (past the single 1024-row block, so the reference's
    ``_bwd_impl`` takes them), B = H = 1, head width d, f32, from the same
    external lse and delta."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _delta, _dkv_call, _dq_call, _fwd
    Sl = 1152
    q, k, v, mask = _inputs(d, seed=d + 8, b=1, s=Sl, h=1)
    dout = np.random.default_rng(9).standard_normal((1, Sl, 1, d)).astype(np.float32)
    out, lse, (qf, kf, vf, maskf) = _fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal, None, None)
    dof = jnp.asarray(dout).reshape(1, Sl, d)
    delta = _delta(dof, out, 1)
    jax_args = (qf, kf, vf, maskf, dof, lse, delta, causal, None, None, 1)
    port_args = (*_t(q, k, v, mask), causal, *_t(lse, delta, dout))
    assert not port_flash._fused_eligible(Sl, Sl)
    np.testing.assert_allclose(port_flash.flash_attention_dq(*port_args).numpy()
                               .reshape(1, Sl, d), np.asarray(_dq_call(*jax_args)),
                               err_msg="dq", **TOL)
    for name, a, b in zip(("dk", "dv"), port_flash.flash_attention_dkv(*port_args),
                          _dkv_call(*jax_args)):
        np.testing.assert_allclose(a.numpy().reshape(1, Sl, d), np.asarray(b),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("d", [384, 512, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_delta_matches_jax(d, dtype):
    """flash_attention_delta on CPU tensors == JAX's ``_delta`` at head width
    d, rowsum(dO * O) in f32 from inputs of either type, (B, H, S)."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _delta
    rng = np.random.default_rng(d)
    dout, out = (rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(2))
    if dtype == "bf16":
        dout, out = _bf16(dout, out)
    jdt = _jdt(dtype)
    want = _delta(jnp.asarray(dout, jdt).reshape(B, S, H * d),
                  jnp.asarray(out, jdt).reshape(B, S, H * d), H)
    got = port_flash.flash_attention_delta(*_t(dout, out, dtype=_tdt(dtype)))
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [384, 512, 1024])
def test_split_planes_are_exact(d):
    """The f32 kernels' prep on CPU tensors (its plain version, what the
    card's check compares with) at head width d: hi is x rounded to tf32
    (its low 13 bits clear), hi + lo is x exactly, natural (2, B, H, S, d)
    and transposed (2, B, H, d, S) in the fragment order 0 2 4 6 1 3 5 7 of
    each 8."""
    q, _, _, _ = _inputs(d, seed=11)
    x = torch.from_numpy(q)
    before = port_flash.flash_attention_split.launches
    nat, tr = port_flash.flash_attention_split(x, True, True)
    assert port_flash.flash_attention_split.launches == before
    assert nat.shape == (2, B, H, S, d) and tr.shape == (2, B, H, d, S)
    assert not (nat[0].view(torch.int32) & 0x1FFF).any()
    torch.testing.assert_close(nat[0] + nat[1], x.permute(0, 2, 1, 3), rtol=0, atol=0)
    order = torch.arange(S).view(-1, 4, 2).transpose(1, 2).reshape(-1)
    torch.testing.assert_close(tr[0] + tr[1], x.permute(0, 2, 3, 1)[..., order],
                               rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_jax_flash(causal):
    """dot_product_attention on CPU tensors routes D=384 to flash_attention
    (its plain versions here) and equals JAX's ``flash_attention`` (Pallas
    K1, then K2 in interpret mode): output and q, k, v gradients."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import flash_attention as jax_flash_attention
    d = 384
    q, k, v, mask = _inputs(d, seed=3)
    dout = np.random.default_rng(4).standard_normal((B, S, H, d)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, jnp.asarray(mask), causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = port_attention.dot_product_attention(tq, tk, tv, kv_mask=torch.from_numpy(mask),
                                               causal=causal)
    assert type(got.grad_fn).__name__ == "_FlashAttentionBackward"
    got.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"d{name}", **TOL)


def _past_the_widths(d, dtype, top, tol):
    """Past q's type's MAX_HEAD_DIM the dense path runs plain attention (no
    flash dispatch), and the ring refuses a CUDA shard of that width with the
    type's range in its message (the refusal comes before any device work,
    so a stand-in that says it is on CUDA shows it here)."""
    from types import SimpleNamespace
    from pianobart_tpu_torch.ops.ring import ring_attention
    q, k, v, mask = _t(*_inputs(d, seed=12)[:3], dtype=dtype) + _t(_inputs(d, seed=12)[3])
    calls = []
    real = port_flash.flash_attention_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_flash, "flash_attention_reference",
                   lambda *a: calls.append(1) or real(*a))
        out = port_attention.dot_product_attention(q, k, v, kv_mask=mask)
    assert calls == [] and out.shape == q.shape and out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               real(q, k, v, mask, False)[0].float().numpy(), **tol)
    shard = SimpleNamespace(is_cuda=True, shape=(B, S, H, d), dtype=dtype)
    with pytest.raises(ValueError, match=f"multiple of 128 up to {top}"):
        ring_attention(shard, shard, shard, None, False, None)


def test_wider_heads_take_the_plain_path_and_the_ring_refuses():
    """f32 past 2048 (at 2176): the plain path, and the ring refuses."""
    _past_the_widths(2176, torch.float32, 2048, TOL)


def test_wider_bf16_heads_take_the_plain_path_and_the_ring_refuses():
    """bf16 past 4096 (at 4224): the plain path, and the ring refuses."""
    _past_the_widths(4224, torch.bfloat16, 4096, TOL_BF16)


# ---------------------------------------------------------------- the ring
RING_SP = 2
RING_D = 384
RING_CASES = {"non_causal": False, "causal": True}


def _ring_worker(rank, world, out_dir):
    """Each case on this rank's shard: output and q/k/v gradients of
    sum(o * sin(o)) through ``ring_attention`` (its blocks take the plain
    versions of K1, delta, K2 on the CPU)."""
    from pianobart_tpu_torch.ops.ring import ring_attention
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1, world)
    ax = mesh.axis("sp")
    res = {}
    for i, (name, causal) in enumerate(RING_CASES.items()):
        q, k, v, m = (torch.from_numpy(x) for x in _inputs(RING_D, 20 + i))
        ql, kl, vl = (mesh.cols(x).clone().requires_grad_() for x in (q, k, v))
        o = ring_attention(ql, kl, vl, mesh.cols(m), causal, ax)
        (o * torch.sin(o)).sum().backward()
        res[name] = [t.detach() for t in (o, ql.grad, kl.grad, vl.grad)]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def port_ring(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring_wide"))
    spawn(_ring_worker, RING_SP, (out,), threads=1)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(RING_SP)]
    return {name: [torch.cat([r[name][j] for r in ranks], dim=1).numpy()
                   for j in range(4)] for name in RING_CASES}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_matches_jax(port_ring, name):
    """The port's ring at sp=2, D=384 (shards of 128 rows) against
    ``ring_attention_sharded`` on the same inputs: forward 3e-5, gradients
    4e-4 (JAX's own ring tolerances)."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.ops.ring import ring_attention_sharded
    from pianobart_tpu.parallel.mesh import make_mesh
    causal = RING_CASES[name]
    q, k, v, m = (jnp.asarray(x) for x in _inputs(RING_D, 20 + list(RING_CASES).index(name)))
    mesh = make_mesh(dp=1, tp=1, sp=RING_SP, devices=jax.devices()[:RING_SP])

    def loss(q, k, v):
        o = ring_attention_sharded(q, k, v, m, causal=causal, mesh=mesh)
        return (o * jnp.sin(o)).sum(), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    got = port_ring[name]
    np.testing.assert_allclose(got[0], np.asarray(out), rtol=3e-5, atol=3e-5)
    for g, want, which in zip(got[1:], grads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(want), rtol=4e-4, atol=4e-4,
                                   err_msg=f"d{which} ({name})")


# ------------------------------------------------------ the slice, small
SLICE = dict(d_model=768, num_heads=2, max_len=256, encoder_layers=2, decoder_layers=2,
             ffn_dim=1024, use_flash_attention=True, dropout=0.0)
SLICE_B = 2


def _slice_batch():
    from pianobart_tpu_torch import vocab as V
    rng = np.random.default_rng(2024)
    x = np.zeros((SLICE_B, SLICE["max_len"], 8), dtype=np.int32)
    for f in range(8):
        x[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], x.shape[:2])
    x[..., 0] = np.sort(x[..., 0], axis=1)
    x[:, -1] = V.EOS
    return x


def _flat_grads(model):
    grads = dict((n, p.grad) for n, p in model.named_parameters())
    return torch.cat([grads[n].reshape(-1) for n in sorted(grads)]).numpy()


def _mesh_worker(rank, world, d):
    """One 1x1x2 mesh step (the ring over sp) from JAX's weights and
    corruption; SGD(lr=1) after a clip that never scales, so ``.grad`` keeps
    the all-reduced gradients."""
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    from pianobart_tpu_torch.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu_torch.train.state import TrainState
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    cfg = inp["cfg"].replace(ring_axis="sp")
    model = PianoBartLM(cfg, device="cpu").train()
    model.load_state_dict(inp["sd"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0),
                       clip_norm=float("inf"))
    step = make_sp_pretrain_step(cfg, make_mesh(1, 1, world))
    c, m = (torch.from_numpy(x) for x in inp["corruption"])
    metrics = step.update(state, torch.from_numpy(inp["batch"]).long(), c.long(), m,
                          torch.Generator().manual_seed(0))
    torch.save((metrics["loss"].item(), _flat_grads(model)),
               os.path.join(d, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """JAX's dense loss and gradients (its Pallas kernels in interpret mode,
    ``PBX_FLASH_INTERPRET=1``) on one corruption of the batch; the port's
    dense ``_forward_loss`` on the same weights and corruption; then the
    1x1x2 mesh step on two ranks."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.models import PianoBartLM as JaxLM
    from pianobart_tpu.models import tiny_config as jax_tiny_config
    from pianobart_tpu.ops.noise import corrupt_batch
    from pianobart_tpu.train.pretrain import _forward_loss as jax_forward_loss
    from pianobart_tpu.train.state import create_train_state as jax_create_train_state
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax
    from pianobart_tpu_torch.models import PianoBartLM, tiny_config
    from pianobart_tpu_torch.train.pretrain import _forward_loss

    d = tmp_path_factory.mktemp("slice_wide")
    jcfg, cfg = jax_tiny_config(**SLICE), tiny_config(**SLICE)
    assert cfg.head_dim == 384
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
    want = {n: g.numpy() for n, g in lm_state_dict_from_jax(jgrads, jcfg).items()}
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
    dense = (total.item(), {n: p.grad.numpy() for n, p in model.named_parameters()},
             len(calls), port_flash.flash_attention_fwd.launches - launches)
    torch.save({"cfg": config_from_jax(jcfg), "batch": batch, "sd": sd,
                "corruption": (np.array(corrupted), np.array(loss_mask))}, d / "inputs.pt")
    spawn(_mesh_worker, 2, (str(d),), threads=1)
    mesh = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    flat_want = np.concatenate([want[n].ravel() for n in sorted(want)])
    return float(jloss), want, flat_want, dense, mesh


def test_slice_dense_step_matches_jax(slice_runs):
    """The port's dense loss and every gradient at head width 384 (two heads
    at d_model 768) against ``jax.grad`` of JAX's ``_forward_loss``: loss
    rtol 1e-5, |d| <= 1e-7 + 1e-4*|g| (f32 summation order;
    ``tests/test_torch_train.py``'s bounds).  Each of the 6 attentions of
    the forward (2 encoder self, 2 decoder self, 2 cross) went through the
    flash dispatch (its plain version on the CPU, no launch counted)."""
    jloss, want, _, (loss, grads, n_flash, launched), _ = slice_runs
    assert n_flash == 6 and launched == 0
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert set(grads) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-7, err_msg=name)


def test_slice_mesh_1x1x2_step_matches_jax_dense(slice_runs):
    """One 1x1x2 mesh step (ring attention over two gloo ranks, shards of
    128 rows at D=384) against JAX's dense step on the same weights and
    corruption, on both ranks: loss rel 2e-5, gradients rtol 2e-4 / atol
    2e-5 (``tests/test_torch_sp_train.py``'s bounds)."""
    jloss, _, flat_want, _, mesh = slice_runs
    for loss, grads in mesh:
        assert loss == pytest.approx(jloss, rel=2e-5)
        np.testing.assert_allclose(grads, flat_want, rtol=2e-4, atol=2e-5)


def test_a_cluster_the_card_cannot_hold_raises():
    """The C entries' code for a cluster the card cannot schedule (2000 + its
    size, ``hopper.cuh:launch_cluster``) raises with the size and width."""
    with pytest.raises(RuntimeError, match="cluster of 4 CTAs.*head width 512"):
        port_flash._raise_for("flash_bwd", 2004, 512)
    with pytest.raises(RuntimeError, match="TMA tensor map"):
        port_flash._raise_for("flash_fwd", 1001)
