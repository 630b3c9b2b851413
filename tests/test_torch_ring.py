"""The port's ring attention (``ops/ring.py``) against the JAX package's.

Four ranks are spawned over gloo on the CPU (``parallel/launch.py``: a
``FileStore`` in a fresh directory, safe under xdist); each runs
``ring_attention`` on its sequence shard, whose blocks take the plain
versions of K1, delta, K2 (on the CPU), and writes its output and gradients.
The parent holds the gathered result against ``ring_attention_sharded`` on
four of conftest's virtual CPU devices (its Pallas kernels in interpret
mode), at JAX's own tolerances (``tests/test_ring.py``): 3e-5 forward, 4e-4
gradients.  Also K2 with the caller's delta against JAX's
``_bwd_fused_call``.

JAX is imported inside the tests: the spawned ranks import this module and
need torch only.
"""
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.parallel.launch import spawn

B, S, H, D = 2, 256, 2, 128
SP = 4
# name -> (causal, mask kind); "padded" masks the last 80 keys of sample 1,
# so the whole last shard (64 rows) of that sample is padding
CASES = {"non_causal": (False, "tail"), "causal": (True, "tail"),
         "no_mask": (False, None), "padded_shard": (True, "padded")}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v


def _mask(kind):
    if kind is None:
        return None
    m = np.ones((B, S), np.float32)
    m[1, S - (30 if kind == "tail" else 80):] = 0.0
    return m


def _ring_worker(rank, world, out_dir):
    """Every case on this rank's shard: output and q/k/v gradients of
    sum(o * sin(o)), through ``ring_attention`` and its plain version."""
    from pianobart_tpu_torch.ops.ring import (ring_attention,
                                              ring_attention_reference,
                                              transport)
    from pianobart_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1, world)
    ax = mesh.axis("sp")
    res = {"transport": transport(ax, torch.device("cpu"))}
    for i, (name, (causal, kind)) in enumerate(CASES.items()):
        q, k, v = (torch.from_numpy(x) for x in _inputs(i))
        m = _mask(kind)
        m = None if m is None else mesh.cols(torch.from_numpy(m))
        for tag, fn in (("ring", ring_attention), ("plain", ring_attention_reference)):
            ql, kl, vl = (mesh.cols(x).clone().requires_grad_() for x in (q, k, v))
            o = fn(ql, kl, vl, m, causal, ax)
            (o * torch.sin(o)).sum().backward()
            res[name, tag] = [t.detach() for t in (o, ql.grad, kl.grad, vl.grad)]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def port_ring(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    spawn(_ring_worker, SP, (out,), threads=1)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(SP)]
    return {key: [torch.cat([r[key][j] for r in ranks], dim=1).numpy()
                  for j in range(4)]
            for key in ranks[0] if key != "transport"}, ranks[0]["transport"]


@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax(port_ring, name):
    """Forward and gradients of the port's ring at sp=4 against
    ``ring_attention_sharded`` on the same inputs (and the port's plain ring
    equal to the wrappers' on the CPU, where they run the same functions)."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.ops.ring import ring_attention_sharded
    from pianobart_tpu.parallel.mesh import make_mesh

    results, _ = port_ring
    causal, kind = CASES[name]
    q, k, v = (jnp.asarray(x) for x in _inputs(list(CASES).index(name)))
    m = _mask(kind)
    m = None if m is None else jnp.asarray(m)
    mesh = make_mesh(dp=1, tp=1, sp=SP, devices=jax.devices()[:SP])

    def loss(q, k, v):
        o = ring_attention_sharded(q, k, v, m, causal=causal, mesh=mesh)
        return (o * jnp.sin(o)).sum(), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    got = results[name, "ring"]
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], np.asarray(out), rtol=3e-5, atol=3e-5)
    for g, want, which in zip(got[1:], grads, "qkv"):
        np.testing.assert_allclose(g, np.asarray(want), rtol=4e-4, atol=4e-4,
                                   err_msg=f"d{which} ({name})")
    for a, b in zip(got, results[name, "plain"]):
        np.testing.assert_array_equal(a, b)


def test_ring_transport_over_gloo_on_the_cpu(port_ring):
    assert port_ring[1] == "gloo on cpu tensors"


@pytest.mark.parametrize("causal", [False, True])
def test_k2_with_external_delta_matches_jax(causal):
    """K2's entry with the caller's delta (the ring backward's contract)
    against JAX's ``_bwd_fused_call`` given the same lse and delta, where
    the delta is not the one of the kernel's own ``out`` (the merged output
    of a ring differs from any block's); the plain version with the same
    delta agrees, and without it both compute another result.  f32,
    tolerance 2e-5 (summation order)."""
    import jax.numpy as jnp
    from pianobart_tpu.ops.flash import _bwd_fused_call, _delta, _fwd
    from pianobart_tpu_torch.ops.flash import (flash_attention_bwd,
                                               flash_attention_bwd_reference)
    q, k, v = _inputs(7)
    do = np.random.default_rng(8).standard_normal((B, S, H, D)).astype(np.float32)
    m = _mask("tail")
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse, (qf, kf, vf, maskf) = _fwd(jq, jk, jv, jnp.asarray(m), causal, None, None)
    other = out * 1.5 + 0.1           # a delta of another output
    delta = _delta(jdo.reshape(B, S, H * D), other, H)
    want = _bwd_fused_call(qf, kf, vf, maskf, jdo.reshape(B, S, H * D), lse, delta,
                           causal, None, None, H)
    args = [torch.from_numpy(x) for x in (q, k, v)] + [torch.from_numpy(m), causal]
    t_lse, t_do = torch.from_numpy(np.array(lse)), torch.from_numpy(do)
    t_delta = torch.from_numpy(np.array(delta))
    got = flash_attention_bwd(*args, None, t_lse, t_do, delta=t_delta)
    plain = flash_attention_bwd_reference(*args, None, t_lse, t_do, t_delta)
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w).reshape(B, S, H, D)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    own = flash_attention_bwd(*args, torch.from_numpy(np.array(out).reshape(B, S, H, D)),
                              t_lse, t_do)
    assert not np.allclose(own[0].numpy(), got[0].numpy(), atol=1e-3)
