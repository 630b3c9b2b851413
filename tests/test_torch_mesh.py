"""The port's mesh over ``torch.distributed`` (``parallel/mesh.py``) and
``encode_sp`` (``parallel/sp.py``) against the JAX package's.

* rank -> (dp, tp, sp) coordinates and every axis's groups as JAX's
  ``make_mesh`` lays devices out, and each rank's block of a batch as the
  ``P("dp", "sp")`` sharding places it, with the same refusal;
* without a mesh a ring model raises; ``init_from_env`` at one rank and its
  refusals;
* four ranks spawned over gloo (``parallel/launch.py``, a ``FileStore`` in a
  fresh directory): the groups each rank builds, a ring rotation, the
  preemption agreement, the flattened gradient all-reduce, the gather, and
  ``encode_sp`` at sp=4 against JAX's ``encode_sp`` (tolerance 2e-4, as
  ``tests/test_ring.py``'s).

JAX is imported inside the tests: the spawned ranks import this module and
need torch only.
"""
import os

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.parallel import mesh as M
from pianobart_tpu_torch.parallel.launch import spawn

SHAPES = [(2, 2, 2), (1, 2, 2), (2, 1, 2), (4, 1, 2), (2, 4, 1), (1, 1, 8)]


def _jax_mesh(dp, tp, sp):
    import jax
    from pianobart_tpu.parallel.mesh import make_mesh
    return make_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:dp * tp * sp])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_coordinates_and_groups_match_jax(shape):
    """Rank r sits where JAX's mesh puts device r, and each axis's groups
    are the device sets along that mesh axis, in index order."""
    dp, tp, sp = shape
    devices = np.vectorize(lambda d: d.id)(_jax_mesh(dp, tp, sp).devices)
    sizes = {"dp": dp, "tp": tp, "sp": sp}
    for r in range(dp * tp * sp):
        coords = tuple(int(c[0]) for c in np.nonzero(devices == r))
        assert M._coords(r, sizes) == coords
    for key in (("sp",), ("tp",), ("dp", "sp"), ("dp",)):
        axes = [M.AXES.index(a) for a in key]
        others = [i for i in range(3) if i not in axes]
        moved = np.moveaxis(devices, others + axes, list(range(3)))
        want = sorted(moved.reshape(-1, int(np.prod([shape[a] for a in axes]))).tolist())
        assert sorted(M._group_ranks(sizes, key)) == want


class _Coords(M.Mesh):
    """A mesh view at any rank without a process group (slicing only)."""

    def __init__(self, shape, rank):
        sizes = dict(zip(M.AXES, shape))
        super().__init__(sizes, rank, torch.device("cpu"), "none", {})


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (4, 1, 1), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_shard_batch_matches_jax_sharding(shape):
    """Each rank's block of a global (B, S, 8) batch is the shard JAX's
    ``P("dp", "sp", None)`` puts on device r (tp ranks hold the same)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    dp, tp, sp = shape
    x = np.arange(4 * 16 * 8).reshape(4, 16, 8)
    arr = jax.device_put(x, NamedSharding(_jax_mesh(dp, tp, sp), P("dp", "sp", None)))
    shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for r in range(dp * tp * sp):
        mesh = _Coords(shape, r)
        np.testing.assert_array_equal(M.shard_batch(mesh, x), shards[r])
        np.testing.assert_array_equal(
            M.shard_batch(mesh, torch.from_numpy(x)).numpy(), shards[r])


def test_indivisible_batch_refused_as_jax():
    """The runner's placement refuses a batch dp does not divide, in the
    words of JAX's ``put_batch_fn``; a sequence sp does not divide is refused
    too."""
    from pianobart_tpu.parallel.mesh import put_batch_fn
    x = np.zeros((3, 8, 8), np.int32)
    with pytest.raises(ValueError) as want:
        put_batch_fn(_jax_mesh(2, 1, 1))(x)
    with pytest.raises(ValueError) as got:
        M.put_batch_fn(_Coords((2, 1, 1), 0))(x)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        M.shard_batch(_Coords((2, 1, 1), 1), x)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="sequence length 8 not divisible by sp=3"):
        M.shard_batch(_Coords((1, 1, 3), 0), np.zeros((2, 8, 8)))


def test_ring_model_needs_an_active_mesh():
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import tiny_config
    model = init_lm(tiny_config(ring_axis="sp"), device="cpu")
    ids = torch.zeros((1, 32, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="no mesh is active"):
        model.encode(ids)
    with M.use_mesh(M.single_device_mesh()):
        assert model.encode(ids).shape == (1, 32, 64)
    assert M.active_mesh() is None


def test_init_from_env_one_rank_and_refusals(monkeypatch):
    """One rank: no process group, the 1x1x1 mesh on the named device; a
    mesh that needs other ranks, NCCL on the CPU and an unknown layout are
    refused before any process group exists."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    mesh = M.init_from_env(None, "nccl", "cpu")
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 1} and not mesh.distributed
    assert mesh.device == torch.device("cpu") and mesh.agree_any(True)
    with pytest.raises(ValueError, match="needs 4 ranks, the job has 1"):
        M.init_from_env("2x1x2", "gloo", "cpu")
    with pytest.raises(ValueError, match="not dpxTPxSP"):
        M.parse_mesh("2x2", 4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        M.init_from_env("1x1x2", "nccl", "cpu")
    assert M.parse_mesh(None, 2) == (2, 1, 1)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _encode_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30, (2, 128, 8)).astype(np.int64)
    mask = np.ones((2, 128), np.float32)
    mask[1, 100:] = 0.0
    return ids, mask


def _mesh_worker(rank, world, out_dir, lm_state):
    from pianobart_tpu_torch.models import PianoBartLM, tiny_config
    from pianobart_tpu_torch.ops.ring import rotate
    from pianobart_tpu_torch.parallel.sp import encode_sp
    res = {}
    mesh = M.make_mesh(2, 1, 2)
    res["axes"] = {k: (mesh.axis(k).size, mesh.axis(k).index, mesh.axis(k).ranks)
                   for k in ("sp", "tp", ("dp", "sp"))}
    res["coords"] = mesh.coords
    # a ring rotation: each rank receives its predecessor's tensors
    got = rotate(mesh.axis("sp"), [torch.full((3,), float(rank)),
                                   torch.full((2, 2), rank, dtype=torch.int32)])
    res["rotated"] = [t.tolist() for t in got]
    res["agree"] = (mesh.agree_any(rank == 3), mesh.agree_any(False))
    grads = [torch.full((2, 3), float(rank)), torch.full((4,), 1.0),
             torch.full((2,), rank, dtype=torch.float64)]
    M.all_reduce_grads_(grads, mesh.axis(("dp", "sp")))
    res["grads"] = [g.tolist() for g in grads]
    res["gathered"] = M.all_gather(torch.full((1, 2), float(rank)),
                                   mesh.axis("sp"), dim=1).tolist()
    # encode_sp over all four ranks on the sp axis
    sp4 = M.make_mesh(1, 1, 4)
    cfg = tiny_config(max_len=128, d_model=128, num_heads=1, emb_size=16,
                      encoder_layers=1, decoder_layers=1, ring_axis="sp")
    model = PianoBartLM(cfg, device="cpu")
    model.load_state_dict(torch.load(lm_state))
    ids, mask = (torch.from_numpy(x) for x in _encode_inputs())
    res["encoded"] = encode_sp(model, ids, mask, sp4).numpy()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The JAX encoder's weights carried to the port, then the four-rank
    run; returns each rank's results and the JAX encoder output."""
    import jax
    import jax.numpy as jnp
    from pianobart_tpu.models import PianoBartLM, tiny_config
    from pianobart_tpu.parallel.sp import encode_sp
    from pianobart_tpu_torch.compat.from_jax import config_from_jax, lm_state_dict_from_jax
    out = tmp_path_factory.mktemp("mesh")
    jcfg = tiny_config(max_len=128, d_model=128, num_heads=1, emb_size=16,
                       encoder_layers=1, decoder_layers=1)
    ids, mask = _encode_inputs()
    params = PianoBartLM(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                                    jnp.asarray(mask))
    torch.save(lm_state_dict_from_jax(params, config_from_jax(jcfg)), out / "lm.pt")
    model, mesh = PianoBartLM(jcfg.replace(ring_axis="sp")), _jax_mesh(1, 1, 4)
    want = jax.jit(lambda p, i, m: encode_sp(model, p, i, m, mesh))(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    spawn(_mesh_worker, 4, (str(out), str(out / "lm.pt")), threads=1)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)], \
        np.asarray(want)


def test_four_ranks_build_the_groups_and_collectives(four_ranks):
    """2x1x2 on four ranks: coordinates, axes (size, index, members), a
    rotation along the sp ring, the agreement (any rank's flag stops all),
    one all-reduce per dtype of the flattened gradients over (dp, sp), the
    gather along sp."""
    ranks, _ = four_ranks
    for r, res in enumerate(ranks):
        d, s = r // 2, r % 2
        assert res["coords"] == {"dp": d, "tp": 0, "sp": s}
        assert res["axes"]["sp"] == (2, s, (2 * d, 2 * d + 1))
        assert res["axes"]["tp"] == (1, 0, (r,))
        assert res["axes"][("dp", "sp")] == (4, r, (0, 1, 2, 3))
        prev = 2 * d + (1 - s)
        assert res["rotated"] == [[float(prev)] * 3, [[prev] * 2] * 2]
        assert res["agree"] == (True, False)
        assert res["grads"] == [[[6.0] * 3] * 2, [4.0] * 4, [6.0] * 2]
        assert res["gathered"] == [[2.0 * d] * 2 + [2.0 * d + 1] * 2]


def test_encode_sp_matches_jax(four_ranks):
    """The encoder with the sequence sharded over four ranks (ring
    attention, each shard's positional offset) equals JAX's ``encode_sp`` on
    the same weights, on every rank."""
    ranks, want = four_ranks
    for res in ranks:
        np.testing.assert_allclose(res["encoded"], want, rtol=2e-4, atol=2e-4)
