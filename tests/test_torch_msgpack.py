"""The port's flax msgpack reader and writer (``compat/flax_msgpack.py``)
against flax's own, and ``flax_tree_from_state_dict`` as the inverse of
``lm_state_dict_from_jax``.

* ``flax.serialization.to_bytes`` -> the port's reader, and the port's
  writer -> ``msgpack_restore``, both bit-exact, for f32, f64 and bf16
  leaves; the port writes flax's bytes exactly.
* The scalars a map may hold read and write as the ``msgpack`` module's.
* flax's chunked form of a huge leaf, and an ext type that is not an
  array, are refused.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from pianobart_tpu.models import PianoBartLM as JaxLM
from pianobart_tpu.models import SequenceClassification as JaxSeq
from pianobart_tpu.models import TokenClassification as JaxTok
from pianobart_tpu.models import tiny_config as jax_tiny_config
from pianobart_tpu_torch.compat import flax_msgpack as fm
from pianobart_tpu_torch.compat.from_jax import (flax_tree_from_state_dict,
                                                 lm_state_dict_from_jax)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(3, 5), (7,), (), (0, 4), (2, 3, 4)]


def _jax_tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(rng.standard_normal(s), dtype=np.float32).astype(dtype)
              for s in SHAPES]
    return {"pianobart": {"layers_0": {"kernel": leaves[0], "bias": leaves[1]},
                          "scalar": leaves[2]},
            "lm_head": {"empty": leaves[3], "cube": leaves[4]}}


def _torch_leaf(a, tdtype):
    if tdtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a).copy())


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flax_bytes_read_bit_exact(dtype):
    np_dtype, tdtype = DTYPES[dtype]
    tree = _jax_tree(np_dtype)
    got = fm.msgpack_restore(serialization.to_bytes(tree))
    want = _map(lambda a: _torch_leaf(a, tdtype), tree)
    assert list(got) == list(want)

    def check(g, w):
        assert g.dtype == tdtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
    _map_pairs(check, got, want)


def _map_pairs(fn, a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _map_pairs(fn, a[k], b[k])
        else:
            fn(a[k], b[k])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_bytes_are_flax_bytes(dtype):
    """The port's writer gives flax's bytes for the same tree, and flax's
    reader gets every leaf back bit for bit."""
    np_dtype, tdtype = DTYPES[dtype]
    tree = _jax_tree(np_dtype, seed=1)
    ported = _map(lambda a: _torch_leaf(a, tdtype), tree)
    blob = fm.to_bytes(ported)
    assert blob == serialization.to_bytes(tree)
    back = serialization.msgpack_restore(blob)

    def check(g, w):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
    _map_pairs(check, back, tree)


@pytest.mark.parametrize("value", [None, True, False, 0, 5, 127, 128, 255, 256, 65535,
                                   65536, 2**32, -1, -32, -33, -128, -129, -2**31 - 1,
                                   1.5, -0.0, "", "x" * 31, "x" * 32, "é" * 200,
                                   "y" * 70000, b"\x00\x01", [1, "a", None],
                                   list(range(20)), {"k": {"n": 1}}])
def test_scalars_match_the_msgpack_module(value):
    assert fm.to_bytes({"v": value}) == msgpack.packb({"v": value}, use_bin_type=True)
    got = fm.msgpack_restore(msgpack.packb({"v": value}, use_bin_type=True))["v"]
    assert got == value and type(got) is type(value)


def test_file_round_trip(tmp_path):
    tree = _map(lambda a: torch.from_numpy(a), _jax_tree(np.float32, seed=2))
    path = str(tmp_path / "t.msgpack")
    fm.write_msgpack(tree, path)
    back = fm.read_msgpack(path)

    def check(g, w):
        assert torch.equal(g, w)
    _map_pairs(check, back, tree)


def test_chunked_leaves_and_foreign_ext_types_are_refused(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    blob = serialization.to_bytes({"big": np.zeros(100, np.float32)})
    assert "__msgpack_chunked_array__" in msgpack.unpackb(blob, raw=False)["big"]
    with pytest.raises(ValueError, match="chunked"):
        fm.msgpack_restore(blob)
    with pytest.raises(ValueError, match="ext type 3"):
        fm.msgpack_restore(serialization.to_bytes({"s": np.float32(1.0)}))
    with pytest.raises(ValueError, match="truncated"):
        fm.msgpack_restore(serialization.to_bytes({"a": np.ones(3)})[:-2])


S = 32


def _models():
    cfg = jax_tiny_config(encoder_layers=2, decoder_layers=1)
    vcfg = jax_tiny_config(encoder_layers=1, decoder_layers=2, decoder_label_vocab=5)
    ids, ones = jnp.zeros((1, S, 8), jnp.int32), jnp.ones((1, S))
    return {"lm": (JaxLM(cfg), (ids, ids, ones, ones), cfg),
            "seq": (JaxSeq(cfg, 4), (ids, ones), cfg),
            "velocity": (JaxTok(vcfg, 5), (ids, jnp.zeros((1, S), jnp.int32), ones, ones),
                         vcfg)}


@pytest.mark.parametrize("kind", ["lm", "seq", "velocity"])
def test_flax_tree_from_state_dict_inverts_lm_state_dict_from_jax(kind):
    """Both ways round, exactly: flax params -> the port's names -> flax
    params, and the port's state_dict -> flax -> the port's."""
    module, sample, cfg = _models()[kind]
    params = fnn.meta.unbox(module.init(jax.random.PRNGKey(3), *sample))["params"]
    sd = lm_state_dict_from_jax(params, cfg)
    tree = flax_tree_from_state_dict(sd)

    def check(g, w):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _map_pairs(check, tree, params)
    back = lm_state_dict_from_jax(tree, cfg)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
