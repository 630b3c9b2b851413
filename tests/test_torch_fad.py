"""The port's FAD metrics: its numpy copy against the JAX package's (equal)
and against ``tests/vendored_shapesimilarity.py``, the upstream package's
per-pair reconstruction (to one unit of the package's 4th decimal, the
bound the JAX package's own test holds); its batched torch windows, rounded
as the package rounds, within 1e-5 of the numpy ones (float64 both)."""
import numpy as np
import pytest
import torch

from pianobart_tpu.utils import fad as jfad
from pianobart_tpu_torch.utils import fad
from tests.vendored_shapesimilarity import shape_similarity_track

torch.set_num_threads(2)


def _tracks(rng, n, P):
    y1 = rng.integers(0, 128, (n, P)).astype(float)
    y2 = rng.integers(0, 128, (n, P)).astype(float)
    y2[0] = y1[0]                 # identical
    y2[1] = y1[1] + 7             # translated
    y1[2] = 60                    # flat: a zero-length curve
    return y1, y2


@pytest.mark.parametrize("P", [5, 9, 23])
def test_numpy_copy_matches_jax_and_the_vendored_upstream(P):
    y1, y2 = _tracks(np.random.default_rng(P), 12, P)
    got = fad.shape_similarity_batch(y1, y2)
    np.testing.assert_array_equal(got, jfad.shape_similarity_batch(y1, y2))
    for a, b, s in zip(y1, y2, got):
        assert shape_similarity_track(a, b) == pytest.approx(float(s), abs=1.01e-4)
    bars = np.sort(np.random.default_rng(0).integers(0, 4, P))
    assert fad.fad_windows(y1[3], y2[3], gap=3) == jfad.fad_windows(y1[3], y2[3], gap=3)
    assert fad.fad_bars(y1[3], y2[3], bars) == jfad.fad_bars(y1[3], y2[3], bars)


@pytest.mark.parametrize("P", [5, 9, 23])
def test_torch_batch_within_1e5_of_numpy(P):
    y1, y2 = _tracks(np.random.default_rng(P + 1), 16, P)
    got = fad.shape_similarity_batch_torch(y1, y2, "cpu")
    assert got.dtype == torch.float64 and got.shape == (16,)
    np.testing.assert_allclose(np.round(got.numpy(), 4),
                               fad.shape_similarity_batch(y1, y2), rtol=0, atol=1e-5)


def test_generation_fad_both_paths_match_jax():
    """``generation_fad`` on a batch with a masked tail: the host path equals
    JAX's and the mean of the per-sample ``fad_windows``/``fad_bars``; the batched window path (``jit_windows``, on the CPU here) gives
    the host path's FAD within 1e-5 and the same FAD-BAR."""
    rng = np.random.default_rng(3)
    B, S = 3, 97
    y = np.zeros((B, S, 8), dtype=np.int64)
    out = np.zeros_like(y)
    y[..., 3] = rng.integers(0, 120, (B, S))
    out[..., 3] = rng.integers(0, 120, (B, S))
    y[..., 0] = np.sort(rng.integers(0, 6, (B, S)), axis=1)
    attn = np.ones((B, S))
    attn[1, 60:] = 0
    host = fad.generation_fad(y, out, attn)
    assert host == jfad.generation_fad(y, out, attn)
    # the batch's one Fréchet pass gives the per-sample metrics' mean
    # (added in order: Python's sum() of floats compensates)
    fw = fb = 0.0
    for j, m in enumerate(attn == 1):
        fw += fad.fad_windows(y[j, m, 3], out[j, m, 3])
        fb += fad.fad_bars(y[j, m, 3], out[j, m, 3], y[j, m, 0])
    assert host == (fw / B, fb / B)
    batched = fad.generation_fad(y, out, attn, jit_windows=True, device="cpu")
    assert batched[0] == pytest.approx(host[0], abs=1e-5)
    assert batched[1] == host[1]
