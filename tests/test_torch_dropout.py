"""The port's bit-sampled dropout against the JAX package's ``Dropout``.

The two draw their bits from different generators, so they are compared by
distribution: identity where no dropout applies, the quantised drop rate
``t/256`` with ``t = min(round(rate*256), 255)``, the keep scale
``256/(256-t)``, unbiasedness, and the keep rate of each side against the
other within binomial bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.ops.dropout import Dropout as JaxDropout
from pianobart_tpu_torch.ops.dropout import dropout, threshold


def _jax(rate, x, seed=0):
    mod = JaxDropout(rate)
    variables = mod.init({"dropout": jax.random.PRNGKey(seed)}, x,
                         deterministic=True)
    return np.asarray(mod.apply(variables, x, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(seed)}))


def _port(rate, x, seed=0, deterministic=False):
    return dropout(x, rate, torch.Generator().manual_seed(seed), deterministic)


def test_deterministic_and_zero_rate_are_identity():
    x = torch.arange(24.0).reshape(4, 6)
    assert _port(0.5, x, deterministic=True) is x
    assert _port(0.0, x) is x
    assert dropout(x, 0.3, None, deterministic=True) is x


def test_needs_an_explicit_generator():
    with pytest.raises(ValueError, match="Generator"):
        dropout(torch.ones(4), 0.1, None)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_drop_rate_and_scale_match_jax(rate):
    """Keep rates within 4 binomial sigmas of the quantised keep rate and of
    each other; survivors carry exactly the same scale on both sides."""
    n = 512 * 512
    t = threshold(rate)
    keep = 1.0 - t / 256.0
    y = _port(rate, torch.ones(512, 512), seed=3).numpy()
    yj = _jax(rate, jnp.ones((512, 512)), seed=3)
    sigma = np.sqrt(keep * (1 - keep) / n)
    for z in (y, yj):
        assert abs((z != 0).mean() - keep) < 4 * sigma
    assert abs((y != 0).mean() - (yj != 0).mean()) < 4 * np.sqrt(2) * sigma
    np.testing.assert_allclose(y[y != 0], 256.0 / (256.0 - t), rtol=1e-6)
    np.testing.assert_allclose(np.unique(y[y != 0]), np.unique(yj[yj != 0]),
                               rtol=1e-6)


def test_bf16_survivors_match_jax():
    """The keep scale is rounded to the input's dtype before the product, as
    the reference casts it: bf16 x = 1.5 at rate 0.1 keeps
    1.5 * bf16(256/230) = 1.5 * 1.109375, rounded to 1.6640625, on both
    sides (a scale kept in f32 would give 1.671875)."""
    x = np.full((256, 256), 1.5, np.float32)
    y = _port(0.1, torch.from_numpy(x).to(torch.bfloat16), seed=5)
    yj = _jax(0.1, jnp.asarray(x, jnp.bfloat16), seed=5)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    kept = y.float().numpy()
    kept_j = np.asarray(yj, np.float32)
    assert set(np.unique(kept)) == {0.0, 1.6640625}
    assert set(np.unique(kept_j)) == {0.0, 1.6640625}


def test_unbiased_expectation():
    y = _port(0.3, torch.full((2048, 256), 2.0), seed=9).numpy()
    assert abs(y.mean() - 2.0) < 0.02


def test_rate_near_one_clamps_to_255():
    """Rate 0.999 rounds to 256/256; the threshold clamps at 255 so uint8
    bits can still pass (1/256 kept, scaled by 256), as in the JAX op."""
    assert threshold(0.999) == 255
    y = _port(0.999, torch.ones(256, 1024), seed=1).numpy()
    assert set(np.unique(y)) <= {0.0, 256.0}
    kept = (y != 0).mean()
    sigma = np.sqrt((1 / 256) * (255 / 256) / y.size)
    assert abs(kept - 1 / 256) < 4 * sigma
    yj = _jax(0.999, jnp.ones((256, 1024)), seed=1)
    assert set(np.unique(yj)) <= {0.0, 256.0}


def test_bf16_input_keeps_its_dtype():
    x = torch.ones(64, 64, dtype=torch.bfloat16)
    assert _port(0.1, x).dtype == torch.bfloat16
