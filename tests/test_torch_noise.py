"""The port's batched corruptions: the invariants ``tests/test_noise.py``
checks for the JAX ones, span infilling against a sequential walk over the
same random draws, and statistics of the port against the JAX package's
corruptions over a few hundred samples.

The two packages draw from different generators, so they are compared by
distribution: each bound below is 4 standard errors of the difference of
two means (or two binomial frequencies) over N samples a side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pianobart_tpu.ops import noise as jnoise
from pianobart_tpu_torch import vocab as V
from pianobart_tpu_torch.ops import noise

S = 64
P = 0.15
N = 400            # samples a side for the statistics
PAD, MASK = np.asarray(V.PAD), np.asarray(V.MASK)


def _sample(seed=2023):
    rng = np.random.default_rng(seed)
    x = np.zeros((S, 8), dtype=np.int64)
    x[:, 0] = np.arange(S) // 4
    x[:, 1] = np.arange(S) % 4
    x[:, 3] = rng.integers(0, 128, S)
    x[-1] = V.EOS
    return x


def _batch(n=8):
    return torch.from_numpy(np.tile(_sample()[None], (n, 1, 1)))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _is_subsequence(rows, x):
    xi = 0
    for r in map(tuple, rows.tolist()):
        while xi < len(x) and tuple(x[xi]) != r:
            xi += 1
        if xi == len(x):
            return False
        xi += 1
    return True


def test_token_deletion_invariants():
    x = _sample()
    out, loss = noise.token_deletion(_batch(), P, _gen(1))
    n_del = int(S * P)
    for o, l in zip(out.numpy(), loss.numpy()):
        assert (o[S - n_del:] == PAD).all()
        assert _is_subsequence(o[:S - n_del], x)
        idx = np.where(l)[0]
        assert len(idx) > 0 and (np.diff(idx) == 1).all() and idx[-1] == S - 1


def test_token_mask_counts():
    x = _sample()
    k = round(S * P)
    n80 = round(k * 0.8)
    out, loss = noise.token_mask(_batch(), P, _gen(2))
    for o, l in zip(out.numpy(), loss.numpy()):
        assert l.sum() == k
        assert (o == MASK).all(-1).sum() == n80
        assert ((o != x).any(-1) <= l).all()


def test_sentence_permutation_preserves_multiset():
    x = _sample()
    out, loss = noise.sentence_permutation(_batch(), _gen(3))
    for o, l in zip(out.numpy(), loss.numpy()):
        assert sorted(map(tuple, o.tolist())) == sorted(map(tuple, x.tolist()))
        for b in np.unique(x[:, 0]):
            np.testing.assert_array_equal(o[o[:, 0] == b], x[x[:, 0] == b])
        np.testing.assert_array_equal(l, (o != x).any(-1))


def _walk(x, fire, spans):
    """The reference's sequential infilling walk over given draws."""
    out, skip = [], 0
    for i in range(len(x)):
        if skip > 0:
            skip -= 1
        elif fire[i] and spans[i] == 0:
            out += [x[i], MASK]
        elif fire[i]:
            out.append(MASK)
            skip = spans[i] - 1
        else:
            out.append(x[i])
    return out


@pytest.mark.parametrize("p,lam", [(0.15, 3.0), (0.9, 0.7)])
def test_token_infilling_matches_sequential_walk(p, lam):
    """Pointer doubling over the jump map and the (B, 10, S) batch of
    attempts give exactly the rows the sequential walk with retries gives on
    the same draws.  The second case (many insertions) forces retries and
    attempts that never fit."""
    x = _sample()
    B, A = 6, noise.MAX_ATTEMPTS
    out, loss = noise.token_infilling(_batch(B), p, _gen(5), lam=lam)
    g = _gen(5)
    fire = (torch.rand((B, A, S), generator=g) < p / max(1.0, lam)).numpy()
    spans = torch.poisson(torch.full((B, A, S), lam), generator=g).long().numpy()
    n_fit = 0
    for b in range(B):
        want = x
        for a in range(A):
            rows = _walk(x, fire[b, a], spans[b, a])
            if len(rows) <= S:
                want = np.stack(rows + [PAD] * (S - len(rows)))
                n_fit += 1
                break
        np.testing.assert_array_equal(out[b].numpy(), want)
        np.testing.assert_array_equal(loss[b].numpy(), (want != x).any(-1))
    assert n_fit > 0


def test_token_infilling_invariants():
    x = _sample()
    out, _ = noise.token_infilling(_batch(10), P, _gen(10))
    out = out.numpy()
    mask_rows = (out == MASK).all(-1)
    assert mask_rows.any()
    for o, m in zip(out, mask_rows):
        content = o[~m]
        content = content[~(content == PAD).all(-1)]
        assert _is_subsequence(content, x)


def test_infilling_zero_percent_identity():
    out, loss = noise.token_infilling(_batch(), 0.0, _gen(4))
    np.testing.assert_array_equal(out.numpy(), _batch().numpy())
    assert int(loss.sum()) == 0


def test_document_rotation():
    x = _sample()
    out, loss = noise.document_rotation(_batch(), _gen(5))
    for o, l in zip(out.numpy(), loss.numpy()):
        matches = [r for r in range(S) if (np.roll(x, -r, axis=0) == o).all()]
        assert matches, "output is not a rotation"
        assert (l == (matches[0] != 0)).all()


def test_corrupt_batch_shapes_and_corrupt():
    out, lm = noise.corrupt_batch(_batch(6), _gen(9), P)
    assert out.shape == (6, S, 8) and out.dtype == torch.int64
    assert lm.shape == (6, S, 8) and lm.dtype == torch.float32
    assert (lm == lm[..., :1]).all() and lm.sum() > 0
    one, loss = noise.corrupt(torch.from_numpy(_sample()), _gen(9), P)
    assert one.shape == (S, 8) and loss.shape == (S,) and loss.dtype == torch.bool


# --------------------------------------------------------------- statistics
def _jax_batch(fn, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    x = jnp.tile(jnp.asarray(_sample(), jnp.int32)[None], (N, 1, 1))
    out, loss = jax.vmap(fn)(keys, x)
    return np.asarray(out), np.asarray(loss).astype(np.float64)


def _close_means(a, b):
    """|mean a - mean b| within 4 standard errors of the difference."""
    se = np.sqrt(a.var() / len(a) + b.var() / len(b))
    assert abs(a.mean() - b.mean()) <= 4 * se + 1e-12, (a.mean(), b.mean(), se)


@pytest.mark.parametrize("name", ["deletion", "mask", "permutation",
                                  "infilling", "rotation"])
def test_loss_fraction_matches_jax(name):
    """Per corruption, the per-sample loss-mask fraction (and, for
    deletion, the first deleted position) has the same mean as JAX's."""
    port_fn, jax_fn = {
        "deletion": (lambda x, g: noise.token_deletion(x, P, g),
                     lambda k, x: jnoise.token_deletion(k, x, P)),
        "mask": (lambda x, g: noise.token_mask(x, P, g),
                 lambda k, x: jnoise.token_mask(k, x, P)),
        "permutation": (noise.sentence_permutation, jnoise.sentence_permutation),
        "infilling": (lambda x, g: noise.token_infilling(x, P, g),
                      lambda k, x: jnoise.token_infilling(k, x, P)),
        "rotation": (noise.document_rotation, jnoise.document_rotation),
    }[name]
    _, loss = port_fn(_batch(N), _gen(11))
    loss = loss.numpy().astype(np.float64)
    _, jloss = _jax_batch(jax_fn, 11)
    _close_means(loss.mean(1), jloss.mean(1))
    if name == "deletion":
        _close_means(loss.argmax(1).astype(float), jloss.argmax(1).astype(float))
    if name == "infilling":   # how many samples came out changed at all
        _close_means((loss.sum(1) > 0).astype(float),
                     (jloss.sum(1) > 0).astype(float))


def _classify(o, x):
    """Which corruption an output looks like (ambiguous outputs, such as an
    unchanged sample, fall in the first class that fits on both sides)."""
    n_mask = (o == MASK).all(-1).sum()
    n_pad = (o == PAD).all(-1).sum()
    if any((np.roll(x, -r, axis=0) == o).all() for r in range(S)):
        return 0                                    # rotation (or unchanged)
    if n_mask == round(round(S * P) * 0.8) and n_pad == 0 and \
            sorted(map(tuple, o[(o != MASK).any(-1)].tolist())) != \
            sorted(map(tuple, x.tolist())):
        return 1                                    # 80/10/10 mask
    if n_mask == 0 and n_pad == int(S * P) and (o[S - n_pad:] == PAD).all():
        return 2                                    # deletion
    if sorted(map(tuple, o.tolist())) == sorted(map(tuple, x.tolist())):
        return 3                                    # bar permutation
    return 4                                        # infilling


def test_corrupt_batch_choice_frequencies_match_jax():
    """The five corruptions are chosen uniformly: the class frequencies of
    the port's outputs agree with JAX's ``corrupt_batch`` within 4 binomial
    standard errors each, and the loss-mask fractions have the same mean."""
    x = _sample()
    out, lm = noise.corrupt_batch(_batch(N), _gen(12), P)
    jout, jlm = jnoise.corrupt_batch(
        jax.random.PRNGKey(12), jnp.tile(jnp.asarray(x, jnp.int32)[None], (N, 1, 1)), P)
    port_cls = np.bincount([_classify(o, x) for o in out.numpy()], minlength=5) / N
    jax_cls = np.bincount([_classify(o, x) for o in np.asarray(jout)], minlength=5) / N
    se = np.sqrt((port_cls * (1 - port_cls) + jax_cls * (1 - jax_cls)) / N)
    assert (np.abs(port_cls - jax_cls) <= 4 * se + 1e-12).all(), (port_cls, jax_cls)
    assert (port_cls[1:] > 0.1).all()
    _close_means(lm.numpy()[..., 0].mean(1), np.asarray(jlm)[..., 0].mean(1))


# ------------------------------------------- the five unused corruptions
# (bar and element level: the JAX package defines them behind the
# reference's flags; the shipped corrupt_batch never picks them)
NB = V.FIELD_SIZES[0]


def _gapped_sample():
    """Bars 0, 2, 4, ... of 3 rows each (empty bars between), an EOS row."""
    x = _sample()
    x[:, 0] = np.arange(S) // 3 * 2
    x[-1] = V.EOS
    return x


def test_bar_deletion_invariants():
    """Every row of a deleted bar goes, the rest keep their order, the tail
    is padding, and the loss covers every position from the first deletion
    on (the JAX package's loss over positions, not the reference's over
    bars)."""
    x = _sample()
    out, loss = noise.bar_deletion(_batch(), P, _gen(21))
    assert loss.shape == (8, S) and loss.dtype == torch.bool
    n_dels = []
    for o, l in zip(out.numpy(), loss.numpy()):
        kept = ~(o == PAD).all(-1)
        n_del = S - kept.sum()
        assert (o[S - n_del:] == PAD).all()
        gone = set(x[:, 0]) - set(o[kept][:, 0])
        want = x[~np.isin(x[:, 0], list(gone))]
        np.testing.assert_array_equal(o[:S - n_del], want)
        first = np.where(np.isin(x[:, 0], list(gone)))[0]
        np.testing.assert_array_equal(
            l, np.arange(S) >= first.min() if len(first) else np.zeros(S, bool))
        n_dels.append(n_del)
    assert max(n_dels) > 0


def test_token_mask_element_counts():
    x = _sample()
    k = round(S * P * 8)
    n80, n10 = round(k * 0.8), round(k * 0.1)
    out, loss = noise.token_mask_element(_batch(), P, _gen(22))
    assert loss.shape == (8, S, 8)
    for o, l in zip(out.numpy(), loss.numpy()):
        assert l.sum() == k
        assert ((o != x) <= l).all()                 # only chosen elements change
        n_mask = (o == MASK[None, :]).sum()
        assert n80 <= n_mask <= n80 + n10            # a random id may be <MASK> too


@pytest.mark.parametrize("make", [_sample, _gapped_sample])
def test_bar_mask_invariants(make):
    """Rows 0 and S-1 are exempt; every other row of a bar shares its loss;
    a row with loss is <MASK> or a random octuple, one without is kept."""
    x = make()
    xb = torch.from_numpy(np.tile(x[None], (16, 1, 1)))
    out, loss = noise.bar_mask(xb, 0.5, _gen(23))
    for o, l in zip(out.numpy(), loss.numpy()):
        assert not l[0] and not l[-1]
        np.testing.assert_array_equal(o[~l], x[~l])
        inner = np.arange(1, S - 1)
        for b in np.unique(x[inner, 0]):
            rows = inner[x[inner, 0] == b]
            assert len(set(l[rows])) == 1
    assert loss.any() and not loss.all()


def test_bar_mask_element_invariants():
    """Per element: rows 0 and S-1 exempt; within a (bar, instrument) group
    each field's loss is shared; an element without loss is kept."""
    x = _sample()
    x[:, 2] = np.arange(S) % 2                       # two instruments
    xb = torch.from_numpy(np.tile(x[None], (8, 1, 1)))
    out, loss = noise.bar_mask_element(xb, 0.5, _gen(24))
    assert loss.shape == (8, S, 8)
    for o, l in zip(out.numpy(), loss.numpy()):
        assert not l[0].any() and not l[-1].any()
        np.testing.assert_array_equal(o[~l], x[~l])
        group = x[:, 0] * V.FIELD_SIZES[2] + x[:, 2]
        for g in np.unique(group[1:-1]):
            rows = 1 + np.where(group[1:-1] == g)[0]
            assert (l[rows] == l[rows[0]]).all()
        mask_elems = l & (o == MASK[None, :])
        assert mask_elems.any()


def _bar_walk(x, fire, spans, num_mask):
    """The JAX package's bar-level infilling walk, sequentially, over given
    draws: the emitted rows."""
    bars = x[:, 0]
    counts = np.bincount(bars, minlength=NB)
    deleted, mask_pos, append_pos = set(), set(), set()
    skip = budget = 0
    for i in range(NB):
        if skip > 0:
            skip -= 1
            continue
        if not fire[i]:
            continue
        if spans[i] == 0:
            if counts[i]:
                append_pos.add(np.where(bars == i)[0].max())
            continue
        hi = min(i + spans[i], NB)
        cur = counts[i:hi].sum()
        if budget + cur > num_mask:
            continue
        budget += cur
        skip = spans[i] - 1
        deleted.update(range(i, hi))
        nonempty = [b for b in range(i, hi) if counts[b]]
        if nonempty:
            mask_pos.add(np.where(bars == nonempty[0])[0].min())
    out = []
    for pos in range(len(x)):
        if pos in mask_pos:
            out.append(MASK)
        elif bars[pos] not in deleted:
            out.append(x[pos])
            if pos in append_pos:
                out.append(MASK)
    return out


@pytest.mark.parametrize("make", [_sample, _gapped_sample])
@pytest.mark.parametrize("p,lam", [(0.15, 3.0), (0.5, 1.0), (0.9, 0.7)])
def test_bar_infilling_matches_sequential_walk(p, lam, make):
    """The device loop over the bars and the (B, 10) batch of attempts give
    exactly the rows of the sequential walk with retries on the same draws;
    the later cases (many appends) force retries and attempts that never
    fit."""
    x = make()
    B, A = 6, noise.MAX_ATTEMPTS
    xb = torch.from_numpy(np.tile(x[None], (B, 1, 1)))
    out, loss = noise.bar_infilling(xb, p, _gen(25), lam=lam)
    g = _gen(25)
    fire = (torch.rand((B, A, NB), generator=g) < p / max(1.0, lam)).numpy()
    spans = torch.poisson(torch.full((B, A, NB), lam), generator=g).long().numpy()
    changed = 0
    for b in range(B):
        want = x
        for a in range(A):
            rows = _bar_walk(x, fire[b, a], spans[b, a], round(S * p))
            if len(rows) <= S:
                want = np.stack(rows + [PAD] * (S - len(rows)))
                break
        np.testing.assert_array_equal(out[b].numpy(), want)
        np.testing.assert_array_equal(loss[b].numpy(), (want != x).any(-1))
        changed += int((want != x).any())
    assert changed > 0


def test_bar_infilling_invariants():
    x = _sample()
    out, loss = noise.bar_infilling(_batch(10), 0.3, _gen(26))
    out = out.numpy()
    for o, l in zip(out, loss.numpy()):
        m = (o == MASK).all(-1)
        content = o[~m]
        content = content[~(content == PAD).all(-1)]
        assert _is_subsequence(content, x)
        np.testing.assert_array_equal(l, (o != x).any(-1))
    assert (out == MASK).all(-1).any()


def test_bar_infilling_zero_percent_identity():
    out, loss = noise.bar_infilling(_batch(), 0.0, _gen(27))
    np.testing.assert_array_equal(out.numpy(), _batch().numpy())
    assert int(loss.sum()) == 0


def test_corrupt_batch_draws_are_unchanged():
    """The shipped corruption (and so every pretrain step's loss) draws
    exactly as before the bar and element variants came: a digest of one
    fixed-generator output, taken before they were added."""
    import hashlib
    out, lm = noise.corrupt_batch(_batch(16), _gen(2024), 0.15)
    digest = hashlib.sha256(out.numpy().tobytes() + lm.numpy().tobytes()).hexdigest()
    assert digest == "d9d9664f6558a0e23a2942745b0432dba61db164611d6a7a00e4e0406c38bdd9"


@pytest.mark.parametrize("name", ["bar_deletion", "mask_element", "bar_mask",
                                  "bar_mask_element", "bar_infilling"])
def test_unused_corruptions_match_jax(name):
    """Per corruption, the per-sample loss fraction has the same mean as
    JAX's; bar deletion's first deleted position too, and element masking's
    count of chosen elements is exactly JAX's."""
    port_fn, jax_fn = {
        "bar_deletion": (noise.bar_deletion, jnoise.bar_deletion),
        "mask_element": (noise.token_mask_element, jnoise.token_mask_element),
        "bar_mask": (noise.bar_mask, jnoise.bar_mask),
        "bar_mask_element": (noise.bar_mask_element, jnoise.bar_mask_element),
        "bar_infilling": (noise.bar_infilling, jnoise.bar_infilling),
    }[name]
    _, loss = port_fn(_batch(N), P, _gen(28))
    loss = loss.numpy().reshape(N, -1).astype(np.float64)
    _, jloss = _jax_batch(lambda k, x: jax_fn(k, x, P), 28)
    jloss = jloss.reshape(N, -1)
    _close_means(loss.mean(1), jloss.mean(1))
    if name == "bar_deletion":
        _close_means(loss.argmax(1).astype(float), jloss.argmax(1).astype(float))
    if name == "mask_element":
        assert (loss.sum(1) == round(S * P * 8)).all()
        assert (jloss.sum(1) == round(S * P * 8)).all()
    if name == "bar_infilling":
        _close_means((loss.sum(1) > 0).astype(float), (jloss.sum(1) > 0).astype(float))
