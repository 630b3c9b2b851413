"""The port's dataset loading against the JAX package's on the same shards:
``load_pretrain`` rows and order, ``ShardedWindows`` indexing,
``concatenate_pretrain`` and ``load_finetune``.  Integer data: every
comparison is exact."""
import os

import numpy as np
import pytest

from pianobart_tpu.data import datasets as jd
from pianobart_tpu_torch.data import datasets as td
from pianobart_tpu_torch.train.pretrain import batch_iterator


def _write_shards(root, sizes, splits=("train", "test", "valid")):
    """Shard ``d{i}`` holds ``sizes[i]`` windows of S=4, split across the
    given splits; row r of the whole corpus is filled with r."""
    base = 0
    for i, n in enumerate(sizes):
        ds = f"d{i}"
        os.makedirs(os.path.join(root, ds), exist_ok=True)
        for j, part in enumerate(np.array_split(np.arange(n), len(splits))):
            arr = (part[:, None, None] + base) * np.ones((len(part), 4, 8),
                                                          dtype=np.int64)
            np.save(os.path.join(root, ds, f"{ds}_{splits[j]}_split.npy"), arr)
        base += n
    return [f"d{i}" for i in range(len(sizes))]


@pytest.mark.parametrize("sizes,frac,seed", [([5, 3, 7], 0.15, 2023),
                                             ([11, 6], 0.3, 1), ([40], 0.15, 7)])
def test_load_pretrain_matches_jax(tmp_path, sizes, frac, seed):
    names = _write_shards(str(tmp_path), sizes)
    got = td.load_pretrain(str(tmp_path), names, valid_fraction=frac, seed=seed)
    want = jd.load_pretrain(str(tmp_path), names, valid_fraction=frac, seed=seed)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and len(g) == len(w)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_load_pretrain_unsplit_layout_and_missing(tmp_path):
    """A single ``<root>/<ds>.npy`` file counts as the train split; no shard
    at all raises as the JAX package does."""
    np.save(tmp_path / "solo.npy", np.arange(9 * 4 * 8).reshape(9, 4, 8))
    for g, w in zip(td.load_pretrain(str(tmp_path), ["solo"]),
                    jd.load_pretrain(str(tmp_path), ["solo"])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(FileNotFoundError):
        td.load_pretrain(str(tmp_path), ["absent"])


def test_sharded_windows_indexing_matches_jax(tmp_path):
    names = _write_shards(str(tmp_path), [4, 6], splits=("train",))
    shards = [np.load(os.path.join(tmp_path, n, f"{n}_train_split.npy"),
                      mmap_mode="r") for n in names]
    order = np.random.default_rng(0).permutation(10)
    port, ref = td.ShardedWindows(shards, order), jd.ShardedWindows(shards, order)
    for key in (np.array([9, 0, 4, 4, 7]), 3, np.int64(8), slice(2, 8),
                slice(None, None, -3), [1, 2]):
        np.testing.assert_array_equal(port[key], ref[key])
    np.testing.assert_array_equal(np.asarray(port, dtype=np.int32),
                                  np.asarray(ref, dtype=np.int32))
    assert port.shape == ref.shape and port.dtype == ref.dtype
    # the runner's batches gather across shard boundaries
    seen = 0
    for batch, w in batch_iterator(port, 3, np.random.default_rng(0),
                                   shuffle=False, drop_last=False):
        assert batch.shape == (3, 4, 8)
        seen += int(w.sum())
    assert seen == len(port)


def test_concatenate_pretrain_matches_jax(tmp_path):
    names = _write_shards(str(tmp_path), [5, 4])
    got = td.concatenate_pretrain(str(tmp_path), names, str(tmp_path / "p.npy"))
    want = jd.concatenate_pretrain(str(tmp_path), names, str(tmp_path / "j.npy"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "p.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()


@pytest.mark.parametrize("dataset,task", [("emotion", "emotion"),
                                          ("pop", "melody"), ("pop", "gen")])
def test_load_finetune_matches_jax(tmp_path, dataset, task):
    """Six arrays in the same order; ``emotion`` reads the ``emopia`` files,
    ``gen`` the ``_genans`` labels."""
    rng = np.random.default_rng(3)
    stem = "emopia" if dataset == "emotion" else dataset
    suffix = "genans" if task == "gen" else "ans"
    for split in ("train", "valid", "test"):
        np.save(tmp_path / f"{stem}_{split}.npy", rng.integers(0, 9, (3, 4, 8)))
        np.save(tmp_path / f"{stem}_{split}_{suffix}.npy", rng.integers(0, 4, (3,)))
    got = td.load_finetune(str(tmp_path), dataset, task)
    want = jd.load_finetune(str(tmp_path), dataset, task)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
