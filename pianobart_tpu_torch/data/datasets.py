"""Dataset loading (``pianobart_tpu/data/datasets.py``).

`.npy`-compatible with the reference layout (``pretrain.py:548-579``,
``finetune.py:277-338``): pretrain shards live at
``<root>/<dataset>/<dataset>_{train,test,valid}_split.npy`` and finetune
data at ``<root>/<dataset>_{split}.npy`` + ``..._ans.npy`` (generation:
``..._genans.npy``).  Arrays are memory-mapped; the runner gathers each
batch's rows on demand, so host memory stays bounded for a large pretrain
concatenation.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_PRETRAIN_DATASETS = ("asap", "EMOPIA", "Pianist8", "POP1K7", "POP909")


class ShardedWindows:
    """Read-only view over a list of mmap'd ``(n_i, S, 8)`` shards with a
    fixed global row order.

    Supports what the trainers use (``len``, ``.shape``, fancy-indexed
    batch gathers) and materializes only the requested rows, where
    ``np.concatenate`` and a permutation would copy the corpus twice."""

    def __init__(self, shards: List[np.ndarray], order: np.ndarray):
        self._shards = shards
        self._starts = np.cumsum([0] + [len(s) for s in shards])
        self._order = np.asarray(order)

    def __len__(self) -> int:
        return len(self._order)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self._order),) + tuple(self._shards[0].shape[1:])

    @property
    def dtype(self):
        return self._shards[0].dtype

    def _get_rows(self, rows: np.ndarray) -> np.ndarray:
        g = self._order[rows]
        shard = np.searchsorted(self._starts, g, side="right") - 1
        out = np.empty((len(g),) + tuple(self._shards[0].shape[1:]),
                       dtype=self._shards[0].dtype)
        for i, (s, r) in enumerate(zip(shard, g - self._starts[shard])):
            out[i] = self._shards[s][r]
        return out

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self._get_rows(np.asarray([key]))[0]
        if isinstance(key, slice):
            return self._get_rows(np.arange(len(self))[key])
        return self._get_rows(np.asarray(key))

    def __array__(self, dtype=None):
        out = self._get_rows(np.arange(len(self)))
        return out if dtype is None else out.astype(dtype)


def load_pretrain(root: str,
                  datasets: Sequence[str] = DEFAULT_PRETRAIN_DATASETS,
                  valid_fraction: float = 0.15,
                  seed: int = 2023) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate pretrain shards, shuffle, 85/15 split (pretrain.py:548-576)."""
    parts: List[np.ndarray] = []
    for ds in datasets:
        for split in ("train", "test", "valid"):
            path = os.path.join(root, ds, f"{ds}_{split}_split.npy")
            if not os.path.exists(path):
                # also accept unsplit single-file layout
                alt = os.path.join(root, f"{ds}.npy")
                if split == "train" and os.path.exists(alt):
                    parts.append(np.load(alt, mmap_mode="r"))
                continue
            parts.append(np.load(path, mmap_mode="r"))
    if not parts:
        raise FileNotFoundError(f"no pretrain shards under {root}")
    n = sum(len(p) for p in parts)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)   # same row selection as the eager concat+fancy
    split = int(n * (1.0 - valid_fraction))
    return (ShardedWindows(parts, idx[:split]),
            ShardedWindows(parts, idx[split:]))


def load_finetune(root: str, dataset: str, task: str):
    """Returns (X_train, X_val, X_test, y_train, y_val, y_test)."""
    if dataset == "emotion":
        dataset = "emopia"
    suffix = "genans" if task == "gen" else "ans"
    out = []
    for split in ("train", "valid", "test"):
        out.append(np.load(os.path.join(root, f"{dataset}_{split}.npy"),
                           allow_pickle=True))
    for split in ("train", "valid", "test"):
        out.append(np.load(os.path.join(root, f"{dataset}_{split}_{suffix}.npy"),
                           allow_pickle=True))
    X_train, X_val, X_test, y_train, y_val, y_test = out
    return X_train, X_val, X_test, y_train, y_val, y_test


def concatenate_pretrain(root: str, datasets: Sequence[str],
                         out_path: str) -> np.ndarray:
    """Merge per-dataset shards into one array (concatenate.py:16-38)."""
    parts = []
    for ds in datasets:
        for split in ("train", "test", "valid"):
            p = os.path.join(root, ds, f"{ds}_{split}_split.npy")
            if os.path.exists(p):
                parts.append(np.load(p))
    merged = np.vstack(parts)
    np.save(out_path, merged)
    return merged
