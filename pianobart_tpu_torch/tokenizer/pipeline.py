"""Offline dataset generation pipeline
(``pianobart_tpu/tokenizer/pipeline.py``).

Replaces the reference's interactive ``convert.py __main__``
(``convert.py:569-651``): reads a dataset zip (or a directory of MIDI
files), splits files 80/10/10, tokenizes per task, and writes the same
``.npy`` artifact layout the trainers consume:

* ``<out>/<dataset>_{train,valid,test}.npy``  (+ ``..._ans.npy`` labels)
* pretrain without padding / melody / velocity: flat streams reshaped to
  ``(m, 1024, ...)`` via :func:`data_split`
* composer: ``<dataset>_composer.json`` name->id map from directory names

Label extraction is explicit path logic instead of the reference's fragile
regexes (``convert.py:479-489``; the asap regex matches literally "ata" on
the shipped paths): composer = the path component under the dataset root,
emotion = ``Q<n>`` prefix quadrant - 1.
"""
from __future__ import annotations

import json
import os
import random
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import vocab as V
from .codec import MELODY_MAP, VELOCITY_MAP
from .segment import data_split, process_bytes

__all__ = ["run_dataset_pipeline", "list_midi_files", "composer_from_path",
           "emotion_from_path"]


def list_midi_files(dataset_path: str) -> List[Tuple[str, bytes]]:
    """(relative name, bytes) for each MIDI file in a zip or directory."""
    out: List[Tuple[str, bytes]] = []
    if os.path.isdir(dataset_path):
        for root, _, files in os.walk(dataset_path):
            for f in sorted(files):
                if f.lower().endswith((".mid", ".midi")):
                    p = os.path.join(root, f)
                    with open(p, "rb") as fh:
                        out.append((os.path.relpath(p, dataset_path), fh.read()))
    else:
        with zipfile.ZipFile(dataset_path) as z:
            for n in z.namelist():
                if n.lower().endswith((".mid", ".midi")):
                    out.append((n, z.read(n)))
    return out


def composer_from_path(rel_path: str, dataset: str = "") -> str:
    """Composer label from the path, mirroring the reference's per-dataset
    rules (convert.py:480-483): asap keys on the FIRST path component
    (``Bach/Fugue/bwv_846/x.mid`` -> Bach), everything else (Pianist8
    style) on the file's parent directory, skipping ``midi`` wrappers."""
    parts = [p for p in rel_path.split("/") if p and p != "midi"]
    if len(parts) < 2:
        return "UNKNOWN"
    if "asap" in dataset.lower():
        return parts[0]
    return parts[-2]


def emotion_from_path(rel_path: str) -> Optional[int]:
    """EMOPIA names files ``Q<quadrant>_...`` (convert.py:489)."""
    base = os.path.basename(rel_path)
    if len(base) >= 2 and base[0] in "Qq" and base[1].isdigit():
        return int(base[1]) - 1
    return None


def _stratified_split(files, label_of, rng) -> Dict[str, list]:
    """Per-label 80/10/10 file split.

    Files whose label is ``None`` (e.g. no ``Q<n>`` prefix — they are
    skipped by the emotion tokenizer anyway) go to train.  Within a label
    group the allocation is train-first: n>=3 guarantees one valid and one
    test file, n==2 one test file, n==1 train only (a class invisible at
    eval time is better than a class that was never trained on).
    """
    groups: Dict[object, list] = {}
    for item in files:
        groups.setdefault(label_of(item[0]), []).append(item)
    splits: Dict[str, list] = {"train": [], "valid": [], "test": []}
    for lab in sorted(groups, key=str):
        g = groups[lab]
        if lab is None:
            splits["train"].extend(g)
            continue
        n = len(g)
        n_test = max(1, n // 10) if n >= 2 else 0
        n_valid = max(1, n // 10) if n >= 3 else 0
        splits["train"].extend(g[: n - n_valid - n_test])
        splits["valid"].extend(g[n - n_valid - n_test: n - n_test])
        splits["test"].extend(g[n - n_test:])
    for part in splits.values():
        rng.shuffle(part)
    return splits


def run_dataset_pipeline(dataset_path: str, task: str = "pretrain",
                         pad: Optional[bool] = None,
                         out_root: Optional[str] = None,
                         seed: int = 2023,
                         window: int = V.MAX_WINDOW,
                         log=print) -> Dict[str, str]:
    """Tokenize one dataset for one task.  Returns {artifact: path}.

    ``window`` (k*1024) emits long-context rows (``cli pretrain
    --max_seq_len k*1024``).
    """
    if task in ("melody", "velocity"):
        # token-classification layouts are inherently unpadded windows;
        # an explicit pad=True was previously overridden in silence
        if pad:
            raise ValueError(f"task {task!r} does not support pad=True "
                             f"(unpadded token-classification layout)")
        pad = False
    elif pad is None:
        pad = True

    name = os.path.splitext(os.path.basename(dataset_path.rstrip("/")))[0]
    out_root = out_root or f"Data/output_{task}"
    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)

    files = list_midi_files(dataset_path)
    rng = random.Random(seed)
    rng.shuffle(files)

    composer_map: Dict[str, int] = {}
    artifacts: Dict[str, str] = {}
    if task == "composer":
        composers = sorted({composer_from_path(p, name) for p, _ in files})
        composer_map = {c: i for i, c in enumerate(composers)}
        jpath = os.path.join(out_dir, f"{name}_{task}.json")
        with open(jpath, "w") as f:
            json.dump(composer_map, f, indent=4)
        artifacts["composer_map"] = jpath

    ok_cnt, all_cnt = 0, 0
    dedup: Dict[str, str] = {}

    def tokenize_one(rel: str, raw: bytes):
        """Label extraction + per-file-tolerant tokenization (returns the
        ProcessResult or None on skip/error, with counting + logging)."""
        nonlocal ok_cnt, all_cnt
        all_cnt += 1
        composer = (composer_from_path(rel, name)
                    if task == "composer" else None)
        emotion = emotion_from_path(rel) if task == "emotion" else None
        if task == "emotion" and emotion is None:
            # file not named Q<quadrant>_…: a None label used to flow
            # into np.asarray(..., int64) and abort the whole run; skip
            # per-file like the reference's caught F() error
            log(f"ERROR(LABEL): {rel}: no Q<quadrant> emotion label "
                f"in filename")
            return None
        res = process_bytes(raw, task=task, pad=pad, composer=composer,
                            emotion=emotion, dedup_seen=dedup,
                            file_name=rel, window=window)
        if not res.ok:
            log(f"ERROR({res.status.upper()}): {res.detail}")
            return None
        ok_cnt += 1
        return res

    tokenized: Dict[str, object] = {}
    if task in ("composer", "emotion"):
        # Stratified 80/10/10: the reference's plain file shuffle
        # (convert.py:606-616) lets small classes land entirely outside the
        # test split.  Files are tokenized FIRST (in global shuffled order, so the dedup drops
        # duplicates deterministically) and only the survivors stratified —
        # otherwise content-dedup could erase a class's test files after
        # the split was balanced.
        for rel, raw in files:
            res = tokenize_one(rel, raw)
            if res is not None:
                tokenized[rel] = res
        label_of = ((lambda rel: composer_from_path(rel, name))
                    if task == "composer" else emotion_from_path)
        survivors = [fr for fr in files if fr[0] in tokenized]
        splits = _stratified_split(survivors, label_of, rng)
    else:
        n = len(files)
        splits = {
            "train": files[: 80 * n // 100],
            "valid": files[80 * n // 100: 90 * n // 100],
            "test": files[90 * n // 100:],
        }

    for split, split_files in splits.items():
        sequences: List = []
        labels: List = []
        for rel, raw in split_files:
            res = (tokenized[rel] if task in ("composer", "emotion")
                   else tokenize_one(rel, raw))
            if res is None:
                continue
            if task == "generate":
                sequences.extend(res.sequences)
                labels.extend(res.labels)
            elif task in ("melody", "velocity"):
                for rows, labs in zip(res.sequences, res.labels):
                    sequences.extend(rows)
                    labels.extend(labs)
            elif task == "pretrain":
                if pad:
                    sequences.extend(res.sequences)
                else:
                    for rows in res.sequences:
                        sequences.extend(rows)
            else:  # composer / emotion
                sequences.extend(res.sequences)
                labels.extend(res.labels)

        if not sequences:
            continue
        out_file = os.path.join(out_dir, f"{name}_{split}.npy")
        ans_file = os.path.join(out_dir, f"{name}_{split}_ans.npy")
        if task == "pretrain":
            arr = np.asarray(sequences, dtype=np.int64)
            if not pad:
                arr = data_split(arr, window=window)
                out_file = os.path.join(out_dir, f"{name}_{split}_split.npy")
            np.save(out_file, arr)
        elif task in ("melody", "velocity"):
            other = (MELODY_MAP if task == "melody" else VELOCITY_MAP)["OTHER"]
            arr = data_split(np.asarray(sequences, dtype=np.int64))
            ans = data_split(np.asarray(labels, dtype=np.int64),
                             content=other, tokens_per_line=1)
            np.save(out_file, arr)
            np.save(ans_file, ans)
            artifacts[f"{split}_ans"] = ans_file
        elif task == "generate":
            np.save(out_file, np.asarray(sequences, dtype=np.int64))
            gen_file = os.path.join(out_dir, f"{name}_{split}_genans.npy")
            np.save(gen_file, np.asarray(labels, dtype=np.int64))
            artifacts[f"{split}_genans"] = gen_file
        else:  # composer / emotion
            np.save(out_file, np.asarray(sequences, dtype=np.int64))
            if task == "composer":
                ids = [composer_map[c] for c in labels]
            else:
                ids = labels
            np.save(ans_file, np.asarray(ids, dtype=np.int64))
            artifacts[f"{split}_ans"] = ans_file
        artifacts[split] = out_file
        log(f"{split}: {len(sequences)} sequences -> {out_file}")

    log(f"{ok_cnt}/{all_cnt} MIDI files successfully processed")
    return artifacts
