"""Dataset validators (``pianobart_tpu/tokenizer/validate.py``).

Equivalent of the reference ``check.py`` invariants (check.py:75-136):

* per field: the max token equals the ``<EOS>`` id and the ``<SOS>`` id
  (eos-1) does not appear in data streams;
* each padded 1024-row window contains exactly one ``<EOS>`` row;
* velocity padding invariant: every non-EOS pad row carries
  ``Velocity <PAD>``;
* optional round-trip of random windows back to MIDI for audition.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import vocab as V
from .codec import octuple_to_midi


@dataclasses.dataclass
class Report:
    ok: bool
    issues: List[str]

    def __str__(self) -> str:
        head = "OK" if self.ok else "FAILED"
        return "\n".join([f"check: {head}"] + [f"  - {i}" for i in self.issues])


def _check_windows(arr: np.ndarray, issues: List[str], name: str,
                   packed: bool = False) -> None:
    if arr.ndim != 3 or arr.shape[-1] != 8:
        issues.append(f"{name}: expected (N, S, 8), got {arr.shape}")
        return
    flat = arr.reshape(-1, 8)
    for f in range(8):
        m = flat[:, f]
        if m.max() > V.EOS[f]:
            issues.append(
                f"{name}: field {V.FIELDS[f]} max {m.max()} > EOS {V.EOS[f]}")
        if m.min() < 0:
            issues.append(f"{name}: field {V.FIELDS[f]} has negatives")
    eos_per_row = (arr[:, :, 0] == V.EOS[0]).sum(axis=1)
    if packed:
        # flat streams reshaped by data_split pack several songs per window;
        # only require that EOS rows exist somewhere in the artifact.
        if eos_per_row.sum() == 0:
            issues.append(f"{name}: no <EOS> rows in packed stream")
    else:
        bad = int((eos_per_row != 1).sum())
        if bad:
            issues.append(f"{name}: {bad}/{len(arr)} windows without exactly "
                          f"one <EOS> row")
    # velocity padding invariant (check.py:117-118)
    pad_rows = arr[:, :, 0] == V.PAD[0]
    vel_ok = (arr[:, :, 5] == V.PAD[5]) | ~pad_rows
    nbad = int((~vel_ok).sum())
    if nbad:
        issues.append(f"{name}: {nbad} pad rows with non-pad Velocity")


def check_pretrain(arr: np.ndarray, packed: bool = False) -> Report:
    issues: List[str] = []
    _check_windows(np.asarray(arr), issues, "pretrain", packed=packed)
    return Report(ok=not issues, issues=issues)


def check_finetune(arr: np.ndarray, ans: Optional[np.ndarray],
                   task: str) -> Report:
    issues: List[str] = []
    arr = np.asarray(arr)
    _check_windows(arr, issues, task, packed=task in ("melody", "velocity"))
    if ans is not None:
        ans = np.asarray(ans)
        if task == "generate":
            _check_windows(ans, issues, "generate-ans")
        elif task in ("melody", "velocity"):
            n_classes = 4 if task == "melody" else 7
            if ans.max() >= n_classes:
                issues.append(f"{task}: label max {ans.max()} >= {n_classes}")
            if len(ans) != len(arr):
                issues.append(f"{task}: {len(ans)} labels != {len(arr)} rows")
        else:
            if len(ans) != len(arr):
                issues.append(f"{task}: {len(ans)} labels != {len(arr)} seqs")
    return Report(ok=not issues, issues=issues)


def roundtrip_sample(arr: np.ndarray, out_path: str, index: int = 0) -> str:
    """Decode window ``index`` back to a .mid file for audition (checkMidi).

    ``index`` selects a window of a (N, S, 8) array; a flat (N*8,) or
    (S, 8) array is one window (index must be 0)."""
    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = arr[index]
    elif index != 0:
        raise IndexError(f"index={index} on a flat array with one window")
    arr = arr.reshape(-1, 8)
    rows = []
    for row in arr:
        if row[0] == V.EOS[0]:
            break
        if row[0] <= V.MAX_BAR:
            rows.append(tuple(int(x) for x in row))
    midi = octuple_to_midi(rows)
    midi.dump(out_path)
    return out_path
