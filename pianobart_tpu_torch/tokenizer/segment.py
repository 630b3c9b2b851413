"""Sequence segmentation, padding and task packaging
(``pianobart_tpu/tokenizer/segment.py``).

The reference's offline windowing (``convert.py:321-333`` ``padding``,
``convert.py:421-508`` segmentation + task packaging inside ``F``,
``convert.py:560-565`` ``data_split``) on top of the port's codec.
``pad_segment`` also serves the demo's intro windowing.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import vocab as V
from ..midi.events import MidiFile
from .codec import MELODY_MAP, VELOCITY_MAP, midi_to_octuple

__all__ = [
    "pad_segment", "segment_song", "encoding_hash", "data_split",
    "process_file", "process_bytes", "ProcessResult",
]

_EOS = tuple(V.EOS)
_PAD = tuple(V.PAD)


def pad_segment(segment: List[Tuple[int, ...]], window: int = V.MAX_WINDOW,
                last: bool = False) -> List[Tuple[int, ...]]:
    """Pad with ``<PAD>`` rows to ``window`` or truncate + ``<EOS>``.

    Mirrors ``padding`` (convert.py:321-333): an over-long segment keeps the
    first ``window-1`` rows (or the *last* ``window-1`` when ``last=True``,
    used by the demo's intro windowing, demo.py:64) and appends ``<EOS>``.
    """
    pad_num = window - len(segment)
    if pad_num < 0:
        segment = segment[1 - window:] if last else segment[:window - 1]
        return list(segment) + [_EOS]
    return list(segment) + [_PAD] * pad_num


def segment_song(encoding: Sequence[Tuple[int, ...]]) -> List[List[Tuple[int, ...]]]:
    """Split a sorted Octuple stream at bar-255 boundaries, renumbering bars.

    Mirrors convert.py:421-445: segment ``k`` (1-based) holds bars in
    ``(255*(k-1), 255*k]``; segments beyond the first subtract
    ``255*(k-1)+1`` from the bar field; every segment gets a trailing
    ``<EOS>`` octuple.  Task labels (9th element) are preserved on note rows.
    """
    segments: List[List[Tuple[int, ...]]] = []
    flag = 1
    former = 0
    encoding = list(encoding)

    def renumber(rows: List[Tuple[int, ...]], k: int) -> List[Tuple[int, ...]]:
        if k <= 1:
            return rows
        off = V.MAX_BAR * (k - 1) + 1
        return [(r[0] - off,) + tuple(r[1:]) for r in rows]

    for i, row in enumerate(encoding):
        if row[0] > V.MAX_BAR * flag:
            seg = renumber(encoding[former:i], flag)
            seg.append(_EOS)
            segments.append(seg)
            former = i
            flag += 1
    seg = renumber(encoding[former:], flag)
    seg.append(_EOS)
    segments.append(seg)
    return segments


def encoding_hash(encoding: Sequence[Tuple[int, ...]]) -> str:
    """Dedup hash over the (program, pitch) stream (convert.py:131-135)."""
    midi_tuple = tuple((e[2], e[3]) for e in encoding)
    return hashlib.md5(str(midi_tuple).encode("ascii")).hexdigest()


def data_split(data: np.ndarray, content=None,
               tokens_per_line: int = V.TOKENS_PER_NOTE,
               window: int = V.MAX_WINDOW) -> np.ndarray:
    """Reshape a flat token stream to ``(m, window, tokens_per_line)`` rows.

    Matches ``data_split`` (convert.py:560-565) including its always-add-one
    row count ``m = N // window + 1``.  ``window`` > 1024 (k*1024) produces
    long-context rows.
    """
    if content is None:
        content = [b + 1 for b in V.TOKEN_BOUNDARY]
    m = data.shape[0] // window + 1
    pad_num = m * window - data.shape[0]
    padded = np.append(data, [content] * pad_num, axis=0)
    return padded.reshape(m, window, tokens_per_line)


class ProcessResult:
    """Outcome of tokenizing one file for a given task."""

    def __init__(self, status: str, detail: str = ""):
        self.status = status  # ok | blank | duplicate | error
        self.detail = detail
        self.sequences: List[List[Tuple[int, ...]]] = []
        self.labels: List = []

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _split_for_generation(segment: List[Tuple[int, ...]]):
    """(intro, continuation) split at the last-bar boundary of the first half
    (convert.py:450-469)."""
    if len(segment) >= 2 * V.MAX_WINDOW:
        half = V.MAX_WINDOW - 1
    else:
        half = len(segment) // 2 - 1
    head = segment[:half]
    if not head:
        return None
    split = len(head)
    for i, row in enumerate(head):
        if row[0] >= head[-1][0]:
            split = i
            break
    intro = list(segment[:split])
    continuation = list(segment[split:])
    if not intro:
        return None
    intro.append(_EOS)
    intro = pad_segment(intro)
    continuation = pad_segment(continuation)
    if sum(1 for r in intro if r[0] == V.EOS[0]) != 1:
        return None
    return intro, continuation


def process_file(
    midi: MidiFile,
    task: str = "pretrain",
    pad: bool = True,
    composer: Optional[str] = None,
    emotion: Optional[int] = None,
    dedup_seen: Optional[dict] = None,
    file_name: str = "<memory>",
    window: int = V.MAX_WINDOW,
) -> ProcessResult:
    """Tokenize one parsed MIDI file and package it for ``task``.

    Equivalent of reference ``F`` (convert.py:335-515) minus the file IO:
    callers parse the MIDI and supply path-derived labels (composer /
    emotion) explicitly instead of regex-ing paths inside the tokenizer.
    """
    if sum(len(i.notes) for i in midi.instruments) == 0:
        return ProcessResult("blank", file_name)
    try:
        encoding = midi_to_octuple(midi, task)
        return _package(encoding, task, pad, composer, emotion, dedup_seen,
                        file_name, window)
    except AssertionError as exc:
        return ProcessResult("error", f"{file_name} {exc}")
    except Exception as exc:  # per-file tolerance, convert.py:511-513
        return ProcessResult("error", f"{file_name} {exc}")


def process_bytes(
    data: bytes,
    task: str = "pretrain",
    pad: bool = True,
    composer: Optional[str] = None,
    emotion: Optional[int] = None,
    dedup_seen: Optional[dict] = None,
    file_name: str = "<memory>",
    window: int = V.MAX_WINDOW,
) -> ProcessResult:
    """Tokenize raw MIDI bytes, preferring the native C++ parse+quantize
    path (:mod:`pianobart_tpu_torch.midi.native`), with the Python path when
    the native library is unavailable."""
    try:
        from ..midi.native import midi_bytes_to_octuple
        encoding = midi_bytes_to_octuple(data, task)
        if encoding is not None:
            if not encoding:
                return ProcessResult("blank", file_name)
            return _package(encoding, task, pad, composer, emotion,
                            dedup_seen, file_name, window)
    except AssertionError as exc:
        return ProcessResult("error", f"{file_name} {exc}")
    except Exception as exc:
        return ProcessResult("error", f"{file_name} {exc}")
    from ..midi.parser import read_midi_bytes
    try:
        midi = read_midi_bytes(data)
    except Exception as exc:
        return ProcessResult("error", f"{file_name} {exc}")
    return process_file(midi, task, pad, composer, emotion, dedup_seen,
                        file_name, window)


def _package(
    encoding,
    task: str,
    pad: bool,
    composer: Optional[str],
    emotion: Optional[int],
    dedup_seen: Optional[dict],
    file_name: str,
    window: int = V.MAX_WINDOW,
) -> ProcessResult:
    try:
        if not encoding:
            return ProcessResult("blank", file_name)
        if dedup_seen is not None:
            h = encoding_hash(encoding)
            if h in dedup_seen:
                return ProcessResult("duplicate", f"{file_name} == {dedup_seen[h]}")
            dedup_seen[h] = file_name

        result = ProcessResult("ok")
        for seg in segment_song(encoding):
            if task == "generate":
                pair = _split_for_generation(seg)
                if pair is None:
                    continue
                result.sequences.append(pair[0])
                result.labels.append(pair[1])
            elif task == "pretrain":
                result.sequences.append(
                    pad_segment(seg, window) if pad else seg)
            elif task == "composer":
                result.sequences.append(pad_segment(seg, window))
                result.labels.append(composer)
            elif task == "emotion":
                result.sequences.append(pad_segment(seg, window))
                result.labels.append(emotion)
            elif task in ("melody", "velocity"):
                other = (MELODY_MAP if task == "melody" else VELOCITY_MAP)["OTHER"]
                labels = [r[8] if len(r) == 9 else other for r in seg]
                rows = [r[:V.TOKENS_PER_NOTE] for r in seg]
                assert len(labels) == len(rows)
                result.sequences.append(rows)
                result.labels.append(labels)
            else:
                raise ValueError(f"unknown task: {task}")
        return result
    except AssertionError as exc:
        return ProcessResult("error", f"{file_name} {exc}")
    except Exception as exc:  # per-file tolerance, convert.py:511-513
        return ProcessResult("error", f"{file_name} {exc}")
