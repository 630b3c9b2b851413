"""MIDI continuation demo (``pianobart_tpu/serve/demo.py``).

Equivalent of reference ``demo.py``: tokenize an input MIDI keeping the
*last* 1024 tokens, run KV-cached generation, clean the output (first
illegal/special token becomes ``<EOS>``; drum pitches dropped,
demo.py:72-102), and write the continuation MIDI.

The weights come from a checkpoint (a checkpoint directory of the port or
a reference ``.ckpt``/``.pth``), or are drawn from a seed without one.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import decode
from .. import vocab as V
from ..device import DeviceLike, resolve_device
from ..midi.parser import read_midi
from ..models.config import PianoBartConfig
from ..tokenizer.codec import midi_to_octuple, octuple_to_midi
from ..tokenizer.segment import pad_segment

__all__ = ["midi_to_window", "clean_generated", "window_to_midi", "run_demo"]


def midi_to_window(midi_path: str, window: int = V.MAX_WINDOW) -> np.ndarray:
    """MIDI file -> (1, window, 8) intro grid, keeping the LAST tokens
    (demo.py:61-68 / convert.py:326-327)."""
    midi = read_midi(midi_path)
    enc = midi_to_octuple(midi, task="pretrain")
    if not enc:
        raise ValueError(f"no notes in {midi_path}")
    rows = pad_segment(list(enc), window=window, last=True)
    return np.asarray([rows], dtype=np.int32)


def clean_generated(octuple: np.ndarray) -> np.ndarray:
    """Truncate at the first illegal token (demo.py:78-89): any field >= its
    PAD id, or a drum-range pitch (>127) — the demo does not emit drums."""
    grid = np.array(octuple).reshape(-1, 8)
    pad = np.asarray(V.PAD)
    eos = pad + 3
    S = grid.shape[0]
    end = S
    for i in range(S):
        row = grid[i]
        if (row >= pad).any() or row[3] > 127:
            end = i
            break
    if end < S:
        grid[end] = eos
        grid[end + 1:] = pad
    else:
        grid[-1] = eos
    return grid


def window_to_midi(octuple: np.ndarray, out_path: str) -> bool:
    """Cleaned grid -> .mid; returns False when generation was empty
    (demo.py:91-102)."""
    grid = clean_generated(octuple)
    content = []
    for row in grid:
        if row[0] == V.EOS[0]:
            break
        content.append(tuple(int(x) for x in row))
    if not content:
        return False
    midi = octuple_to_midi(content)
    midi.dump(out_path)
    return True


def run_demo(input_path: str, output_path: str = "./output.mid",
             ckpt: Optional[str] = None, max_seq_len: int = 1024,
             hs: int = 1024, layers: int = 8, ffn_dims: int = 2048,
             heads: int = 8, nopretrain: bool = False,
             rng_seed: int = 0, force_full: bool = False,
             device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Continue ``input_path`` into ``output_path`` with bf16 weights from
    ``ckpt`` (unless ``nopretrain``) or drawn from ``rng_seed``, on CUDA
    unless ``device`` says otherwise.  Returns the intro and the last
    continuation grid."""
    ckpt = ckpt if ckpt and not nopretrain else None
    device = resolve_device(device)
    # bf16 weights and compute, as the serving path holds them
    cfg = PianoBartConfig(d_model=hs, encoder_layers=layers,
                          decoder_layers=layers, ffn_dim=ffn_dims,
                          num_heads=heads, max_len=max_seq_len,
                          dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    intro = midi_to_window(input_path, window=max_seq_len)
    model = decode.load_inference_model(cfg, ckpt, rng_seed, device)

    # The reference demo is one-shot: a sampled first token outside the
    # legal range truncates the whole continuation to nothing and it just
    # prints "Generate Fail!" (demo.py:102).  Retry a few seeds before
    # giving up; each retry is one more decode on the loaded model.
    retries = int(os.environ.get("PBX_DEMO_RETRIES", "4"))
    out = None
    for attempt in range(max(1, retries)):
        gen = torch.Generator(device=device).manual_seed(rng_seed + 1 + attempt)
        out = decode.generate(model, intro, generator=gen,
                              force_full=force_full, device=device)
        out = out[0].cpu().numpy()
        ok = window_to_midi(out, output_path)
        if ok:
            break
        print(f"empty continuation (seed {rng_seed + 1 + attempt}); retrying")
    print(f"Saved to {output_path}" if ok else "Generate Fail! (empty)")
    return intro, out
