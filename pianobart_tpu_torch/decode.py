"""Autoregressive continuation decoding (``pianobart_tpu/decode.py``).

* the encoder runs ONCE; cross-attention K/V are computed at step 0 and
  reused;
* the decoder runs incrementally with a preallocated self-attention KV
  cache, written in place;
* per-field temperature/top-p sampling happens on the device
  (:mod:`pianobart_tpu_torch.ops.sampling`);
* batched, with a done flag per sample and an early stop on special tokens.

The loop is a Python loop in eager mode: the early-stop test reads
``done.all()`` on the host once per step (skipped under ``force_full``,
where nothing can finish early).  A CUDA graph of the step is the measured
work that replaces it.

:func:`load_inference_model` builds the model a server or a demo decodes
with, from a checkpoint or from a seed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import vocab as V
from .device import DeviceLike, resolve_device
from .models.config import PianoBartConfig
from .models.embedding import OctupleEmbedding
from .models.pianobart import PianoBartLM, attention_mask_from_bars
from .ops.sampling import DEFAULT_TEMPERATURE, DEFAULT_TOP_P, sample_octuple

__all__ = ["generate", "load_inference_model", "checkpoint_entries"]


def _generate_impl(model: PianoBartLM, encoder_ids, encoder_mask, generator,
                   temperature, top_p, max_steps: int, force_full: bool):
    cfg = model.cfg
    B, S, _ = encoder_ids.shape
    dev = encoder_ids.device
    pad_row = torch.tensor(V.PAD, dtype=torch.int32, device=dev)
    sos_row = torch.tensor(V.SOS, dtype=torch.int32, device=dev)

    enc_out = model.encode(encoder_ids, encoder_mask)
    cache = model.build_cache(enc_out, B, S)
    out = pad_row.expand(B, S, 8).clone()
    tok = sos_row.expand(B, 1, 8).clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    def advance(i, logits, tok, done):
        """Sample the next octuple, write row i, update the done flags."""
        nxt = sample_octuple(generator, logits[:, 0, :], cfg, temperature, top_p)
        # early stop on any special token: the row is not written
        is_special = (nxt >= pad_row).any(dim=-1)
        if force_full:
            # fixed-length mode: clamp sampled specials back into vocab
            nxt = torch.minimum(nxt, pad_row - 1)
            is_special = torch.zeros_like(is_special)
        newly_done = done | is_special
        out[:, i] = torch.where(newly_done[:, None], pad_row, nxt)
        # next decoder input (frozen once done)
        tok = torch.where(done[:, None, None], tok, nxt[:, None, :])
        return tok, newly_done

    # step 0 runs outside the loop: it fills the cross-attention cache
    logits, cache = model.decode_step(tok, enc_out, encoder_mask, cache, 0)
    tok, done = advance(0, logits, tok, done)
    for i in range(1, max_steps):
        if not force_full and bool(done.all()):
            break
        logits, cache = model.decode_step(tok, enc_out, encoder_mask, cache, i)
        tok, done = advance(i, logits, tok, done)
    return out


def generate(
    model: PianoBartLM,
    encoder_ids,
    encoder_mask=None,
    generator: Optional[torch.Generator] = None,
    temperature: Sequence[float] = DEFAULT_TEMPERATURE,
    top_p: Sequence[float] = DEFAULT_TOP_P,
    max_steps: Optional[int] = None,
    force_full: bool = False,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Generate a continuation token grid (B, S, 8) int32 from an intro.

    ``device`` defaults to CUDA and must be where ``model`` lives.
    ``generator`` (on that device) drives the sampling; the default is one
    seeded with 0.  ``force_full`` disables the special-token early stop
    (sampled specials are clamped to the largest content id): fixed-length
    continuation and worst-case latency benchmarking.
    """
    device = resolve_device(device)
    p_dev = next(model.parameters()).device
    if p_dev.type != device.type or (device.index is not None
                                     and p_dev.index != device.index):
        raise ValueError(f"model lives on {p_dev}, generate was asked for {device}")
    encoder_ids = torch.as_tensor(encoder_ids).to(device=p_dev, dtype=torch.int64)
    if encoder_ids.ndim == 2:
        encoder_ids = encoder_ids[None]
    if encoder_mask is None:
        encoder_mask = attention_mask_from_bars(encoder_ids)
    else:
        encoder_mask = torch.as_tensor(encoder_mask).to(device=p_dev,
                                                        dtype=torch.float32)
    if generator is None:
        generator = torch.Generator(device=p_dev).manual_seed(0)
    S = encoder_ids.shape[1]
    steps = max_steps or S
    if steps > S:
        # the output buffer is one window (B, S, 8)
        raise ValueError(
            f"max_steps={steps} exceeds the {S}-token window; generate "
            f"per-window and re-feed the continuation")
    with torch.inference_mode():
        return _generate_impl(model, encoder_ids, encoder_mask, generator,
                              tuple(temperature), tuple(top_p), steps,
                              force_full)


def checkpoint_entries(ckpt: str, cfg: PianoBartConfig, kind: Optional[str] = None,
                       model: Optional[torch.nn.Module] = None):
    """The port-named tensors of a checkpoint, on the host: a checkpoint
    directory of the port (a manager root or a payload directory; only the
    weights are read, memory-mapped), a merged ``.msgpack`` (the subtrees
    ``model`` has, when given;
    :func:`~.train.state.load_merged_msgpack`) or a reference
    ``.ckpt``/``.pth`` file (of ``kind``, detected when ``None``;
    :func:`~.compat.torch_import.import_checkpoint`)."""
    import os
    if str(ckpt).endswith(".msgpack"):
        from .train.state import load_merged_msgpack
        return load_merged_msgpack(ckpt, cfg, model)
    if os.path.isdir(ckpt):
        from .train.state import CheckpointManager
        return CheckpointManager(ckpt).params()
    from .compat.torch_import import import_checkpoint
    return import_checkpoint(ckpt, cfg, kind)


def load_inference_model(cfg: PianoBartConfig, ckpt: Optional[str] = None,
                         seed: int = 0, device: DeviceLike = None,
                         kind: Optional[str] = None) -> PianoBartLM:
    """A ``PianoBartLM`` in eval mode on ``device`` (CUDA by default) for
    serving, the demo and evaluation; the counterpart of the JAX package's
    ``load_inference_params``.

    With ``ckpt`` (see :func:`checkpoint_entries`) the model is built on
    the ``meta`` device and its storage allocated on ``device`` without a
    draw; the checkpoint's tensors are copied in (cast to
    ``cfg.param_dtype``), and only the parameters it lacks (the LM head of a
    trunk-only checkpoint) are drawn, in module order from a generator
    seeded with ``seed`` (:func:`~.compat.from_jax.draw_params_`).  Without
    ``ckpt``: ``init_lm(cfg, seed)``."""
    from .compat.from_jax import draw_params_, init_lm
    from .train.state import graft_
    device = resolve_device(device)
    if not ckpt:
        return init_lm(cfg, seed, device)
    model = PianoBartLM(cfg, device="meta").to_empty(device=device)
    saved = checkpoint_entries(ckpt, cfg, kind, model)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, OctupleEmbedding):
                mod.offsets.copy_(torch.tensor(cfg.field_offsets))
    missing = graft_(model, saved, ckpt)
    loaded = set(model.state_dict()) - set(missing)
    return draw_params_(model, seed, skip=loaded).eval()
