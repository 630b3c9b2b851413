"""BART encoder-decoder trunk (``pianobart_tpu/models/bart.py``).

HF-Bart numerics: learned positional embeddings with offset 2,
``layernorm_embedding`` after input+pos, post-LN residual blocks, exact-erf
GELU FFN, q scaled by ``head_dim**-0.5``, additive padding/causal masks.
Activations run in ``cfg.dtype``; parameters live in ``cfg.param_dtype`` and
are cast to ``cfg.dtype`` where they are used; LayerNorm statistics are f32.
The decoder takes an explicit KV cache for incremental decoding.

Dropout follows the reference's composition (``ResidualDropoutLN``, after
the FFN's GELU, after ``layernorm_embedding``).  It applies when the module
is in training mode (``self.training``); its bits come from the
``generator`` passed down the forward.  With ``cfg.fused_dropout_ln`` the
sublayer tails run as the fused K4 kernels (``ops/fused_ln.py``), as the
reference's ``PBX_FUSED_DROPLN=1`` does; off by default, as there.

With ``cfg.ring_axis`` the model runs on this rank's sequence shard:
attention is ring attention over that axis of the active mesh
(``parallel/mesh.py:use_mesh``), positions start at the shard's global
offset, and with ``cfg.ring_tp_axis`` each tp rank projects and attends its
heads with its shards of the q/k/v/out weights (TP∘SP; the parameters placed
by ``parallel/mesh.py:shard_params``).  A tp-sharded FFN or LM-head weight
is gathered over tp where a ``Dense`` uses it (``gather_param``).  ``cfg.remat`` recomputes every
layer in the backward, ``cfg.remat_ffn`` only the FFN
(``torch.utils.checkpoint``); the recompute replays the generator's draws.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .config import PianoBartConfig
from ..ops.attention import dot_product_attention
from ..ops.dropout import dropout
from ..ops.fused_ln import MAX_D, dropout_add_ln, fused_eligible
from ..ops.ring import psum_out, replicated_in, ring_attention, tp_slice
from ..parallel.mesh import axis, gather_param

KVCache = Dict[str, Any]
Generator = Optional[torch.Generator]

LN_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm`` semantics: f32 statistics with the fast
    variance ``E[x^2] - mean^2`` clamped at 0 (a negative round-off variance
    would give NaN), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast
    to ``dtype``.  The parameters join the f32 arithmetic by type promotion,
    so bf16 parameters cost no separate cast."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * weight
    return ((xf - mean) * mul + bias).to(dtype)


def remat(fn, generator: Generator, *args):
    """``fn(*args, generator)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant).  The recompute
    replays the generator's draws: its state is set back to what it was
    before the first run, then restored, so the recomputed dropout bits (and
    fused-tail seeds) are the ones the forward used."""
    if generator is None:
        return checkpoint(fn, *args, None, use_reentrant=False,
                          preserve_rng_state=False)
    start = generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class Dense(nn.Linear):
    """``nn.Linear`` with weights in ``param_dtype``, computing in ``dtype``
    (flax ``Dense(dtype, param_dtype)``): input, weight and bias are cast to
    ``dtype`` at use; a cast to the dtype a tensor already has is free.  A
    weight that ``shard_params`` cut to its tp slice is all-gathered over
    the active mesh's tp axis after the cast (:func:`gather_param`)."""

    def __init__(self, d_in: int, d_out: int, cfg: PianoBartConfig, device=None):
        super().__init__(d_in, d_out, dtype=cfg.param_dtype, device=device)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), gather_param(self.weight, dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm with ``param_dtype`` parameters and f32 statistics."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.ones(cfg.d_model, dtype=cfg.param_dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(cfg.d_model, dtype=cfg.param_dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.dtype)


class ResidualDropoutLN(LayerNorm):
    """``LayerNorm(residual + dropout(h))``, the tail of every sublayer.

    With ``cfg.fused_dropout_ln``, in training, at a nonzero rate and on a
    shape :func:`fused_eligible` takes (the reference's gate without its TPU
    test), the tail is one :func:`dropout_add_ln` call: the residual add in
    f32 and the bits from a seed drawn on the device from ``generator`` per
    call site (the role of the reference's per-site ``make_rng``), with no
    host sync.  Otherwise the unfused composition, adding in ``cfg.dtype``.

    On CUDA the K4 kernels take rows of at most ``MAX_D``, so a fused model
    wider than that (and a multiple of 128, where the reference's gate would
    take its kernel) is refused when it is built on the card.
    """

    def __init__(self, cfg: PianoBartConfig, device=None):
        if (cfg.fused_dropout_ln and cfg.d_model % 128 == 0
                and cfg.d_model > MAX_D and device is not None
                and torch.device(device).type == "cuda"):
            raise ValueError(
                f"fused_dropout_ln at d_model {cfg.d_model} is not supported on "
                f"CUDA: the K4 kernels take rows of at most MAX_D = {MAX_D}")
        super().__init__(cfg, device)
        self.rate = cfg.dropout
        self.fused = cfg.fused_dropout_ln

    def forward(self, residual: torch.Tensor, h: torch.Tensor,
                generator: Generator = None) -> torch.Tensor:
        if (self.fused and self.training and self.rate > 0.0
                and fused_eligible(h.shape)):
            if generator is None:
                raise ValueError("dropout needs an explicit torch.Generator")
            seed = torch.randint(0, 2 ** 63 - 1, (1,), dtype=torch.int64,
                                 device=h.device, generator=generator)
            return dropout_add_ln(h, residual, self.weight, self.bias, seed,
                                  self.rate, LN_EPS)
        h = dropout(h, self.rate, generator, not self.training)
        return layer_norm(residual + h, self.weight, self.bias, self.dtype)


class MultiHeadAttention(nn.Module):
    """HF-Bart-compatible MHA with an optional explicit KV cache."""

    def __init__(self, cfg: PianoBartConfig, causal: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        D = cfg.d_model
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(D, D, cfg, device))

    def forward(
        self,
        x_q: torch.Tensor,                        # (B, Sq, D)
        x_kv: torch.Tensor,                       # (B, Skv, D)
        kv_mask: Optional[torch.Tensor] = None,   # (B, Skv) 1=attend
        cache: Optional[KVCache] = None,
        cache_index: Optional[int] = None,
        generator: Generator = None,
    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        cfg = self.cfg
        B, Sq, D = x_q.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        ring = cfg.ring_axis is not None and cache is None and cache_index is None
        if ring and cfg.ring_tp_axis is not None:
            return self._tp_ring(x_q, x_kv, kv_mask), None

        def heads(x):
            return x.view(x.shape[0], x.shape[1], H, Dh)

        q = heads(self.q_proj(x_q)) * (Dh ** -0.5)
        use_cached_kv = cache is not None and "k" in cache and cache_index is None
        if use_cached_kv:
            # cross-attention during decode: keys/values precomputed
            k, v = cache["k"], cache["v"]
        else:
            k = heads(self.k_proj(x_kv))
            v = heads(self.v_proj(x_kv))

        new_cache: Optional[KVCache] = None
        if cache is not None and not use_cached_kv and cache_index is None:
            # cache build pass (cross-attention prefill): encoder K/V are
            # computed once and reused every decode step
            new_cache = {"k": k, "v": v}
        if cache_index is not None:
            # incremental decode: write this step's K/V at cache_index.  The
            # write goes IN PLACE into the preallocated cache (the reference
            # returns an updated copy); callers hand the same dict back.
            cache["k"][:, cache_index:cache_index + Sq] = k
            cache["v"][:, cache_index:cache_index + Sq] = v
            k, v = cache["k"], cache["v"]
            new_cache = cache
            pos = torch.arange(k.shape[1], device=k.device)
            step_mask = (pos <= cache_index)[None, :]  # causal via cache index
            kv_mask = step_mask if kv_mask is None else kv_mask * step_mask
        elif use_cached_kv:
            new_cache = cache

        if ring:
            # q, k, v hold this rank's sequence shard; keys and values
            # rotate around the ring (no attention dropout, as the reference)
            out = ring_attention(q, k, v, kv_mask, self.causal, axis(cfg.ring_axis))
        else:
            out = dot_product_attention(
                q, k, v, kv_mask=kv_mask,
                causal=self.causal and cache_index is None,
                dropout_rate=cfg.attention_dropout, deterministic=not self.training,
                generator=generator, use_flash=cfg.use_flash_attention)
        return self.out_proj(out.reshape(B, Sq, D)), new_cache

    def _tp_ring(self, x_q, x_kv, kv_mask):
        """TP∘SP: this tp rank projects and ring-attends its H/ntp heads with
        its shards of the q/k/v weights (their rows) and of out_proj's (its
        columns), as ``shard_params`` placed them: no collective touches
        them.  The replicated biases are sliced by ``tp_slice``; the partial
        outputs are summed over tp (``psum_out``), out_proj's bias added
        once."""
        cfg = self.cfg
        tp = axis(cfg.ring_tp_axis)
        ntp = cfg.ring_tp_size
        if cfg.num_heads % ntp or tp.size != ntp:
            raise ValueError(f"{cfg.num_heads} heads over a tp axis of {tp.size} "
                             f"ranks (cfg.ring_tp_size {ntp})")
        B, Sq, D = x_q.shape
        Dh = cfg.head_dim
        Hl = cfg.num_heads // ntp
        DHl = Hl * Dh
        start = tp.index * DHl
        dt = cfg.dtype
        for lin, dim in ((self.q_proj, 0), (self.k_proj, 0), (self.v_proj, 0),
                         (self.out_proj, 1)):
            if getattr(lin.weight, "tp_dim", None) != dim or lin.weight.shape[dim] != DHl:
                raise ValueError(
                    f"TP∘SP takes this rank's tp shards of the attention weights "
                    f"(parallel.mesh.shard_params before the optimizer); got a "
                    f"weight of shape {tuple(lin.weight.shape)}")
        xq_r = replicated_in(x_q, tp)
        xkv_r = xq_r if x_kv is x_q else replicated_in(x_kv, tp)

        def proj(x, lin):
            y = F.linear(x.to(dt), lin.weight.to(dt),
                         tp_slice(lin.bias, start, DHl, 0, tp).to(dt))
            return y.view(y.shape[0], y.shape[1], Hl, Dh)

        q = proj(xq_r, self.q_proj) * (Dh ** -0.5)
        k = proj(xkv_r, self.k_proj)
        v = proj(xkv_r, self.v_proj)
        out = ring_attention(q, k, v, kv_mask, self.causal, axis(cfg.ring_axis))
        partial = F.linear(out.reshape(B, Sq, DHl), self.out_proj.weight.to(dt))
        return psum_out(partial, tp) + self.out_proj.bias.to(dt)


class FeedForward(nn.Module):
    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.rate = cfg.activation_dropout
        self.fc1 = Dense(cfg.d_model, cfg.ffn_dim, cfg, device)
        self.fc2 = Dense(cfg.ffn_dim, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        h = F.gelu(self.fc1(x), approximate="none")
        return self.fc2(dropout(h, self.rate, generator, not self.training))


class _Layer(nn.Module):
    def __init__(self, cfg: PianoBartConfig):
        super().__init__()
        # the FFN alone recomputed, unless the whole layer is (reference
        # _ffn_cls)
        self.remat_ffn = cfg.remat_ffn and not cfg.remat

    def _ffn(self, x, generator: Generator):
        if self.remat_ffn and torch.is_grad_enabled():
            return remat(self.ffn, generator, x)
        return self.ffn(x, generator)


class EncoderLayer(_Layer):
    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__(cfg)
        self.self_attn = MultiHeadAttention(cfg, device=device)
        self.self_attn_layer_norm = ResidualDropoutLN(cfg, device)
        self.ffn = FeedForward(cfg, device)
        self.final_layer_norm = ResidualDropoutLN(cfg, device)

    def forward(self, x, pad_mask, generator: Generator = None):
        h, _ = self.self_attn(x, x, kv_mask=pad_mask, generator=generator)
        x = self.self_attn_layer_norm(x, h, generator)
        return self.final_layer_norm(x, self._ffn(x, generator), generator)


class DecoderLayer(_Layer):
    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__(cfg)
        self.self_attn = MultiHeadAttention(cfg, causal=True, device=device)
        self.self_attn_layer_norm = ResidualDropoutLN(cfg, device)
        self.cross_attn = MultiHeadAttention(cfg, device=device)
        self.cross_attn_layer_norm = ResidualDropoutLN(cfg, device)
        self.ffn = FeedForward(cfg, device)
        self.final_layer_norm = ResidualDropoutLN(cfg, device)

    def forward(self, x, enc_out, self_mask, enc_mask, cache=None,
                cache_index=None, generator: Generator = None):
        h, new_self = self.self_attn(
            x, x, kv_mask=self_mask,
            cache=None if cache is None else cache.get("self"),
            cache_index=cache_index, generator=generator)
        x = self.self_attn_layer_norm(x, h, generator)
        h, new_cross = self.cross_attn(
            x, enc_out, kv_mask=enc_mask,
            cache=None if cache is None else cache.get("cross"),
            generator=generator)
        x = self.cross_attn_layer_norm(x, h, generator)
        x = self.final_layer_norm(x, self._ffn(x, generator), generator)
        new_cache = None
        if new_self is not None or new_cross is not None:
            new_cache = {"self": new_self, "cross": new_cross}
        return x, new_cache


class PositionalEmbedding(nn.Module):
    """HF BartLearnedPositionalEmbedding: table row = position + offset."""

    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.offset = cfg.pos_offset
        self.dtype = cfg.dtype
        self.ring_axis = cfg.ring_axis
        self.embedding = nn.Parameter(torch.empty(
            cfg.max_len + cfg.pos_offset, cfg.d_model, dtype=cfg.param_dtype,
            device=device))

    def forward(self, seq_len: int, start: int = 0) -> torch.Tensor:
        if self.ring_axis is not None:
            # sequence parallel: this shard covers global positions
            # [index * seq_len, ...)
            start = start + axis(self.ring_axis).index * seq_len
        rows = self.embedding[self.offset + start:self.offset + start + seq_len]
        return rows.to(self.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.rate = cfg.dropout
        self.remat = cfg.remat
        self.embed_positions = PositionalEmbedding(cfg, device)
        self.layernorm_embedding = LayerNorm(cfg, device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device)
                                    for _ in range(cfg.encoder_layers))

    def forward(self, inputs_embeds, pad_mask=None, generator: Generator = None):
        x = inputs_embeds + self.embed_positions(inputs_embeds.shape[1])
        x = self.layernorm_embedding(x)
        x = dropout(x, self.rate, generator, not self.training)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = remat(layer, generator, x, pad_mask)
            else:
                x = layer(x, pad_mask, generator)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: PianoBartConfig, device=None):
        super().__init__()
        self.rate = cfg.dropout
        self.remat = cfg.remat
        self.embed_positions = PositionalEmbedding(cfg, device)
        self.layernorm_embedding = LayerNorm(cfg, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.decoder_layers))

    def forward(self, inputs_embeds, enc_out, self_mask=None, enc_mask=None,
                cache=None, cache_index=None, generator: Generator = None):
        start = 0 if cache_index is None else cache_index
        x = inputs_embeds + self.embed_positions(inputs_embeds.shape[1], start)
        x = self.layernorm_embedding(x)
        x = dropout(x, self.rate, generator, not self.training)
        new_cache = {}
        for i, layer in enumerate(self.layers):
            if self.remat and cache is None and torch.is_grad_enabled():
                x, lc = remat(layer, generator, x, enc_out, self_mask, enc_mask,
                              None, None)
            else:
                x, lc = layer(x, enc_out, self_mask, enc_mask,
                              None if cache is None else cache.get(f"layers_{i}"),
                              cache_index, generator)
            if lc is not None:
                new_cache[f"layers_{i}"] = lc
        return x, (new_cache or None)
