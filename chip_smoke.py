#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pianobart_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero with no
result line:

1. device report (name, count, ``nvidia-smi`` name and power limit);
2. build the flash-forward kernel (K1) with ``nvcc`` from the repo's source;
3. K1 against its plain PyTorch version at the serving shapes, with times of
   the kernel, the plain version, the bound and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
4. the serving slice at full flagship width (bf16, random weights from a
   seed): ``GenerationService`` warmup over buckets {1, 2, 4, 8}, concurrent
   requests from threads, output checks, timed batch-1 and batch-8
   fixed-length continuations, and K1's launch count per decode batch.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PEAK_F32 = 67e12       # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
SEED = 0


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(state):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    state["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()}
    state["smi"] = smi.splitlines()[0]
    print(f"[device] {state['device']['kind']} x{state['device']['count']}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")


def phase_build(state):
    from pianobart_tpu_torch.ops import flash
    t0 = time.perf_counter()
    lib = flash.build_kernel()
    print(f"[build] flash_fwd built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({os.path.relpath(lib.path)})")
    with open(lib.path + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or line.startswith("nvcc"):
                print(f"[build]   {line.rstrip()}")


def _flash_case(B, causal, dtype, S=1024, H=8, D=128):
    """Inputs as the encoder makes them: q pre-scaled, a pad tail in the
    last sample."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(SEED + B)
    q = torch.randn(B, S, H, D, device="cuda", generator=g) * D ** -0.5
    k = torch.randn(B, S, H, D, device="cuda", generator=g)
    v = torch.randn(B, S, H, D, device="cuda", generator=g)
    mask = torch.ones(B, S, device="cuda")
    mask[-1, S - 200:] = 0.0     # float, like attention_mask_from_bars
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


def _flash_bound_ms(q, mask, causal):
    """Least time for the work these inputs need: 4*D*H FLOPs per kept
    (row, key) pair, and q/k/v/o/mask/lse bytes moved once."""
    import torch
    B, S, H, D = q.shape
    if causal:   # key c is kept by the rows r >= c
        pairs = (mask * (S - torch.arange(S, device=mask.device))).sum()
    else:
        pairs = mask.sum() * S
    flops = 4.0 * D * H * float(pairs)
    nbytes = 4 * q.numel() * q.element_size() + mask.numel() * 4 + B * H * S * 4
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_F32
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES), (
        "operations" if flops / peak >= nbytes / PEAK_BYTES else "bytes")


def phase_flash(state):
    import torch
    import torch.nn.functional as F
    from pianobart_tpu_torch.ops.flash import (flash_attention_fwd,
                                               flash_attention_reference)
    # Per element |dO| <= atol + rtol*|O_ref|, and |dlse| <= lse_tol.
    # bf16: the kernel rounds P to bf16 before P.V and O to bf16 at the end
    # (2^-9 relative each; rows that see few keys carry |O| up to ~4); the
    # reference keeps P in f32.  f32: only the summation order and expf
    # differ.
    tol = {torch.bfloat16: (1e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}
    cases = [(1, False, torch.bfloat16), (8, False, torch.bfloat16),
             (1, True, torch.bfloat16), (8, True, torch.bfloat16),
             (2, False, torch.float32)]
    for B, causal, dtype in cases:
        q, k, v, mask = _flash_case(B, causal, dtype)
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q, k, v, mask, causal)
        d_o = (out.float() - ref_out.float()).abs()
        err_o = d_o.max().item()
        err_l = (lse - ref_lse).abs().max().item()
        atol, rtol, tol_l = tol[dtype]
        ok_o = bool((d_o <= atol + rtol * ref_out.float().abs()).all())
        ms = _time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal))
        plain_ms = _time_ms(lambda: flash_attention_reference(q, k, v, mask, causal),
                            iters=5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        keep = (mask != 0)[:, None, None, :]
        if causal:
            keep = keep & torch.ones(1024, 1024, dtype=torch.bool,
                                     device="cuda").tril()
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep, scale=1.0))
        bound_ms, bound_by = _flash_bound_ms(q, mask, causal)
        name = f"B={B} S=1024 H=8 D=128 {str(dtype)[6:]} causal={causal}"
        print(f"[flash] {name}: max|dO|={err_o:.3e} (tol {atol:g} + {rtol:g}|O|) "
              f"max|dlse|={err_l:.3e} (tol {tol_l:g}) kernel {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms")
        if not (ok_o and err_l <= tol_l and torch.isfinite(out).all()):
            raise AssertionError(f"flash kernel disagrees with its plain version: {name}")
        if (B, causal, dtype) == (8, False, torch.bfloat16):  # the serving shape
            state["k1"] = dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms)


def _intros(n, S, rng):
    """n (S, 8) intros of random content ids with padded tails."""
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    hi = np.asarray(V.TOKEN_BOUNDARY) + 1
    out = []
    for i in range(n):
        x = (rng.random((S, 8)) * hi).astype(np.int64)
        length = S - 100 * (i % 4 + 1)
        x[length:] = np.asarray(V.PAD)
        out.append(x)
    return out


def _check_outputs(outs, S):
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    pad = np.asarray(V.PAD)
    for o in outs:
        o = np.asarray(o)
        if o.shape != (S, 8):
            raise AssertionError(f"output shape {o.shape}")
        if not ((o < np.asarray(V.FIELD_SIZES)).all() and (o >= 0).all()):
            raise AssertionError("output id outside its field's vocabulary")
        content = ~(o == pad).all(-1)
        if not (o[content] < pad).all():
            raise AssertionError("special id inside a content row")


def phase_serve(state):
    import numpy as np
    import torch
    from pianobart_tpu_torch import vocab as V
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.decode import generate
    from pianobart_tpu_torch.models import PianoBartConfig, PianoBartLM
    from pianobart_tpu_torch.models.pianobart import attention_mask_from_bars
    from pianobart_tpu_torch.ops.flash import flash_attention_fwd
    from pianobart_tpu_torch.serve.app import GenerationService

    cfg = PianoBartConfig(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] flagship PianoBartLM d_model={cfg.d_model} "
          f"layers={cfg.encoder_layers}+{cfg.decoder_layers} heads={cfg.num_heads} "
          f"ffn={cfg.ffn_dim} S={cfg.max_len} bf16, {n_params / 1e6:.1f} M params, "
          f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    S = cfg.max_len

    # encoder through K1 vs the same weights on the plain attention path
    plain = PianoBartLM(cfg.replace(use_flash_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    ids = torch.as_tensor(np.stack(_intros(2, S, rng)), device="cuda")
    mask = attention_mask_from_bars(ids)
    with torch.inference_mode():
        e_flash = model.encode(ids, mask).float()
        e_plain = plain.encode(ids, mask).float()
    del plain
    rows = mask.bool()
    diff = e_flash[rows] - e_plain[rows]
    err = diff.abs().max().item()
    rel = (diff.norm() / e_plain[rows].norm()).item()
    # both paths round to bf16 at different places (scores, P) in each of 8
    # layers of unit-scale LayerNorm outputs
    print(f"[serve] encoder via K1 vs plain attention (bf16, non-pad rows): "
          f"max|d|={err:.3e} (tol 0.5), |d|/|plain|={rel:.3e} (tol 2e-2)")
    if not (err <= 0.5 and rel <= 2e-2 and torch.isfinite(e_flash).all()):
        raise AssertionError("encoder output through K1 disagrees")

    svc = GenerationService(model=model, device="cuda", max_batch=8)
    before = flash_attention_fwd.launches
    warm = svc.warmup()
    print(f"[serve] warmup buckets (s): {warm}")
    if sorted(warm) != [1, 2, 4, 8]:
        raise AssertionError(f"warmup covered {sorted(warm)}")
    if flash_attention_fwd.launches - before != cfg.encoder_layers * len(warm):
        raise AssertionError("K1 did not run 8 times in each warmup decode batch")

    # main path: concurrent requests through the micro-batching service
    intros = _intros(4, S, rng)
    results, lat = [None] * len(intros), [0.0] * len(intros)

    def client(i):
        t = time.perf_counter()
        results[i] = svc.submit(intros[i], seed=i)
        lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(intros))]
    served0 = len(svc.batch_sizes_served)
    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    state["k1_launches"] = launches
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a request was not served")
    batches = svc.batch_sizes_served[served0:]
    _check_outputs(results, S)
    n_content = [int((~(np.asarray(r) == np.asarray(V.PAD)).all(-1)).sum())
                 for r in results]
    print(f"[serve] {len(intros)} concurrent requests served in {wall:.3f} s as "
          f"batches {batches}; latency s {[round(x, 3) for x in lat]}; "
          f"content rows {n_content}; K1 launches {launches}")
    if launches != cfg.encoder_layers * len(batches):
        raise AssertionError(f"K1 launched {launches} times for {len(batches)} "
                             f"decode batches, expected {cfg.encoder_layers} each")

    # fixed-length continuations, batch 1 and batch 8
    for B in (1, 8):
        x = torch.as_tensor(np.stack(_intros(B, S, rng)), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        before = flash_attention_fwd.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, x, generator=gen, force_full=True, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        _check_outputs(out.cpu().numpy(), S)
        if not (out.cpu().numpy() < np.asarray(V.PAD)).all():
            raise AssertionError("force_full output holds a special id")
        d = flash_attention_fwd.launches - before
        if d != cfg.encoder_layers:
            raise AssertionError(f"K1 launched {d} times in one decode batch")
        print(f"[serve] generate force_full B={B}: {sec:.3f} s for {S} steps, "
              f"{B / sec:.3f} continuations/s, {B * S / sec:.1f} tokens/s, "
              f"K1 launches {d}; max_steps cap: none")
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _where_time_goes(model, x, S)


def _where_time_goes(model, x, S, steps=64):
    """Breakdown of one batch-8 decode batch: the encoder (with K1's share)
    by CUDA events, and a profiled window of decode steps for the device's
    busy share and its heaviest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pianobart_tpu_torch.decode import generate
    from pianobart_tpu_torch.models.pianobart import attention_mask_from_bars
    mask = attention_mask_from_bars(x)
    with torch.inference_mode():
        enc_ms = _time_ms(lambda: model.encode(x, mask), iters=5)
    print(f"[where] B={x.shape[0]} encoder pass {enc_ms:.3f} ms "
          f"(8 K1 launches inside)")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    generate(model, x, generator=gen, force_full=True, max_steps=8, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(model, x, generator=gen, force_full=True, max_steps=steps,
                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, busy_us = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            n, t = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, t + us)
    if not per_name:
        print("[where] profiler saw no device events: busy share not measured")
        return
    n_kernels = sum(n for n, _ in per_name.values())
    print(f"[where] profiled {steps} decode steps (encoder included) at "
          f"B={x.shape[0]}: wall {wall:.3f} s, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.1f}%, idle {100 - 100 * busy_us / 1e6 / wall:.1f}%), "
          f"{n_kernels} device ops = {n_kernels / steps:.0f} per step; "
          f"wall per step {1e3 * wall / steps:.2f} ms under the profiler")
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[where]   {us / 1e3:9.3f} ms  x{n:<6d} {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    try:
        import pianobart_tpu_torch  # noqa: F401
    except ImportError:
        print("FAIL: pianobart_tpu_torch is not beside chip_smoke.py", file=sys.stderr)
        return 1
    state = {}
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("flash", phase_flash), ("serve", phase_serve)):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:
            traceback.print_exc()
            print(f"FAIL: phase {name}", file=sys.stderr)
            return 1
        print(f"[{name}] phase ok in {time.perf_counter() - t0:.1f} s")
    k1 = state["k1"]
    print(state["smi"])
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "pianobart_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "pianobart_tpu/ops/flash.py:173",
        "launches": state["k1_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": state["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
