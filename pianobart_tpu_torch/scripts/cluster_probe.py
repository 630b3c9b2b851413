"""The wide heads' cluster kernels on the card: their times at ``--heads 2``
(D = 512, H = 2), at D = 384 and 1024, at ``--hs 2048 --heads 1``'s
widths (D = 1152, 1536, 2048) and, in bf16, at ``--hs 4096 --heads 1``'s
(D = 2176, 3072, 4096: clusters of 9, 12 and 16 CTAs) beside the D = 128
kernels, and
where a warp's time goes in the score exchange that the clusters add
(``csrc/hopper.cuh``): in bf16 K1's and the bf16 backward's (clusters of
ceil(D/256) CTAs of their D = 256 designs, so one ``pair_round`` an
exchange at D = 384 and 512; the backward's two warpgroups a CTA each
exchanging on its own), in f32 K1's (each consumer warpgroup on its own:
two pair rounds at D = 512, three at 1024, ``cluster_sum`` at 384) and the
f32 backward's (``cluster_sum``, two warpgroups a CTA).  Run from the root
of any checkout, it counts that tree's exchanges: run it on two trees to
compare them.

    python -m pianobart_tpu_torch.scripts.cluster_probe

Prints the card's name and power limit, then:

* CUDA-event means of K1, K3a (the dQ kernel) and K3b (the dK/dV kernel) at
  B=32, S=1024 in bf16 and B=8 in f32, with the pad mask of ``chip_smoke.py``,
  at D = 128 (H = 8), 384 (H = 4), 512 (H = 2), 1024 (H = 1), at B=16
  bf16 and B=4 f32 at D = 1152, 1536 and 2048 (H = 1: clusters of 5, 6, 8
  bf16 CTAs and 9, 12, 16 f32 ones), and at B=8 bf16 at D = 2176, 3072 and
  4096 (9, 12, 16 CTAs), through the shipped library;
* the exchange's choice at the largest clusters: the same kernels at
  D = 2048 (bf16 8 CTAs, f32 16) and 4096 (bf16 16) through the shipped
  library and through a copy of ``csrc`` built into
  ``build/cluster_probe/flip`` whose pair-round masks (``K1W_PAIRS``,
  ``BWD_PAIRS``, ``FW_PAIRS``) take the other exchange at 8 and 16 CTAs
  (bf16) and 16 (f32): pair rounds where the shipped kernel runs
  ``cluster_sum`` and the other way round, timed in turns (shipped, other,
  other, shipped);
* for the D = 384, 512, 1152, 1536 and 2048 calls (and f32 K1 at 1024;
  bf16 at 2176, 3072 and 4096),
  the counted library's time and the cycles a warp spends in each phase of
  one exchange (open, scatter, waiting for its units, reduce, waiting for
  the peers' reads, gather, waiting for the sums, reading them; a round of
  ``pair_round`` (one an exchange in a pair, two in four CTAs): open,
  sending its parts as "scatter", waiting for the peer's as "units wait",
  adding them as "reduce"), from a copy of ``csrc`` built into
  ``build/cluster_probe`` whose ``cluster_sum`` and ``pair_round`` add
  ``clock64()`` differences into a ``__device__`` array, a copy per SM
  (modulo 64) so that the atomics do not queue on one address (read back by
  an extra C entry, ``pbt_xprof_read``); the counters cost the f32 K1 about
  10% (the counted time beside the shipped one says how much) and stay out
  of the shipped source;
* for the f32 K1 at D = 384, 512 and 1024, where a consumer warpgroup's
  kv tile goes, cycles a warp: waiting for K's planes, the S products,
  the exchange, the softmax (with O's rescale and P's split), waiting for
  V^T's planes, P V; counted in the same copy, in the f32 K1 of either
  design (``TILE_MARKS``: the per-warpgroup exchange's, or the earlier
  ``flash_fwd_tf32_kernel`` clusters that summed S over both warpgroups at
  once), so that this script, copied into an older checkout, splits that
  tree's kernel too.

Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import shutil
import subprocess

import torch

from ..ops import build, flash

NVCC = "/usr/local/cuda/bin/nvcc"
PHASES = ("open", "scatter", "units wait", "reduce", "reads wait", "gather",
          "sums wait", "read sums")
OUT = os.path.join(os.path.dirname(build._BUILD_DIR), "cluster_probe")
# (file, the start of a pair-round mask's definition, the cluster sizes at
# which the flipped copy takes the other exchange: bf16 8 and 16 CTAs, f32 16)
_FLIPS = (("flash_fwd_d256.cuh", "constexpr uint32_t K1W_PAIRS =", (8, 16)),
          ("flash_bwd.cu", "constexpr uint32_t BWD_PAIRS =", (8, 16)),
          ("flash_fwd.cu", "constexpr uint32_t FW_PAIRS =", (16,)))
# the kernels whose exchange is flipped: (type, kernel, the file of its mask,
# whether it is BWD_PAIRS<true>), at D = 2048 and (bf16) 4096; the f32
# backward sums by cluster_sum at every n: nothing to flip
_FLIPPED = ((torch.bfloat16, "K1", "flash_fwd_d256.cuh", False),
            (torch.bfloat16, "K3a (dQ)", "flash_bwd.cu", False),
            (torch.bfloat16, "K3b (dK/dV)", "flash_bwd.cu", True),
            (torch.float32, "K1", "flash_fwd.cu", False))
COPIES = 64     # copies of the 32 counters, one an SM modulo 64

# (line of cluster_sum, the same with t[i] = clock64() at its phase's end)
_MARKS = (
    ("  const uint32_t reg = smem_u32(region);\n",
     "  const uint32_t reg = smem_u32(region);\n  long long t[9];\n  t[0] = clock64();\n"),
    ("    mbar_wait_cluster(xb, parity);\n  }\n",
     "    mbar_wait_cluster(xb, parity);\n  }\n  t[1] = clock64();\n"),
    ("  mbar_wait_cluster(xb + 1, parity);\n",
     "  t[2] = clock64();\n  mbar_wait_cluster(xb + 1, parity);\n  t[3] = clock64();\n"),
    ("  cluster_arrive_peers(c, xb + 2, lane);\n  mbar_wait_cluster(xb + 2, parity);\n",
     "  t[4] = clock64();\n  cluster_arrive_peers(c, xb + 2, lane);\n"
     "  mbar_wait_cluster(xb + 2, parity);\n  t[5] = clock64();\n"),
    ("  mbar_wait_cluster(xb + 3, parity);\n",
     "  t[6] = clock64();\n  mbar_wait_cluster(xb + 3, parity);\n  t[7] = clock64();\n"),
    ("  if (own_region) cluster_arrive_peers(c, xb, lane);\n}\n",
     "  if (own_region) cluster_arrive_peers(c, xb, lane);\n  t[8] = clock64();\n"
     "  if (lane == 0) {\n    for (int i = 0; i < 8; ++i)\n"
     "      atomicAdd(&pbt_xprof[pbt_xslot() + i], (unsigned long long)(t[i + 1] - t[i]));\n"
     "    atomicAdd(&pbt_xprof[pbt_xslot() + 8], 1ull);\n  }\n}\n"))


# the same for a round of pair_round: open, send, wait for the peer's
# parts, add
_PAIR_MARKS = (
    ("  const int lane = tid & 31;\n",
     "  const int lane = tid & 31;\n  long long t[5];\n  t[0] = clock64();\n"),
    ("  mbar_wait_cluster(ready, ready_parity);   // the peer has read its region\n",
     "  mbar_wait_cluster(ready, ready_parity);   // the peer has read its region\n"
     "  t[1] = clock64();\n"),
    ("  mbar_wait_cluster(full, full_parity);\n",
     "  t[2] = clock64();\n  mbar_wait_cluster(full, full_parity);\n  t[3] = clock64();\n"),
    ("                 :: \"r\"(mapa(smem_u32(next_ready), next)) : \"memory\");\n}\n",
     "                 :: \"r\"(mapa(smem_u32(next_ready), next)) : \"memory\");\n"
     "  t[4] = clock64();\n"
     "  if (lane == 0) {\n    for (int i = 0; i < 4; ++i)\n"
     "      atomicAdd(&pbt_xprof[pbt_xslot() + i], (unsigned long long)(t[i + 1] - t[i]));\n"
     "    atomicAdd(&pbt_xprof[pbt_xslot() + 8], 1ull);\n  }\n}\n"))


# The f32 K1's kv tile as a consumer warp sees it: t[0] before its wait for
# K's planes, then t[i] at the end of TILE_PHASES[i - 1]; added into
# pbt_xprof[16 + i], the warp-tiles counted in pbt_xprof[22].
TILE_PHASES = ("K wait", "S products", "exchange", "softmax", "V wait", "P V")
_TILE_SUM = ("      if (lane == 0) {\n        for (int i = 0; i < 6; ++i)\n"
             "          atomicAdd(&pbt_xprof[pbt_xslot() + 16 + i], (unsigned long long)(tt[i + 1] - tt[i]));\n"
             "        atomicAdd(&pbt_xprof[pbt_xslot() + 22], 1ull);\n      }\n")
TILE_MARKS = {
    # this design: flash_fwd_wide_tf32_kernel, one exchange a warpgroup-tile
    "flash_fwd_wide_tf32_kernel(const": (
        ("      wait_item(it);\n      wait_item(it + 1);\n",
         "      long long tt[7];\n      tt[0] = clock64();\n      wait_item(it);\n"
         "      wait_item(it + 1);\n      tt[1] = clock64();\n"),
        ("      fence_regs(sc);\n      release(it);\n      release(it + 1);\n",
         "      fence_regs(sc);\n      tt[2] = clock64();\n      release(it);\n"
         "      release(it + 1);\n"),
        ("      // the softmax over the sums\n", "      tt[3] = clock64();\n"),
        ("      split_acc_tf32(ph, pl, sc);\n",
         "      split_acc_tf32(ph, pl, sc);\n      tt[4] = clock64();\n"),
        ("      wait_item(it + 3);\n", "      wait_item(it + 3);\n      tt[5] = clock64();\n"),
        ("      release(it + 2);\n      release(it + 3);\n    }\n",
         "      release(it + 2);\n      release(it + 3);\n      tt[6] = clock64();\n"
         + _TILE_SUM + "    }\n")),
    # the earlier flash_fwd_tf32_kernel<CLUSTER_D>: cluster_sum of both warpgroups'
    # S through K lo's slot
    "flash_fwd_tf32_kernel(const": (
        ("      wait_plane(p);\n      wait_plane(p + 1);\n",
         "      long long tt[7];\n      tt[0] = clock64();\n      wait_plane(p);\n"
         "      wait_plane(p + 1);\n      tt[1] = clock64();\n"),
        ("      wgmma_wait<0>();\n      fence_regs(sc);\n",
         "      wgmma_wait<0>();\n      fence_regs(sc);\n      tt[2] = clock64();\n"),
        ("      const int* mk = reinterpret_cast<const int*>(sm + L::MASK + (p % NS) * BN * 4);\n",
         "      tt[3] = clock64();\n"
         "      const int* mk = reinterpret_cast<const int*>(sm + L::MASK + (p % NS) * BN * 4);\n"),
        ("      split_acc_tf32(ph, pl, sc);\n",
         "      split_acc_tf32(ph, pl, sc);\n      tt[4] = clock64();\n"),
        ("      wait_plane(p + 3);\n", "      wait_plane(p + 3);\n      tt[5] = clock64();\n"),
        ("      release(p + 2);\n      release(p + 3);\n    }\n",
         "      release(p + 2);\n      release(p + 3);\n      tt[6] = clock64();\n"
         + _TILE_SUM + "    }\n")),
}


def _count(text: str, head: str, marks) -> str:
    """The function of ``text`` that starts at ``head`` with ``marks`` applied."""
    start = text.index(head)
    end = text.index("\n}\n", start) + 3
    body = text[start:end]
    for line, counted in marks:
        if body.count(line) != 1:
            raise RuntimeError(f"{head!r} has changed: {line!r} not found once")
        body = body.replace(line, counted)
    return text[:start] + body + text[end:]


def _counted_copy() -> str:
    """``csrc`` copied to OUT/csrc with the phases of cluster_sum and
    pair_sum counted."""
    src = os.path.join(OUT, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build._CSRC, src)
    path = os.path.join(src, "hopper.cuh")
    with open(path) as f:
        text = f.read()
    text = _count(text, "__device__ __forceinline__ void cluster_sum(", _MARKS)
    text = _count(text, "__device__ __forceinline__ void pair_round(", _PAIR_MARKS)
    text = text.replace("struct ClusterSum {", (
        f"__device__ unsigned long long pbt_xprof[{COPIES} * 32];\n"
        "// this SM's copy of the counters: atomics of every SM on one address\n"
        "// would queue behind each other and slow the kernel they count\n"
        "__device__ __forceinline__ int pbt_xslot() {\n"
        "  unsigned s;\n  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n"
        f"  return (int)(s % {COPIES}) * 32;\n}}\n"
        "struct ClusterSum {"), 1)
    with open(path, "w") as f:
        f.write(text)
    path = os.path.join(src, "flash_fwd.cu")
    with open(path) as f:
        text = f.read()
    head = next(h for h in TILE_MARKS if h in text)   # the f32 K1 of this tree
    with open(path, "w") as f:
        f.write(_count(text, head, TILE_MARKS[head]))
    read = ('\nextern "C" int pbt_xprof_read(void* out) {\n'
            f"  static unsigned long long z[{COPIES} * 32];\n"
            "  cudaMemcpyFromSymbol(out, pbt::pbt_xprof, sizeof(z));\n"
            "  cudaMemcpyToSymbol(pbt::pbt_xprof, z, sizeof(z));\n"
            "  return (int)cudaGetLastError();\n}\n")
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        with open(os.path.join(src, name), "a") as f:
            f.write(read)
    return src


def _mask_expr(text, anchor):
    """The C++ expression that defines the mask starting at ``anchor``."""
    if text.count(anchor) != 1:
        raise RuntimeError(f"{anchor!r} not found once")
    return text[text.index(anchor) + len(anchor):].split(";", 1)[0]


def _shipped_pairs(name, dkv, n) -> bool:
    """Whether the shipped kernel whose mask is in ``name`` (the dK/dV one
    where ``dkv``) sums by pair rounds at cluster size n."""
    anchor = next(a for f, a, _ in _FLIPS if f == name)
    with open(os.path.join(build._CSRC, name)) as f:
        expr = _mask_expr(f.read(), anchor).replace("1u", "1")
    if "?" in expr:             # DKV ? dK/dV's : dQ's
        expr = expr.split("?", 1)[1].split(":", 1)[0 if dkv else 1]
    return bool((eval(expr, {}) >> n) & 1)


def _flipped_copy() -> str:
    """``csrc`` copied to OUT/flip/csrc with every mask of :data:`_FLIPS`
    taking the other exchange at its sizes."""
    src = os.path.join(OUT, "flip", "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build._CSRC, src)
    for name, anchor, sizes in _FLIPS:
        path = os.path.join(src, name)
        with open(path) as f:
            text = f.read()
        expr = _mask_expr(text, anchor)
        flip = " | ".join(f"(1u << {n})" for n in sizes)
        with open(path, "w") as f:
            f.write(text.replace(anchor + expr, f"{anchor} ({expr}) ^ ({flip})"))
    return src


def _counted_libs(src=None, tag="counted", counted=True):
    src = src or _counted_copy()
    procs = {}
    for name in ("flash_fwd", "flash_bwd"):
        so = os.path.join(OUT, f"{name}_{tag}.so")
        procs[name] = (so, subprocess.Popen(
            [NVCC, *build._NVCC_FLAGS, "-o", so, os.path.join(src, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {tag} {name}:\n{err[-4000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.KERNELS[name][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if counted:
            lib.pbt_xprof_read.argtypes = [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _case(B, dtype, H, D, S=1024):
    """chip_smoke.py's _flash_case: q pre-scaled, a pad tail in the last sample."""
    g = torch.Generator(device="cuda").manual_seed(B)
    q = torch.randn(B, S, H, D, device="cuda", generator=g) * D ** -0.5
    k = torch.randn(B, S, H, D, device="cuda", generator=g)
    v = torch.randn(B, S, H, D, device="cuda", generator=g)
    mask = torch.ones(B, S, device="cuda")
    mask[-1, S - 200:] = 0.0
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out, lse = flash.flash_attention_fwd(q, k, v, mask, False)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    return (q, k, v, mask, False, lse, flash._delta(dout, out), dout)


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    os.makedirs(OUT, exist_ok=True)
    calls = {"K1": lambda a: flash.flash_attention_fwd(*a[:5]),
             "K3a (dQ)": lambda a: flash.flash_attention_dq(*a),
             "K3b (dK/dV)": lambda a: flash.flash_attention_dkv(*a)}
    for dtype, B in ((torch.bfloat16, 32), (torch.float32, 8)):
        for H, D in ((8, 128), (4, 384), (2, 512), (1, 1024), (1, 1152), (1, 1536),
                     (1, 2048), (1, 2176), (1, 3072), (1, 4096)):
            if D > flash.head_dims(dtype)[-1]:
                continue
            b = B if D <= 1024 else B // 2 if D <= 2048 else B // 4
            args = _case(b, dtype, H, D)
            times = ", ".join(f"{name} {_ms(lambda: fn(args)):.4f} ms"
                              for name, fn in calls.items())
            print(f"[cluster_probe] B={b} H={H} D={D} {str(dtype)[6:]}: {times}", flush=True)
    real = flash.build_kernel
    flipped = _counted_libs(_flipped_copy(), "flipped", counted=False)
    for dtype, B, D in ((torch.bfloat16, 16, 2048), (torch.bfloat16, 8, 4096),
                        (torch.float32, 4, 2048)):
        args = _case(B, dtype, 1, D)
        n = (D + 255) // 256 if dtype == torch.bfloat16 else D // 128
        for kind, name, source, dkv in _FLIPPED:
            if kind != dtype:
                continue
            fn = calls[name]
            turns = []
            for who in ("shipped", "flipped", "flipped", "shipped"):
                flash.build_kernel = (real if who == "shipped"
                                      else lambda n: flipped.get(n) or real(n))
                turns.append(_ms(lambda: fn(args)))
            flash.build_kernel = real
            pairs = _shipped_pairs(source, dkv, n)
            shipped = "pair rounds" if pairs else "cluster_sum"
            other = "cluster_sum" if pairs else "pair rounds"
            print(f"[cluster_probe] {name} B={B} H=1 D={D} ({n} CTAs) {str(dtype)[6:]}: "
                  f"{shipped} (shipped) {(turns[0] + turns[3]) / 2:.4f} ms ({turns[0]:.4f}, "
                  f"{turns[3]:.4f}), {other} {(turns[1] + turns[2]) / 2:.4f} ms "
                  f"({turns[1]:.4f}, {turns[2]:.4f})", flush=True)
    libs = _counted_libs()
    flash.build_kernel = lambda name: libs.get(name) or real(name)
    raw = (ctypes.c_ulonglong * (COPIES * 32))()

    def read(lib):
        lib.pbt_xprof_read(raw)
        return [sum(raw[c * 32 + i] for c in range(COPIES)) for i in range(32)]
    try:
        for (dtype, B), (H, D) in itertools.chain(
                itertools.product(((torch.bfloat16, 32), (torch.float32, 8)),
                                  ((4, 384), (2, 512))), (((torch.float32, 8), (1, 1024)),),
                itertools.product(((torch.bfloat16, 16), (torch.float32, 4)),
                                  ((1, 1152), (1, 1536), (1, 2048))),
                itertools.product(((torch.bfloat16, 8),), ((1, 2176), (1, 3072), (1, 4096)))):
            args = _case(B, dtype, H, D)
            for name, fn in calls.items():
                lib = libs["flash_fwd" if name == "K1" else "flash_bwd"]
                counted = _ms(lambda: fn(args))
                torch.cuda.synchronize()
                read(lib)
                fn(args)
                torch.cuda.synchronize()
                buf = read(lib)
                n = max(buf[8], 1)
                total = sum(buf[i] for i in range(8)) / n
                print(f"[cluster_probe] {name} B={B} H={H} D={D} {str(dtype)[6:]}, counted "
                      f"{counted:.4f} ms: {buf[8]} warp-exchanges, cycles each: "
                      + ", ".join(f"{p} {buf[i] / n:.0f}" for i, p in enumerate(PHASES))
                      + f"; total {total:.0f}", flush=True)
                tiles = buf[22]
                if name == "K1" and dtype == torch.float32 and tiles:
                    print(f"[cluster_probe] K1 B={B} H={H} D={D} float32: {tiles} "
                          f"warp-tiles, cycles each: "
                          + ", ".join(f"{p} {buf[16 + i] / tiles:.0f}"
                                      for i, p in enumerate(TILE_PHASES))
                          + f"; total {sum(buf[16 + i] for i in range(6)) / tiles:.0f}",
                          flush=True)
    finally:
        flash.build_kernel = real


if __name__ == "__main__":
    main()
