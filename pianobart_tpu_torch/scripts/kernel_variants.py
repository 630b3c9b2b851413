"""Variants of K1's forward library, built side by side on the card, checked
against the plain version and timed in turns.

    python -m pianobart_tpu_torch.scripts.kernel_variants DIR [DIR ...]
    python -m pianobart_tpu_torch.scripts.kernel_variants --sass OLD_DIR NEW_DIR

Each DIR holds a copy of ``pianobart_tpu_torch/csrc`` with one change (a
parent tree's ``csrc`` works as one), named by its last path component.  Each
``DIR/flash_fwd.cu`` is compiled with ``nvcc`` and :mod:`..ops.build`'s flags,
loaded through ctypes with ``KERNELS["flash_fwd"]``'s argument types, and put
in place of ``ops/flash.py:build_kernel``'s library, so that
``flash_attention_fwd`` launches it.  For each variant it prints ptxas's
registers and spills and the SASS counts of its ``wgmma`` kernels, then at
head width 256 in bf16:

* checks at odd shapes (ragged q and kv tiles, Sq != Skv, causal, a wholly
  masked sample, a tp rank's strided heads, keys whose scores outgrow the
  first tile's): O within ``[flash]``'s bf16 tolerance of the plain version,
  |dlse| <= 1e-3, two launches equal to the bit;
* CUDA-event times of the training, long-context, tp and decode shapes, 40
  launches a turn, in the order first .. last, last .. first, each mean
  beside its ratio to the first variant's;
* where the library exports ``pbt_dbg_read`` and ``pbt_dbg_reset`` (an
  instrumented copy of ``flash_fwd_d256.cuh``: ``clock()`` differences summed
  per region into ``__device__ unsigned long long pbt_dbg[2][16]``, row = the
  consumer warpgroup, columns 0-9 the regions of :data:`REGIONS`, 10 the kv
  tiles, 11 the CTAs, and in row 0 12-13 the producer's free-slot waits and
  its whole time), cycles a tile per region at B=32, S=1024.

``--sass`` compiles ``flash_fwd.cu`` and ``flash_lab.cu`` of two trees and
says, for each ``wgmma`` kernel, whether its SASS is the same instruction for
instruction.  Needs a card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import time

import torch

from ..ops import build, flash

NVCC = "/usr/local/cuda/bin/nvcc"
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
REGIONS = ("Q wait", "K slots wait", "turn wait", "S issue", "S wait",
           "softmax", "V slots wait", "PV issue", "PV wait", "epilogue")


def _compile(src: str, out: str) -> str:
    """ptxas's report; raises if nvcc fails."""
    done = subprocess.run([NVCC, *build._NVCC_FLAGS, "-o", out, src], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stderr[-4000:]}")
    return done.stderr


def _sass(so: str):
    """{kernel name: [instruction, ...]} of a library, addresses stripped."""
    out = subprocess.run([CUOBJDUMP, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        funcs[name] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
                       for line in part.splitlines()[1:]
                       if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
    return funcs


def _load(dirs, out_dir):
    """Compile every variant at once; {name: library}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for d in dirs:
        name = os.path.basename(os.path.normpath(d))
        so = os.path.abspath(os.path.join(out_dir, f"{name}.so"))
        procs[name] = (subprocess.Popen(
            [NVCC, *build._NVCC_FLAGS, "-o", so, os.path.join(d, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-4000:]}")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Performance Loss" in line:
                print(f"{name}: {line.strip()[:300]}")
            if "Compiling entry" in line and "wgmma" in line:
                print(f"{name}: {line.split()[-3][1:60]} | {lines[i + 2].strip()} | "
                      f"{lines[i + 3].strip()[:60]}")
        if os.path.exists(CUOBJDUMP):
            for kname, ins in _sass(so).items():
                if "wgmma" in kname:
                    text = "\n".join(ins)
                    print(f"{name}: SASS {kname[:60]}: " + ", ".join(
                        f"{op} {text.count(op)}" for op in ("HGMMA", "UTMALDG", "HMMA.")))
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.KERNELS["flash_fwd"][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _use(lib):
    flash.build_kernel = lambda name: lib if name == "flash_fwd" else build.build_kernel(name)


def _case(B, Sq, causal, Skv=None, masked=False, tp=False, grow=False, H=4, D=256):
    """bf16 q (pre-scaled), k, v, a pad tail in the last sample's mask."""
    Skv = Skv or Sq
    g = torch.Generator(device="cuda").manual_seed(B)
    hh = 2 * H if tp else H          # tp: H heads as strided views of 2H

    def rnd(S, scale=1.0):
        x = (torch.randn(B, S, hh, D, device="cuda", generator=g) * scale).bfloat16()
        return x[:, :, H:] if tp else x

    q, k, v = rnd(Sq, D ** -0.5), rnd(Skv), rnd(Skv)
    if grow:      # the last kv tile's scores outgrow the others': the running max moves
        k[:, (Skv - 1) // 128 * 128:] *= 4
    mask = torch.ones(B, Skv, device="cuda")
    mask[-1, Skv - min(200, Skv // 3):] = 0.0
    if masked:
        mask[0] = 0.0
    return q, k, v, mask, causal


CHECKS = [dict(B=2, Sq=320, causal=False, masked=True), dict(B=2, Sq=320, causal=True),
          dict(B=1, Sq=64, causal=True), dict(B=2, Sq=192, Skv=320, causal=True),
          dict(B=2, Sq=320, Skv=192, causal=True), dict(B=3, Sq=448, causal=True),
          dict(B=2, Sq=192, Skv=576, causal=False), dict(B=2, Sq=576, causal=True),
          dict(B=1, Sq=1024, causal=False), dict(B=8, Sq=1024, causal=True),
          dict(B=2, Sq=2048, causal=True), dict(B=8, Sq=1024, causal=False, tp=True),
          dict(B=2, Sq=576, causal=False, grow=True), dict(B=2, Sq=576, causal=True, grow=True),
          dict(B=32, Sq=1024, causal=True), dict(B=32, Sq=1024, causal=False)]
TIMED = [dict(B=32, Sq=1024, causal=False), dict(B=32, Sq=1024, causal=True),
         dict(B=16, Sq=2048, causal=False), dict(B=16, Sq=2048, causal=True),
         dict(B=8, Sq=1024, causal=False, tp=True), dict(B=8, Sq=1024, causal=True, tp=True),
         dict(B=1, Sq=1024, causal=False), dict(B=8, Sq=1024, causal=False)]


def _time_ms(fn, iters=40):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(libs) -> set:
    """The variants that disagree with the plain version or with themselves."""
    bad = set()
    for kw in CHECKS:
        q, k, v, m, c = _case(**kw)
        ref, ref_lse = flash.flash_attention_reference(q, k, v, m, c)
        line = []
        for name, lib in libs.items():
            _use(lib)
            o, lse = flash.flash_attention_fwd(q, k, v, m, c)
            o2, lse2 = flash.flash_attention_fwd(q, k, v, m, c)
            torch.cuda.synchronize()
            d = (o.float() - ref.float()).abs()
            dl = (lse - ref_lse).abs().max().item()
            good = (bool((d <= 1e-2 + 1e-2 * ref.float().abs()).all()) and dl <= 1e-3
                    and torch.equal(o, o2) and torch.equal(lse, lse2))
            if not good:
                bad.add(name)
            line.append(f"{name}:{'ok' if good else 'BAD'} {d.max().item():.2e}/{dl:.1e}")
        print(f"check {kw}: " + " ".join(line), flush=True)
    return bad


def time_turns(libs):
    order = list(libs) + list(libs)[::-1]
    for kw in TIMED:
        q, k, v, m, c = _case(**kw)
        res = {name: [] for name in libs}
        for name in order:
            _use(libs[name])
            res[name].append(_time_ms(lambda: flash.flash_attention_fwd(q, k, v, m, c)))
        base = sum(res[order[0]]) / 2
        print(f"time {kw}: " + "; ".join(
            f"{n} {', '.join(f'{t:.4f}' for t in r)} ({sum(r) / 2 / base:.3f})"
            for n, r in res.items()), flush=True)


def counters(libs):
    for name, lib in libs.items():
        if not hasattr(lib, "pbt_dbg_read"):
            continue
        lib.pbt_dbg_read.argtypes = [ctypes.c_void_p]
        for causal in (False, True):
            q, k, v, m, c = _case(32, 1024, causal)
            _use(lib)
            lib.pbt_dbg_reset()
            ms = _time_ms(lambda: flash.flash_attention_fwd(q, k, v, m, c), iters=1)
            buf = (ctypes.c_ulonglong * 32)()
            lib.pbt_dbg_read(ctypes.addressof(buf))
            for wg in range(2):
                row = buf[16 * wg:16 * wg + 16]
                tiles, ctas = row[10], row[11]
                print(f"clock {name} causal={causal} wg{wg}: {tiles / ctas:.2f} tiles a CTA, "
                      f"{sum(row[:10]) / ctas:.0f} cycles a CTA; a tile: " + ", ".join(
                          f"{r} {row[i] / tiles:.0f}" for i, r in enumerate(REGIONS)))
            print(f"clock {name} causal={causal} producer: free-slot waits "
                  f"{buf[12] / buf[11]:.0f} of {buf[13] / buf[11]:.0f} cycles a CTA; "
                  f"4 launches, the last {ms:.4f} ms", flush=True)


def sass_diff(old: str, new: str, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    for src in ("flash_fwd.cu", "flash_lab.cu"):
        found = []
        for tag, d in (("old", old), ("new", new)):
            so = os.path.abspath(os.path.join(out_dir, f"{tag}_{src[:-3]}.so"))
            _compile(os.path.join(d, src), so)
            found.append(_sass(so))
        a, b = found
        for name in sorted(set(a) | set(b)):
            if "wgmma" not in name:
                continue
            if name in a and name in b:
                print(f"{src} {name[:60]}: {len(a[name])} / {len(b[name])} instructions, "
                      f"identical={a[name] == b[name]}")
            else:
                print(f"{src} {name[:60]}: only in {'old' if name in a else 'new'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="csrc copies (with --sass: old and new)")
    ap.add_argument("--sass", action="store_true", help="compare two trees' SASS")
    ap.add_argument("--out", default="build/variants", help="where the libraries go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA device")
    if args.sass:
        sass_diff(*args.dirs, args.out)
        return 0
    t0 = time.perf_counter()
    libs = _load(args.dirs, args.out)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    bad = check(libs)
    time_turns(libs)
    counters(libs)
    print("bad:", sorted(bad))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
