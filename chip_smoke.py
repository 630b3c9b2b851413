#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pianobart_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero with no
result line:

1. device report (name, count, ``nvidia-smi`` name and power limit);
2. build the four kernel sources with ``nvcc`` (flash forward K1, flash
   backward K2/K3a/K3b, fused dropout+residual+LayerNorm K4a/K4b, the
   kernel lab's L1/L2, instances of K1's kernel template), one process per
   source, with ptxas's registers and spills, the HGMMA/UTMALDG/HMMA
   counts of the wgmma kernels' SASS (an HMMA., or no HGMMA or UTMALDG,
   fails) and each one's SASS held against the parent's (:data:`PARENT_SASS`:
   a kernel this tree did not redesign that compiles to other code fails),
   and how many clusters of each cluster kernel the card holds at once at
   every cluster size it launches;
3. ``[flash]``: K1 against its plain PyTorch version at the serving
   shapes (every decode bucket, B = 1, 2, 4, 8), the training shapes and
   the long-context shape (B=16, S=2048), [finetune_mesh]'s tp ranks (B=8,
   4 of 8 heads from ``tp_slice``'d projections, bf16 and f32), and at head
   width 256 (``--heads 4``: B=32 bf16 and B=8 f32, causal and not, the tp
   ranks' 2 of 4 heads, the bf16 decode buckets B = 1, 2, 4, 8, B=2 S=320,
   S=192 (a ragged kv tile of the bf16 kernel's 128 rows) and a wholly
   masked sample), and at the wide heads, clusters (bf16 K1 of
   ceil(D/256) CTAs of its D=256 design, the other kernels of D/128; ``--heads
   2``, D=512: B=32 bf16 and B=8 f32, causal and not, B=8 and 16 at S=2048,
   the tp ranks' 1 of 2 heads, S=320, a wholly masked sample; 4 heads of 384;
   1 head of 1024; past 1024, bf16 clusters of 5, 6, 8 CTAs and f32 ones of
   9, 12, 16, the card's non-portable sizes: ``--hs 2048 --heads 1``'s B=16
   bf16 and B=4 f32, causal and not, B=8 at S=2048, its decode bucket B=2,
   S=320, a wholly masked sample; 1 head of 1152, causal and not; past 2048
   bf16 alone, clusters of 9, 12, 16 CTAs: ``--hs 4096 --heads 1``'s B=8,
   causal and not, B=4 at S=2048, its decode bucket B=2, S=320, a wholly
   masked sample; 1 head of 2176 and of 3072, causal and not), the
   refusals past each type's widest head (f32 2176 and 4096, bf16 4224:
   ValueError with the type's range), then which kernels SDPA ran at
   D = 384, 512, 1024, 2048, 4096, with times of the kernel, the plain
   version, the bound and ``scaled_dot_product_attention`` (a yardstick the
   port never calls);
4. ``[lab]``: every variant of L1 (``upcast`` x ``exp2`` x ``causal``) and
   of L2 (``exp2`` x ``causal``) against its plain version at the lab shape
   (B=32, S=1024, bf16), with the same times, every variant on rows with
   no kept key and at ragged lengths (S=320; Sq=192, Skv=320) at small
   shapes, then the port's kernel lab
   (``kernel_lab.main(kt=True)``: checks against K1, two interleaved
   sweeps) as this phase's main path;
5. ``[flash_bwd]``: K2 against its plain version at the flagship training
   shape (B=32, S=1024, bf16, causal and not), at the pretraining run's
   (B=8, S=1024, bf16, causal and not) and in f32, and K3a and K3b
   at the long-context shape (B=16, S=2048, bf16, causal and not), each
   also at B=2, S=320 (half a CTA past S) and with a fully masked sample,
   and K2 at [finetune_mesh]'s tp ranks (as in ``[flash]``), and the same
   at head width 256 (K2 B=32 bf16 and B=8 f32, K3a/K3b B=16 S=2048 bf16 and
   B=2 f32, the tp ranks', S=320, wholly masked samples) and at the wide
   heads (D=512 at [train_h512]'s shapes, its tp ranks', S=320, a wholly
   masked sample; D=384; D=1024; D=2048 at [train_h2048]'s shapes, K2 B=16
   bf16 and B=4 f32, K3 B=8 S=2048, S=320, a wholly masked sample; D=1152;
   bf16 D=4096 at [train_h4096]'s shapes, K2 B=8, K3 B=4 S=2048, S=320, a
   wholly masked sample; bf16 D=2176 and 3072), with the same times (the
   yardstick is SDPA's backward); at each case the
   delta kernel (rowsum(dO * O), which both run after) against its plain
   version, with its times, and in f32 the tf32 prep (D = 128 and 256);
   last, [train_h256]'s, [train_h512]'s, [train_h2048]'s and [train_h4096]'s
   bf16 K2 calls and their S=2048 steps' K3a and K3b under the profiler, by
   kernel (delta,
   dK/dV, dQ), and
   the kernels SDPA's backward ran at the wide heads;
6. ``[fused_ln]``: K4a and K4b against their plain versions fed the same
   Philox bits, at the flagship's N=32768 rows of D=1024 in bf16, at a
   small N in f32, and at N=8192 rows wider than one warp takes (D = 1152,
   2048 and 8192 in bf16, 2048 in f32), each with its bytes bound (no
   single PyTorch call computes this: no yardstick);
7. ``[serve]``: the serving slice at full flagship width (bf16, random
   weights from a seed): ``GenerationService`` warmup over buckets
   {1, 2, 4, 8}, concurrent requests from threads, output checks, timed
   batch-1 and batch-8 fixed-length continuations, K1's launch count per
   decode batch, and a profiled window of decode steps;
8. ``[serve_http]``: the MIDI-file serving path on [serve]'s model: four
   two-track songs written by the port's MIDI writer, uploaded to the port's
   WSGI ``App``, concurrent ``GET /api/generate`` requests from threads
   (each a 200 whose MIDI downloads and parses back, or the JAX App's 500
   "generation produced no notes"), one request over a localhost socket,
   then the ``demo`` CLI in process; K1 launches 8 per decode batch;
9. ``[train]``: the flagship pretrain step: gradients through K1+K2 against
   the plain attention path at B=4, then ``pretrain_step`` at B=32, S=1024
   (bf16 compute, f32 parameters, dropout 0.1) with ms/step, tokens/s, MFU,
   peak memory, launches per step (K1 and K2 24 each, K3 and K4 none) and
   a profiled window; then the five corruptions the shipped ``corrupt_batch``
   never picks (bar deletion, element masking, bar masking, bar x
   instrument element masking, bar infilling) at B=32, S=1024 on the
   device, each with its ms and the CPU tests' invariants on its output;
10. ``[train_long]``: the long-context step (``max_len=2048``, B=16, the
   flagship's tokens per batch): gradients through K1+K3 against plain
   attention at B=2, then the same timed steps (K1, K3a, K3b 24 each, K2
   none);
11. ``[train_fused]``: the flagship step with ``fused_dropout_ln`` (K4 at
   all 40 sublayer tails): the fused step against the unfused one at
   dropout 1e-9 at B=4, then the timed steps at B=32 (K4a, K4b 40 each, K1,
   K2 24 each), printed beside ``[train]``'s numbers of this run;
12. ``[train_f32]``: the flagship step as ``PianoBartConfig()`` stands (f32
   compute and parameters): gradients through K1+K2 against plain attention
   at B=2, then 3 warm-up and 5 timed steps at B=8 (K1, K2 24 each);
13. ``[train_h256]``: ``--heads 4`` (head width 256, the flagship's H*D):
   gradients through K1+K2 against plain attention at B=4 in bf16 and f32,
   the timed steps at B=32 (K1, delta, K2 24 each), at S=2048 B=16 (K1,
   delta, K3a, K3b 24 each) and in f32 at B=8 (K1, delta, K2 24 each, the
   prep 48: the f32 kernels at D=256 are CTA pairs over the prep's planes),
   then the encoder of a --heads 4 serving model via K1 against plain
   attention and a ``GenerationService`` decode batch (K1 8);
13b. ``[train_h512]``: ``--heads 2`` (head width 512, every attention on
   clusters: bf16 K1 of 2 CTAs, the others of 4) as 13 runs ``--heads 4``: gradients through the
   kernels against plain attention (B=4 bf16, B=2 f32), 10 timed steps at
   B=32 (K1, delta, K2 24 each) beside [train] and beside the plain route's
   3 steps (its ms/step and peak), 2 at S=2048 B=16 (K1, delta, K3a, K3b 24
   each), 3 in f32 at B=8 (the prep 48), the encoder of a --heads 2 server
   via K1 against plain attention and a decode batch (K1 8);
13c. ``[train_h2048]``: ``--hs 2048 --heads 1`` (d_model 2048, one head of
   2048, 549 M parameters drawn once and cast for every model; bf16 clusters
   of 8 CTAs, f32 of 16): gradients through the kernels against plain
   attention (B=2 bf16, B=1 f32), 10 timed steps at B=16 (K1, delta, K2 24
   each) beside the plain route's 3 (ms/step, peak, each step's peak), 2 at
   S=2048 B=8 (K1, delta, K3a, K3b 24 each), 3 in f32 at B=4 (the prep 48),
   the encoder of a bf16-parameter server via K1 against plain attention and
   a decode batch of two requests (K1 8);
13d. ``[train_h4096]``: ``--hs 4096 --heads 1`` (d_model 4096, one head of
   4096, about 1.9 B parameters drawn once, kept on the host and cast for
   every model; bf16 clusters of 16 CTAs): f32 at this width takes the plain
   dense path and the ring raises; gradients through the kernels against
   plain attention (B=2 bf16), 10 timed steps at B=8 (K1, delta, K2 24 each)
   beside the plain route's 3 (ms/step, tokens/s, MFU, peak), 2 at S=2048
   B=4 (K1, delta, K3a, K3b 24 each), the encoder of a bf16-parameter server
   via K1 against plain attention and a decode batch of two requests (K1 8);
14. ``[pretrain_run]``: the pretraining run as a user starts it, at flagship
   width (bf16 compute, f32 parameters), in a temporary directory outside
   the checkout: 64 two-track songs tokenized by the native codec
   (``tokenize --no_pad``) and checked (``check --packed``), ``pretrain``
   (B=8, 3 epochs, a safety save every dispatch) in a subprocess stopped by
   SIGTERM after epoch 1 (exit 75), then ``--resume`` (exit 0, epochs 1-3
   each once); in process the best checkpoint restored into a fresh model
   re-scores ``best_acc`` to 1e-5, and a fourth epoch (``run(4,
   resume=True)``) launches K1 24 per train step and per validation batch,
   K2 24 per train step; tokens/s per epoch and each save's seconds;
15. ``[finetune]``: the finetunes as a user runs them, at flagship width
   (bf16 compute, f32 parameters, dropout 0.1, B=8), in a temporary directory
   outside the checkout: 40 songs by 4 composers written by the port's MIDI
   writer and tokenized by its ``tokenize`` for every task; ``finetune
   --task composer --ckpt`` [pretrain_run]'s ``best/`` (the trunk grafted,
   the head left as drawn, both checked), ``finetune --task velocity`` under
   ``PBX_FUSED_DROPLN=1`` (the fused tails from the CLI's environment: K4a
   and K4b 40 per train step), ``finetune-generation --fad --ckpt`` the same
   ``best/``, one epoch each in process (ms per train step, peak memory, a
   finite loss, ``best/``; K1, delta and K2 24 per train step, K1 24 per
   eval batch); then melody,
   emotion and the ablation one train and one eval step each through their
   step functions, and 4 more emotion train steps under the profiler (the
   device's busy share, the heaviest kernels, the clip and AdamW's share);
16. ``[serve_ckpt]``: the generation finetune's ``best/`` exported by
   ``export-ckpt`` to a reference ``.ckpt`` and converted back by
   ``convert-ckpt`` (weights equal), ``create_app`` over the directory and
   the file (each load's seconds), each loaded model's logits against the
   finetuned model in memory (|diff| 0), both loaded again at the service's
   default cfg (bf16 parameters equal to ``best/``'s cast to bf16), then 2
   uploaded songs generated by
   both models at once (a 200 whose MIDI parses back, or the 500 "no
   notes"; K1 8 launches per decode batch);
17. ``[merge]``: [finetune]'s composer and generation ``best/`` merged over
   [pretrain_run]'s ``best/`` by the ``merge`` CLI in process at flagship
   width (f32), every method (average, task arithmetic, TIES, the random
   and magnitude masks, Fisher and RegMean on 32 windows of
   [pretrain_run]'s data), each with its seconds, peak memory and launches
   (Fisher: K1, delta, K2 24 per batch per model; RegMean: K1 24); the
   deterministic methods against the host in f32 (equal) and in float64,
   and TIES's thresholds equal; the Fisher pass timed by ``StepTimer``, one RegMean batch traced
   with its memory snapshot; ``--head_from`` to a ``.msgpack`` loaded at
   f32 (logits |diff| 0 against the merge in memory), grafted onto a
   classifier, and served at bf16 (2 songs, K1 8 per decode batch);
18. ``[parallel]``: the mesh over torch.distributed on this one card: ``pretrain
   --dist_backend nccl`` with more ranks than cards refused before any process
   group; four ranks spawned over gloo (all on cuda:0, ring blocks staged
   through pinned host memory): ``ring_attention`` at sp = 2 and 4 over (B=4,
   S=2048 and 4096, H=8, D=128), bf16 and f32, causal and not, at sp=2
   over (B=4, S=2048, H=4, D=256) and (H=2, D=512) bf16, over (B=2,
   S=2048, H=1, D=2048) bf16 and f32 and over (B=2, S=2048, H=1, D=4096)
   bf16, against the
   plain ring and dense ``flash_attention`` (a 3S/8 pad tail covering the
   last shard at sp=4); the flagship mesh step (B=2, dropout 0, one step a
   mesh) at 1x1x2, 2x1x2, 1x2x2 (S=2048), 1x1x2 (S=4096) and 1x1x2
   with --heads 2 (S=2048) against the dense step on
   the same card (loss, clipped gradients per group, the same gradients on
   every rank), the parameters placed by ``shard_params`` (at 1x2x2 each rank
   holds its slices of the qkv, mlp and vocab leaves and their AdamW state;
   its gradient shards are gathered whole for the checks and must be its
   slices of them), each rank's launches per step checked, s per step and,
   per rank, the parameter elements held, the memory allocated after the
   step and the peak (ranks sharing one card); then ``torch.distributed.run``
   of ``pretrain --mesh 1x1x2 --dist_backend gloo --max_seq_len 2048`` on
   64 songs tokenized at 2048, one epoch: exit 0, a finite loss, ``best/``;
19. ``[finetune_mesh]``: the finetunes over the mesh on this one card: four
   ranks spawned over gloo (all on cuda:0); ``ring_attention`` at this
   phase's blocks (B=8, S=1024, sp=2, bf16, causal and not) against the
   plain ring and dense attention; the composer, velocity and generation
   steps at flagship width (bf16 compute, f32 parameters, B=8, S=1024,
   dropout 0 and the heads' fixed 0.1 set to 0) on [pretrain_run]'s
   ``best/``, at 2x1x1, 1x2x1 and 1x1x2, velocity's also at 2x1x2 and in f32
   at 2x1x1, 1x2x1 and 1x1x2, one eval step and one train step each, against the
   dense steps on the same card (eval loss and the gathered predictions
   away from ties, train loss, clipped gradients per group, the same
   gradients on every rank), the parameters placed by ``shard_params`` as in
   18 (at 1x2x1 each rank holds its slices), each rank's launches per step
   checked, and per rank the parameter elements held, the memory allocated
   after the train step and the peak; then
   ``torch.distributed.run`` of ``finetune --task
   composer --mesh 2x1x1`` and ``finetune-generation --mesh 1x1x2 --fad`` on
   [finetune]'s corpora with ``--ckpt`` [pretrain_run]'s ``best/``, one
   epoch each: exit 0, ``best/`` once, ``test_outputs.npy`` of the
   single-rank run's shape.

Each main path (lab, serve, serve_http, train, train_long, train_fused, train_f32,
train_h256, train_h256_long, train_h256_f32, serve_h256, train_h512, train_h512_long,
train_h512_f32, serve_h512, train_h2048, train_h2048_long, train_h2048_f32,
serve_h2048, train_h4096, train_h4096_long, serve_h4096, pretrain_run, finetune,
serve_ckpt, merge, parallel, finetune_mesh) is driven with every
kernel's launch count set to 0 just before it and read just after.  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0


def _counters():
    """Every kernel wrapper, by the name of its launch count."""
    from pianobart_tpu_torch.ops import flash, fused_ln
    from pianobart_tpu_torch.scripts import kernel_lab
    return {"flash_attention_fwd": flash.flash_attention_fwd,
            "flash_attention_bwd": flash.flash_attention_bwd,
            "flash_attention_dq": flash.flash_attention_dq,
            "flash_attention_dkv": flash.flash_attention_dkv,
            "flash_attention_delta": flash.flash_attention_delta,
            "flash_attention_split": flash.flash_attention_split,
            "dropout_add_ln_fwd": fused_ln.dropout_add_ln_fwd,
            "dropout_add_ln_bwd": fused_ln.dropout_add_ln_bwd,
            "kt_fwd": kernel_lab.kt_fwd, "hl_fwd": kernel_lab.hl_fwd}


def _reset_counts():
    """Every kernel wrapper's launch count to 0 (just before a main path)."""
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


COUNT_NAMES = "K1, K2, K3a, K3b, delta, split, K4a, K4b, L1, L2"


def _counts(k1=0, k2=0, k3=0, k4=0, f32=False):
    """Expected counts in ``_read_counts`` order (``COUNT_NAMES``): one delta
    before each backward (K2, or K3a and K3b); in f32 one tf32 prep launch
    before each K1, K2, K3a and K3b; the training paths launch no lab
    kernel."""
    split = k1 + k2 + 2 * k3 if f32 else 0
    return (k1, k2, k3, k3, k2 + k3, split, k4, k4, 0, 0)


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


def _cuobjdump():
    """The toolkit's cuobjdump, or the copy in Triton's package; None if
    neither is there."""
    import importlib.util
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    spec = importlib.util.find_spec("triton")
    dirs = ["/usr/local/cuda/bin"] + [
        os.path.join(d, "backends", "nvidia", "bin")
        for d in (spec.submodule_search_locations or [] if spec else [])]
    for d in dirs:
        if os.path.exists(os.path.join(d, "cuobjdump")):
            return os.path.join(d, "cuobjdump")
    return None


# K1's kernel template flash_fwd_wgmma_kernel<KT, SPLIT_P, D>, by its flags
FWD_INSTANCES = {("0", "0"): "K1", ("0", "1"): "L2", ("1", "0"): "L1, P rounded",
                 ("1", "1"): "L1, P split"}


def _sass_label(name):
    """``flash_..._kernel<flags> (role)`` from a kernel's mangled name."""
    label = re.search(r"\d(flash_\w+?_kernel)", name).group(1)
    tail = name[name.index(label) + len(label):]
    if label == "flash_fwd_d256_wgmma_kernel":   # the bf16 forward at D = 256 and past it
        if tail.startswith("ILb1E"):
            return label + ("<true> (K1, D = 384 .. 4096, clusters of ceil(D/256) "
                            "CTAs of the D=256 design)")
        return label + "<false> (K1, D=256, 128-row kv tiles, ping-pong)"
    if label == "flash_bwd_wide_tf32_kernel":    # the f32 backward past D = 256
        return label + ("<true> (dK/dV" if tail.startswith("ILb1E") else "<false> (dQ") + (
            ", clusters of D/128 CTAs, two warpgroups on 32-row tiles)")
    if label == "flash_fwd_wide_tf32_kernel":    # the f32 forward past D = 256
        return label + (" (K1, D = 384 .. 2048, clusters of D/128 CTAs, a score tile "
                        "summed per warpgroup)")
    cluster = {"256": " (CTA pair)"}
    width = re.match(r"ILi(\d+)E", tail)   # the f32 forward's <DW>
    if width:
        return f"{label}<{width.group(1)}>" + cluster.get(width.group(1), "")
    flags = re.match(r"ILb([01])E(?:Lb([01])E)?(?:Li(\d+)E)?", tail)
    if not flags:
        return label
    if label.startswith("flash_bwd"):
        d = flags.group(3)
        dkv = flags.group(1) == "1"
        if label == "flash_bwd_d256_wgmma_kernel":   # the bf16 backward at D = 256 and past it
            if flags.group(2) == "1":
                return label + ("<true, true> (dK/dV" if dkv else "<false, true> (dQ") + (
                    ", D = 384 .. 4096, clusters of ceil(D/256) CTAs of the D=256 design)")
            return label + ("<true, false> (dK/dV, S^T once, P^T handed over)" if dkv
                            else "<false, false> (dQ, 128 rows, K and V through 3 slots)")
        return label + (f"<true{', ' + d if d else ''}> (dK/dV" if dkv
                        else f"<false{', ' + d if d else ''}> (dQ") + (
                            cluster[d].replace(" (", ", ") if d in cluster else ")")
    kt, split, d = flags.groups()
    tf = {"0": "false", "1": "true"}
    return (f"{label}<{tf[kt]}, {tf[split]}, {d}> ({FWD_INSTANCES[kt, split]}"
            + (cluster[d].replace(" (", ", ") if d in cluster else ")"))


# The SASS of every wgmma kernel this tree did not redesign, as the parent
# tree compiled it with the card machine's toolkit (CUDA 12.8;
# :func:`_sass_digest`): the D = 128 and D = 256 kernels and the lab's.  A
# kernel redesigned on purpose leaves this table with its parent's row.
PARENT_SASS = {
    "flash_fwd_tf32_kernel<128>": "15bc73290d4b8edf",
    "flash_fwd_tf32_kernel<256> (CTA pair)": "b8dfd789d8abda8c",
    "flash_fwd_wgmma_kernel<false, false, 128> (K1)": "fef3bd7947d43eeb",
    "flash_fwd_d256_wgmma_kernel<false> (K1, D=256, 128-row kv tiles, ping-pong)":
        "f9a85d7f89bd862e",
    "flash_bwd_tf32_kernel<false, 128> (dQ)": "a64802d4da19cafd",
    "flash_bwd_tf32_kernel<true, 128> (dK/dV)": "eced7122153a00ce",
    "flash_bwd_tf32_kernel<false, 256> (dQ, CTA pair)": "1e41d06a05c17859",
    "flash_bwd_tf32_kernel<true, 256> (dK/dV, CTA pair)": "8f20f3dba3c64edb",
    "flash_bwd_d256_wgmma_kernel<false, false> (dQ, 128 rows, K and V through 3 slots)":
        "54ab1bd849f85e34",
    "flash_bwd_d256_wgmma_kernel<true, false> (dK/dV, S^T once, P^T handed over)":
        "a6af41efd301b88c",
    "flash_bwd_wgmma_kernel<false, 128> (dQ)": "be3f4a52b753c4b0",
    "flash_bwd_wgmma_kernel<true, 128> (dK/dV)": "da23dd626c6dd53e",
    "flash_fwd_wgmma_kernel<false, true, 128> (L2)": "e270d98249afc44e",
    "flash_fwd_wgmma_kernel<true, false, 128> (L1, P rounded)": "a8c8a6b545c191cc",
    "flash_fwd_wgmma_kernel<true, true, 128> (L1, P split)": "5576364b937ec2f3",
}


def _sass_digest(sass):
    """A kernel's SASS instructions (addresses, encodings and label numbers
    left out) as a short sha256: equal for code equal instruction for
    instruction."""
    import hashlib
    labels = {}

    def label(m):
        return labels.setdefault(m.group(0), f".L{len(labels)}")
    lines = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", sass)
    text = re.sub(r"\.L_x_\d+", label, "\n".join(lines))
    return hashlib.sha256(text.encode()).hexdigest()[:16], len(lines)


def _sass_by_label(tool, path):
    """{label: (digest, instructions, HGMMA/UTMALDG/HMMA counts)} of the wgmma
    kernels in a built library."""
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    found = {}
    for kernel in sass.split("Function : ")[1:]:
        name = kernel.split("\n", 1)[0].strip()
        if re.search(r"flash_\w+_(wgmma|tf32)_kernel", name):
            counts = {op: kernel.count(op) for op in ("HGMMA", "UTMALDG", "HMMA.")}
            found[_sass_label(name)] = (*_sass_digest(kernel), counts)
    return found


def _cluster_occupancy(libs):
    """[build]'s lines: cudaOccupancyMaxActiveClusters of every cluster
    kernel at each cluster size it launches (D = 256 .. 4096 in bf16, 2048 in
    f32: the bf16 kernels' 9 .. 16 CTAs past 2048 and the f32 ones' past
    1024 are non-portable sizes), from the libraries'
    ``pbt_cluster_occupancy``; fails where the card holds none."""
    import ctypes

    import torch
    from pianobart_tpu_torch.ops.flash import MAX_HEAD_DIM
    kernels = (("flash_fwd", 1, 0, "K1 bf16"), ("flash_fwd", 0, 0, "K1 f32"),
               ("flash_bwd", 1, 1, "dK/dV bf16"), ("flash_bwd", 1, 0, "dQ bf16"),
               ("flash_bwd", 0, 1, "dK/dV f32"), ("flash_bwd", 0, 0, "dQ f32"))
    rows = {}
    for lib, dtype, which, what in kernels:
        by_n = {}
        top = MAX_HEAD_DIM[torch.bfloat16 if dtype == 1 else torch.float32]
        for D in range(256, top + 1, 128):
            n = ctypes.c_int(0)
            active = libs[lib].pbt_cluster_occupancy(D, dtype, which, ctypes.byref(n))
            if n.value > 1:
                by_n.setdefault(n.value, [active, []])[1].append(D)
        rows[what] = by_n
        print(f"[build] clusters held at once, {what}: " + "; ".join(
            f"n={n} (D={'/'.join(map(str, ds))}) {a} ({a * n} SMs)"
            for n, (a, ds) in sorted(by_n.items())))
        if any(a < 1 for a, _ in by_n.values()):
            raise AssertionError(f"the card holds no cluster of some size of {what}: {by_n}")
    return rows


def phase_build(state):
    """All sources built together (one nvcc per source, started at once),
    then what the wgmma kernels (K1's bf16 instances at D = 128 and 256 and
    its f32 kernel, the lab's three instances of K1's template, K2/K3's
    dK/dV and dQ kernels in both types and the bf16 ones at D=256) compiled
    to: Hopper's products (HGMMA), tensor loads (UTMALDG) and any older
    tensor-core product (HMMA.) in their SASS.  Fails if one of them has an
    HMMA., or no HGMMA or no UTMALDG (the lab's mma.sync design, or any
    other, come back), and so do the f32 kernels' D=256 instances (CTA
    pairs, ``<256>`` and ``<*, 256>``).  Fails too if a bf16 D=256 kernel
    (K1's ``flash_fwd_d256_wgmma_kernel<false>`` and the backward's
    ``flash_bwd_d256_wgmma_kernel``, both instances, its clusters' too; 128
    accumulators a thread) or the f32 K1's clusters
    (``flash_fwd_wide_tf32_kernel``: O, S and Q hi's fragments, 160 registers
    a thread) spill, or if ptxas serializes their wgmma (its "Potential
    Performance Loss" remark); and if a wgmma kernel of :data:`PARENT_SASS`
    compiles to other code than its parent's.  Then prints how many clusters of each cluster
    kernel the card holds at once, at every size it launches."""
    from pianobart_tpu_torch.ops.build import build_kernels
    t0 = time.perf_counter()
    libs = build_kernels()
    print(f"[build] {', '.join(libs)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    spilled = []
    for name, lib in libs.items():
        print(f"[build] {name}: {os.path.relpath(lib.path)}")
        entry = ""
        with open(lib.path + ".log") as f:
            for line in f:
                if ("registers" in line or "spill" in line or "Compiling" in line
                        or "warning" in line or "Performance Loss" in line
                        or line.startswith("nvcc")):
                    print(f"[build]   {line.strip()}")
                if "Compiling entry function" in line:
                    entry = line
                elif ("spill stores" in line
                      and ("d256_wgmma_kernel" in entry
                           and "fwd_d256_wgmma_kernelILb1E" not in entry   # not K1's clusters
                           or "flash_fwd_wide_tf32_kernel" in entry)
                      and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)):
                    spilled.append(f"{_sass_label(entry)}: {line.strip()}")
                elif "serialized" in line and ("d256_wgmma_kernel" in line
                                               or "flash_fwd_wide_tf32_kernel" in line):
                    spilled.append(line.strip())
    if spilled:   # many accumulators a thread; products that must overlap
        raise AssertionError(f"a D=256 bf16 kernel or the f32 K1's clusters spill or run "
                             f"their wgmma serialized: {spilled}")
    _cluster_occupancy(libs)
    tool = _cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: SASS not inspected")
        return
    changed, seen = [], set()
    for lib, expect in (("flash_fwd", 6), ("flash_bwd", 12), ("flash_lab", 3)):
        found = _sass_by_label(tool, libs[lib].path)
        seen |= set(found)
        for label, (digest, n_ins, counts) in found.items():
            parent = PARENT_SASS.get(label)
            same = ("" if parent is None else ", the parent's" if parent == digest
                    else f", NOT the parent's ({parent})")
            print(f"[build] {lib} SASS of {label}: "
                  + ", ".join(f"{op} {n}" for op, n in counts.items())
                  + f"; {n_ins} instructions, {digest}{same}")
            if counts["HMMA."] or not (counts["HGMMA"] and counts["UTMALDG"]):
                raise AssertionError(f"{label} is not a TMA + wgmma kernel: {counts}")
            if parent is not None and parent != digest:
                changed.append(label)
        if len(found) != expect:
            raise AssertionError(f"{lib}: {len(found)} wgmma kernels in its SASS, not {expect}")
    missing = set(PARENT_SASS) - seen
    if changed or missing:
        raise AssertionError(f"kernels not redesigned here compile to other code than their "
                             f"parent's: {changed}; gone: {sorted(missing)}")


# --heads 4: the flagship's width (H*D = 1024) at head width 256
H256 = dict(H=4, D=256)
# the wide heads, clusters (bf16 of ceil(D/256) CTAs, f32 of D/128):
# --heads 2 at the flagship's width (D=512, H*D = 1024), --hs 1536's width as
# 4 heads of 384 (bf16: a pair whose second CTA's upper half lies past D),
# 1 head of 1024 (f32 n = 8, the card's largest portable cluster), 1152
# (bf16 5 CTAs, the last one's upper half past D; f32 9, a non-portable
# size), 1536 (6 / 12) and --hs 2048 --heads 1 (8 / 16); past 2048 bf16
# alone: 2176 (9 CTAs, the last one's upper half past D), 3072 (12) and
# --hs 4096 --heads 1 (16, the card's largest cluster)
WIDTHS = {"h256": H256, "h384": dict(H=4, D=384), "h512": dict(H=2, D=512),
          "h1024": dict(H=1, D=1024), "h1152": dict(H=1, D=1152),
          "h1536": dict(H=1, D=1536), "h2048": dict(H=1, D=2048),
          "h2176": dict(H=1, D=2176), "h3072": dict(H=1, D=3072),
          "h4096": dict(H=1, D=4096)}
# the train shapes of a width: K1 and K2 in bf16 at S=1024, K3a and K3b in
# bf16 at S=2048, K1 and K2 in f32 at S=1024 ([train]'s and its siblings';
# --hs 2048 --heads 1 at half the batch, the same B*H*D; --hs 4096 --heads 1
# at a quarter, in bf16 alone)
TRAIN_B = {"": (32, 16, 8), "h256": (32, 16, 8), "h512": (32, 16, 8),
           "h2048": (16, 8, 4), "h4096": (8, 4, None)}


def _width(kind):
    """The (name, H and D) of a case's width tag ("h256", "h512 tp", ...):
    ("", {}) for the flagship's 8 heads of 128."""
    for tag in kind.split():
        if tag in WIDTHS:
            return tag, WIDTHS[tag]
    return "", {}


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


def _tp_flash_case(B, causal, dtype, S=1024, H=8, D=128, tp=2):
    """q, k, v as the last of ``tp`` ranks makes them under TP∘SP
    (``models/bart.py:_tp_ring``): ``tp_slice``'s row slices of q, k and v
    projections (weight and bias) applied to a (B, S, H*D) activation,
    (B, S, H/tp, D) views of the products, q scaled; the pad mask of
    :func:`_flash_case`."""
    import torch
    import torch.nn.functional as F
    from pianobart_tpu_torch.ops.ring import tp_slice
    from pianobart_tpu_torch.parallel.mesh import single_device_mesh
    g = torch.Generator(device="cuda").manual_seed(SEED + B)
    x = torch.randn(B, S, H * D, device="cuda", generator=g).to(dtype)
    n, start = H // tp * D, (tp - 1) * (H // tp) * D
    ax = single_device_mesh("cuda").axis("tp")   # the forward alone: no collective

    def proj():
        w = torch.randn(H * D, H * D, device="cuda", generator=g) * (H * D) ** -0.5
        b = torch.randn(H * D, device="cuda", generator=g) * 0.1
        y = F.linear(x, tp_slice(w, start, n, 0, ax).to(dtype),
                     tp_slice(b, start, n, 0, ax).to(dtype))
        return y.view(B, S, H // tp, D)

    q, k, v = proj() * D ** -0.5, proj(), proj()
    mask = torch.ones(B, S, device="cuda")
    mask[-1, S - 200:] = 0.0
    return q, k, v, mask


def _attn_flops(q, mask, causal, products):
    """``products`` products of 2*D FLOPs per kept (row, key) pair per head."""
    import torch
    B, S, H, D = q.shape
    if causal:   # key c is kept by the rows r >= c
        pairs = (mask * (S - torch.arange(S, device=mask.device))).sum()
    else:
        pairs = mask.sum() * S
    return products * 2.0 * D * H * float(pairs)


def _attn_bound_ms(q, mask, causal, products, arrays, row_vectors):
    """Least time for attention work on these inputs: ``products`` products
    of 2*D FLOPs per kept (row, key) pair per head, and ``arrays`` (B, S, H,
    D) arrays, ``row_vectors`` (B, H, S) f32 vectors and the mask moved
    once.  bf16 products at the bf16 tensor-core peak; f32 ones as 3xTF32,
    three tf32 products each at the tf32 peak (the least time for products
    of f32 accuracy on this card: the CUDA cores' f32 peak is slower)."""
    import torch
    from pianobart_tpu_torch.utils.flops import (PEAK_BF16_H100, PEAK_TF32_H100,
                                                 roofline_ms)
    B, S, H, D = q.shape
    flops = _attn_flops(q, mask, causal, products)
    nbytes = (arrays * q.numel() * q.element_size() + mask.numel() * 4
              + row_vectors * B * H * S * 4)
    if q.dtype == torch.bfloat16:
        return roofline_ms(flops, nbytes, PEAK_BF16_H100)
    return roofline_ms(3 * flops, nbytes, PEAK_TF32_H100)


def phase_flash(state):
    import torch
    from pianobart_tpu_torch.ops.flash import (flash_attention_fwd,
                                               flash_attention_reference,
                                               flash_attention_split)
    # Per element |dO| <= atol + rtol*|O_ref|, and |dlse| <= lse_tol.
    # bf16: the kernel rounds P to bf16 before P.V and O to bf16 at the end
    # (2^-9 relative each; rows that see few keys carry |O| up to ~4); the
    # reference keeps P in f32.  f32: 3xTF32 products (about 2^-22
    # relative), ex2.approx and the summation order.
    tol = {torch.bfloat16: (1e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}
    f32 = torch.float32
    bf16 = torch.bfloat16
    # B = 1, 2, 4 and 8 are the serving paths' decode buckets
    cases = [(1, False, torch.bfloat16, 1024), (2, False, torch.bfloat16, 1024),
             (4, False, torch.bfloat16, 1024), (8, False, torch.bfloat16, 1024),
             (1, True, torch.bfloat16, 1024), (8, True, torch.bfloat16, 1024),
             (32, False, torch.bfloat16, 1024), (32, True, torch.bfloat16, 1024),
             (16, False, torch.bfloat16, 2048), (16, True, torch.bfloat16, 2048),
             (2, False, f32, 1024), (2, True, f32, 1024), (8, False, f32, 1024),
             # [merge]'s Fisher and RegMean batches
             (4, False, f32, 1024), (4, True, f32, 1024),
             # [finetune_mesh]'s tp ranks: 4 of 8 heads, tp_slice'd projections
             (8, False, torch.bfloat16, 1024, "tp"), (8, True, torch.bfloat16, 1024, "tp"),
             (8, False, f32, 1024, "tp"), (8, True, f32, 1024, "tp"),
             # --heads 4 (D=256): [train_h256]'s shapes, the tp ranks' (2 of 4
             # heads), ragged tiles (S=320; S=192, 64 past a 128-row kv tile)
             # and a wholly masked sample
             (32, False, bf16, 1024, "h256"), (32, True, bf16, 1024, "h256"),
             (8, False, f32, 1024, "h256"), (8, True, f32, 1024, "h256"),
             (8, False, bf16, 1024, "h256 tp"), (8, True, bf16, 1024, "h256 tp"),
             (8, False, f32, 1024, "h256 tp"), (8, True, f32, 1024, "h256 tp"),
             # the bf16 decode buckets of a --heads 4 server ([train_h256]'s)
             (1, False, bf16, 1024, "h256"), (2, False, bf16, 1024, "h256"),
             (4, False, bf16, 1024, "h256"), (8, False, bf16, 1024, "h256"),
             (2, False, bf16, 192, "h256"),
             (2, False, bf16, 320, "h256"), (2, True, bf16, 320, "h256"),
             (2, False, f32, 320, "h256"), (2, True, f32, 320, "h256"),
             (2, False, bf16, 320, "h256 masked"), (2, False, f32, 320, "h256 masked"),
             # the wide heads (clusters: bf16 of 2 CTAs at 384 and 512, 4 at
             # 1024; f32 of D/128): --heads 2 (D=512) at [train_h512]'s shapes,
             # its decode bucket B=8, its tp ranks' (1 of 2 heads), S=320 and a
             # wholly masked sample; 4 heads of 384 (a half-empty CTA in bf16,
             # an odd cluster in f32); 1 head of 1024
             (32, False, bf16, 1024, "h512"), (32, True, bf16, 1024, "h512"),
             (8, False, f32, 1024, "h512"), (8, True, f32, 1024, "h512"),
             (8, False, bf16, 1024, "h512"), (16, False, bf16, 2048, "h512"),
             (8, False, bf16, 1024, "h512 tp"), (8, True, f32, 1024, "h512 tp"),
             (2, True, bf16, 320, "h512"), (2, False, bf16, 320, "h512 masked"),
             (2, False, f32, 320, "h512 masked"),
             (8, False, bf16, 1024, "h384"), (8, True, bf16, 1024, "h384"),
             (8, False, f32, 1024, "h384"),
             (4, True, bf16, 1024, "h1024"), (2, False, f32, 1024, "h1024"),
             # past 1024 (bf16 clusters of 5, 6, 8 CTAs; f32 of 9, 12, 16):
             # --hs 2048 --heads 1 at [train_h2048]'s shapes (B=16 bf16, B=4
             # f32, B=8 at S=2048) and its decode bucket B=2; 1152 and 1536
             (16, False, bf16, 1024, "h2048"), (16, True, bf16, 1024, "h2048"),
             (4, False, f32, 1024, "h2048"), (4, True, f32, 1024, "h2048"),
             (8, False, bf16, 2048, "h2048"), (2, False, bf16, 1024, "h2048"),
             (2, False, bf16, 320, "h2048 masked"), (2, True, f32, 320, "h2048"),
             (4, False, bf16, 1024, "h1152"), (4, True, bf16, 1024, "h1152"),
             (2, False, f32, 1024, "h1152"), (2, True, f32, 1024, "h1152"),
             # past 2048, bf16 alone (clusters of 9, 12, 16 CTAs, non-portable):
             # --hs 4096 --heads 1 at [train_h4096]'s shapes (B=8, B=4 at
             # S=2048) and its decode bucket B=2, S=320 and a wholly masked
             # sample; 2176 (the last CTA's upper half past D) and 3072
             (8, False, bf16, 1024, "h4096"), (8, True, bf16, 1024, "h4096"),
             (4, False, bf16, 2048, "h4096"), (2, False, bf16, 1024, "h4096"),
             (2, True, bf16, 320, "h4096"), (2, False, bf16, 320, "h4096 masked"),
             (4, False, bf16, 1024, "h2176"), (4, True, bf16, 1024, "h2176"),
             (4, False, bf16, 1024, "h3072"), (4, True, bf16, 1024, "h3072")]
    for B, causal, dtype, S, *kind in cases:
        kind = kind[0] if kind else ""
        tp = "tp" in kind
        wname, width = _width(kind)
        q, k, v, mask = (_tp_flash_case if tp else _flash_case)(
            B, causal, dtype, S=S, **width)
        if "masked" in kind:
            mask[0] = 0.0
        s0 = flash_attention_split.launches
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        torch.cuda.synchronize()
        # f32 at D = 128 and 256: one prep launch (Q's, K's and V^T's planes)
        preps = flash_attention_split.launches - s0
        if preps != (dtype == f32):
            raise AssertionError(f"K1 ran {preps} prep launches, not {int(dtype == f32)}")
        ref_out, ref_lse = flash_attention_reference(q, k, v, mask, causal)
        d_o = (out.float() - ref_out.float()).abs()
        err_o = d_o.max().item()
        err_l = (lse - ref_lse).abs().max().item()
        atol, rtol, tol_l = tol[dtype]
        ok_o = bool((d_o <= atol + rtol * ref_out.float().abs()).all())
        ms = _time_ms(lambda: flash_attention_fwd(q, k, v, mask, causal))
        plain_ms = _time_ms(lambda: flash_attention_reference(q, k, v, mask, causal),
                            iters=5)
        lib_ms = _sdpa_ms(q, k, v, mask, causal)
        bound_ms, bound_by = _attn_bound_ms(q, mask, causal, 2, 4, 1)
        tflops = _attn_flops(q, mask, causal, 2) / ms / 1e9
        name = (f"B={B} S={S} H={q.shape[2]} D={q.shape[3]} {str(dtype)[6:]} "
                f"causal={causal}" + (", sample 0 fully masked" if "masked" in kind else "")
                + (f" (tp rank 1 of 2, {2 * q.shape[2]} heads)" if tp else ""))
        if dtype == f32:
            bound_by += ", 3xTF32"
        print(f"[flash] {name}: max|dO|={err_o:.3e} (tol {atol:g} + {rtol:g}|O|) "
              f"max|dlse|={err_l:.3e} (tol {tol_l:g}) kernel {ms:.4f} ms "
              f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound), "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms")
        if not (ok_o and err_l <= tol_l and torch.isfinite(out).all()):
            raise AssertionError(f"flash kernel disagrees with its plain version: {name}")
        if kind in TRAIN_B and (B, causal, dtype, S) in (
                (TRAIN_B[kind][0], False, bf16, 1024), (TRAIN_B[kind][2], False, f32, 1024)):
            # the train shapes ([train], [train_f32]; [train_h256]'s,
            # [train_h512]'s, [train_h2048]'s)
            key = "k1" + (f"_{wname}" if wname else "") + ("_f32" if dtype == f32 else "")
            state[key] = dict(max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by.split(",")[0],
                              library_ms=lib_ms)
    _refusals()
    _sdpa_kernels("flash", ("h384", "h512", "h1024", "h2048", "h4096"))


def _refusals():
    """On CUDA tensors the kernels refuse a width past their type's
    MAX_HEAD_DIM with the type's range, and raise (no fallback): f32 past
    2048 (at 2176 and 4096), bf16 past 4096 (at 4224); K1, delta and K2's
    entry (its checks come before any launch)."""
    import torch
    from pianobart_tpu_torch.ops.flash import (flash_attention_bwd, flash_attention_delta,
                                               flash_attention_fwd)
    for dtype, D, top in ((torch.float32, 2176, 2048), (torch.float32, 4096, 2048),
                          (torch.bfloat16, 4224, 4096)):
        q, k, v, mask = _flash_case(1, False, dtype, S=256, H=1, D=D)
        lse = torch.zeros(1, 1, 256, device="cuda")
        for what, call in (("K1", lambda: flash_attention_fwd(q, k, v, mask)),
                           ("delta", lambda: flash_attention_delta(q, q)),
                           ("K2", lambda: flash_attention_bwd(q, k, v, mask, False, None, lse,
                                                              q, delta=lse))):
            try:
                call()
            except ValueError as e:
                if f"multiple of 128 up to {top}" not in str(e):
                    raise AssertionError(f"{what} refused D={D} {dtype} with {e}") from e
            else:
                raise AssertionError(f"{what} took D={D} in {dtype}")
        print(f"[flash] {str(dtype)[6:]} D={D}: K1, delta and K2 raise ValueError "
              f"(\"up to {top}\")")


def _sdpa_kernels(tag, widths, backward=False):
    """Which kernels ``scaled_dot_product_attention`` (with its backward)
    ran at each width (its flash backend stops at D=256), by name, the
    longest first, at B=8, S=1024 with the pad mask, bf16 and f32.  Last in
    a phase: the host launches more slowly after a profiler window."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for wname in widths:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = _flash_case(8, False, dtype, **WIDTHS[wname])
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(backward)
                          for x in (q, k, v))
            keep = (mask != 0)[:, None, None, :]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=1.0)
                if backward:
                    torch.autograd.grad(o, (qt, kt, vt), torch.ones_like(o))
                torch.cuda.synchronize()
            per = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
            top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
            print(f"[{tag}] sdpa{' fwd+bwd' if backward else ''} at B=8 S=1024 "
                  f"H={q.shape[2]} D={q.shape[3]} {str(dtype)[6:]} ran: "
                  + "; ".join(f"{n[:70]} ({us / 1e3:.3f} ms)" for n, us in top))
            del q, k, v, mask, qt, kt, vt, o


def _sdpa_ms(q, k, v, mask, causal):
    """Yardstick, never used by the port: ``scaled_dot_product_attention``
    with the same mask, (B, H, S, D) views of the same inputs."""
    import torch
    import torch.nn.functional as F
    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    keep = (mask != 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    return _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, scale=1.0))


def phase_lab(state):
    """L1 and L2, every variant, against their plain versions at the lab
    shape, then the port's kernel lab as this phase's main path."""
    import math
    import torch
    from pianobart_tpu_torch.ops.flash import flash_attention_reference
    from pianobart_tpu_torch.scripts import kernel_lab as lab
    # Per element |dO| <= atol + rtol*|O_ref|, and |dlse| <= 1e-3 (K1's).
    # P rounded to bf16 (L1 without upcast): K1's bf16 tolerance.  P split
    # into two bf16 halves (L1 with upcast, L2): both sides keep ~16 bits of
    # P or more and round O to bf16 once, so they differ by one bf16 step of
    # O at most (2^-7 relative), plus 1e-4 for entries near zero.  Under
    # exp2 with the f32 log2(e), lse * ln 2 must also equal K1's plain
    # natural lse (1e-3).
    B, S, D = 32, 1024, 128
    q, k, v, mask = _flash_case(B, False, torch.bfloat16)
    kt = k.reshape(*k.shape[:2], -1).transpose(1, 2).contiguous()
    kt_ms = _time_ms(lambda: k.reshape(*k.shape[:2], -1).transpose(1, 2).contiguous())
    print(f"[lab] B={B} S={S} H=8 D={D} bf16, pad tail in the last sample; "
          f"K's transpose alone (inside every kt_fwd call) {kt_ms:.4f} ms")
    variants = ([("kt_fwd", dict(upcast=u, exp2=e)) for u in (True, False)
                 for e in (False, True)]
                + [("hl_fwd", dict(exp2=e)) for e in (True, False)])
    for causal in (False, True):
        _, nat_lse = flash_attention_reference(q, k, v, mask, causal)
        bound_ms, bound_by = _attn_bound_ms(q, mask, causal, 2, 4, 1)
        lib_ms = _sdpa_ms(q, k, v, mask, causal)
        for name, kw in variants:
            fn = getattr(lab, f"{name}_lse")
            ref = getattr(lab, f"{name}_reference")
            out, lse = fn(q, k, v, mask, causal, **kw)
            torch.cuda.synchronize()
            r_out, r_lse = ref(q, k, v, mask, causal, **kw)
            split = kw.get("upcast", True)
            atol, rtol = (1e-4, 2.0 ** -7) if split else (1e-2, 1e-2)
            d_o = (out.float() - r_out.float()).abs()
            err_o = d_o.max().item()
            ok = bool((d_o <= atol + rtol * r_out.float().abs()).all())
            err_l = (lse - r_lse).abs().max().item()
            ok = ok and err_l <= 1e-3 and bool(torch.isfinite(out).all())
            nat = ""
            if kw["exp2"] and split:
                err_n = (lse * math.log(2.0) - nat_lse).abs().max().item()
                ok = ok and err_n <= 1e-3
                nat = f" max|lse*ln2 - K1 lse|={err_n:.3e} (tol 0.001)"
            ms = _time_ms(lambda: fn(q, k, v, mask, causal, **kw))
            with_kt = ""
            if name == "kt_fwd":   # the kernel alone, then with the transpose
                ms, with_kt = _time_ms(lambda: lab.kt_attention(
                    q, kt, v, mask, causal, **kw)), f" ({ms:.4f} ms with K's transpose)"
            plain_ms = _time_ms(lambda: ref(q, k, v, mask, causal, **kw),
                                iters=3, warmup=1)
            opts = " ".join(f"{o}={int(x)}" for o, x in kw.items())
            label = f"{name} {opts} causal={int(causal)}"
            print(f"[lab] {label}: max|dO|={err_o:.3e} (tol {atol:g} + {rtol:g}|O|) "
                  f"max|dlse|={err_l:.3e} (tol 0.001){nat} kernel {ms:.4f} ms{with_kt}, "
                  f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
                  f"sdpa {lib_ms:.4f} ms")
            if not ok:
                raise AssertionError(f"{label} disagrees with its plain version")
            if not causal and kw in (dict(upcast=True, exp2=False), dict(exp2=True)):
                state["kt" if name == "kt_fwd" else "hl"] = dict(
                    max_abs_err=err_o, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)
            del out, lse, r_out, r_lse, d_o
    del q, k, v, kt, mask, nat_lse
    torch.cuda.empty_cache()

    def check(what, q, k, v, mask, causal):
        """Every variant against its plain version; the largest |dO|."""
        errs = []
        for name, kw in variants:
            out, lse = getattr(lab, f"{name}_lse")(q, k, v, mask, causal, **kw)
            r_out, r_lse = getattr(lab, f"{name}_reference")(q, k, v, mask, causal, **kw)
            atol, rtol = (1e-4, 2.0 ** -7) if kw.get("upcast", True) else (1e-2, 1e-2)
            d_o = (out.float() - r_out.float()).abs()
            errs.append(d_o.max().item())
            if not (bool((d_o <= atol + rtol * r_out.float().abs()).all())
                    and (lse - r_lse).abs().max().item() <= 1e-3
                    and bool(torch.isfinite(out).all())):
                raise AssertionError(f"{name} {kw} causal={causal} disagrees on {what}")
        return max(errs)

    # rows with no kept key: every key of sample 0 masked, the first kv tile
    # of sample 1; O and lse as the plain version's -1e30 sentinel gives them
    for S in (256, 320):
        q, k, v, mask = _flash_case(2, False, torch.bfloat16, S=S)
        mask[0] = 0.0
        mask[1] = 1.0
        mask[1, :80] = 0.0
        err = check("fully masked rows", q, k, v, mask, False)
        print(f"[lab] fully masked rows (B=2 S={S}, sample 0 all masked, sample 1 its "
              f"first 80 keys), every variant: max|dO| {err:.3e}")

    # ragged tiles: lengths 64 past a multiple of K1's 128-row tiles (rows past
    # Sq not stored, keys past Skv TMA's zeros, under KT a whole box of them)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for Sq, Skv in ((320, 320), (192, 320)):
        q = (torch.randn(2, Sq, 8, D, device="cuda", generator=g) * D ** -0.5).bfloat16()
        k, v = (torch.randn(2, Skv, 8, D, device="cuda", generator=g).bfloat16()
                for _ in range(2))
        mask = torch.ones(2, Skv, device="cuda")
        mask[1, Skv - 40:] = 0.0
        errs = [check(f"Sq={Sq} Skv={Skv}", q, k, v, mask, causal) for causal in (False, True)]
        print(f"[lab] ragged tiles B=2 Sq={Sq} Skv={Skv} H=8, every variant, causal and "
              f"not: max|dO| {max(errs):.3e}")

    # main path: the lab's own program, as `PBX_LAB_KT=1 python -m
    # pianobart_tpu_torch.scripts.kernel_lab` runs it
    _reset_counts()
    t0 = time.perf_counter()
    res = lab.main(device="cuda", kt=True)
    torch.cuda.synchronize()
    counts = _read_counts()
    state.setdefault("launches", {})["lab"] = counts
    print(f"[lab] kernel_lab.main(kt=True) in {time.perf_counter() - t0:.1f} s; "
          f"launches ({COUNT_NAMES}) {tuple(counts.values())}")
    if not (counts["kt_fwd"] and counts["hl_fwd"] and counts["flash_attention_fwd"]):
        raise AssertionError(f"the lab did not launch every kernel: {counts}")
    if len(res["checks"]) != 4 or len(res["sweeps"]) != 2:
        raise AssertionError(f"the lab ran {res['checks']}, {len(res['sweeps'])} sweeps")


def _bwd_errors(got, want, tol):
    """Per output max |d| and ||d||/||ref||, and whether every output holds
    |d| <= atol*max|ref| + rtol*|ref|, ||d|| <= ntol*||ref|| and is finite."""
    import torch
    atol, rtol, ntol = tol
    errs, rels, ok = [], [], True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        errs.append(d.max().item())
        rels.append((d.norm() / b.norm()).item())
        ok = ok and bool((d <= atol * b.abs().max() + rtol * b.abs()).all())
        ok = ok and rels[-1] <= ntol and bool(torch.isfinite(a).all())
    return errs, rels, ok


def _sdpa_bwd_ms(q, k, v, mask, causal, dout):
    """Yardstick, never used by the port: SDPA's forward+backward minus its
    forward, with the same mask."""
    import torch
    import torch.nn.functional as F
    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    keep = (mask != 0)[:, None, None, :]
    if causal:
        keep = keep & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    dot = dout.transpose(1, 2)

    def sdpa_fb():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=1.0)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_f():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep, scale=1.0)
    return _time_ms(sdpa_fb, iters=5) - _time_ms(sdpa_f, iters=5)


def phase_flash_bwd(state):
    """K2 against flash_attention_bwd_reference at the flagship train shape,
    K3a and K3b against their plain versions at the long-context shape, and
    at each case the delta kernel against its plain version."""
    import torch
    from pianobart_tpu_torch.ops.flash import (
        _delta, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_delta, flash_attention_dkv, flash_attention_dkv_reference,
        flash_attention_dq, flash_attention_dq_reference, flash_attention_fwd,
        flash_attention_split, flash_attention_split_reference)
    from pianobart_tpu_torch.utils.flops import PEAK_F32_H100, roofline_ms
    # Per element |d| <= atol*max|ref| + rtol*|ref|, and per output ||d|| <=
    # ntol*||ref||.  bf16: the kernel rounds P and dS to bf16 as product
    # operands and dQ/dK/dV to bf16 at the end (2^-9 relative each) where the
    # plain version keeps f32; dQ = dS K sums terms of both signs (each row of
    # dS sums to zero), so an entry can be far smaller than the terms whose
    # rounding it carries, hence the part that scales with the tensor's
    # largest entry.  That part is loose for the bulk of the rows (the largest
    # entries sit in rows that see few keys), so the norm check holds the
    # whole tensor: a lost kv tile or a coarser dS moves it far past 1e-2.
    # f32: 3xTF32 products (about 2^-22 relative), ex2.approx and summation
    # order.  K3a and K3b are the same CUDA kernels as K2 behind their own
    # entries: the same tolerances.
    tol = {torch.bfloat16: (1e-2, 1e-2, 1e-2), torch.float32: (1e-5, 1e-5, 1e-5)}
    # the last field masks every key of sample 0 (its lse is the -1e30
    # sentinel, so P is 1 on every key); S=320 leaves the last 128-row CTA
    # of each kernel half past S
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("K2", 32, 1024, False, bf16, False), ("K2", 32, 1024, True, bf16, False),
             ("K2", 8, 1024, False, bf16, False), ("K2", 8, 1024, True, bf16, False),
             ("K2", 2, 1024, False, f32, False), ("K2", 2, 1024, True, f32, False),
             ("K2", 8, 1024, False, f32, False),
             ("K2", 4, 1024, False, f32, False), ("K2", 4, 1024, True, f32, False),
             ("K2", 2, 320, False, bf16, False), ("K2", 2, 320, True, bf16, False),
             ("K2", 2, 320, False, bf16, True), ("K2", 2, 320, False, f32, False),
             ("K2", 2, 320, False, f32, True),
             ("K3", 16, 2048, False, bf16, False), ("K3", 16, 2048, True, bf16, False),
             ("K3", 2, 2048, False, f32, False), ("K3", 2, 2048, True, f32, False),
             ("K3", 2, 320, False, bf16, False), ("K3", 2, 320, True, bf16, False),
             ("K3", 2, 320, False, bf16, True),
             # [finetune_mesh]'s tp ranks: 4 of 8 heads, tp_slice'd projections
             ("K2", 8, 1024, False, bf16, False, "tp"), ("K2", 8, 1024, True, bf16, False, "tp"),
             ("K2", 8, 1024, False, f32, False, "tp"), ("K2", 8, 1024, True, f32, False, "tp"),
             # --heads 4 (D=256): [train_h256]'s shapes (K2 at B=32 bf16 and
             # B=8 f32, K3 at B=16 S=2048 bf16 and B=2 f32), the tp ranks' (2 of
             # 4 heads), ragged tiles and a wholly masked sample
             ("K2", 32, 1024, False, bf16, False, "h256"), ("K2", 32, 1024, True, bf16, False, "h256"),
             ("K2", 8, 1024, False, f32, False, "h256"), ("K2", 8, 1024, True, f32, False, "h256"),
             ("K3", 16, 2048, False, bf16, False, "h256"), ("K3", 16, 2048, True, bf16, False, "h256"),
             ("K3", 2, 2048, False, f32, False, "h256"), ("K3", 2, 2048, True, f32, False, "h256"),
             ("K2", 8, 1024, False, bf16, False, "h256 tp"),
             ("K2", 8, 1024, True, bf16, False, "h256 tp"),
             ("K2", 8, 1024, False, f32, False, "h256 tp"),
             ("K2", 8, 1024, True, f32, False, "h256 tp"),
             ("K2", 2, 320, False, bf16, False, "h256"), ("K2", 2, 320, True, bf16, False, "h256"),
             ("K2", 2, 320, False, bf16, True, "h256"), ("K2", 2, 320, False, f32, False, "h256"),
             ("K2", 2, 320, False, f32, True, "h256"),
             ("K3", 2, 320, False, bf16, False, "h256"), ("K3", 2, 320, True, bf16, False, "h256"),
             ("K3", 2, 320, False, bf16, True, "h256"), ("K3", 2, 320, True, f32, False, "h256"),
             ("K3", 2, 320, False, f32, True, "h256"),
             # the wide heads (bf16 clusters of ceil(D/256) CTAs of the D=256
             # design, f32 of D/128 CTAs, two warpgroups a CTA): --heads 2 (D=512) at
             # [train_h512]'s shapes (K2 B=32 bf16 and B=8 f32, K3 B=16 S=2048
             # bf16 and B=2 f32), its tp ranks' (1 of 2 heads), S=320 and a
             # wholly masked sample; 4 heads of 384; 1 head of 1024
             ("K2", 32, 1024, False, bf16, False, "h512"), ("K2", 32, 1024, True, bf16, False, "h512"),
             ("K2", 8, 1024, False, f32, False, "h512"), ("K2", 8, 1024, True, f32, False, "h512"),
             ("K3", 16, 2048, False, bf16, False, "h512"), ("K3", 16, 2048, True, bf16, False, "h512"),
             ("K3", 2, 2048, False, f32, False, "h512"), ("K3", 2, 2048, True, f32, False, "h512"),
             ("K2", 8, 1024, True, bf16, False, "h512 tp"),
             ("K2", 8, 1024, False, f32, False, "h512 tp"),
             ("K2", 2, 320, True, bf16, False, "h512"), ("K2", 2, 320, False, bf16, True, "h512"),
             ("K2", 2, 320, False, f32, True, "h512"), ("K3", 2, 320, True, f32, False, "h512"),
             ("K3", 2, 320, False, bf16, True, "h512"),
             ("K2", 8, 1024, False, bf16, False, "h384"), ("K2", 8, 1024, True, bf16, False, "h384"),
             ("K2", 8, 1024, False, f32, False, "h384"), ("K3", 2, 2048, True, bf16, False, "h384"),
             ("K2", 4, 1024, True, bf16, False, "h1024"), ("K2", 2, 1024, False, f32, False, "h1024"),
             # past 1024 (bf16 clusters of 5, 6, 8 CTAs; f32 of 9, 12, 16):
             # --hs 2048 --heads 1 at [train_h2048]'s shapes (K2 B=16 bf16 and
             # B=4 f32, K3 B=8 S=2048 bf16), S=320 and a wholly masked sample;
             # 1152 (bf16: the last CTA's upper half past D) and 1536
             ("K2", 16, 1024, False, bf16, False, "h2048"), ("K2", 16, 1024, True, bf16, False, "h2048"),
             ("K2", 4, 1024, False, f32, False, "h2048"), ("K2", 4, 1024, True, f32, False, "h2048"),
             ("K3", 8, 2048, False, bf16, False, "h2048"), ("K3", 8, 2048, True, bf16, False, "h2048"),
             ("K2", 2, 320, False, bf16, True, "h2048"), ("K3", 2, 320, True, f32, False, "h2048"),
             ("K2", 4, 1024, False, bf16, False, "h1152"), ("K2", 4, 1024, True, bf16, False, "h1152"),
             ("K2", 2, 1024, False, f32, False, "h1152"), ("K2", 2, 1024, True, f32, False, "h1152"),
             ("K3", 2, 2048, True, bf16, False, "h1152"),
             # past 2048, bf16 alone (clusters of 9, 12, 16 CTAs):
             # --hs 4096 --heads 1 at [train_h4096]'s shapes (K2 B=8, K3 B=4
             # S=2048), S=320 and a wholly masked sample; 2176 and 3072
             ("K2", 8, 1024, False, bf16, False, "h4096"), ("K2", 8, 1024, True, bf16, False, "h4096"),
             ("K3", 4, 2048, False, bf16, False, "h4096"), ("K3", 4, 2048, True, bf16, False, "h4096"),
             ("K2", 2, 320, False, bf16, True, "h4096"), ("K3", 2, 320, True, bf16, False, "h4096"),
             ("K2", 4, 1024, False, bf16, False, "h2176"), ("K2", 4, 1024, True, bf16, False, "h2176"),
             ("K3", 2, 2048, True, bf16, False, "h2176"),
             ("K2", 4, 1024, False, bf16, False, "h3072"), ("K2", 4, 1024, True, bf16, False, "h3072")]
    for kid, B, S, causal, dtype, masked, *kind in cases:
        kind = kind[0] if kind else ""
        tp = "tp" in kind
        wname, width = _width(kind)
        q, k, v, mask = (_tp_flash_case if tp else _flash_case)(
            B, causal, dtype, S=S, **width)
        mask[0, S - 300:] = 0.0      # a second pad tail
        if masked:
            mask[0] = 0.0
        out, lse = flash_attention_fwd(q, k, v, mask, causal)
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
        name = (f"{kid} B={B} S={S} H={q.shape[2]} D={q.shape[3]} {str(dtype)[6:]} "
                f"causal={causal}" + (", sample 0 fully masked" if masked else "")
                + (f" (tp rank 1 of 2, {2 * q.shape[2]} heads)" if tp else ""))
        # delta: both sides sum exact f32 products, in another order
        got_d, want_d = flash_attention_delta(dout, out), _delta(dout, out)
        torch.cuda.synchronize()
        err_d = (got_d - want_d).abs().max().item()
        ok_d = bool(torch.isclose(got_d, want_d, atol=1e-4, rtol=1e-5).all())
        d_ms = _time_ms(lambda: flash_attention_delta(dout, out))
        d_plain = _time_ms(lambda: _delta(dout, out))
        # dO and O read once, delta written; a multiply-add per element
        d_bound = roofline_ms(2.0 * dout.numel(), 2 * dout.numel() * dout.element_size()
                              + want_d.numel() * 4, PEAK_F32_H100)
        print(f"[flash_bwd] delta {name}: max|d| {err_d:.3e} (tol 1e-4 + 1e-5|ref|), "
              f"kernel {d_ms:.4f} ms, bound {d_bound[0]:.4f} ms ({d_bound[1]}), "
              f"plain {d_plain:.4f} ms")
        if not ok_d:
            raise AssertionError(f"the delta kernel disagrees with its plain version: {name}")
        if kind in TRAIN_B and (kid, B, causal, dtype, masked) == (
                "K2", TRAIN_B[kind][0], False, bf16, False):
            state["delta" + (f"_{wname}" if wname else "")] = dict(
                max_abs_err=err_d, ms=d_ms, plain_ms=d_plain, bound_ms=d_bound[0],
                bound_by=d_bound[1], library_ms=None)
        del got_d, want_d
        if dtype == f32 and not causal:
            train = kind in TRAIN_B and (kid, B, S, masked) == ("K2", TRAIN_B[kind][2],
                                                                1024, False)
            _split_row(state, name, q, ("split" + (f"_{wname}" if wname else "")) if train
                       else None, flash_attention_split, flash_attention_split_reference)
        s0 = flash_attention_split.launches
        if kid == "K2":
            got = flash_attention_bwd(q, k, v, mask, causal, out, lse, dout)
        else:
            delta = _delta(dout, out)
            args = (q, k, v, mask, causal, lse, delta, dout)
            got = (flash_attention_dq(*args), *flash_attention_dkv(*args))
        torch.cuda.synchronize()
        # f32 at D = 128 and 256: one prep launch a backward entry (K2; K3a, K3b)
        preps = flash_attention_split.launches - s0
        want_preps = (dtype == f32) * (1 if kid == "K2" else 2)
        if preps != want_preps:
            raise AssertionError(f"{kid} ran {preps} prep launches, not {want_preps}")
        if kid == "K2":
            want = flash_attention_bwd_reference(q, k, v, mask, causal, out, lse, dout)
            errs, rels, ok = _bwd_errors(got, want, tol[dtype])
            del want
            ms = [_time_ms(lambda: flash_attention_bwd(q, k, v, mask, causal, out,
                                                       lse, dout), iters=10)]
            plain_ms = [_time_ms(lambda: flash_attention_bwd_reference(
                q, k, v, mask, causal, out, lse, dout), iters=3, warmup=1)]
            # S, dP, dV, dQ, dK; q, k, v, dO read and dQ, dK, dV written; lse, delta
            bounds = [_attn_bound_ms(q, mask, causal, 5, 7, 2)]
        else:
            want = (flash_attention_dq_reference(*args),
                    *flash_attention_dkv_reference(*args))
            errs, rels, ok = _bwd_errors(got, want, tol[dtype])
            del want
            ms = [_time_ms(lambda: flash_attention_dq(*args), iters=10),
                  _time_ms(lambda: flash_attention_dkv(*args), iters=10)]
            plain_ms = [_time_ms(lambda: flash_attention_dq_reference(*args),
                                 iters=3, warmup=1),
                        _time_ms(lambda: flash_attention_dkv_reference(*args),
                                 iters=3, warmup=1)]
            # K3a: S, dP, dQ; q, k, v, dO read, dQ written.  K3b: S, dP, dV,
            # dK; q, k, v, dO read, dK, dV written.  Both read lse and delta.
            bounds = [_attn_bound_ms(q, mask, causal, 3, 5, 2),
                      _attn_bound_ms(q, mask, causal, 4, 6, 2)]
        lib_ms = _sdpa_bwd_ms(q, k, v, mask, causal, dout)
        atol, rtol, ntol = tol[dtype]
        times = ", ".join(
            f"{part}kernel {t:.4f} ms, bound {bm:.4f} ms ({bb}), plain {p:.4f} ms"
            for part, t, (bm, bb), p in zip(
                ["", ""] if kid == "K2" else ["K3a ", "K3b "], ms, bounds, plain_ms))
        print(f"[flash_bwd] {name}: max|d| dq {errs[0]:.3e} dk {errs[1]:.3e} "
              f"dv {errs[2]:.3e} (tol {atol:g}*max|ref| + {rtol:g}|ref|), "
              f"||d||/||ref|| dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} "
              f"(tol {ntol:g}), {times}, sdpa bwd {lib_ms:.4f} ms")
        if not ok:
            raise AssertionError(f"{kid} disagrees with its plain version: {name}")
        if kind in TRAIN_B and (B, causal, dtype, masked) in (
                (TRAIN_B[kind][0], False, bf16, False), (TRAIN_B[kind][1], False, bf16, False),
                (TRAIN_B[kind][2], False, f32, False)):
            # the train shapes ([train], [train_long], [train_f32]; [train_h256]'s,
            # [train_h512]'s and [train_h2048]'s)
            keys = (["k2" if dtype == bf16 else "k2_f32"] if kid == "K2"
                    else ["k3a", "k3b"])
            if wname:
                keys = [f"k2_{wname}_f32" if key == "k2_f32" else f"{key}_{wname}"
                        for key in keys]
            err_of = [max(errs)] if kid == "K2" else [errs[0], max(errs[1:])]
            for key, e, t, (bm, bb), p in zip(keys, err_of, ms, bounds, plain_ms):
                state[key] = dict(max_abs_err=e, ms=t, plain_ms=p, bound_ms=bm,
                                  bound_by=bb, library_ms=lib_ms)
        del q, k, v, out, lse, dout, got
        torch.cuda.empty_cache()
    # The D=256 bf16 calls of [train_h256] (K2) and its S=2048 step (K3a, K3b)
    # by kernel: delta, dK/dV, dQ, and the same of [train_h512] (D=512, the
    # clusters).  Last, as the host launches more slowly after a profiler
    # window, and the small rows above are host bound.
    for kid, B, S, wname in (("K2", 32, 1024, "h256"), ("K3", 16, 2048, "h256"),
                             ("K2", 32, 1024, "h512"), ("K3", 16, 2048, "h512"),
                             ("K2", 16, 1024, "h2048"), ("K3", 8, 2048, "h2048"),
                             ("K2", 8, 1024, "h4096"), ("K3", 4, 2048, "h4096")):
        q, k, v, mask = _flash_case(B, False, bf16, S=S, **WIDTHS[wname])
        mask[0, S - 300:] = 0.0
        out, lse = flash_attention_fwd(q, k, v, mask, False)
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        dout = torch.randn(out.shape, device="cuda", generator=g).to(bf16)
        if kid == "K2":
            def call():
                flash_attention_bwd(q, k, v, mask, False, out, lse, dout)
        else:
            args = (q, k, v, mask, False, lse, _delta(dout, out), dout)

            def call():
                flash_attention_dq(*args)
                flash_attention_dkv(*args)
        call()
        kern = "d256_wgmma_kernel<{}, " + ("false>" if wname == "h256" else "true>")
        _profile_window("flash_bwd", f"5 calls of {kid} B={B} S={S} H={q.shape[2]} "
                        f"D={q.shape[3]} bfloat16", lambda: [call() for _ in range(5)], 5,
                        groups={"delta": lambda n: "flash_delta" in n,
                                "dK/dV": lambda n: kern.format("true") in n,
                                "dQ": lambda n: kern.format("false") in n})
        del q, k, v, mask, out, lse, dout
        torch.cuda.empty_cache()
    _sdpa_kernels("flash_bwd", ("h384", "h512", "h1024", "h2048", "h4096"), backward=True)


def _split_row(state, name, x, key, split, reference):
    """The f32 kernels' prep on ``x`` (natural and transposed planes, as the
    backward asks for q) against its plain version, bit for bit, with its
    times and bytes bound (x read once, four planes written once); kept
    under ``state[key]`` unless ``key`` is None."""
    import torch
    from pianobart_tpu_torch.utils.flops import PEAK_F32_H100, roofline_ms
    got, want = split(x, True, True), reference(x, True, True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = _time_ms(lambda: split(x, True, True))
    plain_ms = _time_ms(lambda: reference(x, True, True), iters=5)
    bound = roofline_ms(6.0 * x.numel(), 5 * x.numel() * 4, PEAK_F32_H100)
    print(f"[flash_bwd] tf32 split of q ({name}): planes equal to the plain "
          f"version's: {same} (tol: equal), kernel {ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}), plain {plain_ms:.4f} ms")
    if not same:
        raise AssertionError(f"the tf32 split kernel disagrees with its plain version: {name}")
    if key:
        state[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], library_ms=None)


def _ln_bound_ms(N, D, itemsize, backward):
    """Least time for K4a (or K4b) on N rows of D: each input read once and
    each output written once, about 10 (20) f32 operations per element."""
    from pianobart_tpu_torch.utils.flops import PEAK_F32_H100, roofline_ms
    rows = N * D * itemsize
    if backward:   # h, residual, dout in, dh, dres out; gamma, mean, rstd in;
        #            dgamma, dbeta out; the seed
        return roofline_ms(20.0 * N * D, 5 * rows + 3 * D * 4 + 2 * N * 4 + 8,
                           PEAK_F32_H100)
    # h, residual in, out out; gamma, beta in; mean, rstd out; the seed
    return roofline_ms(10.0 * N * D, 3 * rows + 2 * D * 4 + 2 * N * 4 + 8,
                       PEAK_F32_H100)


def phase_fused_ln(state):
    """K4a and K4b against their plain versions fed the same Philox bits."""
    import torch
    from pianobart_tpu_torch.ops import fused_ln as FL
    # The keep decisions must agree exactly: the kernel's are dh != 0, the
    # plain version's the bits of philox_bits (dy is never exactly 0 here).
    # Then per element |d| <= atol*max|ref| + rtol*|ref| and per output
    # ||d|| <= ntol*||ref||.  bf16: out, dh and dres round to bf16 on both
    # sides and round apart by one step (2^-8 relative) where the f32 values
    # differ by an ulp (rsqrtf, summation order); dgamma and dbeta are f32
    # sums over the rows in another order (8 rows per warp, 8 warps, then
    # one partial per 64 rows).  f32: rsqrtf and summation order only.
    tol = {torch.bfloat16: (1e-2, 1e-2, 5e-3), torch.float32: (1e-4, 1e-4, 1e-5)}
    rate = 0.1
    # the flagship's rows, then rows wider than one warp takes (split across
    # 2, 2 and 8 warps), the width of a d_model-2048 model in f32 too
    bf16, f32 = torch.bfloat16, torch.float32
    for N, D, dtype in ((32768, 1024, bf16), (256, 1024, f32), (8192, 1152, bf16),
                        (8192, 2048, bf16), (8192, 8192, bf16), (8192, 2048, f32)):
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        h, res, dout = (torch.randn(N, D, device="cuda", generator=g).to(dtype)
                        for _ in range(3))
        gamma = 1.0 + 0.1 * torch.randn(D, device="cuda", generator=g)
        beta = 0.1 * torch.randn(D, device="cuda", generator=g)
        seed = torch.randint(0, 2 ** 63 - 1, (1,), dtype=torch.int64,
                             device="cuda", generator=g)
        out, mean, rstd = FL.dropout_add_ln_fwd(h, res, gamma, beta, seed, rate)
        grads = FL.dropout_add_ln_bwd(h, res, gamma, mean, rstd, dout, seed, rate)
        torch.cuda.synchronize()
        bits = FL.philox_bits(seed, N, D)
        keep_diff = int(((grads[0] != 0) != (bits >= FL.threshold(rate))).sum())
        r_out, r_mean, r_rstd = FL.dropout_add_ln_reference(h, res, gamma, beta,
                                                            seed, rate, bits=bits)
        r_grads = FL.dropout_add_ln_bwd_reference(h, res, gamma, r_mean, r_rstd,
                                                  dout, seed, rate, bits=bits)
        errs, rels, ok = _bwd_errors((out, *grads), (r_out, *r_grads), tol[dtype])
        ok = ok and keep_diff == 0
        del bits, r_out, r_grads
        ms = [_time_ms(lambda: FL.dropout_add_ln_fwd(h, res, gamma, beta, seed, rate)),
              _time_ms(lambda: FL.dropout_add_ln_bwd(h, res, gamma, mean, rstd, dout,
                                                     seed, rate))]
        plain_ms = [
            _time_ms(lambda: FL.dropout_add_ln_reference(h, res, gamma, beta, seed,
                                                         rate), iters=5),
            _time_ms(lambda: FL.dropout_add_ln_bwd_reference(
                h, res, gamma, mean, rstd, dout, seed, rate), iters=5)]
        bounds = [_ln_bound_ms(N, D, h.element_size(), b) for b in (False, True)]
        atol, rtol, ntol = tol[dtype]
        name = f"N={N} D={D} {str(dtype)[6:]} rate={rate}"
        outs = ("out", "dh", "dres", "dgamma", "dbeta")
        print(f"[fused_ln] {name}: keep decisions differing {keep_diff} (tol 0); "
              f"max|d| " + " ".join(f"{o} {e:.3e}" for o, e in zip(outs, errs))
              + f" (tol {atol:g}*max|ref| + {rtol:g}|ref|); ||d||/||ref|| "
              + " ".join(f"{o} {r:.3e}" for o, r in zip(outs, rels))
              + f" (tol {ntol:g})")
        for kid, t, (bm, bb), p in zip(("K4a", "K4b"), ms, bounds, plain_ms):
            print(f"[fused_ln] {name}: {kid} kernel {t:.4f} ms, bound {bm:.4f} ms "
                  f"({bb}), plain {p:.4f} ms, library: none (no single PyTorch "
                  f"call computes it)")
        if not ok:
            raise AssertionError(f"K4 disagrees with its plain version: {name}")
        if (N, D, dtype) == (32768, 1024, bf16):   # the flagship train shape
            for key, e, t, (bm, bb), p in zip(("k4a", "k4b"), (errs[0], max(errs[1:])),
                                              ms, bounds, plain_ms):
                state[key] = dict(max_abs_err=e, ms=t, plain_ms=p, bound_ms=bm,
                                  bound_by=bb, library_ms=None)
        del h, res, dout, out, grads
        torch.cuda.empty_cache()


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


def _encoder_vs_plain(tag, model, rng):
    """The encoder of a serving model through K1 against the same weights on
    the plain attention path, on two intros."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartLM
    from pianobart_tpu_torch.models.pianobart import attention_mask_from_bars
    cfg = model.cfg
    plain = PianoBartLM(cfg.replace(use_flash_attention=False), device="cuda").eval()
    plain.load_state_dict(model.state_dict())
    ids = torch.as_tensor(np.stack(_intros(2, cfg.max_len, rng)), device="cuda")
    mask = attention_mask_from_bars(ids)
    _reset_counts()
    with torch.inference_mode():
        e_flash = model.encode(ids, mask).float()
        launches = _read_counts()["flash_attention_fwd"]
        e_plain = plain.encode(ids, mask).float()
    del plain
    rows = mask.bool()
    diff = e_flash[rows] - e_plain[rows]
    err = diff.abs().max().item()
    rel = (diff.norm() / e_plain[rows].norm()).item()
    # both paths round to bf16 at different places (scores, P) in each of 8
    # layers of unit-scale LayerNorm outputs
    print(f"[{tag}] encoder via K1 ({launches} launches) vs plain attention (bf16, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, non-pad rows): max|d|={err:.3e} "
          f"(tol 0.5), |d|/|plain|={rel:.3e} (tol 2e-2)")
    if not (err <= 0.5 and rel <= 2e-2 and torch.isfinite(e_flash).all()
            and launches == cfg.encoder_layers):
        raise AssertionError("encoder output through K1 disagrees")


def phase_serve(state):
    import numpy as np
    import torch
    from pianobart_tpu_torch import vocab as V
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.decode import generate
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.ops.flash import flash_attention_fwd
    from pianobart_tpu_torch.serve.app import GenerationService

    # serving holds bf16 weights, as GenerationService's default does
    cfg = PianoBartConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()   # the kernel checks before are larger
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
    _encoder_vs_plain("serve", model, rng)

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
    _reset_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    state.setdefault("launches", {})["serve"] = _read_counts()
    launches = flash_attention_fwd.launches
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
    state["serve_model"] = model   # [serve_http] serves the same weights


def _where_time_goes(model, x, S, steps=64):
    """Breakdown of one batch-8 decode batch: the encoder (with K1's share)
    by CUDA events, and a profiled window of decode steps for the device's
    busy share and its heaviest kernels."""
    import torch
    from pianobart_tpu_torch.decode import generate
    from pianobart_tpu_torch.models.pianobart import attention_mask_from_bars
    mask = attention_mask_from_bars(x)
    with torch.inference_mode():
        enc_ms = _time_ms(lambda: model.encode(x, mask), iters=5)
    print(f"[where] B={x.shape[0]} encoder pass {enc_ms:.3f} ms "
          f"(8 K1 launches inside)")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    generate(model, x, generator=gen, force_full=True, max_steps=8, device="cuda")
    _profile_window("where", f"{steps} decode steps (encoder included) at B={x.shape[0]}",
                    lambda: generate(model, x, generator=gen, force_full=True,
                                     max_steps=steps, device="cuda"), steps)


def _profile_window(tag, what, fn, steps, groups=None):
    """Run ``fn`` (``steps`` steps) under torch.profiler: the device's busy
    share of the wall time, device ops per step, the heaviest kernels, and
    the device time of each of ``groups`` ({label: predicate on a kernel's
    name})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, busy_us = {}, 0.0
    for e in prof.events():
        # a user annotation on the device's timeline (the optimizer's
        # "Optimizer.step#AdamW.step") spans kernels that are counted anyway
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            busy_us += us
            n, t = per_name.get(e.name, (0, 0.0))
            per_name[e.name] = (n + 1, t + us)
    if not per_name:
        print(f"[{tag}] profiler saw no device events: busy share not measured")
        return None
    n_kernels = sum(n for n, _ in per_name.values())
    busy = busy_us / 1e6 / wall
    print(f"[{tag}] profiled {what}: wall {wall:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s ({100 * busy:.1f}%, idle {100 - 100 * busy:.1f}%), "
          f"{n_kernels} device ops = {n_kernels / steps:.0f} per step; "
          f"wall per step {1e3 * wall / steps:.2f} ms under the profiler")
    for name, (n, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms  x{n:<6d} {name[:90]}")
    for label, pick in (groups or {}).items():
        us = sum(t for name, (_, t) in per_name.items() if pick(name))
        print(f"[{tag}] {label}: {us / 1e3:.3f} ms of the busy time "
              f"({100 * us / busy_us:.1f}%), {us / 1e3 / steps:.3f} ms per step")
    return busy


def _song(rng, n_notes=300):
    """A two-track piano song (melody over a bass line, 4/4 then 3/4, two
    tempos) as the port's MidiFile."""
    from pianobart_tpu_torch.midi import (Instrument, MidiFile, Note, TempoChange,
                                          TimeSignature)
    song = MidiFile(ticks_per_beat=480)
    song.tempo_changes = [TempoChange(tempo=float(rng.integers(70, 160)), time=0),
                          TempoChange(tempo=float(rng.integers(70, 160)), time=480 * 64)]
    song.time_signature_changes = [TimeSignature(4, 4, 0), TimeSignature(3, 4, 480 * 128)]
    for program, lo, hi, name in ((0, 60, 96, "MELODY"), (32, 28, 60, "PIANO")):
        inst, tick = Instrument(program=program, name=name), 0
        for _ in range(n_notes):
            dur = int(rng.choice([120, 240, 360, 480, 960]))
            inst.notes.append(Note(velocity=int(rng.integers(40, 120)),
                                   pitch=int(rng.integers(lo, hi)),
                                   start=tick, end=tick + dur))
            tick += int(rng.choice([120, 240, 240, 480]))
        song.instruments.append(inst)
    return song


def _wsgi(app, method, path, body=b"", ctype=None):
    """One WSGI call: (status, headers, body bytes)."""
    import io
    got = {}
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path,
               "wsgi.input": io.BytesIO(body), "CONTENT_LENGTH": str(len(body))}
    if ctype:
        environ["CONTENT_TYPE"] = ctype
    out = b"".join(app(environ, lambda status, headers: got.update(
        status=status, headers=dict(headers))))
    return got["status"], got["headers"], out


def _check_answer(app, status, body, written):
    """A generate answer is a 200 whose MIDI downloads, parses back and is
    one decoded grid cleaned and written, or the JAX App's 500 for an empty
    continuation; anything else fails."""
    from pianobart_tpu_torch.midi import read_midi_bytes
    j = json.loads(body)
    if status == "500 Internal Server Error":
        if j != {"error": "generation produced no notes"}:
            raise AssertionError(f"unexpected 500 body {j}")
        return "500", None
    if status != "200 OK":
        raise AssertionError(f"generate answered {status}: {j}")
    st, _, blob = _wsgi(app, "GET", f"/api/outputs/{j['file']}")
    if st != "200 OK":
        raise AssertionError(f"output {j['file']} does not download: {st}")
    n_notes = sum(len(i.notes) for i in read_midi_bytes(blob).instruments)
    if n_notes == 0 or blob not in written():
        raise AssertionError(f"output {j['file']} is not a cleaned decoded grid")
    return "200", j


def phase_serve_http(state):
    """The MIDI-file serving path on the card: uploads and concurrent
    generate requests through the port's WSGI ``App`` (random flagship
    weights, [serve]'s model), one request over a localhost socket, then
    the demo CLI in process."""
    import contextlib
    import io
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.midi import midi_bytes, read_midi
    from pianobart_tpu_torch.ops.flash import flash_attention_fwd
    from pianobart_tpu_torch.serve.app import App, GenerationService
    from pianobart_tpu_torch.serve.demo import window_to_midi

    model = state.pop("serve_model")
    retries = int(os.environ.setdefault("PBX_DEMO_RETRIES", "4"))
    here = os.getcwd()
    work = tempfile.mkdtemp(prefix="serve_http_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    t_phase = time.perf_counter()
    try:
        os.chdir(work)   # App keeps uploads/ and outputs/ under the working directory
        rng = np.random.default_rng(SEED)
        svc = GenerationService(model=model, device="cuda", max_batch=8)
        grids = []
        decode = svc._decode_batch

        def recording(intros, seeds):
            out = decode(intros, seeds)
            grids.extend(out)
            return out

        svc._decode_batch = recording

        def written():
            """The bytes each recorded grid writes as a continuation."""
            out = []
            for g in grids:
                if window_to_midi(g, "check.mid"):
                    with open("check.mid", "rb") as f:
                        out.append(f.read())
            return out

        app = App(svc)
        names = []
        for i in range(4):
            data = midi_bytes(_song(rng))
            boundary = "pbxsmoke"
            body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                    f"filename=\"song{i}.mid\"\r\nContent-Type: audio/midi\r\n\r\n"
                    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
            st, _, out = _wsgi(app, "POST", "/api/upload", body,
                               f"multipart/form-data; boundary={boundary}")
            if st != "200 OK":
                raise AssertionError(f"upload answered {st}: {out!r}")
            names.append(json.loads(out)["file"])
            with open(os.path.join("uploads", names[-1]), "rb") as f:
                if f.read() != data:
                    raise AssertionError("upload stored other bytes")
        st, _, out = _wsgi(app, "GET", "/api/health")
        health = json.loads(out)
        if st != "200 OK" or health["status"] != "ok" or not health["model_loaded"]:
            raise AssertionError(f"health {st}: {health}")
        print(f"[serve_http] {len(names)} uploads of two-track songs "
              f"({2 * 300} notes each), health {health}; PBX_DEMO_RETRIES={retries}")

        answers, lat = [None] * len(names), [0.0] * len(names)

        def client(i):
            t = time.perf_counter()
            answers[i] = _wsgi(app, "GET", f"/api/generate/pianobart/{names[i]}")
            lat[i] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(names))]
        _reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a generate request never returned")
        ends = []
        for i, (st, _, body) in enumerate(answers):
            kind, j = _check_answer(app, st, body, written)
            ends.append(kind)
            what = (f"latency_s {j['latency_s']} attempts {j['attempts']} "
                    f"batch {j['batch_size_served']}" if j else
                    f"no notes after {retries} attempts")
            print(f"[serve_http]   request {i}: {kind}, client {lat[i]:.3f} s, {what}")
        print(f"[serve_http] {len(names)} concurrent requests in {wall:.3f} s; "
              f"batch_sizes_served {svc.batch_sizes_served}")

        # one request over a real socket
        threading.Thread(target=app.run, kwargs={"host": "127.0.0.1", "port": 0},
                         daemon=True).start()
        for _ in range(500):
            if app.server is not None:
                break
            time.sleep(0.01)
        url = (f"http://127.0.0.1:{app.server.server_port}"
               f"/api/generate/pianobart/{names[0]}")
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(url, timeout=300) as r:
                st, body = f"{r.status} {r.reason}", r.read()
        except urllib.error.HTTPError as err:   # a 500 is one of the two answers
            st, body = f"{err.code} {err.reason}", err.read()
        finally:
            app.shutdown()
        kind, j = _check_answer(app, st, body, written)
        ends.append(kind)
        print(f"[serve_http] over a localhost socket: {kind} in "
              f"{time.perf_counter() - t0:.3f} s"
              + (f", attempts {j['attempts']}" if j else ""))
        batches = len(svc.batch_sizes_served)

        # the demo CLI in process, on the card (its own flagship model)
        demo_out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(demo_out):
            rc = cli.main(["demo", "--input", os.path.join("uploads", names[1]),
                           "--output", "demo_out.mid"])
        lines = demo_out.getvalue().splitlines()
        empty = sum(x.startswith("empty continuation") for x in lines)
        saved = "Saved to demo_out.mid" in lines
        if rc != 0 or not (saved or lines[-1:] == ["Generate Fail! (empty)"]):
            raise AssertionError(f"demo CLI: rc {rc}, output {lines}")
        if saved and not any(i.notes for i in read_midi("demo_out.mid").instruments):
            raise AssertionError("the demo's output has no notes")
        demo_attempts = empty + int(saved)
        print(f"[serve_http] demo CLI in {time.perf_counter() - t0:.1f} s: "
              f"{lines[-1]} after {demo_attempts} attempt(s)")

        state.setdefault("launches", {})["serve_http"] = _read_counts()
        k1 = flash_attention_fwd.launches
        expect = model.cfg.encoder_layers * (batches + demo_attempts)
        print(f"[serve_http] answers: {ends.count('200')} x 200, {ends.count('500')} x "
              f"500 (no notes); {batches} decode batches + {demo_attempts} demo "
              f"decodes; K1 launches {k1} (expected {expect})")
        if k1 != expect:
            raise AssertionError(f"K1 launched {k1} times, expected {expect}")
        others = {n: c for n, c in state["launches"]["serve_http"].items()
                  if c and n != "flash_attention_fwd"}
        if others:
            raise AssertionError(f"kernels off this path launched: {others}")
    finally:
        os.chdir(here)
        shutil.rmtree(work, ignore_errors=True)
    # the service's worker thread outlives the phase; the flagship weights
    # must not, so the later phases start as they do without this one
    svc.model = None
    del model
    torch.cuda.empty_cache()
    print(f"[serve_http] wall {time.perf_counter() - t_phase:.1f} s")


def _pretrain_batch(B, S, rng):
    """Clean pretrain windows: random content ids per field, bars ascending,
    EOS last; every fourth window is a song's last, with a pad tail of S/8 to
    3S/8 rows."""
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    x = np.zeros((B, S, 8), dtype=np.int64)
    for f in range(8):
        x[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    x[..., 0] = np.sort(x[..., 0], axis=1)
    for i in range(B):
        end = S - ((S // 8) * (1 + (i // 4) % 3) if i % 4 == 3 else 0)
        x[i, end - 1] = V.EOS
        x[i, end:] = V.PAD
    return x


def _grad_groups(name):
    """Parameter group of a parameter name, for the gradient check."""
    parts = name.split(".")
    if parts[1] in ("encoder", "decoder") and parts[2] == "layers":
        sub = parts[4]
        kind = ("norm" if "norm" in sub else "ffn" if sub == "ffn" else sub)
        return f"{parts[1]}.{kind}"
    if parts[0] == "lm_head":
        return "lm_head"
    return f"{parts[1]}.{parts[2]}"


def _grad_check(tag, models, batch, gen, expects, what):
    """Gradients of two models with the same weights on the same corrupted
    batch (each forward's dropout from its own generator, seeded alike):
    the losses and ||g_a - g_b|| / ||g_b|| per parameter group, with each
    model's launch counts as ``expects`` says."""
    import torch
    from pianobart_tpu_torch.ops.noise import corrupt_batch
    from pianobart_tpu_torch.train.pretrain import _forward_loss
    corrupted, loss_mask = corrupt_batch(batch, gen)
    losses = []
    for m, expect in zip(models, expects):
        _reset_counts()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        total, _ = _forward_loss(m, batch, corrupted, loss_mask, g)
        total.backward()
        torch.cuda.synchronize()
        losses.append(total.item())
        if tuple(_read_counts().values()) != expect:
            raise AssertionError(f"{what}: launches {_read_counts()}, expected "
                                 f"{expect} ({COUNT_NAMES})")
    groups = {}
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        d, r = groups.setdefault(_grad_groups(name), [0.0, 0.0])
        groups[_grad_groups(name)] = [d + (p.grad - q.grad).float().square().sum().item(),
                                      r + q.grad.float().square().sum().item()]
    # bf16: both paths round at different places (K2 and K3 round P and dS
    # to bf16 as operands where the plain attention rounds the
    # probabilities; K4 adds the residual in f32 where the unfused tail adds
    # in bf16); these differences compound over 8+8 layers.  f32: both paths
    # keep f32 accuracy and differ by summation order.
    tol = 5e-2 if models[0].cfg.dtype == torch.bfloat16 else 1e-3
    rels = {g: (d / r) ** 0.5 for g, (d, r) in groups.items()}
    print(f"[{tag}] grads {what}, B={batch.shape[0]}: loss {losses[0]:.6f} vs "
          f"{losses[1]:.6f}; |dg|/|g| per group (tol {tol:g}):")
    for g, rel in sorted(rels.items()):
        print(f"[{tag}]   {g:24s} {rel:.3e}")
    if not (max(rels.values()) <= tol and abs(losses[0] - losses[1]) <= 1e-2
            * abs(losses[1])):
        raise AssertionError(f"gradients {what} disagree")


def _model(cfg, weights=None, train=False):
    """``init_lm(cfg, seed=SEED)`` on the card; or, given ``weights`` (the
    state dict of a model of the same widths drawn once, at the longest
    ``max_len``), a model built at ``cfg`` that loads them, cast to
    ``cfg.param_dtype``, the position tables cut to its rows, so that a
    phase with many models of one wide configuration draws its weights on
    the host once."""
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartLM
    if weights is None:
        return init_lm(cfg, seed=SEED, device="cuda", train=train)
    model = PianoBartLM(cfg, device="cuda")
    own = model.state_dict()
    model.load_state_dict({k: w if w.shape == own[k].shape else w[:own[k].shape[0]]
                           for k, w in weights.items()})
    return model.train(train)


def _flash_vs_plain(tag, cfg, rng, gen, B, expect, weights=None):
    """The flagship model's gradients through the flash kernels against the
    same weights on the plain attention path, dropout off."""
    import torch
    from pianobart_tpu_torch.models import PianoBartLM
    model = _model(cfg, weights, train=True)
    plain = PianoBartLM(cfg.replace(use_flash_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain.train()
    batch = torch.as_tensor(_pretrain_batch(B, cfg.max_len, rng), device="cuda")
    kernels = "K1+K2" if expect[1] else "K1+K3"
    _grad_check(tag, (model, plain), batch, gen, (expect, _counts()),
                f"via {kernels} vs plain attention, dropout off")


def _train_steps(tag, cfg, B, rng, gen, expect, warmup=3, steps=10, profile=True,
                 weights=None, peaks=0):
    """``pretrain_step`` at batch B: warm-up, then timed steps with the
    launches of every kernel per step (each as ``expect`` says), ms/step,
    tokens/s, model-FLOP MFU, peak device memory (``peak_gib``; with
    ``peaks``, that many more steps' peaks each in ``step_peaks``), and
    (``profile``) a profiled window; the model's weights ``weights`` where
    given (:func:`_model`)."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.ops.noise import corrupt_batch
    from pianobart_tpu_torch.train.pretrain import pretrain_step
    from pianobart_tpu_torch.train.state import create_train_state
    from pianobart_tpu_torch.utils.flops import PEAK_BF16_H100, pretrain_step_flops

    S = cfg.max_len
    t0 = time.perf_counter()
    model = _model(cfg, weights, train=True)
    st = create_train_state(model)
    batch = torch.as_tensor(_pretrain_batch(B, S, rng), device="cuda")
    print(f"[{tag}] flagship width ({cfg.num_heads} heads of {cfg.head_dim}) B={B} S={S} "
          f"{str(cfg.dtype)[6:]} compute, "
          f"{str(cfg.param_dtype)[6:]} params, dropout {cfg.dropout}, "
          f"fused_dropout_ln={cfg.fused_dropout_ln}, AdamW lr 2e-5; "
          f"init {time.perf_counter() - t0:.1f} s")
    c_ms = _time_ms(lambda: corrupt_batch(batch, gen), iters=10)
    print(f"[{tag}] corrupt_batch B={B}: {c_ms:.3f} ms (CUDA events)")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        pretrain_step(st, batch, gen)
    torch.cuda.synchronize()

    _reset_counts()
    per_step, metrics = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = _read_counts()
        _, m = pretrain_step(st, batch, gen)
        after = _read_counts()
        per_step.append(tuple(after[k] - before[k] for k in after))
        metrics.append((m["loss"], m["grad_norm"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state_launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # each step's peak, apart from the timed run (the peak's reset and read
    # synchronize the host with the card)
    step_peaks = []
    for _ in range(peaks):
        torch.cuda.reset_peak_memory_stats()
        pretrain_step(st, batch, gen)
        torch.cuda.synchronize()
        step_peaks.append(torch.cuda.max_memory_allocated() / 2**30)
    losses = [l.item() for l, _ in metrics]
    norms = [g.item() for _, g in metrics]
    model_flops, hw_flops = pretrain_step_flops(model.state_dict(), cfg, B, S)
    step_s = wall / steps
    mfu = 100 * model_flops / step_s / PEAK_BF16_H100
    print(f"[{tag}] {steps} timed steps after {warmup} warm-up: {1e3 * step_s:.1f} "
          f"ms/step, {B * S / step_s:.0f} tokens/s, model-FLOP MFU {mfu:.2f}% "
          f"({model_flops / 1e12:.2f} TFLOP/step; hardware FLOPs "
          f"{hw_flops / 1e12:.2f}) against {PEAK_BF16_H100 / 1e12:.0f} TFLOP/s; "
          f"peak device memory {peak:.2f} GiB")
    if peaks:
        print(f"[{tag}] peak device memory of each of {peaks} more steps "
              f"{[round(x, 2) for x in step_peaks]} GiB")
    print(f"[{tag}] loss per step {[round(x, 5) for x in losses]}")
    print(f"[{tag}] grad_norm per step {[round(x, 5) for x in norms]}")
    print(f"[{tag}] launches per step ({COUNT_NAMES}) {per_step}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError("non-finite loss or grad_norm")
    if any(k != expect for k in per_step):
        raise AssertionError(f"launches per step {per_step}, expected {expect}")
    if profile:
        _profile_window(tag, f"2 pretrain steps at B={B}",
                        lambda: [pretrain_step(st, batch, gen) for _ in range(2)], 2)
    return state_launches, dict(ms=1e3 * step_s, peak_gib=peak, mfu=mfu,
                                tokens_s=B * S / step_s, step_peaks=step_peaks)


def phase_train(state):
    """The flagship pretrain step at B=32, S=1024: bf16 compute, f32
    parameters, dropout 0.1, every attention through K1 and K2."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartConfig

    cfg = PianoBartConfig(dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    _flash_vs_plain("train", cfg.replace(dropout=0.0), rng, gen, 4,
                    _counts(k1=n_attn, k2=n_attn))
    torch.cuda.empty_cache()
    launches, state["train"] = _train_steps("train", cfg, 32, rng, gen,
                                            _counts(k1=n_attn, k2=n_attn))
    state.setdefault("launches", {})["train"] = launches
    _unused_corruptions("train", 32, cfg.max_len)


def _first_of_group(keys):
    """For each entry of ``keys``, the index of the first entry with its
    key."""
    import numpy as np
    _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
    return first[inverse]


def _is_subsequence(rows, x):
    xi = 0
    for r in map(tuple, rows.tolist()):
        while xi < len(x) and tuple(x[xi]) != r:
            xi += 1
        if xi == len(x):
            return False
        xi += 1
    return True


def _corruption_faults(name, x, o, l, p):
    """The invariants the CPU tests (tests/test_torch_noise.py) check, on
    one sample's output: a list of what failed."""
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    S = len(x)
    pad, mask = np.asarray(V.PAD), np.asarray(V.MASK)
    bad = []
    if name == "bar_deletion":
        gone = np.setdiff1d(x[:, 0], o[:, 0])
        dropped = np.isin(x[:, 0], gone)
        n = S - int(dropped.sum())
        first = np.where(dropped)[0]
        want_l = np.arange(S) >= (first.min() if len(first) else S)
        if not ((o[:n] == x[~dropped]).all() and (o[n:] == pad).all()):
            bad.append("survivors are not x without the deleted bars, then padding")
        if not (l == want_l).all():
            bad.append("loss is not every position from the first deletion")
    elif name == "token_mask_element":
        k = round(S * p * 8)
        n80, n10 = round(k * 0.8), round(k * 0.1)
        if l.sum() != k or not ((o != x) <= l).all():
            bad.append("not k elements chosen, or an unchosen one changed")
        if not n80 <= (o == mask[None]).sum() <= n80 + n10:
            bad.append("<MASK> count")
    elif name in ("bar_mask", "bar_mask_element"):
        if l[0].any() or l[-1].any():
            bad.append("row 0 or S-1 not exempt")
        if not (o[~l] == x[~l]).all():
            bad.append("an element without loss changed")
        key = x[:, 0] if name == "bar_mask" else x[:, 0] * V.FIELD_SIZES[2] + x[:, 2]
        inner = np.arange(1, S - 1)
        first = inner[_first_of_group(key[inner])]
        if not (l[inner] == l[first]).all():
            bad.append("the loss differs inside a group")
    elif name == "bar_infilling":
        if not (l == (o != x).any(-1)).all():
            bad.append("loss is not the changed rows")
        content = o[~(o == mask).all(-1) & ~(o == pad).all(-1)]
        if not _is_subsequence(content, x[~(x == pad).all(-1)]):
            bad.append("content rows are not a subsequence of x")
    return bad


def _unused_corruptions(tag, B, S, p=0.15):
    """The five corruptions the shipped ``corrupt_batch`` never picks, on
    the device at the pretrain shape: ms by CUDA events, and the CPU tests'
    invariants on every sample of the card's output."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.ops import noise
    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batch = torch.as_tensor(_pretrain_batch(B, S, rng), device="cuda")
    x = batch.cpu().numpy()
    for name in ("bar_deletion", "token_mask_element", "bar_mask", "bar_mask_element",
                 "bar_infilling"):
        fn = getattr(noise, name)
        ms = _time_ms(lambda: fn(batch, p, gen), iters=5, warmup=1)
        out, loss = fn(batch, p, gen)
        o, l = out.cpu().numpy(), loss.cpu().numpy()
        faults = {f for i in range(B) for f in _corruption_faults(name, x[i], o[i], l[i], p)}
        print(f"[{tag}] {name} B={B} S={S}: {ms:.3f} ms (CUDA events); loss fraction "
              f"{l.mean():.4f}; invariants on all {B} samples: "
              f"{'hold' if not faults else sorted(faults)}")
        if faults or out.shape != batch.shape or not l.any():
            raise AssertionError(f"{name} on the card: {sorted(faults)}")


def phase_train_long(state):
    """The long-context pretrain step: max_len 2048 at B=16 (the flagship's
    tokens per batch), where every attention backward takes K3a and K3b."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartConfig

    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, max_len=2048)
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k3=n_attn)
    _flash_vs_plain("train_long", cfg.replace(dropout=0.0), rng, gen, 2, expect)
    torch.cuda.empty_cache()
    launches, state["train_long"] = _train_steps("train_long", cfg, 16, rng, gen,
                                                 expect)
    state["launches"]["train_long"] = launches


def phase_train_fused(state):
    """The flagship step with the fused sublayer tail (K4 at 2 sites per
    encoder layer and 3 per decoder layer), beside [train] of this run."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig

    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, fused_dropout_ln=True)
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    n_tail = 2 * cfg.encoder_layers + 3 * cfg.decoder_layers
    # At dropout 1e-9 the uint8 dropout keeps everything and K4 drops each
    # element with probability 4/2^32 (~0.16 of 168 M tail elements per
    # forward at B=4): the two steps then differ by bf16 rounding only.
    tiny = cfg.replace(dropout=1e-9)
    fused = init_lm(tiny, seed=SEED, device="cuda", train=True)
    unfused = init_lm(tiny.replace(fused_dropout_ln=False), seed=SEED,
                      device="cuda", train=True)
    batch = torch.as_tensor(_pretrain_batch(4, cfg.max_len, rng), device="cuda")
    _grad_check("train_fused", (fused, unfused), batch, gen,
                (_counts(k1=n_attn, k2=n_attn, k4=n_tail),
                 _counts(k1=n_attn, k2=n_attn)),
                "of the fused tail vs the unfused, dropout 1e-9")
    del fused, unfused
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_fused", cfg, 32, rng, gen,
                                 _counts(k1=n_attn, k2=n_attn, k4=n_tail))
    state["launches"]["train_fused"] = launches
    state["train_fused"] = res
    base = state["train"]
    print(f"[train_fused] beside [train] of this run: {res['ms']:.1f} vs "
          f"{base['ms']:.1f} ms/step ({100 * (res['ms'] / base['ms'] - 1):+.1f}%), "
          f"{res['tokens_s']:.0f} vs {base['tokens_s']:.0f} tokens/s, peak "
          f"{res['peak_gib']:.2f} vs {base['peak_gib']:.2f} GiB")


def phase_train_f32(state):
    """The flagship step as ``PianoBartConfig()`` stands: f32 compute and f32
    parameters, dropout 0.1, at B=8; every attention through the f32 K1 and
    K2, beside [train] of this run."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartConfig

    torch.cuda.empty_cache()
    cfg = PianoBartConfig()
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k2=n_attn, f32=True)
    _flash_vs_plain("train_f32", cfg.replace(dropout=0.0), rng, gen, 2, expect)
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_f32", cfg, 8, rng, gen, expect, warmup=3,
                                 steps=5)
    state["launches"]["train_f32"] = launches
    state["train_f32"] = res
    base = state["train"]
    print(f"[train_f32] beside [train] of this run (bf16 compute, B=32): "
          f"{res['ms']:.1f} vs {base['ms']:.1f} ms/step, {res['tokens_s']:.0f} vs "
          f"{base['tokens_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} vs "
          f"{base['peak_gib']:.2f} GiB")


def phase_train_h256(state):
    """``--heads 4`` (head width 256, the flagship's H*D = 1024): gradients
    through K1 and K2 against the plain attention path at B=4 in bf16 and in
    f32; the timed pretrain steps at B=32 (bf16 compute, f32 parameters,
    dropout 0.1: K1, delta, K2 24 each), at ``max_len=2048``, B=16 (K1,
    delta, K3a, K3b 24 each) and in f32 at B=8, [train_f32]'s batch (K1,
    delta, K2 24 each, the prep 48: the f32 kernels' CTA pairs read the
    prep's planes); then the serving path:
    the encoder via K1 against plain attention and one ``GenerationService``
    decode batch of two concurrent requests (K1 8 launches)."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.serve.app import GenerationService

    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, num_heads=4)
    if cfg.head_dim != 256:
        raise AssertionError(f"--heads 4 gives head width {cfg.head_dim}")
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k2=n_attn)
    expect_f32 = _counts(k1=n_attn, k2=n_attn, f32=True)
    _flash_vs_plain("train_h256", cfg.replace(dropout=0.0), rng, gen, 4, expect)
    _flash_vs_plain("train_h256", PianoBartConfig(num_heads=4, dropout=0.0), rng, gen, 4,
                    expect_f32)
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h256", cfg, 32, rng, gen, expect)
    state["launches"]["train_h256"] = launches
    state["train_h256"] = res
    base = state["train"]
    print(f"[train_h256] beside [train] of this run (8 heads of 128): {res['ms']:.1f} vs "
          f"{base['ms']:.1f} ms/step ({100 * (res['ms'] / base['ms'] - 1):+.1f}%), "
          f"MFU {res['mfu']:.2f} vs {base['mfu']:.2f}%, peak {res['peak_gib']:.2f} vs "
          f"{base['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    launches, _ = _train_steps("train_h256_long", cfg.replace(max_len=2048), 16, rng, gen,
                               _counts(k1=n_attn, k3=n_attn), warmup=1, steps=3,
                               profile=False)
    state["launches"]["train_h256_long"] = launches
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h256_f32", PianoBartConfig(num_heads=4), 8, rng, gen,
                                 expect_f32, warmup=2, steps=3, profile=False)
    state["launches"]["train_h256_f32"] = launches
    base = state["train_f32"]
    print(f"[train_h256_f32] beside [train_f32] of this run (8 heads of 128): "
          f"{res['ms']:.1f} vs {base['ms']:.1f} ms/step, {res['tokens_s']:.0f} vs "
          f"{base['tokens_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} vs "
          f"{base['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    # serving a --heads 4 model (bf16 parameters, as GenerationService holds them)
    scfg = PianoBartConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16, num_heads=4)
    model = init_lm(scfg, seed=SEED, device="cuda")
    _encoder_vs_plain("train_h256", model, rng)
    svc = GenerationService(model=model, device="cuda", max_batch=8)
    intros = _intros(2, scfg.max_len, rng)
    results = [None] * len(intros)

    def client(i):
        results[i] = svc.submit(intros[i], seed=i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(intros))]
    _reset_counts()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts = _read_counts()
    state["launches"]["serve_h256"] = counts
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a --heads 4 request was not served")
    _check_outputs(results, scfg.max_len)
    batches = svc.batch_sizes_served
    want = _counts(k1=scfg.encoder_layers * len(batches))
    print(f"[train_h256] --heads 4 GenerationService: {len(intros)} concurrent requests "
          f"served as batches {batches}; launches ({COUNT_NAMES}) "
          f"{tuple(counts.values())}, expected {want}")
    if tuple(counts.values()) != want:
        raise AssertionError("K1 did not run 8 times a --heads 4 decode batch")


def phase_train_h512(state):
    """``--heads 2`` (head width 512, the flagship's H*D = 1024; every
    attention on clusters, bf16 K1 of 2 CTAs, the others of 4): gradients through K1 and K2 against
    the plain attention path at B=4 in bf16 and B=2 in f32; the timed
    pretrain steps at B=32 (bf16 compute, f32 parameters, dropout 0.1: K1,
    delta, K2 24 each) beside [train] of this run and beside the plain
    route's (``use_flash_attention=False``, the path such a width took
    before) ms/step and peak; at ``max_len=2048``, B=16 (K1, delta, K3a,
    K3b 24 each); in f32 at B=8 (K1, delta, K2 24 each, the prep 48); then
    the serving path: the encoder via K1 against plain attention and one
    ``GenerationService`` decode batch of two concurrent requests (K1 8)."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.serve.app import GenerationService

    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, num_heads=2)
    if cfg.head_dim != 512:
        raise AssertionError(f"--heads 2 gives head width {cfg.head_dim}")
    rng = np.random.default_rng(SEED + 5)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k2=n_attn)
    expect_f32 = _counts(k1=n_attn, k2=n_attn, f32=True)
    _flash_vs_plain("train_h512", cfg.replace(dropout=0.0), rng, gen, 4, expect)
    _flash_vs_plain("train_h512", PianoBartConfig(num_heads=2, dropout=0.0), rng, gen, 2,
                    expect_f32)
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h512", cfg, 32, rng, gen, expect, profile=False)
    state["launches"]["train_h512"] = launches
    state["train_h512"] = res
    torch.cuda.empty_cache()
    _, plain = _train_steps("train_h512_plain", cfg.replace(use_flash_attention=False), 32,
                            rng, gen, _counts(), warmup=1, steps=3, profile=False)
    base = state["train"]
    print(f"[train_h512] beside [train] of this run (8 heads of 128) and the plain route "
          f"at D=512: {res['ms']:.1f} vs {base['ms']:.1f} vs {plain['ms']:.1f} ms/step, "
          f"MFU {res['mfu']:.2f} vs {base['mfu']:.2f} vs {plain['mfu']:.2f}%, peak "
          f"{res['peak_gib']:.2f} vs {base['peak_gib']:.2f} vs {plain['peak_gib']:.2f} GiB")
    if "train_h256" in state:
        print(f"[train_h512] beside [train_h256] of this run (4 heads of 256): "
              f"{res['ms']:.1f} vs {state['train_h256']['ms']:.1f} ms/step")
    torch.cuda.empty_cache()
    launches, _ = _train_steps("train_h512_long", cfg.replace(max_len=2048), 16, rng, gen,
                               _counts(k1=n_attn, k3=n_attn), warmup=1, steps=2,
                               profile=False)
    state["launches"]["train_h512_long"] = launches
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h512_f32", PianoBartConfig(num_heads=2), 8, rng, gen,
                                 expect_f32, warmup=2, steps=3, profile=False)
    state["launches"]["train_h512_f32"] = launches
    base = state["train_f32"]
    print(f"[train_h512_f32] beside [train_f32] of this run (8 heads of 128): "
          f"{res['ms']:.1f} vs {base['ms']:.1f} ms/step, {res['tokens_s']:.0f} vs "
          f"{base['tokens_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} vs "
          f"{base['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    # serving a --heads 2 model (bf16 parameters, as GenerationService holds them)
    scfg = PianoBartConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16, num_heads=2)
    model = init_lm(scfg, seed=SEED, device="cuda")
    _encoder_vs_plain("train_h512", model, rng)
    svc = GenerationService(model=model, device="cuda", max_batch=8)
    intros = _intros(2, scfg.max_len, rng)
    results = [None] * len(intros)

    def client(i):
        results[i] = svc.submit(intros[i], seed=i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(intros))]
    _reset_counts()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts = _read_counts()
    state["launches"]["serve_h512"] = counts
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a --heads 2 request was not served")
    _check_outputs(results, scfg.max_len)
    batches = svc.batch_sizes_served
    want = _counts(k1=scfg.encoder_layers * len(batches))
    print(f"[train_h512] --heads 2 GenerationService: {len(intros)} concurrent requests "
          f"served as batches {batches}; launches ({COUNT_NAMES}) "
          f"{tuple(counts.values())}, expected {want}")
    if tuple(counts.values()) != want:
        raise AssertionError("K1 did not run 8 times a --heads 2 decode batch")


def phase_train_h2048(state):
    """``--hs 2048 --heads 1`` (d_model 2048, one head of 2048, 8+8 layers,
    FFN 2048: 549 M parameters, at full width and depth; every attention
    on clusters, bf16 of 8 CTAs, f32 of 16, a non-portable size): gradients
    through K1 and K2 against the plain attention path at B=2 in bf16 and
    B=1 in f32; the timed pretrain steps at B=16 (bf16 compute, f32
    parameters, dropout 0.1: K1, delta, K2 24 each) beside the plain
    route's (``use_flash_attention=False``, the path this width took before)
    ms/step and peak; at ``max_len=2048``, B=8 (K1, delta, K3a, K3b 24
    each); in f32 at B=4 (K1, delta, K2 24 each, the prep 48); then the
    serving path with bf16 parameters: the encoder via K1 against plain
    attention and one ``GenerationService`` decode batch of two concurrent
    requests (K1 8).  The weights are drawn once and cast for every model
    (:func:`_model`)."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.serve.app import GenerationService

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, d_model=2048, num_heads=1, ffn_dim=2048)
    if cfg.head_dim != 2048:
        raise AssertionError(f"--hs 2048 --heads 1 gives head width {cfg.head_dim}")
    t0 = time.perf_counter()
    # at S=2048's position tables, which the S=1024 models take the first rows of
    weights = _model(cfg.replace(dtype=torch.float32, max_len=2048)).state_dict()
    n_params = sum(w.numel() for w in weights.values())
    print(f"[train_h2048] --hs 2048 --heads 1: {n_params / 1e6:.1f} M parameters drawn "
          f"once in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k2=n_attn)
    expect_f32 = _counts(k1=n_attn, k2=n_attn, f32=True)
    f32_cfg = cfg.replace(dtype=torch.float32)
    _flash_vs_plain("train_h2048", cfg.replace(dropout=0.0), rng, gen, 2, expect,
                    weights=weights)
    _flash_vs_plain("train_h2048", f32_cfg.replace(dropout=0.0), rng, gen, 1, expect_f32,
                    weights=weights)
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h2048", cfg, 16, rng, gen, expect, profile=False,
                                 weights=weights, peaks=2)
    state["launches"]["train_h2048"] = launches
    state["train_h2048"] = res
    torch.cuda.empty_cache()
    _, plain = _train_steps("train_h2048_plain", cfg.replace(use_flash_attention=False), 16,
                            rng, gen, _counts(), warmup=1, steps=3, profile=False,
                            weights=weights, peaks=1)
    print(f"[train_h2048] beside the plain route at D=2048: {res['ms']:.1f} vs "
          f"{plain['ms']:.1f} ms/step ({100 * (res['ms'] / plain['ms'] - 1):+.1f}%), "
          f"MFU {res['mfu']:.2f} vs {plain['mfu']:.2f}%, peak {res['peak_gib']:.2f} vs "
          f"{plain['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    launches, _ = _train_steps("train_h2048_long", cfg.replace(max_len=2048), 8, rng, gen,
                               _counts(k1=n_attn, k3=n_attn), warmup=1, steps=2,
                               profile=False, weights=weights, peaks=1)
    state["launches"]["train_h2048_long"] = launches
    torch.cuda.empty_cache()
    launches, _ = _train_steps("train_h2048_f32", f32_cfg, 4, rng, gen, expect_f32,
                               warmup=2, steps=3, profile=False, weights=weights, peaks=1)
    state["launches"]["train_h2048_f32"] = launches
    torch.cuda.empty_cache()

    # serving a --hs 2048 --heads 1 model (bf16 parameters, as GenerationService holds them)
    scfg = cfg.replace(param_dtype=torch.bfloat16)
    model = _model(scfg, weights)
    del weights
    torch.cuda.empty_cache()
    _encoder_vs_plain("train_h2048", model, rng)
    svc = GenerationService(model=model, device="cuda", max_batch=8)
    intros = _intros(2, scfg.max_len, rng)
    results = [None] * len(intros)

    def client(i):
        results[i] = svc.submit(intros[i], seed=i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(intros))]
    _reset_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts = _read_counts()
    state["launches"]["serve_h2048"] = counts
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a --hs 2048 --heads 1 request was not served")
    _check_outputs(results, scfg.max_len)
    batches = svc.batch_sizes_served
    want = _counts(k1=scfg.encoder_layers * len(batches))
    print(f"[train_h2048] --hs 2048 --heads 1 GenerationService: {len(intros)} concurrent "
          f"requests served as batches {batches} in {time.perf_counter() - t0:.1f} s; "
          f"launches ({COUNT_NAMES}) {tuple(counts.values())}, expected {want}")
    if tuple(counts.values()) != want:
        raise AssertionError("K1 did not run 8 times a --hs 2048 decode batch")
    del svc, model
    torch.cuda.empty_cache()
    print(f"[train_h2048] wall {time.perf_counter() - t_phase:.1f} s")


def phase_train_h4096(state):
    """``--hs 4096 --heads 1`` (d_model 4096, one head of 4096, 8+8 layers,
    FFN 2048: about 1.9 B parameters, at full width and depth; every bf16
    attention on clusters of 16 CTAs, the card's largest): gradients through
    K1 and K2 against the plain attention path at B=2 (bf16, dropout off);
    10 timed pretrain steps at B=8 (bf16 compute, f32 parameters, dropout
    0.1: K1, delta, K2 24 each; B*H*D the flagship's) beside the plain
    route's 3 (ms/step, MFU, peak); at ``max_len=2048``, B=4, 2 steps (K1,
    delta, K3a, K3b 24 each); the serving path with bf16 parameters: the
    encoder via K1 against plain attention and one ``GenerationService``
    decode batch of two concurrent requests (K1 8).  In f32 this width is
    past the kernels (2048): the dense attention takes the plain path and
    the ring raises.  The weights are drawn once on the card, kept on the
    host and cast for every model (:func:`_model`)."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.ops import attention
    from pianobart_tpu_torch.ops.ring import ring_attention
    from pianobart_tpu_torch.serve.app import GenerationService

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = PianoBartConfig(dtype=torch.bfloat16, d_model=4096, num_heads=1, ffn_dim=2048)
    if cfg.head_dim != 4096:
        raise AssertionError(f"--hs 4096 --heads 1 gives head width {cfg.head_dim}")
    # f32: past the kernels' 2048, the dense step's attention is plain and the
    # ring refuses a CUDA shard (before any device work)
    q = torch.randn(1, 256, 1, 4096, device="cuda")
    _reset_counts()
    out = attention.dot_product_attention(q * 4096 ** -0.5, q, q)
    if any(_read_counts().values()) or not torch.isfinite(out).all():
        raise AssertionError(f"f32 attention at D=4096 launched {_read_counts()}")
    try:
        ring_attention(q, q, q, None, False, None)
    except ValueError as e:
        if "up to 2048" not in str(e):
            raise AssertionError(f"the f32 ring at D=4096 refused with {e}") from e
        print(f"[train_h4096] f32 at D=4096: dense attention on the plain path (no launch); "
              f"the ring raises ValueError: {e}")
    else:
        raise AssertionError("the f32 ring took D=4096")
    del q, out
    t0 = time.perf_counter()
    # at S=2048's position tables, which the S=1024 models take the first rows
    # of; kept on the host, so that the card holds only the model at work
    model = _model(cfg.replace(dtype=torch.float32, max_len=2048))
    weights = {k: w.cpu() for k, w in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    n_params = sum(w.numel() for w in weights.values())
    print(f"[train_h4096] --hs 4096 --heads 1: {n_params / 1e6:.1f} M parameters drawn "
          f"once in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    expect = _counts(k1=n_attn, k2=n_attn)
    _flash_vs_plain("train_h4096", cfg.replace(dropout=0.0), rng, gen, 2, expect,
                    weights=weights)
    torch.cuda.empty_cache()
    launches, res = _train_steps("train_h4096", cfg, 8, rng, gen, expect, profile=False,
                                 weights=weights, peaks=1)
    state["launches"]["train_h4096"] = launches
    state["train_h4096"] = res
    torch.cuda.empty_cache()
    _, plain = _train_steps("train_h4096_plain", cfg.replace(use_flash_attention=False), 8,
                            rng, gen, _counts(), warmup=1, steps=3, profile=False,
                            weights=weights)
    print(f"[train_h4096] beside the plain route at D=4096: {res['ms']:.1f} vs "
          f"{plain['ms']:.1f} ms/step ({100 * (res['ms'] / plain['ms'] - 1):+.1f}%), "
          f"{res['tokens_s']:.0f} vs {plain['tokens_s']:.0f} tokens/s, "
          f"MFU {res['mfu']:.2f} vs {plain['mfu']:.2f}%, peak {res['peak_gib']:.2f} vs "
          f"{plain['peak_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    launches, _ = _train_steps("train_h4096_long", cfg.replace(max_len=2048), 4, rng, gen,
                               _counts(k1=n_attn, k3=n_attn), warmup=1, steps=2,
                               profile=False, weights=weights)
    state["launches"]["train_h4096_long"] = launches
    torch.cuda.empty_cache()

    # serving a --hs 4096 --heads 1 model (bf16 parameters, as GenerationService holds them)
    scfg = cfg.replace(param_dtype=torch.bfloat16)
    model = _model(scfg, weights)
    del weights
    _encoder_vs_plain("train_h4096", model, rng)
    svc = GenerationService(model=model, device="cuda", max_batch=8)
    intros = _intros(2, scfg.max_len, rng)
    results = [None] * len(intros)

    def client(i):
        results[i] = svc.submit(intros[i], seed=i)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(intros))]
    _reset_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    counts = _read_counts()
    state["launches"]["serve_h4096"] = counts
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a --hs 4096 --heads 1 request was not served")
    _check_outputs(results, scfg.max_len)
    batches = svc.batch_sizes_served
    want = _counts(k1=scfg.encoder_layers * len(batches))
    print(f"[train_h4096] --hs 4096 --heads 1 GenerationService: {len(intros)} concurrent "
          f"requests served as batches {batches} in {time.perf_counter() - t0:.1f} s; "
          f"launches ({COUNT_NAMES}) {tuple(counts.values())}, expected {want}")
    if tuple(counts.values()) != want:
        raise AssertionError("K1 did not run 8 times a --hs 4096 decode batch")
    del svc, model
    torch.cuda.empty_cache()
    print(f"[train_h4096] wall {time.perf_counter() - t_phase:.1f} s")


def _meta(save_dir):
    """``meta.json`` of a checkpoint directory, or None while it is absent
    or half written."""
    try:
        with open(os.path.join(save_dir, "meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _epoch_events(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == "epoch"]


def _pretrain_cli(tag, argv, cwd, log, stop_after_epoch=None):
    """``python -m pianobart_tpu_torch.cli pretrain`` as a user starts it,
    in ``cwd``; with ``stop_after_epoch``, SIGTERM once ``meta.json`` shows
    that epoch saved.  Returns (exit code, seconds); the process never
    outlives the call."""
    import signal
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.dirname(os.path.abspath(__file__)),
                      os.environ.get("PYTHONPATH")])))
    save = os.path.join(cwd, "result", "pretrain", "pianobart")
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "pianobart_tpu_torch.cli",
                                 "pretrain"] + argv, cwd=cwd, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            if stop_after_epoch is not None:
                while (_meta(save) or {}).get("last_step") is None or \
                        _meta(save)["last_step"] < stop_after_epoch:
                    if proc.poll() is not None or time.perf_counter() - t0 > 600:
                        raise AssertionError(f"{tag}: epoch {stop_after_epoch} was "
                                             f"never saved (exit {proc.poll()})")
                    time.sleep(0.05)
                print(f"[pretrain_run] {tag}: epoch {stop_after_epoch} saved after "
                      f"{time.perf_counter() - t0:.1f} s; SIGTERM")
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    with open(log) as f:
        for line in f:
            if line.startswith(("train ", "Epoch", "[preempt]", "Time cost",
                                "Traceback", "WARNING")) or "Error" in line:
                print(f"[pretrain_run]   {tag}| {line.rstrip()}")
    return rc, wall


def phase_pretrain_run(state):
    """The pretraining run as a user starts it, at flagship width (bf16
    compute, f32 parameters, random init), every file in a temporary
    directory outside the checkout: 64 two-track songs tokenized by the
    native codec, checked, pretrained 3 epochs at B=8 with a safety save
    every dispatch by the CLI in a subprocess, SIGTERM after epoch 1 (exit
    75), ``--resume`` (exit 0); then in process the best checkpoint restored
    into a fresh model re-scores its ``best_acc``, and a fourth epoch runs
    with every kernel's launches counted."""
    import io
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.data import load_pretrain
    from pianobart_tpu_torch.midi import native
    from pianobart_tpu_torch.models import PianoBartConfig
    from pianobart_tpu_torch.train import state as state_mod
    from pianobart_tpu_torch.train.runner import PretrainRunner
    from pianobart_tpu_torch.train.state import create_train_state

    torch.cuda.empty_cache()
    B, seed = 8, 2023          # the CLI's --batch_size here, its --seed default
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pbt_pretrain_run_")
    # kept for [finetune], which grafts its best/ (main() removes it)
    state.setdefault("tmpdirs", []).append(tmp)
    state["pretrain_best"] = os.path.join(tmp, "result", "pretrain", "pianobart", "best")
    try:
        rng = np.random.default_rng(SEED + 4)
        songs = os.path.join(tmp, "songs")
        os.makedirs(songs)
        for i in range(64):
            _song(rng).dump(os.path.join(songs, f"song{i:02d}.mid"))
        data = os.path.join(tmp, "Data", "output_pretrain")
        t0 = time.perf_counter()
        if not native.available():
            raise AssertionError("the native MIDI codec did not build (g++)")
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = cli.main(["tokenize", "--dataset", songs, "--no_pad",
                           "--out_root", data])
            split = os.path.join(data, "songs", "songs_train_split.npy")
            state["pretrain_data"] = split      # [merge]'s --data
            rc_check = cli.main(["check", "--file", split, "--packed"])
        lines = log.getvalue().splitlines()
        print(f"[pretrain_run] tokenize --no_pad by the native codec "
              f"({os.path.basename(native._lib._name)}) in "
              f"{time.perf_counter() - t0:.2f} s: "
              + "; ".join(l for l in lines if "->" in l or "processed" in l))
        print(f"[pretrain_run] check --packed: {' '.join(lines[-1:])} (exit {rc_check})")
        if rc != 0 or rc_check != 0 or "64/64 MIDI files" not in log.getvalue():
            raise AssertionError(f"tokenize/check failed: {lines}")

        argv = ["--dataroot", data, "--datasets", "songs", "--batch_size", str(B),
                "--epochs", "3", "--checkpoint_every_dispatches", "1"]
        save = os.path.join(tmp, "result", "pretrain", "pianobart")
        rc, wall1 = _pretrain_cli("run", argv, tmp, os.path.join(tmp, "run.log"),
                                  stop_after_epoch=1)
        meta = _meta(save)
        print(f"[pretrain_run] run: exit {rc} after {wall1:.1f} s; meta last_step "
              f"{meta['last_step']}, safety {meta.get('safety')}")
        if rc != 75 or not (meta.get("safety") or meta["last_step"] > 1):
            raise AssertionError("pretrain did not exit 75 with a safety or "
                                 "epoch-end save on SIGTERM")
        rc, wall2 = _pretrain_cli("resume", argv + ["--resume"], tmp,
                                  os.path.join(tmp, "resume.log"))
        meta = _meta(save)
        epochs = [e["epoch"] for e in _epoch_events(save)]
        print(f"[pretrain_run] resume: exit {rc} after {wall2:.1f} s; meta "
              f"last_step {meta['last_step']}, history {[h['step'] for h in meta['history']]}, "
              f"metrics.jsonl epochs {epochs}, best_step {meta['best_step']} "
              f"best_acc {meta['best_acc']:.6f}")
        if rc != 0 or meta["last_step"] != 3 or "safety" in meta or \
                [h["step"] for h in meta["history"]] != [1, 2, 3] or epochs != [1, 2, 3]:
            raise AssertionError("the resumed run did not end with epochs 1-3 "
                                 "each saved and logged once")

        # in process: a fresh model, the best checkpoint, the same data and seed
        cfg = PianoBartConfig(dtype=torch.bfloat16)   # the CLI's defaults
        X_train, X_val = load_pretrain(data, ["songs"], seed=seed)
        st = create_train_state(init_lm(cfg, seed=1, device="cuda", train=True))
        runner = PretrainRunner(st, cfg, X_train, X_val, save, batch_size=B,
                                seed=seed, checkpoint_every_dispatches=1)
        t0 = time.perf_counter()
        _, best_step = runner.ckpt.restore(runner.state, best=True)
        t_restore = time.perf_counter() - t0
        va = runner.valid_epoch()
        n_tok = np.asarray(cfg.field_sizes, dtype=np.float64)
        rescored = float((va["field_acc"] * n_tok).sum() / n_tok.sum())
        diff = abs(rescored - meta["best_acc"])
        print(f"[pretrain_run] best/ (epoch {best_step}) restored into init_lm(seed=1) "
              f"in {t_restore:.2f} s, re-scored: weighted acc {rescored:.6f} vs "
              f"best_acc {meta['best_acc']:.6f}, |diff| {diff:.2e} (tol 1e-5)")
        if diff > 1e-5:
            raise AssertionError("the restored best checkpoint does not re-score best_acc")

        saves, copies = [], []
        for name in ("save", "save_safety"):
            real = getattr(runner.ckpt, name)

            def timed(*a, _real=real, _name=name, **k):
                t = time.perf_counter()
                _real(*a, **k)
                saves.append((_name, time.perf_counter() - t))
            setattr(runner.ckpt, name, timed)
        real_payload = state_mod._payload

        def timed_payload(st):   # the copy to the host, before torch.save
            t = time.perf_counter()
            out = real_payload(st)
            copies.append(time.perf_counter() - t)
            return out
        n_train, n_valid = len(X_train) // B, -(-len(X_val) // B)
        n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
        expect = _counts(k1=n_attn * (n_train + n_valid), k2=n_attn * n_train)
        _reset_counts()
        t0 = time.perf_counter()
        state_mod._payload = timed_payload
        try:
            runner.run(4, resume=True)
        finally:
            state_mod._payload = real_payload
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        counts = _read_counts()
        state["launches"]["pretrain_run"] = counts
        events = _epoch_events(save)
        last = events[-1]
        print(f"[pretrain_run] run(4, resume=True) in {wall4:.1f} s: epoch "
              f"{last['epoch']}, {n_train} train steps + {n_valid} valid batch(es) "
              f"(train {len(X_train)}, valid {len(X_val)} windows), loss "
              f"{last['train']['loss']:.4f}, weighted acc {last['weighted_acc']:.6f}")
        print(f"[pretrain_run] launches ({COUNT_NAMES}) {tuple(counts.values())}, "
              f"expected {expect}")
        if tuple(counts.values()) != expect:
            raise AssertionError(f"launches {counts}, expected {expect}")
        if last["epoch"] != 4 or not np.isfinite(last["train"]["loss"]):
            raise AssertionError("epoch 4 did not train")
        tps = [round(e["train"]["tokens_per_sec"]) for e in events]
        tokens = n_train * B * cfg.max_len
        safety = sum(t for n, t in saves if n == "save_safety")
        bare = tokens / (tokens / last["train"]["tokens_per_sec"] - safety)
        base = state["train"]
        print(f"[pretrain_run] tokens/s per epoch (B={B}, epochs 1-4, each "
              f"including its safety save) {tps}; epoch 4 without its safety save "
              f"{bare:.0f}; beside [train] of this run at B=32: {base['ms']:.1f} "
              f"ms/step, {base['tokens_s']:.0f} tokens/s")
        size = os.path.getsize(os.path.join(save, "step_4", "state.pt")) / 2**30
        print(f"[pretrain_run] checkpoint saves of epoch 4, {size:.2f} GiB a payload "
              f"(s, of which the copy to the host): " + ", ".join(
                  f"{n} {t:.2f} ({c:.2f})" for (n, t), c in zip(saves, copies))
              + f"; restore of best/ {t_restore:.2f}")
        state["pretrain_run"] = dict(saves=saves, copies=copies, tokens_s=tps,
                                     rescore_diff=diff)
    finally:
        # only what [finetune] needs outlives the phase: best/ and meta.json
        save = os.path.dirname(state["pretrain_best"])
        for d in os.listdir(save) if os.path.isdir(save) else []:
            if d not in ("best", "meta.json"):
                path = os.path.join(save, d)
                shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    print(f"[pretrain_run] wall {time.perf_counter() - t_phase:.1f} s")


def _supervised_cli(tag, argv, n_attn, n_tails=0):
    """One training command of the finetune CLI in process: each train and
    eval step timed (synchronized), launches over the run, peak device
    memory.  Checks the launches (K1 per attention per train step and per
    eval batch, delta and K2 per attention per train step, K4a and K4b per
    sublayer tail per train step when ``n_tails``: a run under
    ``PBX_FUSED_DROPLN=1``), a finite loss and ``best/``.  Returns (runner,
    train-step seconds, launches)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.train import runner as runner_mod

    runners, steps = [], {True: [], False: []}
    real_init = runner_mod.SupervisedRunner.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        step_fn = self.step_fn

        def timed(st, x, y, gen, train=True, weight=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step_fn(st, x, y, gen, train=train, weight=weight)
            torch.cuda.synchronize()
            steps[train].append(time.perf_counter() - t)
            return out
        self.step_fn = timed
        runners.append(self)

    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = _read_counts()
    t0 = time.perf_counter()
    runner_mod.SupervisedRunner.__init__ = init
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        runner_mod.SupervisedRunner.__init__ = real_init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _read_counts()
    counts = tuple(after[k] - before[k] for k in after)
    peak = torch.cuda.max_memory_allocated() / 2**30
    run = runners[0]
    with open(os.path.join(run.save_dir, "metrics.jsonl")) as f:
        epoch = [e for e in map(json.loads, f) if e["event"] == "epoch"][-1]
    n_train, n_eval = len(steps[True]), len(steps[False])
    want = (-(-len(run.X_train) // 8), -(-len(run.X_val) // 8) + -(-len(run.X_test) // 8))
    expect = _counts(k1=n_attn * (n_train + n_eval), k2=n_attn * n_train,
                     k4=n_tails * n_train)
    ms = [round(1e3 * t, 1) for t in steps[True]]
    print(f"[finetune] {tag}: exit {rc} in {wall:.1f} s; {n_train} train steps "
          f"(ms each {ms}; {np.median(ms[1:]):.1f} ms/step after the first), "
          f"{n_eval} eval batches ({1e3 * np.mean(steps[False]):.1f} ms each); "
          f"train {len(run.X_train)}, valid {len(run.X_val)}, test {len(run.X_test)} "
          f"windows; loss {epoch['train']['loss']:.4f}, valid {epoch['valid']}; "
          f"peak {peak:.2f} GiB; best/ "
          f"{os.path.isdir(os.path.join(run.save_dir, 'best'))}")
    print(f"[finetune] {tag}: launches ({COUNT_NAMES}) {counts}, expected {expect}")
    if rc != 0 or (n_train, n_eval) != want or counts != expect:
        raise AssertionError(f"{tag}: exit {rc}, steps {(n_train, n_eval)} (want "
                             f"{want}), launches {counts}")
    if not np.isfinite(epoch["train"]["loss"]) or not os.path.isdir(
            os.path.join(run.save_dir, "best")):
        raise AssertionError(f"{tag}: no finite loss or no best/")
    return run, ms, counts


def phase_finetune(state):
    """The finetunes as a user runs them, at flagship width (bf16 compute,
    f32 parameters, dropout 0.1, the CLI's B=8), in a temporary directory
    outside the checkout: 40 two-track songs by 4 composers written by the
    port's MIDI writer, tokenized by the port's ``tokenize`` for every task;
    ``finetune --task composer --ckpt`` [pretrain_run]'s ``best/`` (the
    trunk grafted onto the classifier, checked), ``finetune --task
    velocity`` and ``finetune-generation --fad --ckpt`` the same, one epoch
    each; then melody, emotion and the ablation one train and one eval step
    each through their step functions, and 4 more emotion train steps under
    the profiler."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.compat.from_jax import init_model
    from pianobart_tpu_torch.data import load_finetune
    from pianobart_tpu_torch.models import (PianoBartConfig, PianoBartLM,
                                            SequenceClassification,
                                            TokenClassification)
    from pianobart_tpu_torch.train.finetune import (finetune_seq_step,
                                                    finetune_token_step)
    from pianobart_tpu_torch.train.generation import ablation_step
    from pianobart_tpu_torch.train.state import CheckpointManager, create_train_state

    t_phase = time.perf_counter()
    pre_best = state["pretrain_best"]
    tmp = tempfile.mkdtemp(prefix="pbt_finetune_")
    state["tmpdirs"].append(tmp)
    state["finetune_dir"] = tmp
    here = os.getcwd()
    cfg = PianoBartConfig(dtype=torch.bfloat16)        # the CLI's defaults
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    try:
        os.chdir(tmp)        # the CLI writes result/finetune/<run>/ here
        rng = np.random.default_rng(SEED + 5)
        for comp in ("Bach", "Chopin", "Liszt", "Mozart"):
            os.makedirs(os.path.join("songs", comp))
            for i in range(10):      # Q1-Q4: the emotion labels of the names
                _song(rng).dump(os.path.join("songs", comp, f"Q{i % 4 + 1}_{comp}{i}.mid"))
        data = {}
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            for task in ("composer", "velocity", "generate", "melody", "emotion"):
                if cli.main(["tokenize", "--dataset", "songs", "--task", task,
                             "--out_root", os.path.join("Data", task)]) != 0:
                    raise AssertionError(f"tokenize --task {task} failed")
                data[task] = os.path.abspath(os.path.join("Data", task, "songs"))
        print(f"[finetune] tokenize --task composer/velocity/generate/melody/emotion "
              f"of 40 songs in {time.perf_counter() - t0:.1f} s: "
              + "; ".join(l for l in log.getvalue().splitlines() if "train:" in l))

        # the pretrain trunk grafted onto the composer classifier, checked
        real_graft, grafts = cli._load_init_ckpt, []

        def checked(model, args):
            drawn = {k: v.clone() for k, v in model.state_dict().items()
                     if not k.startswith("pianobart.")}
            out = real_graft(model, args)
            saved = CheckpointManager(args.ckpt).params()
            sd = out.state_dict()
            trunk = [k for k in sd if k.startswith("pianobart.")]
            grafts.append((
                all(torch.equal(sd[k], saved[k].to(sd[k].device)) for k in trunk),
                all(torch.equal(sd[k], v) for k, v in drawn.items()), len(trunk),
                len(drawn)))
            return out
        cli._load_init_ckpt = checked
        try:
            _reset_counts()
            composer, _, _ = _supervised_cli("composer", [
                "finetune", "--task", "composer", "--dataroot", data["composer"],
                "--dataset", "songs", "--epochs", "1", "--ckpt", pre_best], n_attn)
        finally:
            cli._load_init_ckpt = real_graft
        trunk_ok, head_ok, n_trunk, n_head = grafts[0]
        print(f"[finetune] composer --ckpt [pretrain_run]'s best/: {n_trunk} trunk "
              f"tensors equal the checkpoint's: {trunk_ok}; {n_head} head tensors "
              f"kept their draw: {head_ok}")
        if not (trunk_ok and head_ok):
            raise AssertionError("the graft of the pretrain trunk is wrong")
        # the fused sublayer tails from the CLI's environment, as the JAX
        # CLI's model reads it: K4a and K4b at all 40 tails a train step
        os.environ["PBX_FUSED_DROPLN"] = "1"
        try:
            velocity, _, _ = _supervised_cli("velocity (PBX_FUSED_DROPLN=1)", [
                "finetune", "--task", "velocity", "--dataroot", data["velocity"],
                "--dataset", "songs", "--epochs", "1"], n_attn,
                n_tails=2 * cfg.encoder_layers + 3 * cfg.decoder_layers)
        finally:
            os.environ.pop("PBX_FUSED_DROPLN")
        if not velocity.cfg.fused_dropout_ln:
            raise AssertionError("PBX_FUSED_DROPLN=1 did not reach the config")
        del velocity
        gen, _, _ = _supervised_cli("generation", [
            "finetune-generation", "--dataroot", data["generate"], "--datasets",
            "songs", "--fad", "--epochs", "1", "--ckpt", pre_best], n_attn)
        state["gen_best"] = os.path.abspath(os.path.join(gen.save_dir, "best"))
        # [finetune_mesh] runs the CLI over a mesh on these corpora and
        # holds its test outputs against these runs'
        state["finetune_data"] = data
        state["finetune_runs"] = {"composer": os.path.abspath(composer.save_dir),
                                  "generation": os.path.abspath(gen.save_dir)}
        # the two models [merge] merges, over [pretrain_run]'s best/
        state["merge_models"] = (os.path.abspath(os.path.join(composer.save_dir, "best")),
                                 state["gen_best"])
        del composer
        model = gen.state.model.eval()
        for p in model.parameters():
            p.grad = None
        state["gen_model"] = model
        del gen

        # melody, emotion, ablation: one train and one eval step at B=8
        def one_step(tag, cls, kw, step, task, where, profile=0):
            X, _, _, Y, _, _ = load_finetune(data[where], "songs", task)
            x = torch.as_tensor(X[:8].astype(np.int64), device="cuda")
            y = np.asarray(Y[:8]).astype(np.int64)
            if y.ndim == 3 and y.shape[-1] == 1:      # token labels (N, S, 1)
                y = y[..., 0]
            y = torch.as_tensor(y, device="cuda")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            m = init_model(cls, cfg, seed=SEED, device="cuda", train=True, **kw)
            st = create_train_state(m)
            gen_ = torch.Generator(device="cuda").manual_seed(SEED)
            before = _read_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, mt = step(st, x, y, gen_, train=True)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t
            mid = _read_counts()
            t = time.perf_counter()
            _, me = step(st, x, y, None, train=False)
            torch.cuda.synchronize()
            t_eval = time.perf_counter() - t
            after = _read_counts()
            tr = tuple(mid[k] - before[k] for k in mid)
            ev = tuple(after[k] - mid[k] for k in mid)
            losses = (mt["loss"].item(), me["loss"].item())
            print(f"[finetune] {tag}: B={len(x)} first train step {1e3 * t_train:.1f} ms, "
                  f"eval step {1e3 * t_eval:.1f} ms, losses {losses}, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches train "
                  f"{tr} eval {ev}")
            if tr != _counts(k1=n_attn, k2=n_attn) or ev != _counts(k1=n_attn) \
                    or not np.isfinite(losses).all() or st.step != 1:
                raise AssertionError(f"{tag}: launches {tr} / {ev}, losses {losses}")
            if profile:
                # where a finetune train step's time goes: the device's busy
                # share, and the clip and AdamW (foreach kernels over the
                # f32 parameters) beside the forward and backward
                _profile_window(
                    "finetune", f"{profile} {tag} train steps at B={len(x)}",
                    lambda: [step(st, x, y, gen_, train=True) for _ in range(profile)],
                    profile, {"clip + AdamW (multi_tensor_apply kernels)":
                              lambda n: "multi_tensor_apply" in n})

        one_step("melody", TokenClassification, {"class_num": 5},
                 finetune_token_step, "melody", "melody")
        one_step("emotion", SequenceClassification, {"class_num": 4},
                 finetune_seq_step, "emotion", "emotion", profile=4)
        one_step("ablation", PianoBartLM, {},
                 lambda st, x, y, g, train, weight=None: ablation_step(
                     st, x, g, train=train, weight=weight), "gen", "generate")
        state["launches"]["finetune"] = _read_counts()
    finally:
        os.chdir(here)
    print(f"[finetune] wall {time.perf_counter() - t_phase:.1f} s")


def phase_serve_ckpt(state):
    """Serving from checkpoints: the generation finetune's ``best/`` exported
    to a reference ``.ckpt`` (``export-ckpt``) and converted back
    (``convert-ckpt``, its weights checked equal); ``create_app`` over the
    directory and the file, each load timed; each loaded model's fused
    logits on one batch (B=2) against the finetuned model in memory
    (|diff| 0: the same f32 parameters, the same kernels); both loaded at
    the service's default cfg (``serve --ckpt`` as users run it), their bf16
    parameters checked equal to ``best/``'s cast; then 2 uploaded
    songs, each a ``GET /api/generate/<model>/<file>`` to both models at
    once, K1 8 launches per decode batch."""
    import contextlib
    import io

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.midi import midi_bytes
    from pianobart_tpu_torch.models import PianoBartConfig, attention_mask_from_bars
    from pianobart_tpu_torch.ops.flash import flash_attention_fwd
    from pianobart_tpu_torch.serve.app import create_app
    from pianobart_tpu_torch.serve.demo import window_to_midi
    from pianobart_tpu_torch.train.state import CheckpointManager

    t_phase = time.perf_counter()
    best, model = state.pop("gen_best"), state.pop("gen_model")
    here = os.getcwd()
    work = os.path.join(state["finetune_dir"], "serve")
    os.makedirs(work)
    ref = os.path.join(work, "generation.ckpt")
    try:
        os.chdir(work)   # App keeps uploads/ and outputs/ here
        timings = {}
        for name, argv in (("export-ckpt", ["export-ckpt", "--ckpt", best, "--output", ref]),
                           ("convert-ckpt", ["convert-ckpt", "--ckpt", ref, "--output",
                                             "converted"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(argv) != 0:
                    raise AssertionError(f"{name} failed")
            timings[name] = time.perf_counter() - t0
        a, b = CheckpointManager(best).params(), CheckpointManager("converted").params()
        same = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        print(f"[serve_ckpt] export-ckpt of best/ to a reference .ckpt "
              f"({os.path.getsize(ref) / 2**30:.2f} GiB) in {timings['export-ckpt']:.1f} s, "
              f"convert-ckpt back in {timings['convert-ckpt']:.1f} s; the converted "
              f"weights equal best/'s: {same}")
        if not same:
            raise AssertionError("export-ckpt then convert-ckpt changed the weights")

        cfg = PianoBartConfig(dtype=torch.bfloat16)   # the finetune's: f32 params
        app = create_app(ckpts={"finetuned": best, "exported": ref}, device="cuda",
                         cfg=cfg)
        payload = os.path.getsize(os.path.join(best, "state.pt")) / 2**30
        for name, svc in app.services.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc._ensure()
            torch.cuda.synchronize()
            print(f"[serve_ckpt] load '{name}' ({svc.ckpt}; "
                  f"{payload if name == 'finetuned' else os.path.getsize(ref) / 2**30:.2f}"
                  f" GiB file) in {time.perf_counter() - t0:.2f} s")
        X = np.load(os.path.join(state["finetune_dir"], "Data", "generate", "songs",
                                 "songs_test.npy"))
        x = torch.as_tensor(np.concatenate([X, X])[:2].astype(np.int64), device="cuda")
        mask = attention_mask_from_bars(x)
        with torch.no_grad():
            want = model(x, x, mask, mask)
            for name, svc in app.services.items():
                diff = (svc.model(x, x, mask, mask).float() - want.float()).abs().max().item()
                print(f"[serve_ckpt] '{name}' fused logits (B=2) against the finetuned "
                      f"model in memory: |diff| {diff}")
                if diff != 0.0:
                    raise AssertionError(f"'{name}' loads other weights (|diff| {diff})")
        del model, want
        # serve --ckpt / demo --ckpt as users run them: the service's default
        # cfg casts the f32 checkpoint into bf16 parameters on load
        for name, svc in create_app(ckpts={"finetuned": best, "exported": ref},
                                    device="cuda").services.items():
            t0 = time.perf_counter()
            svc._ensure()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = svc.model.state_dict()
            bad = sorted(set(got) ^ set(a)) + [
                k for k, v in a.items() if k in got and not torch.equal(
                    got[k].cpu(), v.to(torch.bfloat16) if v.is_floating_point() else v)]
            print(f"[serve_ckpt] load '{name}' with the default cfg (bf16 parameters) "
                  f"in {dt:.2f} s; {len(got) - len(bad)} of {len(a)} tensors equal "
                  f"best/'s cast to bf16")
            if bad:
                raise AssertionError(f"'{name}' at the default cfg: {bad[:5]} differ")
            svc.model = None
        torch.cuda.empty_cache()

        grids = {}
        for name, svc in app.services.items():
            decode = svc._decode_batch

            def recording(intros, seeds, _decode=decode, _name=name):
                out = _decode(intros, seeds)
                grids.setdefault(_name, []).extend(out)
                return out
            svc._decode_batch = recording

        def written():
            out = []
            for g in (g for gs in grids.values() for g in gs):
                if window_to_midi(g, "check.mid"):
                    with open("check.mid", "rb") as f:
                        out.append(f.read())
            return out

        rng = np.random.default_rng(SEED + 6)
        names = []
        for i in range(2):
            body = (b"--pbx\r\nContent-Disposition: form-data; name=\"file\"; "
                    b"filename=\"s.mid\"\r\n\r\n" + midi_bytes(_song(rng))
                    + b"\r\n--pbx--\r\n")
            st, _, out = _wsgi(app, "POST", "/api/upload", body,
                               "multipart/form-data; boundary=pbx")
            if st != "200 OK":
                raise AssertionError(f"upload answered {st}")
            names.append(json.loads(out)["file"])
        _reset_counts()
        answers = {}

        def client(model_name, fname):
            t = time.perf_counter()
            answers[model_name, fname] = (_wsgi(app, "GET",
                                                f"/api/generate/{model_name}/{fname}"),
                                          time.perf_counter() - t)
        threads = [threading.Thread(target=client, args=(m, f))
                   for m in app.services for f in names]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a generate request never returned")
        wall = time.perf_counter() - t0
        ends = []
        for (m, f), ((st, _, body), lat) in sorted(answers.items()):
            kind, j = _check_answer(app, st, body, written)
            ends.append(kind)
            print(f"[serve_ckpt]   {m}/{f}: {kind} in {lat:.3f} s"
                  + (f", attempts {j['attempts']} batch {j['batch_size_served']}"
                     if j else ""))
        state["launches"]["serve_ckpt"] = _read_counts()
        batches = sum(len(s.batch_sizes_served) for s in app.services.values())
        k1 = flash_attention_fwd.launches
        _, _, health = _wsgi(app, "GET", "/api/health")
        print(f"[serve_ckpt] {len(threads)} requests in {wall:.2f} s: "
              f"{ends.count('200')} x 200, {ends.count('500')} x 500 (no notes); "
              f"{batches} decode batches, K1 launches {k1} (expected "
              f"{cfg.encoder_layers * batches}); health {json.loads(health)}")
        if k1 != cfg.encoder_layers * batches:
            raise AssertionError(f"K1 launched {k1} times for {batches} decode batches")
        others = {n: c for n, c in state["launches"]["serve_ckpt"].items()
                  if c and n != "flash_attention_fwd"}
        if others:
            raise AssertionError(f"kernels off this path launched: {others}")
        for svc in app.services.values():
            svc.model = None      # the worker threads outlive the phase
    finally:
        os.chdir(here)
    torch.cuda.empty_cache()
    print(f"[serve_ckpt] wall {time.perf_counter() - t_phase:.1f} s")


def _close(card, host, pre=None, rtol=1e-6, atol=1e-7):
    """(max |card - host|, whether every entry is within ``rtol * |host| +
    atol``, entries decided apart, entries) over a state_dict, the host in
    float64.  With ``pre`` (a selection: TIES, a magnitude mask) an entry
    that one side leaves at its pretrained value and the other does not was
    decided apart: f32 deltas against exact ones may order entries at a
    threshold apart.  Those are counted, not compared."""
    worst, ok, apart, n = 0.0, True, 0, 0
    for k, h in host.items():
        c = card[k].cpu()
        d = (c.double() - h).abs()
        if pre is not None:
            split = (c == pre[k]) != (h == pre[k].double())
            apart += int(split.sum())
            d = d.masked_fill(split, 0.0)
        worst = max(worst, float(d.max()))
        ok = ok and bool((d <= rtol * h.abs() + atol).all())
        n += h.numel()
    return worst, ok, apart, n


def _rel_by_group(got, want):
    """||got - want|| / ||want|| over each ``_grad_groups`` group, for
    trunk-named state_dicts (a group's norm, as ``_grad_check`` takes it:
    an entry whose exact value is 0, as a key bias's gradient is, carries
    only rounding on both sides)."""
    sums = {}
    for k, w in want.items():
        d, r = sums.setdefault(_grad_groups("pianobart." + k), [0.0, 0.0])
        sums[_grad_groups("pianobart." + k)] = [
            d + (got[k].double() - w.double()).square().sum().item(),
            r + w.double().square().sum().item()]
    return {g: (d / r) ** 0.5 for g, (d, r) in sums.items()}


def _merge_stats_vs_plain(cfg, trunk, batch):
    """One Fisher batch (the trunk's LM-loss gradients) and one RegMean
    batch (its Dense-input Grams) at the merge's shape, f32, through the
    kernels (K1, delta, K2 and the prep; K1 and the prep) against the same
    trunk and batch on the plain attention path.  Both keep f32 accuracy
    (3xTF32 products against f32 ones, TF32 off) and differ by summation
    order, as in ``_grad_check``: tolerance 1e-3 on each group's relative
    norm; a wrong tile, mask or lse moves an attention's output and
    everything after it by far more.  The last window's last 200 rows
    become PAD, as a song's end leaves them, so the masks are held too."""
    import numpy as np
    import torch
    from pianobart_tpu_torch import vocab as V
    from pianobart_tpu_torch.merge import cli as merge_cli
    batch = batch.copy()
    batch[-1, -200:] = np.asarray(V.PAD)
    head = merge_cli._template_head(cfg)
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    real = (batch[..., 0] != V.PAD[0]).sum(axis=1).tolist()
    out = {}
    for what, c, fisher, gram in (
            ("kernels", cfg, _counts(k1=n_attn, k2=n_attn, f32=True),
             _counts(k1=n_attn, f32=True)),
            ("plain", cfg.replace(use_flash_attention=False), _counts(), _counts())):
        _reset_counts()
        grads = merge_cli._lm_grad_fn(c, head, "cuda")(trunk, batch)
        torch.cuda.synchronize()
        got_f = tuple(_read_counts().values())
        _reset_counts()
        grams = merge_cli._trunk_grams(c, trunk, [batch], "cuda")
        torch.cuda.synchronize()
        got_g = tuple(_read_counts().values())
        print(f"[merge] one Fisher and one RegMean batch via {what} (B={len(batch)}, S="
              f"{batch.shape[1]}, real rows {real}): launches ({COUNT_NAMES}) {got_f} and "
              f"{got_g}, expected {fisher} and {gram}")
        if (got_f, got_g) != (fisher, gram):
            raise AssertionError(f"the merge statistics via {what} launched {got_f}, {got_g}")
        out[what] = (grads, grams)
    tol = 1e-3
    for i, name in enumerate(("Fisher gradients", "RegMean Grams")):
        rels = _rel_by_group(out["kernels"][i], out["plain"][i])
        print(f"[merge] {name}, kernels against plain attention: ||d||/||plain|| "
              f"per group (tol {tol:g}):")
        for g, rel in sorted(rels.items()):
            print(f"[merge]   {g:28s} {rel:.3e}")
        if not max(rels.values()) <= tol:
            raise AssertionError(f"{name} through the kernels disagree with plain attention")
    del out
    torch.cuda.empty_cache()


def phase_merge(state):
    """Model merging as a user runs it, at flagship width (f32 parameters
    and compute, as ``run_merge`` builds the model): [finetune]'s composer
    and generation ``best/`` merged over [pretrain_run]'s ``best/`` by the
    port's ``merge`` CLI in process, every method (average, task arithmetic,
    TIES, the random mask over average, the magnitude mask over TIES,
    Fisher and RegMean on 32 windows of [pretrain_run]'s data in batches of
    4), each with its seconds, peak memory and launches (Fisher: K1, delta
    and K2 24 per batch per model, the f32 prep before each K1 and K2;
    RegMean: K1 and the prep 24 per batch per model; the rest none); the
    deterministic methods held against the same functions on the host, in
    f32 (equal) and in float64, TIES's thresholds equal; the Fisher pass timed by ``StepTimer``
    and one RegMean batch traced with its memory; then ``--head_from`` the
    generation ``best/`` to a ``.msgpack``, loaded at f32 (its logits those
    of the merge in memory, |diff| 0) and at the service's bf16 to serve 2
    uploaded songs (K1 8 per decode batch), and grafted by ``finetune
    --ckpt`` onto a classifier."""
    import contextlib
    import io

    import numpy as np
    import torch
    from pianobart_tpu_torch import cli
    from pianobart_tpu_torch.compat.from_jax import init_model
    from pianobart_tpu_torch.decode import checkpoint_entries, load_inference_model
    from pianobart_tpu_torch.merge import cli as merge_cli
    from pianobart_tpu_torch.merge import methods
    from pianobart_tpu_torch.midi import midi_bytes
    from pianobart_tpu_torch.models import (PianoBartConfig, PianoBartLM,
                                            SequenceClassification,
                                            attention_mask_from_bars)
    from pianobart_tpu_torch.ops.flash import flash_attention_fwd
    from pianobart_tpu_torch.serve.app import create_app
    from pianobart_tpu_torch.serve.demo import window_to_midi
    from pianobart_tpu_torch.utils.profiling import (MEMORY_FILE, TRACE_FILE,
                                                     StepTimer, trace)

    t_phase = time.perf_counter()
    pre = state["pretrain_best"]
    composer, generation = state.pop("merge_models")
    data = state["pretrain_data"]
    work = os.path.join(state["finetune_dir"], "merge")
    os.makedirs(work)
    cfg = PianoBartConfig()                      # run_merge's default
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    n_win = min(32, len(np.load(data, mmap_mode="r")))
    n_batches = len(range(0, n_win, 4))
    base = ["merge", "--models", composer, generation, "--pretrained", pre,
            "--data", data, "--num_examples", "32", "--device", "cuda"]
    runs = (("average_merging", ["--method", "average_merging"], _counts()),
            ("task_arithmetic", ["--method", "task_arithmetic"], _counts()),
            ("ties_merging", ["--method", "ties_merging"], _counts()),
            ("mask random/average", ["--method", "mask_merging"], _counts()),
            ("mask magnitude/ties", ["--method", "mask_merging", "--mask_strategy",
                                     "magnitude", "--mask_apply_method", "ties_merging"],
             _counts()),
            ("fisher_merging", ["--method", "fisher_merging"],
             _counts(k1=2 * n_batches * n_attn, k2=2 * n_batches * n_attn, f32=True)),
            ("regmean_merging", ["--method", "regmean_merging"],
             _counts(k1=2 * n_batches * n_attn, f32=True)))
    merged, timer = {}, StepTimer()
    real_merge, real_fisher = merge_cli.merge, methods.compute_fisher_weights

    def keeping(args, cfg=None):
        out = real_merge(args, cfg)
        merged[args.output] = out
        return out

    def timed_fisher(*a, **k):
        with timer:
            return timer.observe(real_fisher(*a, **k))
    print(f"[merge] {composer} and {generation} over {pre}; --data {n_win} windows "
          f"in {n_batches} batches of 4; f32 parameters and compute")
    merge_cli.merge, methods.compute_fisher_weights = keeping, timed_fisher
    try:
        _reset_counts()
        for name, extra, expect in runs:
            out = os.path.join(work, name.replace(" ", "_").replace("/", "_") + ".msgpack")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = _read_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as log:
                rc = cli.main(base + extra + ["--output", out])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = _read_counts()
            counts = tuple(after[k] - before[k] for k in after)
            size = os.path.getsize(out) / 2**30
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[merge] {name}: {dt:.1f} s, peak {peak:.2f} GiB, {size:.2f} GiB file; launches ({COUNT_NAMES}) {counts}, expected "
                  f"{expect}; {log.getvalue().strip()}")
            if rc != 0 or counts != expect:
                raise AssertionError(f"{name}: exit {rc}, launches {counts}")
            if name == "fisher_merging":
                print(f"[merge] fisher_merging: the Fisher pass of each model by StepTimer "
                      f"{timer.count} x {timer.mean_ms:.0f} ms ({n_batches} batches, B=4)")
            if name != "ties_merging":
                os.remove(out)
                merged.pop(out)
        # --head_from: the merged trunk with the generation finetune's LM head
        head_path = os.path.join(work, "merged.msgpack")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(base + ["--method", "ties_merging", "--head_from", generation,
                                  "--output", head_path])
        print(f"[merge] ties_merging --head_from the generation best/: exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s")
        state["launches"]["merge"] = _read_counts()
    finally:
        merge_cli.merge, methods.compute_fisher_weights = real_merge, real_fisher
    if rc != 0:
        raise AssertionError("merge --head_from failed")

    # the deterministic methods on the card against the host: in f32 (the
    # same arithmetic: equal entry for entry) and in float64
    trunks = {n: merge_cli._trunk(checkpoint_entries(p, cfg), "cuda")
              for n, p in (("pre", pre), ("composer", composer), ("generation", generation))}
    host32 = {n: {k: v.cpu() for k, v in t.items()} for n, t in trunks.items()}
    host = {n: {k: v.double() for k, v in t.items()} for n, t in host32.items()}
    ties_file = os.path.join(work, "ties_merging.msgpack")
    cli_ties = merged.pop(ties_file)
    same = all(torch.equal(cli_ties[merge_cli.TRUNK + k], v) for k, v in
               methods.ties_merging(trunks["pre"], [trunks["composer"],
                                                    trunks["generation"]]).items())
    print(f"[merge] the CLI's ties_merging equals the function's on the same trunks: {same}")
    if not same:
        raise AssertionError("the merge CLI does not compute ties_merging")
    cases = (("average_merging", False, lambda t: methods.average_merging(
                 [t["composer"], t["generation"]])),
             ("task_arithmetic", False, lambda t: methods.task_arithmetic(
                 t["pre"], [t["composer"], t["generation"]])),
             ("ties_merging", True, lambda t: methods.ties_merging(
                 t["pre"], [t["composer"], t["generation"]])),
             ("magnitude mask (composer)", True, lambda t: methods.mask_model_weights(
                 t["composer"], t["pre"], mask_strategy="magnitude")),
             ("magnitude mask (generation)", True, lambda t: methods.mask_model_weights(
                 t["generation"], t["pre"], mask_strategy="magnitude", seed=1)))
    for name, selects, fn in cases:
        t0 = time.perf_counter()
        card = fn(trunks)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        want32 = fn(host32)
        equal = all(torch.equal(card[k].cpu(), v) for k, v in want32.items())
        del want32
        t0 = time.perf_counter()
        want = fn(host)
        t_host = time.perf_counter() - t0
        worst, ok, apart, n = _close(card, want, host32["pre"] if selects else None)
        # at most one entry in a million decided apart at a threshold
        print(f"[merge] {name}: card (f32) {t_card:.2f} s; equal to the host's f32 entry "
              f"for entry: {equal}; against the host's float64 ({t_host:.1f} s): max "
              f"|diff| {worst:.3e} (tol rtol 1e-6, atol 1e-7), {apart} of {n} entries "
              f"decided apart (at most 1e-6 of them): {'ok' if ok else 'FAIL'}")
        if not (equal and ok and apart <= 1e-6 * n):
            raise AssertionError(f"{name} on the card disagrees with the host")
        del card, want
    # TIES's trim thresholds: the k-th smallest |delta| of each model, k =
    # int(0.8 * total), on the card (a sort) against the host (kthvalue); the
    # card's kthvalue timed for the record (PR 12 timed the host's sort too:
    # 30 s, which is why the host keeps kthvalue)
    for n in ("composer", "generation"):
        flat = torch.cat([(trunks[n][k] - trunks["pre"][k]).reshape(-1)
                          for k in trunks["pre"]]).abs()
        k = int(flat.numel() * 0.8)
        thr = methods._kth_smallest(flat, k)
        t_thr = _time_ms(lambda: methods._kth_smallest(flat, k), iters=3, warmup=1)
        kth = []
        t_kth = _time_ms(lambda: kth.append(torch.kthvalue(flat, k).values), iters=1,
                         warmup=0)
        hflat = torch.cat([(host[n][key] - host["pre"][key]).reshape(-1)
                           for key in host["pre"]]).abs()
        t0 = time.perf_counter()
        hthr = methods._kth_smallest(hflat, k)
        t_host = time.perf_counter() - t0
        equal = thr.item() == np.float32(hthr.item()) == kth[0].item()
        print(f"[merge] TIES threshold of {n} over {flat.numel()} entries: card "
              f"{thr.item():.9e} (by a sort {t_thr:.1f} ms; kthvalue {t_kth:.1f} ms; CUDA "
              f"events), host float64 {hthr.item():.12e} (kthvalue {1e3 * t_host:.0f} "
              f"ms); equal: {equal}")
        if not equal:
            raise AssertionError("TIES thresholds differ between the card and the host")
        del flat, hflat
    # the random mask over average: each model's kept share of its delta
    for i, n in enumerate(("composer", "generation")):
        masked = methods.mask_model_weights(trunks[n], trunks["pre"], seed=i)
        kept = sum(int((masked[k] != trunks["pre"][k]).sum()) for k in masked)
        moved = sum(int((trunks[n][k] != trunks["pre"][k]).sum()) for k in masked)
        frac, sigma = kept / moved, (0.2 * 0.8 / moved) ** 0.5
        print(f"[merge] random mask of {n} (seed {i}): kept {frac:.5f} of the {moved} "
              f"moved entries against 1 - 0.8 = 0.2 (4 sigma {4 * sigma:.1e})")
        if abs(frac - 0.2) > 4 * sigma + 1e-4:
            raise AssertionError("the random mask's kept fraction is off")
        del masked
    del host, host32
    # one RegMean batch under the profiler, with the allocator's history
    batch = np.load(data)[:4].astype(np.int64)
    log_dir = os.path.join(work, "trace")
    with trace(log_dir, with_memory=True):
        merge_cli._trunk_grams(cfg, trunks["composer"], [batch], "cuda")
        torch.cuda.synchronize()
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k1_seen = any("flash_fwd_tf32_kernel" in nm for nm in names)
    snap = os.path.getsize(os.path.join(log_dir, MEMORY_FILE)) / 2**20
    print(f"[merge] trace of one RegMean batch: {len(names)} event names, K1 "
          f"(flash_fwd_tf32_kernel) among them: {k1_seen}; memory snapshot {snap:.1f} MiB")
    if not k1_seen or snap <= 0:
        raise AssertionError("the trace lacks K1 or the memory snapshot")
    _merge_stats_vs_plain(cfg, trunks["composer"], batch)
    del trunks
    torch.cuda.empty_cache()

    # the load form: the .msgpack at f32 against the merge in memory
    sd = merged.pop(head_path)
    x = torch.as_tensor(np.load(data)[:2].astype(np.int64), device="cuda")
    mask = attention_mask_from_bars(x)
    t0 = time.perf_counter()
    loaded = load_inference_model(cfg, head_path, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    ref = PianoBartLM(cfg, device="cuda").eval()
    ref.load_state_dict(sd)
    with torch.no_grad():
        diff = (loaded(x, x, mask, mask) - ref(x, x, mask, mask)).abs().max().item()
    print(f"[merge] {os.path.getsize(head_path) / 2**30:.2f} GiB .msgpack loaded at f32 "
          f"in {t_load:.2f} s: fused logits (B=2) against the merge in memory: |diff| {diff}")
    if diff != 0.0:
        raise AssertionError(f"the .msgpack loads other weights (|diff| {diff})")
    del loaded, ref
    # finetune --ckpt: the merged trunk grafted onto a classifier
    clf = init_model(SequenceClassification, PianoBartConfig(dtype=torch.bfloat16),
                     seed=SEED, device="cuda", train=True, class_num=8)
    head0 = {k: v.clone() for k, v in clf.state_dict().items()
             if not k.startswith(merge_cli.TRUNK)}

    class Args:
        ckpt, nopretrain = head_path, False
    cli._load_init_ckpt(clf, Args)
    got = clf.state_dict()
    trunk_ok = all(torch.equal(got[k], v) for k, v in sd.items()
                   if k.startswith(merge_cli.TRUNK))
    head_ok = all(torch.equal(got[k], v) for k, v in head0.items())
    print(f"[merge] finetune --ckpt the .msgpack: the classifier's trunk equals the "
          f"merge's: {trunk_ok}; its head kept its draw: {head_ok}")
    if not (trunk_ok and head_ok):
        raise AssertionError("the merged trunk did not graft")
    del clf, head0, got, sd
    torch.cuda.empty_cache()

    # serve --ckpt merged=<file> at the service's default (bf16 parameters)
    here = os.getcwd()
    try:
        os.chdir(work)
        app = create_app(ckpts={"merged": head_path}, device="cuda")
        svc = app.services["merged"]
        t0 = time.perf_counter()
        svc._ensure()
        torch.cuda.synchronize()
        print(f"[merge] serve --ckpt merged=<.msgpack>: loaded with bf16 parameters in "
              f"{time.perf_counter() - t0:.2f} s")
        grids = []
        decode = svc._decode_batch

        def recording(intros, seeds):
            out = decode(intros, seeds)
            grids.extend(out)
            return out
        svc._decode_batch = recording

        def written():
            out = []
            for g in grids:
                if window_to_midi(g, "check.mid"):
                    with open("check.mid", "rb") as f:
                        out.append(f.read())
            return out
        rng = np.random.default_rng(SEED + 7)
        names = []
        for _ in range(2):
            body = (b"--pbx\r\nContent-Disposition: form-data; name=\"file\"; "
                    b"filename=\"s.mid\"\r\n\r\n" + midi_bytes(_song(rng))
                    + b"\r\n--pbx--\r\n")
            st, _, out = _wsgi(app, "POST", "/api/upload", body,
                               "multipart/form-data; boundary=pbx")
            if st != "200 OK":
                raise AssertionError(f"upload answered {st}")
            names.append(json.loads(out)["file"])
        _reset_counts()
        answers = {}

        def client(fname):
            t = time.perf_counter()
            answers[fname] = (_wsgi(app, "GET", f"/api/generate/merged/{fname}"),
                              time.perf_counter() - t)
        threads = [threading.Thread(target=client, args=(f,)) for f in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a generate request never returned")
        ends = []
        for f, ((st, _, body), lat) in sorted(answers.items()):
            kind, _ = _check_answer(app, st, body, written)
            ends.append(kind)
            print(f"[merge]   merged/{f}: {kind} in {lat:.3f} s")
        batches = len(svc.batch_sizes_served)
        k1 = flash_attention_fwd.launches
        others = {n: c for n, c in _read_counts().items() if c and n != "flash_attention_fwd"}
        print(f"[merge] {len(threads)} requests to the merged model: {ends.count('200')} x "
              f"200, {ends.count('500')} x 500 (no notes); {batches} decode batches, K1 "
              f"launches {k1} (expected {cfg.encoder_layers * batches})")
        if k1 != cfg.encoder_layers * batches or others:
            raise AssertionError(f"K1 launched {k1} times for {batches} decode batches; "
                                 f"others {others}")
        svc.model = None
    finally:
        os.chdir(here)
    torch.cuda.empty_cache()
    print(f"[merge] wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# [parallel]: the mesh over torch.distributed (ring attention, TP∘SP, dp)
# ---------------------------------------------------------------------------

# the flagship mesh steps of [parallel]: (dp, tp, sp), S; B=2
# (mesh, S, heads): the flagship's 8 heads of 128, and --heads 2 (head
# width 512, clusters) at 1x1x2.  The CPU tests hold the 2x1x1 step and
# --heads 4's 1x1x2 (tests/test_torch_sp_train.py, test_torch_head256.py),
# and [finetune_mesh] runs dp meshes here; the ring at D=256 stays above.
PARALLEL_STEPS = (((1, 1, 2), 2048, 8), ((2, 1, 2), 2048, 8),
                  ((1, 2, 2), 2048, 8), ((1, 1, 2), 4096, 8), ((1, 1, 2), 2048, 2))


def _mesh_cfg(cfg, shape):
    dp, tp, sp = shape
    if tp > 1:
        return cfg.replace(ring_axis="sp", ring_tp_axis="tp", ring_tp_size=tp)
    return cfg.replace(ring_axis="sp") if sp > 1 else cfg


def _mesh_step_counts(shape, S, sp_index, n_layers=8, f32=False):
    """Expected launches of one rank's flagship step: K1 once per visible
    ring block (encoder self and cross attention see both of 2 shards, the
    causal decoder self attention the shards up to its own), then delta
    once per attention and K2 (local shard <= 1024 rows) or K3a and K3b per
    visible block; without a ring the dense step's 24 (K3 past 1024 rows);
    in f32 one tf32 prep launch per K1, K2, K3a and K3b."""
    if shape[1] == 1 and shape[2] == 1:
        blocks = 3 * n_layers
    else:
        blocks = n_layers * (shape[2] + (1 + sp_index) + shape[2])
    local = S // shape[2]
    k2, k3 = (blocks, 0) if local <= 1024 else (0, blocks)
    split = blocks + k2 + 2 * k3 if f32 else 0
    return (blocks, k2, k3, k3, 3 * n_layers, split, 0, 0, 0, 0)


def _ring_case(mesh, S, dtype, causal, B=4, H=8, D=128):
    """``ring_attention`` over the sp axis of ``mesh`` at (B, S, H, D)
    against the plain ring and against dense ``flash_attention`` on the
    card, output and q/k/v gradients; sample 1 ends in S/8 pad rows, sample
    3 (where B > 3) in 3S/8 (at sp=4 its whole last shard).  Returns this
    rank's errors and times."""
    import torch
    from pianobart_tpu_torch.ops.flash import flash_attention
    from pianobart_tpu_torch.ops.ring import ring_attention, ring_attention_reference
    ax = mesh.axis("sp")
    g = torch.Generator(device="cuda").manual_seed(SEED + S)
    q, k, v, dout = (torch.randn(B, S, H, D, device="cuda", generator=g)
                     for _ in range(4))
    q, k, v, dout = (q * D ** -0.5).to(dtype), k.to(dtype), v.to(dtype), dout.to(dtype)
    mask = torch.ones(B, S, device="cuda")
    mask[1, S - S // 8:] = 0.0
    if B > 3:
        mask[3, S - 3 * S // 8:] = 0.0
    out = {}
    for tag, fn in (("kernels", ring_attention), ("plain", ring_attention_reference)):
        ql, kl, vl = (mesh.cols(x).detach().clone().requires_grad_() for x in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(ql, kl, vl, mesh.cols(mask), causal, ax)
        o.backward(mesh.cols(dout))
        torch.cuda.synchronize()
        out[tag] = ([o.detach(), ql.grad, kl.grad, vl.grad], time.perf_counter() - t0)
    qd, kd, vd = (x.detach().clone().requires_grad_() for x in (q, k, v))
    od = flash_attention(qd, kd, vd, mask, causal)
    od.backward(dout)
    dense = [mesh.cols(x) for x in (od.detach(), qd.grad, kd.grad, vd.grad)]
    # Per tensor |d| <= atol*max|ref| + rtol*|ref| and ||d|| <= ntol*||ref||.
    # Against the plain ring: the kernels' own backward tolerances ([flash_bwd],
    # set at up to 2048 keys a row; f32 errors grow with the keys summed over,
    # so the f32 one scales with S/2048).  Against dense attention: bf16
    # rounds each block's output before the f32 merge (as the reference's
    # ring), one rounding more than dense attention: twice the bf16
    # tolerance; in f32 both sides are kernel results (K2 or K3 over the
    # shard, K3 over S past 1024 rows): the sum of their norm tolerances,
    # the per-element one as [flash]'s f32 (1e-4), each scaled as above.
    f = S / 2048
    tol_plain = ((1e-2, 1e-2, 1e-2) if dtype == torch.bfloat16
                 else (1e-5 * f, 1e-5 * f, 1e-5 * f))
    tol_dense = ((2e-2, 2e-2, 2e-2) if dtype == torch.bfloat16
                 else (1e-4 * f, 1e-4 * f, 2e-5 * f))
    e_plain, r_plain, ok_plain = _bwd_errors(out["kernels"][0], out["plain"][0], tol_plain)
    e_dense, r_dense, ok_dense = _bwd_errors(out["kernels"][0], dense, tol_dense)
    return {"sp": mesh.shape["sp"], "B": B, "S": S, "H": H, "D": D,
            "dtype": str(dtype)[6:], "causal": causal,
            "err_plain": e_plain, "rel_plain": r_plain, "ok_plain": ok_plain,
            "err_dense": e_dense, "rel_dense": r_dense, "ok_dense": ok_dense,
            "tol_plain": tol_plain, "tol_dense": tol_dense,
            "s_kernels": out["kernels"][1], "s_plain": out["plain"][1]}


def _rel_groups(got, want):
    """||got - want|| / ||want|| per ``_grad_groups`` group of two
    name -> gradient dicts of the LM."""
    sums = {}
    for n, w in want.items():
        d, r = sums.get(_grad_groups(n), (0.0, 0.0))
        sums[_grad_groups(n)] = (d + (got[n].double() - w.double()).square().sum().item(),
                                 r + w.double().square().sum().item())
    return {g: (d / r) ** 0.5 for g, (d, r) in sums.items()}


def _held(model):
    """What this rank holds right after a step, read before anything else
    allocates: its parameter elements, ``memory_allocated`` and the peak
    since the step's window opened, in GiB."""
    import torch
    return {"params_held": sum(p.numel() for p in model.parameters()),
            "alloc_gib": torch.cuda.memory_allocated() / 2**30,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _whole_grads(model, mesh):
    """The whole gradients by name (tp shards gathered over the mesh's tp
    axis), and whether each shard this rank holds is this rank's slice of
    the gathered one."""
    import torch
    from pianobart_tpu_torch.parallel.mesh import (gather_state_dict, shard_slice,
                                                   sharded_dims)
    own = {n: p.grad.detach() for n, p in model.named_parameters()}
    dims, tp = sharded_dims(model), mesh.axis("tp")
    got = gather_state_dict(own, dims, tp)
    ok = all(torch.equal(own[n], shard_slice(got[n], tp.size, tp.index, d))
             for n, d in dims.items())
    return got, ok


def _held_line(rows):
    """Per rank: parameter elements held, GiB allocated after the step, peak."""
    return (f"per rank: parameter elements held {[r['params_held'] for r in rows]}, "
            f"allocated after the step GiB {[round(r['alloc_gib'], 3) for r in rows]}, "
            f"peak GiB {[round(r['peak_gib'], 3) for r in rows]}")


def _parallel_rank(rank, world, out_dir):
    """One of [parallel]'s four ranks, all on cuda:0 over gloo: the ring
    checks at sp = 2 (a 2x1x2 mesh: two rings; also at head width 256, bf16)
    and 4, then the flagship mesh steps of ``PARALLEL_STEPS`` (rank 0 also
    runs the dense step on the same weights and corruption, once per S and
    head count, and holds each mesh's loss and clipped gradients against
    it), one step each on the parameters ``shard_params`` placed (tp > 1:
    this rank's slices of the qkv, mlp and vocab leaves), its launches
    counted from 0 on this rank, its seconds, the parameter elements it
    holds, its memory allocated after the step and its peak; the gradient
    shards gathered whole for the comparisons."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.compat.from_jax import init_lm
    from pianobart_tpu_torch.models import PianoBartConfig, PianoBartLM
    from pianobart_tpu_torch.ops.noise import corrupt_batch
    from pianobart_tpu_torch.ops.ring import transport
    from pianobart_tpu_torch.parallel.mesh import make_mesh, shard_params
    from pianobart_tpu_torch.train.pretrain import _update
    from pianobart_tpu_torch.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu_torch.train.state import create_train_state
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = {"device": f"{dev} ({torch.cuda.get_device_name(0)})", "ring": [], "steps": []}
    for sp in (2, 4):
        mesh = make_mesh(world // sp, 1, sp, device=dev)
        res["backend"] = mesh.backend
        res[f"transport_sp{sp}"] = transport(mesh.axis("sp"), dev)
        for S in (2048, 4096):
            for dtype in (torch.bfloat16, torch.float32):
                for causal in (False, True):
                    res["ring"].append(_ring_case(mesh, S, dtype, causal))
        if sp == 2:      # --heads 4 and 2: K1 and K2 at D=256 and 512 on shards of 1024
            for width in (H256, WIDTHS["h512"]):
                for causal in (False, True):
                    res["ring"].append(_ring_case(mesh, 2048, torch.bfloat16, causal, **width))
            # --hs 2048 --heads 1: the clusters of 8 (bf16) and 16 (f32) CTAs
            for dtype in (torch.bfloat16, torch.float32):
                for causal in (False, True):
                    res["ring"].append(_ring_case(mesh, 2048, dtype, causal, B=2,
                                                  **WIDTHS["h2048"]))
            # --hs 4096 --heads 1: bf16 clusters of 16 CTAs (f32 past 2048
            # raises: [train_h4096])
            for causal in (False, True):
                res["ring"].append(_ring_case(mesh, 2048, torch.bfloat16, causal, B=2,
                                              **WIDTHS["h4096"]))
    torch.cuda.empty_cache()
    cfg0 = PianoBartConfig(dtype=torch.bfloat16, dropout=0.0, max_len=4096)
    sd = init_lm(cfg0, seed=SEED, device=dev, train=True).state_dict()
    totals, dense_by = {}, {}
    for shape, S, heads in PARALLEL_STEPS:
        mesh = make_mesh(*shape, device=dev)
        if mesh is None:                    # ranks outside a 2-rank mesh
            continue
        # --heads 4 has the flagship's parameter shapes: the same weights
        base = cfg0.replace(num_heads=heads)
        cfg = _mesh_cfg(base, shape)
        batch = torch.as_tensor(_pretrain_batch(2, S, np.random.default_rng(SEED + S)),
                                device=dev)
        rec = {"shape": shape, "S": S, "heads": heads, "coords": mesh.coords}
        if rank == 0 and (S, heads) not in dense_by:
            # the dense step on the same weights and corruption, once per S and heads
            dense = PianoBartLM(base, device=dev).train()
            dense.load_state_dict(sd)
            dstate = create_train_state(dense)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            corrupted, loss_mask = corrupt_batch(batch, gen)
            m = _update(dstate, batch, corrupted, loss_mask, gen)
            dense_by[S, heads] = (
                {n: p.grad.detach().clone() for n, p in dense.named_parameters()},
                (m["loss"].item(), m["grad_norm"].item()))
            del dense, dstate
        if rank == 0:
            want, rec["dense"] = dense_by[S, heads]
        model = PianoBartLM(cfg, device=dev).train()
        model.load_state_dict(sd)
        # tp > 1: this rank keeps its slices of the qkv, mlp and vocab leaves
        st = create_train_state(shard_params(model, mesh))
        step = make_sp_pretrain_step(cfg, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(st, batch, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        rec["s_per_step"] = [time.perf_counter() - t0]
        counts = _read_counts()
        for kname, n in counts.items():
            totals[kname] = totals.get(kname, 0) + n
        rec["counts"] = tuple(counts.values())
        rec.update(_held(model))
        rec["loss"], rec["grad_norm"] = m["loss"].item(), m["grad_norm"].item()
        got, rec["shards_ok"] = _whole_grads(model, mesh)
        rec["grad_sq"] = sum(float(g.double().square().sum()) for g in got.values())
        if rank == 0:
            rec["rel"] = _rel_groups(got, want)
        res["steps"].append(rec)
        del model, st, step, got
        torch.cuda.empty_cache()
    del dense_by
    res["launches"] = totals
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _nccl_refusal():
    """``pretrain --mesh 1x1x2 --dist_backend nccl`` as the second of two
    ranks on this one card: the CLI exits with the reason before any
    process group exists."""
    import torch
    from pianobart_tpu_torch import cli
    n = torch.cuda.device_count() + 1
    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "RANK")}
    os.environ.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), RANK="1")
    try:
        cli.main(["pretrain", "--mesh", f"1x1x{n}", "--dist_backend", "nccl",
                  "--batch_size", str(n), "--max_seq_len", str(1024 * n)])
    except SystemExit as exc:
        msg = str(exc)
    else:
        raise AssertionError("nccl with more ranks than cards was not refused")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if "one rank per card" not in msg or torch.distributed.is_initialized():
        raise AssertionError(f"nccl refusal: {msg!r}")
    print(f"[parallel] --dist_backend nccl, {n} ranks on {torch.cuda.device_count()} "
          f"card(s): refused before any process group: {msg}")


def _torchrun(argv, cwd, log):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    pianobart_tpu_torch.cli`` + ``argv`` in ``cwd`` (two ranks, as a user
    starts a mesh job), its output into ``log``; the job and every process
    it started are killed past 400 s.  Returns (exit code, seconds, the
    output's lines)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.dirname(os.path.abspath(__file__)),
                      os.environ.get("PYTHONPATH")])), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "pianobart_tpu_torch.cli"] + argv
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=400)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall = time.perf_counter() - t0
    with open(log) as f:
        return rc, wall, f.read().splitlines()


def _parallel_cli(tmp):
    """The user path: 64 songs tokenized at 2048 by the CLI, then
    ``torch.distributed.run --standalone --nproc_per_node 2 -m
    pianobart_tpu_torch.cli pretrain --mesh 1x1x2 --dist_backend gloo
    --max_seq_len 2048`` for one epoch at B=4; exit 0, a finite loss,
    ``best/`` written once."""
    import contextlib
    import io
    import math

    import numpy as np
    from pianobart_tpu_torch import cli
    rng = np.random.default_rng(SEED + 13)
    songs = os.path.join(tmp, "songs")
    os.makedirs(songs)
    for i in range(64):
        _song(rng).dump(os.path.join(songs, f"song{i:02d}.mid"))
    data = os.path.join(tmp, "Data")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(["tokenize", "--dataset", songs, "--no_pad", "--out_root", data,
                       "--max_seq_len", "2048"])
    if rc != 0:
        raise AssertionError(f"tokenize at 2048: {log.getvalue()[-2000:]}")
    rc, wall, lines = _torchrun([
        "pretrain", "--dataroot", data, "--datasets", "songs", "--mesh", "1x1x2",
        "--dist_backend", "gloo", "--max_seq_len", "2048", "--batch_size", "4",
        "--epochs", "1"], tmp, os.path.join(tmp, "cli.log"))
    for line in lines:
        if line.startswith(("rank ", "train ", "Epoch", "Time cost", "Traceback")) \
                or "Error" in line:
            print(f"[parallel]   cli| {line[:300]}")
    save = os.path.join(tmp, "result", "pretrain", "pianobart")
    meta = _meta(save) or {}
    events = _epoch_events(save) if os.path.exists(os.path.join(save, "metrics.jsonl")) else []
    loss = events[0]["train"]["loss"] if events else float("nan")
    print(f"[parallel] user path: torch.distributed.run pretrain --mesh 1x1x2 "
          f"--dist_backend gloo --max_seq_len 2048, B=4, 1 epoch: exit {rc} in "
          f"{wall:.1f} s (2 ranks sharing one card); train loss {loss}; meta best_step "
          f"{meta.get('best_step')}, history {[h['step'] for h in meta.get('history', [])]}")
    if rc != 0 or not math.isfinite(loss) or meta.get("best_step") != 1 or \
            len(events) != 1 or not os.path.exists(os.path.join(save, "best", "state.pt")):
        raise AssertionError("the mesh pretrain CLI did not end with exit 0, a finite "
                             "loss and best/ written once:\n" + "\n".join(lines[-40:]))


def _step_rows(ranks, step, keys):
    """Every rank's record of rank 0's ``step`` (the ranks of its mesh):
    the one that agrees with it on ``keys``."""
    return [rec for r in ranks for rec in r["steps"]
            if all(rec[k] == step[k] for k in keys)]


def _ring_report(tag, ranks):
    """Print each ring case of the ranks' results; the names of the failed."""
    failed = []
    for i, case in enumerate(ranks[0]["ring"]):
        rows = [r["ring"][i] for r in ranks]
        e_p = [max(x["err_plain"]) for x in rows]
        e_d = [max(x["err_dense"]) for x in rows]
        r_p = [max(x["rel_plain"]) for x in rows]
        r_d = [max(x["rel_dense"]) for x in rows]
        ok = all(x["ok_plain"] and x["ok_dense"] for x in rows)
        name = (f"sp={case['sp']} B={case['B']} S={case['S']} H={case['H']} "
                f"D={case['D']} {case['dtype']}{' causal' if case['causal'] else ''}")
        print(f"[{tag}] ring {name}: vs plain ring max|d| {max(e_p):.3e} ||d||/||ref|| "
              f"{max(r_p):.3e} (tol {case['tol_plain']}); vs dense flash_attention max|d| "
              f"{max(e_d):.3e} ||d||/||ref|| {max(r_d):.3e} (tol {case['tol_dense']}); "
              f"o, dq, dk, dv on every rank; fwd+bwd {max(x['s_kernels'] for x in rows):.3f} s "
              f"kernels, {max(x['s_plain'] for x in rows):.3f} s plain (4 ranks sharing one "
              f"card){'' if ok else '  FAILED'}")
        if not ok:
            failed.append(f"ring {name}")
    return failed


def phase_parallel(state):
    """The mesh over torch.distributed on this one card: the NCCL refusal;
    four ranks spawned over gloo (all on cuda:0) for the ring checks and the
    flagship mesh steps (the main path: every count set to 0 on each rank
    before each step, read after, summed over the ranks); then the CLI as
    a user starts it under torch.distributed.run."""
    import shutil
    import tempfile

    import torch
    from pianobart_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _nccl_refusal()
    tmp = tempfile.mkdtemp(prefix="pbt_parallel_")
    state.setdefault("tmpdirs", []).append(tmp)
    t0 = time.perf_counter()
    spawn(_parallel_rank, 4, (tmp,), backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    print(f"[parallel] 4 ranks spawned over {ranks[0]['backend']} in {spawn_s:.1f} s; "
          f"devices {[r['device'] for r in ranks]}; ring transport at sp=2 "
          f"{ranks[0]['transport_sp2']!r}, at sp=4 {ranks[0]['transport_sp4']!r}")
    failed = _ring_report("parallel", ranks)
    for step in ranks[0]["steps"]:
        dp, tp, sp = step["shape"]
        rows = _step_rows(ranks, step, ("shape", "S", "heads"))
        name = (f"{dp}x{tp}x{sp} S={step['S']} B=2"
                + (f" --heads {step['heads']}" if step["heads"] != 8 else ""))
        dloss, dnorm = step["dense"]
        rel = step["rel"]
        counts = [r["counts"] for r in rows]
        expect = [_mesh_step_counts(step["shape"], step["S"], r["coords"]["sp"]) for r in rows]
        print(f"[parallel] flagship step {name} ({len(rows)} ranks sharing one card): loss "
              f"{step['loss']:.6f} vs dense {dloss:.6f}, grad_norm {step['grad_norm']:.6f} vs "
              f"{dnorm:.6f}; s/step {[round(t, 3) for r in rows for t in r['s_per_step']]}")
        print(f"[parallel]   {_held_line(rows)}")
        print(f"[parallel]   launches per rank ({COUNT_NAMES}) {counts}, expected {expect}")
        print(f"[parallel]   clipped grads against the dense step, ||d||/||dense|| per group "
              f"(tol 5e-2): " + ", ".join(f"{g} {v:.2e}" for g, v in sorted(rel.items())))
        same = len({r["grad_sq"] for r in rows}) == 1
        shards = all(r["shards_ok"] for r in rows)
        if not (counts == expect and len(rows) == dp * tp * sp
                and max(rel.values()) <= 5e-2 and same and shards
                and abs(step["loss"] - dloss) <= 1e-2 * abs(dloss)):
            failed.append(f"step {name} (same grads on every rank: {same}, each "
                          f"rank's shards its slices of them: {shards})")
    launches = {}
    for r in ranks:
        for kname, n in r["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    state["launches"]["parallel"] = launches
    print(f"[parallel] main path launches, all ranks ({COUNT_NAMES}) "
          f"{tuple(launches.values())}")
    if failed:
        raise AssertionError(f"[parallel] failed: {failed}")
    _parallel_cli(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[parallel] wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# [finetune_mesh]: the finetunes over the mesh (dp, tp, sp) on torch.distributed
# ---------------------------------------------------------------------------

FINETUNE_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 1, 2))
# (finetune, compute dtype, meshes): the three finetunes in bf16, velocity
# (the label decoder's shard offsets) at every mesh, composer and
# generation at all but 2x1x2, whose four ranks cost the most and which
# tests/test_torch_finetune_mesh.py holds for every finetune on the CPU;
# velocity again in f32, where its bf16 decoder positions part from
# the dense step by 4e-2 (on the ring of one under tp, and under sp), so
# that rounding, which shrinks with the compute type, and a fault of the
# label decoder's mesh path, which does not, can be told apart; 2x1x1
# (only the order of the sums changes) gives the f32 floor, and the dense
# step on weights moved by one ulp the gradients' own sensitivity
FINETUNE_RUNS = (("composer", "bf16", FINETUNE_MESHES[:3]),
                 ("velocity", "bf16", FINETUNE_MESHES),
                 ("generation", "bf16", FINETUNE_MESHES[:3]),
                 ("velocity", "f32", ((2, 1, 1), (1, 2, 1), (1, 1, 2))))
# Against the dense step: the train and eval losses (relative), and the
# clipped gradients per group (||d||/||dense||): a bound for every group
# and the groups' own.  bf16: [parallel]'s bounds.  f32 (both sides f32
# GEMMs and the 3xTF32 kernels, summed in other orders): _grad_check's f32
# bound, and for velocity's decoder positions, which read 0.96e-3 and
# 1.28e-3 at 1x2x1 and 1x1x2 on an H100 where the other groups read <=
# 2.7e-4 (and 4.07e-2 / 4.03e-2 in bf16: the gap shrinks with the compute
# type as the other groups' do), 5e-3.
FINETUNE_TOL = {"bf16": (1e-2, 5e-2, {}),
                "f32": (1e-4, 1e-3, {"decoder.embed_positions": 5e-3})}


def _empty_model(kind, cfg, dev):
    """``kind``'s model at ``cfg``, built on the meta device with its storage
    on ``dev`` (no draw; the octuple offsets set)."""
    import torch
    from pianobart_tpu_torch.models import (PianoBartLM, SequenceClassification,
                                            TokenClassification)
    from pianobart_tpu_torch.models.embedding import OctupleEmbedding
    cls, kw = {"composer": (SequenceClassification, {"class_num": 8}),
               "velocity": (TokenClassification, {"class_num": 8}),
               "generation": (PianoBartLM, {})}[kind]
    model = cls(cfg, device="meta", **kw).to_empty(device=dev)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, OctupleEmbedding):
                mod.offsets.copy_(torch.tensor(cfg.field_offsets))
    return model.train()


def _finetune_step(kind, cfg, mesh=None):
    """``kind``'s train step as the CLI builds it (the generation finetune in
    its default ``intro`` mode): over ``mesh``, or dense without one."""
    import functools
    from pianobart_tpu_torch.train import finetune as ft
    from pianobart_tpu_torch.train import finetune_sp as fsp
    from pianobart_tpu_torch.train.generation import generation_step
    if mesh is None:
        return {"composer": ft.finetune_seq_step,
                "velocity": functools.partial(ft.finetune_token_step, velocity=True),
                "generation": generation_step}[kind]
    if kind == "composer":
        return fsp.make_sp_seq_step(cfg, mesh)
    if kind == "velocity":
        return fsp.make_sp_token_step(cfg, mesh, velocity=True)
    return fsp.make_sp_generation_step(cfg, mesh)


def _dense_eval(kind, cfg, state, x, y):
    """The dense eval step: its loss, its predictions (``pred`` or
    ``outputs``) and where they are away from a tie: the top-two margin of
    the logits they were read from (a forward hook) at least |top1|/16 (and
    1/16), past the rounding that bf16 logits of either step carry."""
    import torch
    from pianobart_tpu_torch.models.heads import split_fields
    seen = []
    hook = state.model.register_forward_hook(lambda mod, inp, out: seen.append(out))
    try:
        _, m = _finetune_step(kind, cfg)(state, x, y, None, train=False)
    finally:
        hook.remove()
    logits = seen[0].float()
    fields = split_fields(logits, cfg) if kind == "generation" else [logits]
    decided = []
    for f in fields:
        top = f.topk(2, dim=-1).values
        decided.append(top[..., 0] - top[..., 1] >= top[..., 0].abs().clamp(min=1.0) / 16)
    decided = torch.stack(decided, -1) if kind == "generation" else decided[0]
    return m["loss"].item(), m.get("pred", m.get("outputs")), decided


def _ulp_gaps(kind, cfg, sd, x, y, want):
    """The dense train step again, on the weights ``sd`` each moved by one
    ulp up or down (a seeded draw): its clipped gradients against ``want``
    per group, the gradients' own sensitivity to a rounding-level change
    of the activations, which a mesh makes where it splits a sum."""
    import torch
    from pianobart_tpu_torch.train.state import create_train_state
    dev = x.device
    model = _empty_model(kind, cfg, dev)
    model.load_state_dict(sd)
    g = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, device=dev, generator=g) * 2 - 1
            p.mul_(1 + sign * 2.0 ** -23)
    _finetune_step(kind, cfg)(create_train_state(model), x, y,
                              torch.Generator(device=dev).manual_seed(SEED), train=True)
    return _rel_groups({n: p.grad for n, p in model.named_parameters()}, want)


def _finetune_mesh_rank(rank, world, out_dir, ckpt):
    """One of [finetune_mesh]'s four ranks, all on cuda:0 over gloo.  First
    the ring at this phase's blocks (B=8, S=1024 over sp=2: the 2x1x2
    mesh's two rings).  Then each of ``FINETUNE_RUNS`` at flagship width
    (f32 parameters, dropout 0 and the heads' fixed 0.1 set to 0, B=8,
    S=1024) on [pretrain_run]'s ``best/`` (the heads and the label
    embedding drawn from the seed): at each of its meshes one eval step,
    then one train step, each step's launches counted from 0 on this rank;
    rank 0 also runs the dense eval and train steps once per run and holds
    each mesh's eval loss and predictions, its train loss and its clipped
    gradients against them, and in f32 the gradients' own sensitivity to
    a one-ulp change of the weights (:func:`_ulp_gaps`).  Each mesh model's
    parameters are placed by ``shard_params`` (tp > 1: this rank's slices
    of the qkv, mlp and vocab leaves); the gradient shards are gathered
    whole for the comparisons, and the parameter elements held and the
    memory allocated after the train step are read with the peak."""
    import numpy as np
    import torch
    from pianobart_tpu_torch.compat.from_jax import draw_params_
    from pianobart_tpu_torch.decode import checkpoint_entries
    from pianobart_tpu_torch.models import PianoBartConfig, heads
    from pianobart_tpu_torch.parallel.mesh import make_mesh, shard_params
    from pianobart_tpu_torch.train.state import create_train_state, graft_
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    heads.HEAD_DROPOUT = 0.0
    dev = torch.device("cuda", 0)
    meshes = {shape: make_mesh(*shape, device=dev) for shape in FINETUNE_MESHES}
    res, totals = {"steps": [], "ring": []}, {}
    for causal in (False, True):
        res["ring"].append(_ring_case(meshes[2, 1, 2], 1024, torch.bfloat16, causal, B=8))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 14)
    x = torch.as_tensor(_pretrain_batch(8, 1024, rng), device=dev)
    labels = {"composer": torch.as_tensor(rng.integers(0, 8, 8), device=dev),
              "velocity": torch.as_tensor(rng.integers(0, 8, (8, 1024)), device=dev),
              "generation": torch.as_tensor(_pretrain_batch(8, 1024, rng), device=dev)}
    for kind, dname, shapes in FINETUNE_RUNS:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
        cfg0 = PianoBartConfig(dtype=dtype, dropout=0.0,
                               decoder_label_vocab=8 if kind == "velocity" else None)
        base = _empty_model(kind, cfg0, dev)
        missing = graft_(base, checkpoint_entries(ckpt, cfg0, model=base), ckpt)
        draw_params_(base, SEED, skip=set(base.state_dict()) - set(missing))
        sd = base.state_dict()
        del base
        y, want = labels[kind], None
        if rank == 0:
            # the dense steps on the same weights and batch, once per run
            dense = _empty_model(kind, cfg0, dev)
            dense.load_state_dict(sd)
            dstate = create_train_state(dense)
            dense_eval = _dense_eval(kind, cfg0, dstate, x, y)
            _, m = _finetune_step(kind, cfg0)(
                dstate, x, y, torch.Generator(device=dev).manual_seed(SEED), train=True)
            want = {n: p.grad.detach().clone() for n, p in dense.named_parameters()}
            dense_m = (m["loss"].item(), m["grad_norm"].item(), dense_eval[0])
            del dense, dstate
            ulp = _ulp_gaps(kind, cfg0, sd, x, y, want) if dname == "f32" else None
            torch.cuda.empty_cache()
        for shape in shapes:
            mesh = meshes[shape]
            if mesh is None:                # ranks outside a 2-rank mesh
                continue
            cfg = _mesh_cfg(cfg0, shape)
            model = _empty_model(kind, cfg, dev)
            model.load_state_dict(sd)
            st = create_train_state(shard_params(model, mesh))
            step = _finetune_step(kind, cfg, mesh)
            rec = {"kind": kind, "dtype": dname, "shape": shape, "coords": mesh.coords,
                   "counts": []}
            if rank == 0:
                rec["dense"], rec["ulp"] = dense_m, ulp
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times = []
            # eval first: on the weights the dense eval step saw
            for train in (False, True):
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = step(st, x, y, torch.Generator(device=dev).manual_seed(SEED)
                            if train else None, train=train)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts = _read_counts()
                for kname, n in counts.items():
                    totals[kname] = totals.get(kname, 0) + n
                rec["counts"].append(tuple(counts.values()))
                if train:
                    rec.update(_held(model))
                    rec["loss"], rec["grad_norm"] = m["loss"].item(), m["grad_norm"].item()
                    got, rec["shards_ok"] = _whole_grads(model, mesh)
                    rec["grad_sq"] = sum(float(g.double().square().sum())
                                         for g in got.values())
                    if rank == 0:
                        rec["rel"] = _rel_groups(got, want)
                    del got
                else:
                    out = m.get("pred", m.get("outputs"))
                    rec["eval"] = (m["loss"].item(), tuple(out.shape))
                    if rank == 0:
                        # the gathered predictions in the dense step's sample order
                        _, d_out, decided = dense_eval
                        same = out == d_out
                        rec["agree"] = (float(same.float().mean()),
                                        float(decided.float().mean()),
                                        int((decided & ~same).sum()))
            rec["s_per_step"] = times
            res["steps"].append(rec)
            del model, st, step
            torch.cuda.empty_cache()
        del sd, want
        if rank == 0:
            del dense_eval
    res["launches"] = totals
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _finetune_mesh_cli(tag, argv, cwd, want_outputs):
    """A finetune command of the CLI under ``torch.distributed.run``
    (:func:`_torchrun`) in ``cwd``, one epoch: exit 0 on both ranks, a
    finite loss, ``best/`` written once and ``test_outputs.npy`` of the
    shape of the single-rank run's (``want_outputs``)."""
    import math

    import numpy as np
    rc, wall, lines = _torchrun(argv, cwd, os.path.join(cwd, f"{tag}.log"))
    for line in lines:
        if line.startswith(("rank ", "Epoch", "Traceback")) or "Error" in line:
            print(f"[finetune_mesh]   {tag}| {line[:300]}")
    save = os.path.join(cwd, "result", "finetune", f"{tag}_pianobart")
    meta = _meta(save) or {}
    events = _epoch_events(save) if os.path.exists(os.path.join(save, "metrics.jsonl")) else []
    loss = events[0]["train"]["loss"] if events else float("nan")
    path = os.path.join(save, "test_outputs.npy")
    shape = np.load(path).shape if os.path.exists(path) else None
    want = np.load(want_outputs).shape
    print(f"[finetune_mesh] user path: torch.distributed.run {argv[0]} ... --mesh "
          f"{argv[argv.index('--mesh') + 1]}, 1 epoch: exit {rc} in {wall:.1f} s "
          f"(2 ranks sharing one card); "
          f"train loss {loss}; valid {events[0]['valid'] if events else None}; "
          f"meta best_step {meta.get('best_step')}; test_outputs {shape} (single-rank "
          f"run's {want})")
    if rc != 0 or not math.isfinite(loss) or meta.get("best_step") != 1 or \
            len(events) != 1 or shape != want or \
            not os.path.exists(os.path.join(save, "best", "state.pt")) or \
            "\n".join(lines).count(" of mesh ") != 2:     # both ranks (one pipe: lines may merge)
        raise AssertionError(f"the mesh {tag} CLI did not end with exit 0, a finite "
                             f"loss, best/ once and the test outputs' shape:\n"
                             + "\n".join(lines[-40:]))


def phase_finetune_mesh(state):
    """The finetunes over the mesh on this one card: four ranks spawned over
    gloo (all on cuda:0) for the ring at B=8 against the plain ring and
    dense attention, then the flagship composer, velocity and generation
    eval and train steps at 2x1x1, 1x2x1 and 1x1x2, velocity's also at 2x1x2
    and in f32 at 2x1x1, 1x2x1 and 1x1x2, against the dense steps (the main path:
    every count set to 0 on each rank before each step, read after, summed
    over the ranks); then the CLI as a user starts it under
    torch.distributed.run on [finetune]'s corpora: ``finetune --task
    composer --mesh 2x1x1`` and ``finetune-generation --mesh 1x1x2 --fad``."""
    import shutil
    import tempfile

    import torch
    from pianobart_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pbt_finetune_mesh_")
    state["tmpdirs"].append(tmp)
    t0 = time.perf_counter()
    spawn(_finetune_mesh_rank, 4, (tmp, state["pretrain_best"]), backend="gloo")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    print(f"[finetune_mesh] 4 ranks spawned over gloo in {spawn_s:.1f} s; flagship "
          f"width, f32 parameters, dropout 0 (heads' 0.1 off), B=8, S=1024, "
          f"[pretrain_run]'s best/")
    failed = _ring_report("finetune_mesh", ranks)
    for step in ranks[0]["steps"]:
        dp, tp, sp = step["shape"]
        rows = _step_rows(ranks, step, ("kind", "dtype", "shape"))
        name = f"{step['kind']} {step['dtype']} {dp}x{tp}x{sp}"
        dloss, dnorm, deval = step["dense"]
        tol_loss, tol_grad, tol_group = FINETUNE_TOL[step["dtype"]]
        rel = step["rel"]
        counts = [r["counts"] for r in rows]
        expect = []
        for r in rows:
            train = _mesh_step_counts(step["shape"], 1024, r["coords"]["sp"],
                                      f32=step["dtype"] == "f32")
            expect.append([(train[0],) + (0,) * 4 + (train[0] if train[5] else 0,)
                           + (0,) * 4, train])
        agree, decided, wrong = step["agree"]
        print(f"[finetune_mesh] {name} ({len(rows)} ranks sharing one card): loss "
              f"{step['loss']:.6f} vs dense {dloss:.6f}, grad_norm {step['grad_norm']:.6f} "
              f"vs {dnorm:.6f}; s/step (eval, train) "
              f"{[round(t, 3) for r in rows for t in r['s_per_step']]}")
        print(f"[finetune_mesh]   {_held_line(rows)} (eval and train)")
        print(f"[finetune_mesh]   eval: loss {step['eval'][0]:.6f} vs dense {deval:.6f} "
              f"(tol rel {tol_loss:g}); gathered predictions {step['eval'][1]} equal to the "
              f"dense step's at {100 * agree:.3f}%, {wrong} unequal of the "
              f"{100 * decided:.3f}% away from a tie (tol 0)")
        print(f"[finetune_mesh]   launches per rank (eval, train; {COUNT_NAMES}) "
              f"{counts}, expected {expect}")
        print(f"[finetune_mesh]   clipped grads against the dense step, ||d||/||dense|| "
              f"per group (tol {tol_grad:g}"
              + "".join(f", {g} {t:g}" for g, t in tol_group.items()) + "): "
              + ", ".join(f"{g} {v:.2e}" for g, v in sorted(rel.items())))
        if step["ulp"] is not None:
            print(f"[finetune_mesh]   the dense step on weights moved by one ulp, against "
                  f"the dense step, ||d||/||dense|| per group: "
                  + ", ".join(f"{g} {v:.2e}" for g, v in sorted(step["ulp"].items())))
        same = len({r["grad_sq"] for r in rows}) == 1
        shards = all(r["shards_ok"] for r in rows)
        # the eval step's predictions, gathered into the global batch
        n_out = {"composer": (8,), "velocity": (8, 1024),
                 "generation": (8, 1024, 8)}[step["kind"]]
        if not (counts == expect and len(rows) == dp * tp * sp
                and all(v <= tol_group.get(g, tol_grad) for g, v in rel.items()) and same
                and shards and abs(step["loss"] - dloss) <= tol_loss * abs(dloss)
                and abs(step["eval"][0] - deval) <= tol_loss * abs(deval)
                and wrong == 0 and all(r["eval"][1] == n_out for r in rows)):
            failed.append(f"{name} (same grads on every rank: {same}, each rank's "
                          f"shards its slices of them: {shards})")
    launches = {}
    for r in ranks:
        for kname, n in r["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    state["launches"]["finetune_mesh"] = launches
    print(f"[finetune_mesh] main path launches, all ranks ({COUNT_NAMES}) "
          f"{tuple(launches.values())}")
    if failed:
        raise AssertionError(f"[finetune_mesh] failed: {failed}")
    data, runs, pre_best = (state["finetune_data"], state["finetune_runs"],
                            state["pretrain_best"])
    _finetune_mesh_cli("composer", [
        "finetune", "--task", "composer", "--dataroot", data["composer"], "--dataset",
        "songs", "--epochs", "1", "--ckpt", pre_best, "--mesh", "2x1x1",
        "--dist_backend", "gloo"], tmp, os.path.join(runs["composer"], "test_outputs.npy"))
    _finetune_mesh_cli("generation", [
        "finetune-generation", "--dataroot", data["generate"], "--datasets", "songs",
        "--fad", "--epochs", "1", "--ckpt", pre_best, "--mesh", "1x1x2",
        "--dist_backend", "gloo"], tmp, os.path.join(runs["generation"], "test_outputs.npy"))
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[finetune_mesh] wall {time.perf_counter() - t_phase:.1f} s")


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
    import shutil
    state = {"launches": {}, "tmpdirs": []}
    try:
        for name, phase in PHASES:
            t0 = time.perf_counter()
            try:
                phase(state)
            except Exception:
                traceback.print_exc()
                print(f"FAIL: phase {name}", file=sys.stderr)
                return 1
            print(f"[{name}] phase ok in {time.perf_counter() - t0:.1f} s")
    finally:
        for d in state["tmpdirs"]:
            shutil.rmtree(d, ignore_errors=True)
    print(state["smi"])
    print(json.dumps({"kernels": [
        _kernel_record(*rec, state) for rec in KERNEL_RECORDS]}))
    print(json.dumps({"ok": True, "device": state["device"]}))
    return 0


# name, state key, source, the TPU kernel it replaces, launch counter, the
# main path it belongs to
KERNEL_RECORDS = (
    ("flash_fwd", "k1", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train"),
    ("flash_bwd", "k2", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train"),
    ("flash_dq", "k3a", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:276",
     "flash_attention_dq", "train_long"),
    ("flash_dkv", "k3b", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:312",
     "flash_attention_dkv", "train_long"),
    # no Pallas kernel: the reference's _delta, which XLA fuses
    ("flash_delta", "delta", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:499",
     "flash_attention_delta", "train"),
    # the f32 kernels (3xTF32) behind the same entries, on [train_f32]'s path
    ("flash_fwd_f32", "k1_f32", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_f32"),
    ("flash_bwd_f32", "k2_f32", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_f32"),
    # no Pallas kernel: the f32 kernels' operand prep (the reference's _mxu_in
    # cast its f32 operands for single bf16 passes)
    ("tf32_split", "split", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:80",
     "flash_attention_split", "train_f32"),
    # head width 256 (--heads 4): the same entries' D=256 kernels, on
    # [train_h256]'s paths (the f32 ones CTA pairs over the prep's planes)
    ("flash_fwd_h256", "k1_h256", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h256"),
    ("flash_bwd_h256", "k2_h256", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h256"),
    ("flash_dq_h256", "k3a_h256", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:276",
     "flash_attention_dq", "train_h256_long"),
    ("flash_dkv_h256", "k3b_h256", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:312",
     "flash_attention_dkv", "train_h256_long"),
    ("flash_delta_h256", "delta_h256", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:499",
     "flash_attention_delta", "train_h256"),
    ("flash_fwd_h256_f32", "k1_h256_f32", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h256_f32"),
    ("flash_bwd_h256_f32", "k2_h256_f32", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h256_f32"),
    ("tf32_split_h256", "split_h256", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:80",
     "flash_attention_split", "train_h256_f32"),
    # head widths 384 .. 1024 (--heads 2 is D=512): the cluster instances
    # (the same instance at every such width), on [train_h512]'s paths
    ("flash_fwd_h512", "k1_h512", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h512"),
    ("flash_bwd_h512", "k2_h512", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h512"),
    ("flash_dq_h512", "k3a_h512", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:276",
     "flash_attention_dq", "train_h512_long"),
    ("flash_dkv_h512", "k3b_h512", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:312",
     "flash_attention_dkv", "train_h512_long"),
    ("flash_delta_h512", "delta_h512", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:499",
     "flash_attention_delta", "train_h512"),
    ("flash_fwd_h512_f32", "k1_h512_f32", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h512_f32"),
    ("flash_bwd_h512_f32", "k2_h512_f32", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h512_f32"),
    ("tf32_split_h512", "split_h512", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:80",
     "flash_attention_split", "train_h512_f32"),
    # head widths 1152 .. 2048 (--hs 2048 --heads 1 is D=2048): the same
    # cluster instances at bf16 8 CTAs and f32 16, on [train_h2048]'s paths
    ("flash_fwd_h2048", "k1_h2048", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h2048"),
    ("flash_bwd_h2048", "k2_h2048", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h2048"),
    ("flash_dq_h2048", "k3a_h2048", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:276",
     "flash_attention_dq", "train_h2048_long"),
    ("flash_dkv_h2048", "k3b_h2048", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:312",
     "flash_attention_dkv", "train_h2048_long"),
    ("flash_delta_h2048", "delta_h2048", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:499",
     "flash_attention_delta", "train_h2048"),
    # head widths 2176 .. 4096, bf16 alone (--hs 4096 --heads 1 is D=4096): the
    # same bf16 cluster instances at 16 CTAs, on [train_h4096]'s paths
    ("flash_fwd_h4096", "k1_h4096", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h4096"),
    ("flash_bwd_h4096", "k2_h4096", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h4096"),
    ("flash_dq_h4096", "k3a_h4096", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:276",
     "flash_attention_dq", "train_h4096_long"),
    ("flash_dkv_h4096", "k3b_h4096", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:312",
     "flash_attention_dkv", "train_h4096_long"),
    ("flash_delta_h4096", "delta_h4096", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:499",
     "flash_attention_delta", "train_h4096"),
    ("flash_fwd_h2048_f32", "k1_h2048_f32", "flash_fwd.cu", "pianobart_tpu/ops/flash.py:173",
     "flash_attention_fwd", "train_h2048_f32"),
    ("flash_bwd_h2048_f32", "k2_h2048_f32", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:351",
     "flash_attention_bwd", "train_h2048_f32"),
    ("tf32_split_h2048", "split_h2048", "flash_bwd.cu", "pianobart_tpu/ops/flash.py:80",
     "flash_attention_split", "train_h2048_f32"),
    ("fused_ln_fwd", "k4a", "fused_ln.cu", "pianobart_tpu/ops/fused_ln.py:91",
     "dropout_add_ln_fwd", "train_fused"),
    ("fused_ln_bwd", "k4b", "fused_ln.cu", "pianobart_tpu/ops/fused_ln.py:112",
     "dropout_add_ln_bwd", "train_fused"),
    ("kt_fwd", "kt", "flash_lab.cu", "scripts/kernel_lab.py:41", "kt_fwd", "lab"),
    ("hl_fwd", "hl", "flash_lab.cu", "scripts/kernel_lab.py:154", "hl_fwd", "lab"),
)


def _kernel_record(name, key, source, replaces, counter, home, state):
    """One entry of the kernels line.  ``launches`` is the count on the
    kernel's own main path (``home``); ``launches_by_path`` gives the count
    of every main path, each read after its own run from 0."""
    rec = state[key]
    by_path = {path: counts[counter] for path, counts in state["launches"].items()}
    return {"name": name, "route": "cuda",
            "source": f"pianobart_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": by_path[home], "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}


PHASES = (("device", phase_device), ("build", phase_build),
          ("flash", phase_flash), ("lab", phase_lab), ("flash_bwd", phase_flash_bwd),
          ("fused_ln", phase_fused_ln), ("serve", phase_serve),
          ("serve_http", phase_serve_http),
          ("train", phase_train), ("train_long", phase_train_long),
          ("train_fused", phase_train_fused), ("train_f32", phase_train_f32),
          ("train_h256", phase_train_h256), ("train_h512", phase_train_h512),
          ("train_h2048", phase_train_h2048), ("train_h4096", phase_train_h4096),
          ("pretrain_run", phase_pretrain_run), ("finetune", phase_finetune),
          ("serve_ckpt", phase_serve_ckpt), ("merge", phase_merge),
          ("parallel", phase_parallel), ("finetune_mesh", phase_finetune_mesh))


if __name__ == "__main__":
    sys.exit(main())
