"""What each rank of a mesh holds on the card around one train step, for a
checkout of the port: parameter elements, ``torch.cuda.memory_allocated``
just before and just after the step, and the peak in the step's window.

    MESH_MEMORY_TREE=<checkout> python3 pianobart_tpu_torch/scripts/mesh_memory.py

The port is imported from ``MESH_MEMORY_TREE`` (default: the working
directory), so one call can measure a parent checkout and the change in
turns, each run a process of its own.  Four ranks are spawned over gloo,
all on ``cuda:0``, and each takes one step at every entry of ``STEPS``: the
flagship pretrain step at ``[parallel]``'s shape (B=2, S=2048, bf16 compute,
f32 parameters, dropout 0), and the composer, velocity and generation
finetune steps at ``[finetune_mesh]``'s (B=8, S=1024), on random weights;
under tp the parameters are placed by ``parallel/mesh.py:shard_params``
where the checkout has it.  Prints the card's name and power limit, then one
JSON object a step: per rank ``params_held``, ``before_gib``,
``alloc_gib``, ``peak_gib`` and ``s``.  Needs one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

TREE = os.path.abspath(os.environ.get("MESH_MEMORY_TREE", os.getcwd()))

# (step, compute dtype, mesh); the meshes without tp first, so that no step
# of a tree that shards runs before them in the process
STEPS = (("pretrain", "bf16", (2, 1, 2)), ("composer", "bf16", (2, 1, 1)),
         ("composer", "bf16", (1, 1, 2)), ("pretrain", "bf16", (1, 2, 2)),
         ("composer", "bf16", (1, 2, 1)), ("velocity", "bf16", (1, 2, 1)),
         ("generation", "bf16", (1, 2, 1)), ("velocity", "f32", (1, 2, 1)))


def _batch(B, S, rng):
    import numpy as np
    from pianobart_tpu_torch import vocab as V
    batch = np.zeros((B, S, 8), dtype=np.int64)
    for f in range(8):
        batch[..., f] = rng.integers(0, V.TOKEN_BOUNDARY[f], (B, S))
    return batch


def _rank(rank, world, out_dir):
    import numpy as np
    import torch
    from pianobart_tpu_torch.models import (PianoBartConfig, PianoBartLM,
                                            SequenceClassification,
                                            TokenClassification, heads)
    from pianobart_tpu_torch.parallel import mesh as M
    from pianobart_tpu_torch.train import finetune_sp as fsp
    from pianobart_tpu_torch.train.pretrain_sp import make_sp_pretrain_step
    from pianobart_tpu_torch.train.state import create_train_state
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    heads.HEAD_DROPOUT = 0.0
    shard = getattr(M, "shard_params", None)
    rng = np.random.default_rng(0)
    rows = []
    for kind, dname, shape in STEPS:
        mesh = M.make_mesh(*shape, device=dev)
        if mesh is None:                    # ranks outside a 2-rank mesh
            continue
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
        pre = kind == "pretrain"
        cfg = PianoBartConfig(dtype=dt, dropout=0.0, max_len=4096 if pre else 1024,
                              decoder_label_vocab=8 if kind == "velocity" else None)
        if shape[1] > 1:
            cfg = cfg.replace(ring_axis="sp", ring_tp_axis="tp", ring_tp_size=shape[1])
        elif shape[2] > 1:
            cfg = cfg.replace(ring_axis="sp")
        B, S = (2, 2048) if pre else (8, 1024)
        x = torch.as_tensor(_batch(B, S, rng), device=dev)
        torch.manual_seed(0)
        if kind == "composer":
            model, step = (SequenceClassification(cfg, 8, device=dev),
                           fsp.make_sp_seq_step(cfg, mesh))
            y = torch.as_tensor(rng.integers(0, 8, B), device=dev)
        elif kind == "velocity":
            model, step = (TokenClassification(cfg, 8, device=dev),
                           fsp.make_sp_token_step(cfg, mesh, velocity=True))
            y = torch.as_tensor(rng.integers(0, 8, (B, S)), device=dev)
        else:
            model = PianoBartLM(cfg, device=dev)
            step = (make_sp_pretrain_step(cfg, mesh) if pre
                    else fsp.make_sp_generation_step(cfg, mesh))
            y = torch.as_tensor(_batch(B, S, rng), device=dev)
        with torch.no_grad():
            for p in model.parameters():
                p.normal_(0.0, 0.02)
        model.train()
        if shard is not None:
            shard(model, mesh)
        st = create_train_state(model)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        if pre:
            step(st, x, gen)
        else:
            step(st, x, y, gen, train=True)
        torch.cuda.synchronize()
        rows.append({"kind": kind, "dtype": dname, "shape": shape, "rank": rank,
                     "params_held": sum(p.numel() for p in model.parameters()),
                     "before_gib": before,
                     "alloc_gib": torch.cuda.memory_allocated() / 2**30,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "s": time.perf_counter() - t0})
        del model, st, step
        torch.cuda.empty_cache()
    torch.save(rows, os.path.join(out_dir, f"rank{rank}.pt"))


def main() -> int:
    import torch
    import pianobart_tpu_torch
    from pianobart_tpu_torch.parallel.launch import spawn
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"port from {os.path.dirname(pianobart_tpu_torch.__file__)}")
    with tempfile.TemporaryDirectory() as out:
        spawn(_rank, 4, (out,), backend="gloo")
        rows = [r for k in range(4)
                for r in torch.load(os.path.join(out, f"rank{k}.pt"), weights_only=False)]
    for kind, dname, shape in STEPS:
        got = sorted((r for r in rows if (r["kind"], r["dtype"], r["shape"])
                      == (kind, dname, shape)), key=lambda r: r["rank"])
        print(json.dumps({"tree": TREE, "step": kind, "dtype": dname,
                          "mesh": "x".join(map(str, shape)),
                          **{k: [r[k] for r in got] for k in
                             ("params_held", "before_gib", "alloc_gib", "peak_gib", "s")}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, TREE)    # the spawned ranks inherit the path
    sys.exit(main())
