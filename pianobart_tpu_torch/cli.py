"""Command-line interface of the port (``pianobart_tpu/cli.py``), with the
JAX CLI's flags plus ``--device``:

    python -m pianobart_tpu_torch.cli tokenize --dataset songs/ --no_pad
    python -m pianobart_tpu_torch.cli pretrain --dataroot Data/output_pretrain --datasets songs
    python -m pianobart_tpu_torch.cli pretrain ... --resume
    python -m torch.distributed.run --nproc_per_node 2 -m pianobart_tpu_torch.cli pretrain ... --mesh 1x1x2
    python -m torch.distributed.run --nproc_per_node 2 -m pianobart_tpu_torch.cli finetune ... --mesh 2x1x1
    python -m pianobart_tpu_torch.cli finetune --task composer --dataset pianist8 --ckpt result/pretrain/pianobart
    python -m pianobart_tpu_torch.cli finetune-generation --dataroot ... --datasets maestro --fad
    python -m pianobart_tpu_torch.cli ablation --dataroot ... --datasets maestro
    python -m pianobart_tpu_torch.cli eval-gen --ckpt ... --dataroot ... --output gen.npy
    python -m pianobart_tpu_torch.cli export-ckpt --ckpt result/finetune/generation_pianobart --output gen.ckpt
    python -m pianobart_tpu_torch.cli convert-ckpt --ckpt gen.ckpt --output converted/
    python -m pianobart_tpu_torch.cli check --file songs_train_split.npy --packed
    python -m pianobart_tpu_torch.cli concat --dataroot ... --datasets a b --output all.npy
    python -m pianobart_tpu_torch.cli make-dict --out_dir Data
    python -m pianobart_tpu_torch.cli serve --ckpt gen=result/finetune/generation_pianobart --warm
    python -m pianobart_tpu_torch.cli demo --input song.mid --output out.mid --ckpt gen.ckpt

    python -m pianobart_tpu_torch.cli merge --models result/finetune/composer_pianobart \
        result/finetune/generation_pianobart --pretrained result/pretrain/pianobart \
        --method ties_merging --head_from result/finetune/generation_pianobart

The training commands, ``eval-gen``, ``merge``, ``serve`` and ``demo`` run
on CUDA unless ``--device cpu`` is given, and raise without a card
otherwise; the data and checkpoint-conversion commands run on the host.
The training commands (``pretrain``, ``finetune``, ``finetune-generation``,
``ablation``) take ``--mesh dpxTPxSP``: one rank per process of a
``torch.distributed.run`` job (``--dist_backend nccl``, one rank per card;
``gloo`` for ranks that share a card or run on the CPU).  Under
``PBX_FUSED_DROPLN=1`` their sublayer tails run the fused K4 kernels, as the
JAX CLI's model reads that variable.
``--ckpt`` takes a checkpoint directory of the port (a manager root or a
payload directory), a merged ``.msgpack`` (of this ``merge`` or the JAX
package's) or a reference ``.ckpt``/``.pth`` file.  The JAX package's orbax
checkpoints reach the port through the JAX CLI's ``export-ckpt``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max_seq_len", type=int, default=1024)
    p.add_argument("--hs", type=int, default=1024)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--ffn_dims", type=int, default=2048)
    p.add_argument("--heads", type=int, default=8)


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; without a card it "
                        "raises unless 'cpu' is given)")


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="compute type; parameters stay f32")
    p.add_argument("--name", type=str, default="pianobart")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint to initialize from (a checkpoint "
                        "directory of the port, a merged .msgpack, or a "
                        "reference .ckpt/.pth); the entries the model shares "
                        "are grafted")
    p.add_argument("--resume", action="store_true",
                   help="resume epoch/optimizer from the save dir")
    p.add_argument("--nopretrain", action="store_true")
    p.add_argument("--seed", type=int, default=2023)
    # beyond-reference training knobs (defaults = reference behavior)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="lr schedule; cosine/linear decay to 0 over "
                        "--decay_steps optimizer steps")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear lr warmup steps (any schedule)")
    p.add_argument("--decay_steps", type=int, default=None,
                   help="total optimizer steps for cosine/linear decay")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: update params every k "
                        "micro-batches (emulates a k-times-larger batch)")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="Polyak-average the params with this decay (e.g. "
                        "0.999); eval/best-selection then use the EMA "
                        "weights")
    _add_device_flag(p)


def _add_mesh_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh", type=str, default=None,
                   help="dpxTPxSP over the ranks of a torch.distributed.run "
                        "job, e.g. 2x1x2 (default: every rank on dp)")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default="nccl",
                   help="nccl: one rank per card; gloo: ranks that share a "
                        "card, or --device cpu")


def _cfg_from_args(args, train: bool = False, **kw):
    """``--dtype bf16`` (the default, also of the commands without the flag):
    bf16 compute over f32 parameters.  ``train``: a training command, whose
    sublayer tails run the fused K4 kernels (``fused_dropout_ln``) when
    ``PBX_FUSED_DROPLN=1``, as the JAX CLI's model reads that variable; the
    port's model reads its config only."""
    import torch
    from .models import PianoBartConfig
    if train:
        kw.setdefault("fused_dropout_ln",
                      os.environ.get("PBX_FUSED_DROPLN", "0") == "1")
    dtype = (torch.bfloat16 if getattr(args, "dtype", "bf16") == "bf16"
             else torch.float32)
    return PianoBartConfig(
        d_model=args.hs, encoder_layers=args.layers,
        decoder_layers=args.layers, ffn_dim=args.ffn_dims,
        num_heads=args.heads, max_len=args.max_seq_len, dtype=dtype,
        param_dtype=torch.float32, **kw)


def _load_init_ckpt(model, args):
    """--ckpt: graft the checkpoint's entries that the model shares (a
    pretrain trunk into a classifier, a finetune into an LM) onto the drawn
    model.  A directory is a checkpoint of the port; a ``.msgpack`` the
    output of ``merge``; another file a reference ``.ckpt``/``.pth`` (its
    kind detected)."""
    if not args.ckpt or args.nopretrain:
        return model
    from .decode import checkpoint_entries
    from .train.state import graft_
    graft_(model, checkpoint_entries(args.ckpt, model.cfg, model=model), args.ckpt)
    return model


def _train_state(model, args, mesh=None):
    """AdamW (and the EMA shadow) over ``model``'s parameters.  Under a
    mesh the parameters are placed first (``shard_params``: each tp rank
    keeps its slices of the qkv, mlp and vocab leaves, as the JAX CLI's
    ``_init_state`` places them), after any ``--ckpt`` graft and before
    ``--resume``, so the optimizer and the shadow hold the slices."""
    from .train.state import create_train_state
    if mesh is not None:
        from .parallel.mesh import shard_params
        shard_params(model, mesh)
    return create_train_state(model, args.lr, schedule=args.lr_schedule,
                              warmup_steps=args.warmup_steps,
                              decay_steps=args.decay_steps,
                              accum_steps=args.accum_steps,
                              ema_decay=args.ema_decay)


def _make_lr_fn(args, lr: float):
    """Host-side mirror of the optimizer's LR schedule for epoch logging.

    ``None`` for the plain constant case (nothing to log); otherwise maps
    ``TrainState.step`` (micro-steps) to the learning rate of the next real
    update: with --accum_steps k the schedule advances every k-th
    micro-step, hence the // accum."""
    schedule = getattr(args, "lr_schedule", "constant")
    warmup = getattr(args, "warmup_steps", 0)
    accum = max(1, getattr(args, "accum_steps", 1))
    if schedule == "constant" and warmup <= 0:
        return None
    from .train.state import make_schedule
    sched = make_schedule(lr, schedule, warmup,
                          getattr(args, "decay_steps", None))
    return lambda opt_step: float(sched(opt_step // accum))


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _run_guarded(runner, epochs: int, resume: bool) -> int:
    """Run a training loop under a PreemptionGuard.

    SIGTERM/SIGINT: the runner finishes the in-flight dispatch, writes the
    mid-epoch safety checkpoint, and we exit EX_TEMPFAIL (75) so requeueing
    schedulers restart the job; ``--resume`` then continues the interrupted
    epoch (utils/preemption.py)."""
    from .utils.preemption import EXIT_PREEMPTED, Preempted, PreemptionGuard
    guard = PreemptionGuard().install()
    if guard is not None:
        runner.preempt = guard
    try:
        runner.run(epochs, resume=resume)
    except Preempted as exc:
        print(f"[preempt] {exc}", file=sys.stderr)
        return EXIT_PREEMPTED
    finally:
        runner.logger.close()
        if guard is not None:
            guard.uninstall()
    return 0


def _mesh_layout(args, cfg, world: int):
    """(dp, tp, sp) of ``--mesh`` (default: every rank on dp) for a job of
    ``world`` ranks, with the reference CLI's refusals
    (``pianobart_tpu/cli.py:88-96, 240-269``)."""
    from .parallel.mesh import parse_mesh
    bs = args.batch_size
    if args.mesh is None and bs % world:
        raise SystemExit(
            f"--batch_size {bs} is not divisible by the {world} ranks; pick "
            f"--batch_size {max(1, bs // world) * world} / "
            f"{(bs // world + 1) * world}, or pass an explicit --mesh (e.g. "
            f"--mesh {world}x1x1)")
    try:
        dp, tp, sp = parse_mesh(args.mesh, world)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    if dp * tp * sp != world:
        raise SystemExit(f"--mesh {dp}x{tp}x{sp} needs {dp * tp * sp} ranks; "
                         f"the job has {world} (start it with "
                         f"torch.distributed.run --nproc_per_node {dp * tp * sp})")
    if bs % dp:
        raise SystemExit(f"--batch_size {bs} must be divisible by the dp mesh "
                         f"axis ({dp}); use --mesh to pick a layout")
    if cfg.max_len % sp:
        raise SystemExit(f"--max_seq_len {cfg.max_len} must be divisible by "
                         f"the sp mesh axis ({sp})")
    if cfg.num_heads % tp:
        raise SystemExit(f"--heads {cfg.num_heads} must be divisible by the "
                         f"tp mesh axis ({tp})")
    return dp, tp, sp


@contextlib.contextmanager
def _mesh_run(args, cfg):
    """The device, and under ``torch.distributed.run`` (``WORLD_SIZE`` > 1)
    this rank's mesh of ``--mesh``, for a training command: yields ``(cfg,
    device, mesh, put_batch)``; ``mesh`` and ``put_batch`` are None on one
    rank.  Every rank draws the whole model, and :func:`_train_state` then
    keeps each tp rank's slices of the tp-sharded parameters; sp > 1 routes
    through the ring (TP∘SP with tp > 1; tp > 1 at sp = 1 is a ring of
    one), so the yielded ``cfg`` names the ring's axes.  The process group
    is torn down on the way out."""
    from .device import resolve_device
    world = int(os.environ.get("WORLD_SIZE", 1))
    dp, tp, sp = _mesh_layout(args, cfg, world)
    if world == 1:
        yield cfg, resolve_device(args.device), None, None
        return
    from .parallel.mesh import init_from_env, put_batch_fn
    try:
        mesh = init_from_env(f"{dp}x{tp}x{sp}", args.dist_backend, args.device)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    try:
        if sp > 1 or tp > 1:
            cfg = cfg.replace(ring_axis="sp")
        if tp > 1:
            cfg = cfg.replace(ring_tp_axis="tp", ring_tp_size=tp)
        print(f"rank {mesh.rank} of mesh {dp}x{tp}x{sp} at {mesh.coords} on "
              f"{mesh.device} over {mesh.backend}")
        yield cfg, mesh.device, mesh, put_batch_fn(mesh)
    finally:
        mesh.close()


def cmd_pretrain(args) -> int:
    from .compat.from_jax import init_lm
    from .data import load_pretrain
    from .train.runner import PretrainRunner

    with _mesh_run(args, _cfg_from_args(args, train=True)) as (cfg, device, mesh,
                                                                put_batch):
        train_step_fn = eval_step_fn = None
        if mesh is not None:
            from .train.pretrain_sp import make_sp_eval_step, make_sp_pretrain_step
            train_step_fn = make_sp_pretrain_step(cfg, mesh, args.mask_percent)
            eval_step_fn = make_sp_eval_step(cfg, mesh, args.mask_percent)
        X_train, X_val = load_pretrain(args.dataroot, args.datasets,
                                       seed=args.seed)
        print(f"train {X_train.shape} valid {X_val.shape}")
        if X_train.shape[1] != cfg.max_len:
            raise SystemExit(
                f"data windows are {X_train.shape[1]} tokens but --max_seq_len "
                f"is {cfg.max_len}; re-tokenize with `tokenize --max_seq_len "
                f"{cfg.max_len}` (long windows) or pass --max_seq_len "
                f"{X_train.shape[1]}")
        model = _load_init_ckpt(init_lm(cfg, seed=args.seed, device=device,
                                        train=True), args)
        state = _train_state(model, args, mesh)
        save_dir = os.path.join("result", "pretrain", args.name)
        runner = PretrainRunner(state, cfg, X_train, X_val, save_dir,
                                batch_size=args.batch_size,
                                mask_percent=args.mask_percent,
                                patience=30, seed=args.seed,
                                checkpoint_every_dispatches=(
                                    args.checkpoint_every_dispatches),
                                train_step_fn=train_step_fn,
                                eval_step_fn=eval_step_fn,
                                lr_fn=_make_lr_fn(args, args.lr),
                                put_batch=put_batch, mesh=mesh)
        return _run_guarded(runner, args.epochs, args.resume)


def cmd_finetune(args) -> int:
    import functools
    from .compat.from_jax import init_model
    from .data import load_finetune
    from .models import SequenceClassification, TokenClassification
    from .train.finetune import finetune_seq_step, finetune_token_step
    from .train.finetune_sp import make_sp_seq_step, make_sp_token_step
    from .train.runner import SupervisedRunner

    class_num = args.class_num or {"melody": 4, "velocity": 7,
                                   "composer": 8, "emotion": 4}[args.task]
    seq = args.task in ("composer", "emotion")
    velocity = args.task == "velocity"
    cfg = _cfg_from_args(
        args, train=True, decoder_label_vocab=(class_num + 1 if velocity else None))
    with _mesh_run(args, cfg) as (cfg, device, mesh, put_batch):
        data = list(load_finetune(args.dataroot, args.dataset, args.task))
        # token labels come out of the tokenizer as (N, S, 1)
        for i in range(3, 6):
            y = np.asarray(data[i])
            if y.ndim == 3 and y.shape[-1] == 1:
                data[i] = y.squeeze(-1)
        # fail fast on out-of-range labels (a CE gather past the classes)
        n_classes = class_num + (0 if seq else 1)
        y_max = max(int(np.asarray(data[i]).max()) for i in range(3, 6))
        if y_max >= n_classes:
            raise SystemExit(
                f"label id {y_max} out of range for --class_num {class_num} "
                f"({n_classes} classes); pass --class_num {y_max + (1 if seq else 0)}")
        model = init_model(SequenceClassification if seq else TokenClassification,
                           cfg, seed=args.seed, device=device, train=True,
                           class_num=n_classes)
        state = _train_state(_load_init_ckpt(model, args), args, mesh)
        save_dir = os.path.join("result", "finetune", f"{args.task}_{args.name}")
        if mesh is not None:
            step = (make_sp_seq_step(cfg, mesh, args.weight) if seq else
                    make_sp_token_step(cfg, mesh, velocity, args.weight))
        elif seq:
            step = functools.partial(finetune_seq_step, reg_weight=args.weight)
        else:
            step = functools.partial(finetune_token_step, velocity=velocity,
                                     reg_weight=args.weight)
        runner = SupervisedRunner(state, cfg, step, data, save_dir,
                                  batch_size=args.batch_size, patience=3,
                                  seed=args.seed, lr_fn=_make_lr_fn(args, args.lr),
                                  put_batch=put_batch, mesh=mesh)
        return _run_guarded(runner, args.epochs, args.resume)


def cmd_finetune_generation(args) -> int:
    import functools
    from .compat.from_jax import init_lm
    from .data import load_finetune
    from .train.finetune_sp import make_sp_generation_step
    from .train.generation import generation_step
    from .train.runner import SupervisedRunner
    from .utils.fad import generation_fad

    with _mesh_run(args, _cfg_from_args(args, train=True)) as (cfg, device, mesh,
                                                                put_batch):
        data = load_finetune(args.dataroot, args.datasets, "gen")
        model = init_lm(cfg, seed=args.seed, device=device, train=True)
        state = _train_state(_load_init_ckpt(model, args), args, mesh)
        save_dir = os.path.join("result", "finetune", f"generation_{args.name}")
        step_fn = (functools.partial(generation_step, decoder_mode=args.decoder_mode)
                   if mesh is None else
                   make_sp_generation_step(cfg, mesh, args.decoder_mode))

        def eval_hook(x, y, metrics):
            if not args.fad:
                return {}
            fad, fad_bar = generation_fad(y, metrics["outputs"], metrics["attn_dec"],
                                          jit_windows=args.fad_jit, device=device)
            return {"fad": fad, "fad_bar": fad_bar}

        runner = SupervisedRunner(state, cfg, step_fn, data, save_dir,
                                  batch_size=args.batch_size, patience=30,
                                  seed=args.seed, select="weighted_field_acc",
                                  eval_hook=eval_hook,
                                  lr_fn=_make_lr_fn(args, args.lr),
                                  put_batch=put_batch, mesh=mesh)
        return _run_guarded(runner, args.epochs, args.resume)


def cmd_ablation(args) -> int:
    from .compat.from_jax import init_lm
    from .train.finetune_sp import make_sp_ablation_step
    from .train.generation import ablation_step
    from .train.runner import SupervisedRunner

    with _mesh_run(args, _cfg_from_args(args, train=True)) as (cfg, device, mesh,
                                                                put_batch):
        # full sequences (Ablation.py:279-304), split 80/10/10 after a seeded
        # shuffle
        parts, looked = [], []
        for split in ("train", "test", "valid"):
            p = os.path.join(args.dataroot, f"{args.datasets}_{split}.npy")
            looked.append(p)
            if os.path.exists(p):
                parts.append(np.load(p, allow_pickle=True))
        if not parts:
            raise SystemExit(f"no ablation data found; looked for: {looked}")
        arr = np.concatenate(parts, axis=0)
        arr = arr[np.random.default_rng(args.seed).permutation(len(arr))]
        s1, s2 = int(len(arr) * 0.8), int(len(arr) * 0.9)
        X_train, X_val, X_test = arr[:s1], arr[s1:s2], arr[s2:]
        data = (X_train, X_val, X_test, X_train, X_val, X_test)
        model = init_lm(cfg, seed=args.seed, device=device, train=True)
        state = _train_state(_load_init_ckpt(model, args), args, mesh)
        save_dir = os.path.join("result", "finetune", f"ablation_{args.name}")
        step = ablation_step if mesh is None else make_sp_ablation_step(cfg, mesh)

        def step_fn(state, x, y, generator, train=True, weight=None):
            return step(state, x, generator, train=train, weight=weight)

        runner = SupervisedRunner(state, cfg, step_fn, data, save_dir,
                                  batch_size=args.batch_size, patience=30,
                                  seed=args.seed, select="weighted_field_acc",
                                  lr_fn=_make_lr_fn(args, args.lr),
                                  put_batch=put_batch, mesh=mesh)
        return _run_guarded(runner, args.epochs, args.resume)


def cmd_eval_gen(args) -> int:
    """Generation over a test set, the tail padded to the batch -> one
    stacked ``.npy`` (the reference's ``eval_generation.py``)."""
    import torch
    from .decode import generate, load_inference_model
    from .device import resolve_device

    device = resolve_device(args.device)
    cfg = _cfg_from_args(args)
    X = np.load(os.path.join(args.dataroot, f"{args.datasets}_test.npy"),
                allow_pickle=True).astype(np.int32)
    model = load_inference_model(
        cfg, None if args.nopretrain else args.ckpt, args.seed, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    outs = []
    bs = args.batch_size
    for i in range(0, len(X), bs):
        chunk = X[i:i + bs]
        n = len(chunk)
        if n < bs:
            chunk = np.concatenate([chunk, np.tile(chunk[:1], (bs - n, 1, 1))])
        out = generate(model, chunk, generator=gen, device=device).cpu().numpy()
        outs.append(out[:n])
        print(f"generated {i + n}/{len(X)}")
    out = np.concatenate(outs, axis=0)
    np.save(args.output, out)
    print(f"saved {out.shape} to {args.output}")
    return 0


def cmd_merge(args) -> int:
    from .merge.cli import run_merge
    run_merge(args)
    return 0


def cmd_convert_ckpt(args) -> int:
    """A reference ``.ckpt``/``.pth`` -> a checkpoint directory of the port
    (a ``PianoBartLM``: the entries it lacks drawn from seed 0)."""
    from .decode import load_inference_model
    from .train.state import CheckpointManager, create_train_state

    model = load_inference_model(_cfg_from_args(args), args.ckpt, 0, "cpu",
                                 kind=args.kind)
    CheckpointManager(args.output).save(
        0, create_train_state(model), {"weighted_acc": -1.0, "source": args.ckpt},
        is_best=True)
    print(f"converted {args.ckpt} -> {args.output}")
    return 0


def cmd_export_ckpt(args) -> int:
    """A checkpoint directory of the port -> a reference ``.ckpt`` (its
    weights, or with ``--ema`` its EMA shadow, grafted onto a
    ``PianoBartLM``)."""
    from .compat.torch_export import export_lm, export_trunk, save_torch_checkpoint
    from .decode import load_inference_model
    from .train.state import CheckpointManager

    cfg = _cfg_from_args(args)
    model = load_inference_model(cfg, args.ckpt, 0, "cpu")
    if args.ema:
        CheckpointManager(args.ckpt).restore_ema_params(model)
    sd = model.state_dict()
    sd = (export_trunk(sd, cfg, strict_ref=args.strict_ref) if args.trunk_only
          else export_lm(sd, cfg, strict_ref=args.strict_ref))
    save_torch_checkpoint(sd, args.output)
    print(f"exported {args.ckpt} -> {args.output} "
          f"({'trunk' if args.trunk_only else 'lm'}"
          f"{', ema' if args.ema else ''}, {len(sd)} tensors)")
    return 0


def cmd_tokenize(args) -> int:
    from .tokenizer.pipeline import run_dataset_pipeline
    run_dataset_pipeline(args.dataset, task=args.task, pad=args.pad,
                         out_root=args.out_root, seed=args.seed,
                         window=args.max_seq_len)
    return 0


def cmd_concat(args) -> int:
    from .data import concatenate_pretrain
    concatenate_pretrain(args.dataroot, args.datasets, args.output)
    return 0


def cmd_check(args) -> int:
    from .tokenizer.validate import (check_finetune, check_pretrain,
                                     roundtrip_sample)
    arr = np.load(args.file, allow_pickle=True)
    if args.task == "pretrain":
        report = check_pretrain(arr, packed=args.packed)
    else:
        ans = np.load(args.ans, allow_pickle=True) if args.ans else None
        report = check_finetune(arr, ans, task=args.task)
    print(report)
    if args.sample:
        path = roundtrip_sample(arr[:1], args.sample)
        print(f"round-trip sample written to {path}")
    return 0 if report.ok else 1


def cmd_make_dict(args) -> int:
    """Emit the Octuple vocabulary artifacts (reference make_dict.py)."""
    from .vocab import VOCAB
    os.makedirs(args.out_dir, exist_ok=True)
    pkl = os.path.join(args.out_dir, "Octuple.pkl")
    txt = os.path.join(args.out_dir, "dict.txt")
    VOCAB.save_pickle(pkl)
    VOCAB.dump_dict_txt(txt)
    print(f"wrote {pkl} and {txt} ({VOCAB.total} tokens)")
    return 0


def cmd_demo(args) -> int:
    from .serve.demo import run_demo
    run_demo(input_path=args.input, output_path=args.output, ckpt=args.ckpt,
             max_seq_len=args.max_seq_len, hs=args.hs, layers=args.layers,
             ffn_dims=args.ffn_dims, heads=args.heads,
             nopretrain=args.nopretrain, force_full=args.force_full,
             device=args.device)
    return 0


def cmd_serve(args) -> int:
    # "name=path" entries register named models; a bare path registers as
    # "pianobart"
    from .serve.app import create_app, parse_ckpt_registry
    app = create_app(ckpts=parse_ckpt_registry(args.ckpt),
                     max_batch=args.max_batch,
                     batch_window_s=args.batch_window, device=args.device)
    if args.warm:
        # one decode at every bucket shape before the first live request
        for name, service in app.services.items():
            timings = service.warmup()
            print(f"warmed '{name}' decode buckets: {timings}")
    app.run(host=args.host, port=args.port)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pianobart_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pretrain")
    sp.add_argument("--datasets", type=str, nargs="+",
                    default=["asap", "EMOPIA", "Pianist8", "POP1K7", "POP909"])
    sp.add_argument("--dataroot", type=str, default="Data/output_pretrain")
    sp.add_argument("--mask_percent", type=float, default=0.15)
    sp.add_argument("--checkpoint_every_dispatches", type=int, default=0,
                    help="mid-epoch crash-safety saves every N dispatches "
                         "into the rotating safety/ slot (0 = off); "
                         "--resume restarts the interrupted epoch from it")
    _add_mesh_flags(sp)
    _add_model_flags(sp)
    _add_train_flags(sp)
    sp.set_defaults(fn=cmd_pretrain)

    sf = sub.add_parser("finetune")
    sf.add_argument("--task", required=True,
                    choices=["melody", "velocity", "composer", "emotion"])
    sf.add_argument("--dataset", type=str, required=True)
    sf.add_argument("--dataroot", type=str, default="Data/finetune/others")
    sf.add_argument("--class_num", type=int, default=None)
    sf.add_argument("--weight", type=float, default=None,
                    help="L2 regularization weight (sum of the parameters' "
                         "unsquared L2 norms, as the reference)")
    sf.add_argument("--error_correction", action="store_true",
                    help="accepted for reference-CLI parity; label squeeze "
                         "is automatic")
    _add_mesh_flags(sf)
    _add_model_flags(sf)
    _add_train_flags(sf)
    sf.set_defaults(fn=cmd_finetune, batch_size=8, epochs=50)

    sg = sub.add_parser("finetune-generation")
    sg.add_argument("--datasets", type=str, default="maestro")
    sg.add_argument("--dataroot", type=str, default="Data/finetune/others")
    sg.add_argument("--decoder_mode", choices=["intro", "shifted"],
                    default="intro")
    sg.add_argument("--fad", action="store_true",
                    help="compute FAD metrics during eval epochs")
    sg.add_argument("--fad_jit", action="store_true",
                    help="window FAD in ONE batched call on the model's "
                         "device instead of the host per-sample loop")
    _add_mesh_flags(sg)
    _add_model_flags(sg)
    _add_train_flags(sg)
    sg.set_defaults(fn=cmd_finetune_generation, batch_size=8, lr=2e-6)

    sa = sub.add_parser("ablation")
    sa.add_argument("--datasets", type=str, default="maestro")
    sa.add_argument("--dataroot", type=str, default="Data/output_generation")
    _add_mesh_flags(sa)
    _add_model_flags(sa)
    _add_train_flags(sa)
    sa.set_defaults(fn=cmd_ablation, batch_size=8)

    se = sub.add_parser("eval-gen")
    se.add_argument("--datasets", type=str, default="maestro")
    se.add_argument("--dataroot", type=str, required=True)
    se.add_argument("--output", type=str, default="generation_output.npy")
    _add_model_flags(se)
    _add_train_flags(se)
    se.set_defaults(fn=cmd_eval_gen, batch_size=8)

    sm = sub.add_parser("merge")
    sm.add_argument("--models", nargs="+", required=True,
                    help="finetuned checkpoints (checkpoint directories of "
                         "the port or reference .ckpt/.pth files)")
    sm.add_argument("--pretrained", type=str, default=None,
                    help="pretrained backbone checkpoint")
    sm.add_argument("--method", default="mask_merging",
                    choices=["average_merging", "task_arithmetic",
                             "ties_merging", "mask_merging",
                             "fisher_merging", "regmean_merging"])
    sm.add_argument("--data", type=str, default=None,
                    help="pretrain .npy for fisher/regmean statistics")
    sm.add_argument("--num_examples", type=int, default=32)
    sm.add_argument("--mask_apply_method", default="average_merging")
    sm.add_argument("--weight_mask_rate", type=float, default=0.8)
    sm.add_argument("--use_weight_rescale",
                    action=argparse.BooleanOptionalAction, default=True)
    sm.add_argument("--mask_strategy", default="random",
                    choices=["random", "magnitude"])
    sm.add_argument("--scaling_coefficient", type=float, default=1.0)
    sm.add_argument("--param_value_mask_rate", type=float, default=0.8)
    sm.add_argument("--head_from", type=str, default=None,
                    help="checkpoint whose LM head rides along in the merged "
                         "output; without it the msgpack is trunk-only and "
                         "consumers draw the head")
    sm.add_argument("--output", type=str, default="merged_params.msgpack")
    _add_device_flag(sm)
    sm.set_defaults(fn=cmd_merge)

    scc = sub.add_parser("convert-ckpt")
    scc.add_argument("--ckpt", required=True, help="reference .ckpt/.pth")
    scc.add_argument("--output", required=True,
                     help="checkpoint directory of the port")
    scc.add_argument("--kind", default=None,
                     choices=[None, "trunk", "lm", "seq", "token"])
    _add_model_flags(scc)
    scc.set_defaults(fn=cmd_convert_ckpt)

    sxc = sub.add_parser("export-ckpt")
    sxc.add_argument("--ckpt", required=True,
                     help="checkpoint directory of the port")
    sxc.add_argument("--output", required=True, help="reference .ckpt path")
    sxc.add_argument("--trunk_only", action="store_true",
                     help="export the PianoBart trunk only (pretrain-style "
                          "checkpoint, pretrain.py:100)")
    sxc.add_argument("--strict_ref", action="store_true",
                     help="also emit the reference's unused HF token-"
                          "embedding tables so main.py:168's strict "
                          "load_state_dict accepts the checkpoint")
    sxc.add_argument("--ema", action="store_true",
                     help="export the Polyak shadow average instead of the "
                          "raw params (runs trained with --ema_decay)")
    _add_model_flags(sxc)
    sxc.set_defaults(fn=cmd_export_ckpt)

    st = sub.add_parser("tokenize")
    st.add_argument("--dataset", type=str, required=True,
                    help="dataset zip or directory of MIDI files")
    st.add_argument("--task", default="pretrain",
                    choices=["pretrain", "composer", "generate", "melody",
                             "velocity", "emotion"])
    st.add_argument("--pad", action="store_true", default=None)
    st.add_argument("--no_pad", dest="pad", action="store_false",
                    default=None,
                    help="emit the flat packed stream (pretrain "
                         "*_split.npy layout, convert.py:560-565)")
    st.add_argument("--out_root", type=str, default=None)
    st.add_argument("--seed", type=int, default=2023)
    st.add_argument("--max_seq_len", type=int, default=1024,
                    help="window length (k*1024 for long-context training)")
    st.set_defaults(fn=cmd_tokenize)

    scat = sub.add_parser("concat")
    scat.add_argument("--dataroot", type=str, required=True)
    scat.add_argument("--datasets", type=str, nargs="+", required=True)
    scat.add_argument("--output", type=str, required=True)
    scat.set_defaults(fn=cmd_concat)

    sc = sub.add_parser("check")
    sc.add_argument("--file", required=True)
    sc.add_argument("--ans", default=None)
    sc.add_argument("--task", default="pretrain")
    sc.add_argument("--packed", action="store_true",
                    help="flat data_split stream (several songs per window)")
    sc.add_argument("--sample", type=str, default=None,
                    help="write one decoded window to this .mid for audition")
    sc.set_defaults(fn=cmd_check)

    smd = sub.add_parser("make-dict")
    smd.add_argument("--out_dir", default="Data",
                     help="where to write Octuple.pkl + dict.txt")
    smd.set_defaults(fn=cmd_make_dict)

    sd = sub.add_parser("demo")
    sd.add_argument("--input", required=True)
    sd.add_argument("--output", default="./output.mid")
    sd.add_argument("--ckpt", default=None)
    sd.add_argument("--nopretrain", action="store_true")
    sd.add_argument("--force_full", action="store_true",
                    help="generate a full fixed-length continuation (no "
                         "early stop on sampled special tokens)")
    _add_model_flags(sd)
    _add_device_flag(sd)
    sd.set_defaults(fn=cmd_demo)

    sv = sub.add_parser("serve")
    sv.add_argument("--ckpt", nargs="+", default=None,
                    help="checkpoint(s) to serve: a bare path (served as "
                         "'pianobart') and/or name=path entries; the "
                         "<model> segment of /api/generate/<model>/<file> "
                         "selects one")
    sv.add_argument("--host", default="0.0.0.0")
    sv.add_argument("--port", type=int, default=5000)
    sv.add_argument("--max_batch", type=int, default=8,
                    help="micro-batching: max concurrent requests per "
                         "batched decode")
    sv.add_argument("--batch_window", type=float, default=0.02,
                    help="seconds to gather concurrent requests before "
                         "dispatching a batch")
    sv.add_argument("--warm", action="store_true",
                    help="run one decode at every batch bucket at startup")
    _add_device_flag(sv)
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
