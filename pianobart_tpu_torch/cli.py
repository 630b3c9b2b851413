"""Command-line interface of the port (``pianobart_tpu/cli.py``), with the
JAX CLI's flags plus ``--device``:

    python -m pianobart_tpu_torch.cli tokenize --dataset songs/ --no_pad
    python -m pianobart_tpu_torch.cli pretrain --dataroot Data/output_pretrain --datasets songs
    python -m pianobart_tpu_torch.cli pretrain ... --resume
    python -m pianobart_tpu_torch.cli check --file songs_train_split.npy --packed
    python -m pianobart_tpu_torch.cli concat --dataroot ... --datasets a b --output all.npy
    python -m pianobart_tpu_torch.cli make-dict --out_dir Data
    python -m pianobart_tpu_torch.cli serve --warm
    python -m pianobart_tpu_torch.cli demo --input song.mid --output out.mid

``pretrain``, ``serve`` and ``demo`` run on CUDA unless ``--device cpu`` is
given, and raise without a card otherwise; the data commands run on the
host.  ``pretrain --ckpt`` takes the port's own checkpoint directories;
serving still runs random weights (``--nopretrain``, or no ``--ckpt``): a
checkpoint path there raises until serving loads one (ROADMAP Queue A item
6).  The other subcommands come with their slices.
"""
from __future__ import annotations

import argparse
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
                        "directory of the port)")
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


def _cfg_from_args(args, **kw):
    """``--dtype bf16``: bf16 compute over f32 parameters."""
    import torch
    from .models import PianoBartConfig
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    return PianoBartConfig(
        d_model=args.hs, encoder_layers=args.layers,
        decoder_layers=args.layers, ffn_dim=args.ffn_dims,
        num_heads=args.heads, max_len=args.max_seq_len, dtype=dtype,
        param_dtype=torch.float32, **kw)


def _load_init_ckpt(model, args):
    """--ckpt: the port's checkpoint directory (a manager root or a payload
    directory).  Merged ``.msgpack`` files and reference ``.ckpt`` files
    load with ROADMAP Queue A item 6."""
    if not args.ckpt or args.nopretrain:
        return model
    if os.path.isdir(args.ckpt):
        from .train.state import CheckpointManager
        return CheckpointManager(args.ckpt).restore_params(model)
    raise NotImplementedError(
        f"cannot load checkpoint {args.ckpt!r}: the PyTorch port loads its "
        f"own checkpoint directories only; merged .msgpack and reference "
        f".ckpt files come with checkpoint interop (ROADMAP Queue A item 6)")


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
        if guard is not None:
            guard.uninstall()
    return 0


def cmd_pretrain(args) -> int:
    from .compat.from_jax import init_lm
    from .data import load_pretrain
    from .device import resolve_device
    from .train.runner import PretrainRunner
    from .train.state import create_train_state

    device = resolve_device(args.device)
    cfg = _cfg_from_args(args)
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
    state = create_train_state(model, args.lr, schedule=args.lr_schedule,
                               warmup_steps=args.warmup_steps,
                               decay_steps=args.decay_steps,
                               accum_steps=args.accum_steps,
                               ema_decay=args.ema_decay)
    save_dir = os.path.join("result", "pretrain", args.name)
    runner = PretrainRunner(state, cfg, X_train, X_val, save_dir,
                            batch_size=args.batch_size,
                            mask_percent=args.mask_percent,
                            patience=30, seed=args.seed,
                            checkpoint_every_dispatches=(
                                args.checkpoint_every_dispatches),
                            lr_fn=_make_lr_fn(args, args.lr))
    return _run_guarded(runner, args.epochs, args.resume)


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
    # "pianobart" (create_app refuses any path until checkpoints load)
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
    _add_model_flags(sp)
    _add_train_flags(sp)
    sp.set_defaults(fn=cmd_pretrain)

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
                         "'pianobart') and/or name=path entries; refused "
                         "until the port loads checkpoints")
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
