"""Command-line interface of the port (``pianobart_tpu/cli.py``): the
``serve`` and ``demo`` subcommands, with the JAX CLI's flags plus
``--device``.  Both run on CUDA unless ``--device cpu`` is given, and
raise without a card otherwise.

    python -m pianobart_tpu_torch.cli serve --warm
    python -m pianobart_tpu_torch.cli demo --input song.mid --output out.mid

The weights are random (``--nopretrain``, or no ``--ckpt``): a checkpoint
path raises until the port can load one (ROADMAP Queue A item 6).  The
other subcommands come with their slices.
"""
from __future__ import annotations

import argparse
import sys


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
