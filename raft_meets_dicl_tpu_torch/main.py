"""CLI argument parsing and dispatch for the PyTorch/CUDA port.

Counterpart of ``raft_meets_dicl_tpu/main.py``; ``train``, ``serve`` and
``checkpoint`` are ported.

    python -m raft_meets_dicl_tpu_torch.main train -d strategy.yaml \
        -m model.yaml [-i inspect.yaml] -o runs [--limit-steps N] \
        [--checkpoint FILE | --resume FILE|auto] [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main serve -c serve.yaml \
        [--checkpoint FILE] [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main checkpoint info FILE|DIR \
        [--sort EXPRS]
    python -m raft_meets_dicl_tpu_torch.main checkpoint trim DIR \
        [--compare EXPRS] [--keep-latest N] [--keep-best N]

``train`` and ``serve`` run on ``cuda`` unless ``--device cpu`` is given,
and fail without CUDA rather than falling back to the CPU.

``serve.yaml`` holds a ``serve:`` section with ``model``, ``buckets`` and
optionally ``checkpoint``, ``batch-size``, ``max-wait-ms``,
``queue-limit``, ``requests`` and ``rate``; the keys of parts not ported
yet (``wire-format``, ``ladder``, ``video``, ``quant``) are refused.
"""

import argparse
import logging

from . import cmd


def build_parser():
    def fmtcls(prog):
        return argparse.HelpFormatter(prog, max_help_position=42)

    parser = argparse.ArgumentParser(
        description="Optical Flow Estimation (PyTorch/CUDA port)",
        formatter_class=fmtcls)
    subp = parser.add_subparsers(dest="command", help="help for command")

    train = subp.add_parser("train", aliases=["t"], formatter_class=fmtcls,
                            help="train model")
    train.add_argument("-d", "--data", help="training strategy and data")
    train.add_argument("-m", "--model", help="specification of the model")
    train.add_argument("-i", "--inspect",
                       help="specification of metrics, validation and "
                            "checkpoints [default: cfg/inspect/default.yaml]")
    train.add_argument("-s", "--seeds", help="seed config for initializing RNGs")
    train.add_argument("-o", "--output", default="runs",
                       help="base output directory [default: %(default)s]")
    train.add_argument("--device", default="cuda",
                       help="torch device: cuda, cuda:N or cpu "
                            "[default: cuda; fails without CUDA]")
    train.add_argument("--checkpoint",
                       help="start with pre-trained model state from "
                            "checkpoint (the port's or the JAX package's)")
    train.add_argument("--resume",
                       help="resume training from checkpoint (full state); "
                            "'auto' picks the newest valid checkpoint of "
                            "the model under --output")
    train.add_argument("--start-stage", type=int,
                       help="start with specified stage and skip previous")
    train.add_argument("--start-epoch", type=int,
                       help="start with specified epoch and skip previous")
    train.add_argument("--reproduce", action="store_true",
                       help="use seeds from config")
    train.add_argument("--suffix", "--sfx", dest="suffix",
                       help="suffix for output directory")
    train.add_argument("--comment", dest="comment",
                       help="comment to add to config file")
    train.add_argument("--limit-steps", type=int, dest="steps",
                       help="limit to a fixed number of steps")

    serve = subp.add_parser("serve", formatter_class=fmtcls,
                            help="serve flow inference (continuous "
                                 "shape-bucketed batching)")
    serve.add_argument("-c", "--config",
                       help="serve configuration (yaml/json with a "
                            "'serve' section; CLI flags win)")
    serve.add_argument("-m", "--model", help="model specification to serve")
    serve.add_argument("--checkpoint",
                       help="checkpoint to load (the port's or the JAX "
                            "package's; also: the config's 'checkpoint' "
                            "key) [default: seeded weights]")
    serve.add_argument("--buckets", metavar="SPEC",
                       help="canonical request shapes, comma-separated "
                            "HxW list, e.g. '368x496,448x1024' (required; "
                            "also: the config's 'buckets' key)")
    serve.add_argument("-b", "--batch-size", type=int,
                       help="device batch size per dispatch [default: 4]")
    serve.add_argument("--max-wait-ms", type=float,
                       help="max time a partial batch waits before "
                            "dispatching padded [default: 50]")
    serve.add_argument("--queue-limit", type=int,
                       help="per-bucket admission queue bound; overload "
                            "sheds with a typed rejection [default: 64]")
    serve.add_argument("--requests", type=int,
                       help="built-in open-loop client: request count "
                            "[default: 32]")
    serve.add_argument("--rate", type=float,
                       help="built-in open-loop client: submissions/s "
                            "[default: 50]")
    serve.add_argument("--device", default="cuda",
                       help="torch device: cuda, cuda:N or cpu "
                            "[default: cuda; fails without CUDA]")

    chkpt = subp.add_parser("checkpoint", formatter_class=fmtcls,
                            help="inspect and manage checkpoints")
    chkpt_sub = chkpt.add_subparsers(dest="subcommand",
                                     help="help for subcommand")

    chkpt_info = chkpt_sub.add_parser("info", formatter_class=fmtcls,
                                      help="show info on checkpoint(s)")
    chkpt_info.add_argument("file", nargs="+",
                            help="checkpoint file or directory to search")
    chkpt_info.add_argument("--sort",
                            help="expression(s) for sorting checkpoints "
                                 "(comma-separated)")

    chkpt_trim = chkpt_sub.add_parser("trim", formatter_class=fmtcls,
                                      help="remove bad and/or outdated "
                                           "checkpoints")
    chkpt_trim.add_argument("directory", nargs="+",
                            help="directory to search for checkpoints")
    chkpt_trim.add_argument("--compare",
                            help="expression(s) for comparing checkpoints "
                                 "(comma-separated)")
    chkpt_trim.add_argument("--keep-latest", type=int,
                            help="keep specified number of latest "
                                 "checkpoints")
    chkpt_trim.add_argument("--keep-best", type=int,
                            help="keep specified number of best checkpoints")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return None

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    command = {"t": "train"}.get(args.command, args.command)
    return {"train": cmd.train, "serve": cmd.serve,
            "checkpoint": cmd.checkpoint}[command](args)


if __name__ == "__main__":
    main()
