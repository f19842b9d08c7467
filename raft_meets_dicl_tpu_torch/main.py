"""CLI argument parsing and dispatch for the PyTorch/CUDA port.

Counterpart of ``raft_meets_dicl_tpu/main.py``; ``train``, ``evaluate``,
``serve`` and ``checkpoint`` are ported.

    python -m raft_meets_dicl_tpu_torch.main train -d strategy.yaml \
        -m model.yaml [-i inspect.yaml] [-e env.yaml] -o runs \
        [--limit-steps N] [--wire-format f32|bf16|u8] [--loader-procs N] \
        [--checkpoint FILE | --resume FILE|auto] [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main train -c run/config.json \
        --reproduce [-e env.yaml] -o runs [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main evaluate -d data.yaml \
        -m model.yaml -c chkpt.ckpt [-b N] [-o report.json] \
        [-f DIR --flow-format FORMAT] [--buckets group|HxW,...] \
        [--fwbw] [--iterations N] [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main serve -c serve.yaml \
        [--checkpoint FILE] [--device cpu]
    python -m raft_meets_dicl_tpu_torch.main checkpoint info FILE|DIR \
        [--sort EXPRS]
    python -m raft_meets_dicl_tpu_torch.main checkpoint trim DIR \
        [--compare EXPRS] [--keep-latest N] [--keep-best N]

``train``, ``evaluate`` and ``serve`` run on ``cuda`` unless ``--device
cpu`` is given, and fail without CUDA rather than falling back to the
CPU.

``serve.yaml`` holds a ``serve:`` section with ``model``, ``buckets`` and
optionally ``checkpoint``, ``wire-format``, ``batch-size``,
``max-wait-ms``, ``queue-limit``, ``requests`` and ``rate``
(``cfg/serve/example.yaml`` serves as it ships); the keys of parts not
ported yet (``ladder``, ``video``, ``quant``) are refused.
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
    train.add_argument("-c", "--config",
                       help="full training configuration (a run's "
                            "config.json, or cfg/full); the part flags "
                            "override its parts")
    train.add_argument("-d", "--data", help="training strategy and data")
    train.add_argument("-m", "--model", help="specification of the model")
    train.add_argument("-i", "--inspect",
                       help="specification of metrics, validation and "
                            "checkpoints [default: cfg/inspect/default.yaml]")
    train.add_argument("-s", "--seeds", help="seed config for initializing RNGs")
    train.add_argument("-e", "--env", "--environment", dest="env",
                       help="environment config: loader arguments, wire "
                            "format, deterministic switch "
                            "[default: cfg/env/default.yaml]")
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
    train.add_argument("--wire-format", choices=["f32", "bf16", "u8"],
                       help="host->device batch wire format: compact image "
                            "dtype + on-device normalization (also: "
                            "RMD_WIRE_FORMAT or the env config's 'wire' "
                            "section) [default: host-normalized f32]")
    train.add_argument("--loader-procs", type=int, metavar="N",
                       help="decode the input pipeline in N worker "
                            "processes (also: RMD_LOADER_PROCS; the env "
                            "config's 'loader.procs') [default: the "
                            "loader's num_workers]")

    eval_ = subp.add_parser("evaluate", aliases=["e", "eval"],
                            formatter_class=fmtcls, help="evaluate model")
    eval_.add_argument("-d", "--data", required=True,
                       help="evaluation dataset")
    eval_.add_argument("-m", "--model", required=True,
                       help="the model to use")
    eval_.add_argument("-c", "--checkpoint", required=True,
                       help="the checkpoint to load (the port's or the "
                            "JAX package's)")
    eval_.add_argument("-b", "--batch-size", type=int, default=1,
                       help="batch-size to use for evaluation")
    eval_.add_argument("--iterations", type=int,
                       help="recurrence iteration override for the "
                            "model's update loop (also: RMD_ITERATIONS) "
                            "[default: model config]")
    eval_.add_argument("-x", "--metrics",
                       help="specification of metrics to use for "
                            "evaluation [default: cfg/eval/default.yaml]")
    eval_.add_argument("-o", "--output",
                       help="write detailed output to this file (json or "
                            "yaml)")
    eval_.add_argument("--incremental", metavar="PATH",
                       help="append per-sample metrics to this JSONL as the "
                            "sweep runs, so a crash keeps partial results "
                            "[default: <output>.samples.jsonl when -o is "
                            "set]")
    eval_.add_argument("--no-incremental", action="store_true",
                       help="disable the incremental per-sample JSONL")
    eval_.add_argument("-f", "--flow",
                       help="compute and write flow images to specified "
                            "directory")
    from .cmd.eval import FLOW_FORMATS

    eval_.add_argument("--flow-format", default="visual:flow",
                       choices=FLOW_FORMATS, metavar="FORMAT",
                       help="output format for flow images "
                            "[default: %(default)s]")
    eval_.add_argument("--flow-mrm", type=float,
                       help="maximum range of motion for visual flow image "
                            "output")
    eval_.add_argument("--flow-gamma", type=float,
                       help="gamma for visual:flow image output")
    eval_.add_argument("--flow-transform",
                       help="transform for visual:flow:dark image output")
    eval_.add_argument("--flow-only", action="store_true",
                       help="only compute flow images, do not evaluate "
                            "metrics")
    eval_.add_argument("--fwbw", action="store_true",
                       help="also run the reversed pair per sample and "
                            "derive forwards-backwards consistency "
                            "products (occlusion masks + confidence; "
                            "enables the visual:occlusion and "
                            "visual:confidence flow formats)")
    eval_.add_argument("--epe-cmap", default="gray",
                       help="colormap for end-point-error visualization "
                            "(gray and viridis built in, others need "
                            "matplotlib)")
    eval_.add_argument("--epe-max", type=float, default=None,
                       help="maximum end point error for visualization")
    eval_.add_argument("--device", default="cuda",
                       help="torch device: cuda, cuda:N or cpu "
                            "[default: cuda; fails without CUDA]")
    eval_.add_argument("--device-ids",
                       help="one device index of --device's platform "
                            "(more than one: not ported yet)")
    eval_.add_argument("--buckets", metavar="SPEC",
                       help="shape buckets for mixed-resolution datasets: "
                            "'group' (batch same-shape samples) or a "
                            "comma-separated HxW list, e.g. "
                            "'384x1280,448x1024' (quantize + batch). "
                            "Also: RMD_EVAL_BUCKETS")
    eval_.add_argument("--wire-format", choices=["f32", "bf16", "u8"],
                       help="host->device batch wire format (compact image "
                            "dtype, on-device normalization; also: "
                            "RMD_WIRE_FORMAT) [default: host-normalized "
                            "f32]")
    # accepted so that JAX command lines parse; refused by name
    eval_.add_argument("--precompile", action="store_true",
                       help="not ported yet (ROADMAP slice 7)")
    eval_.add_argument("--compile-cache", metavar="DIR",
                       help="not ported yet (ROADMAP slice 7)")
    eval_.add_argument("--telemetry", metavar="PATH",
                       help="not ported yet (ROADMAP slice 7)")

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
    serve.add_argument("--wire-format", choices=["f32", "bf16", "u8"],
                       help="request wire format: compact image dtype "
                            "decoded in the inference step (also: the "
                            "config's 'wire-format' key, then "
                            "RMD_WIRE_FORMAT) [default: host-normalized "
                            "f32]")
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
    command = {"t": "train", "e": "evaluate", "eval": "evaluate"}.get(
        args.command, args.command)
    return {"train": cmd.train, "evaluate": cmd.evaluate,
            "serve": cmd.serve, "checkpoint": cmd.checkpoint}[command](args)


if __name__ == "__main__":
    main()
