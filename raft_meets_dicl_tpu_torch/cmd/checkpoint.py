"""The ``checkpoint`` subcommand: info and trim over checkpoint stores
(counterpart of ``raft_meets_dicl_tpu/cmd/checkpoint.py``). Both read the
port's files and the JAX package's."""

from pathlib import Path

from ..strategy import Checkpoint
from ..strategy.checkpoint import load_directory


def checkpoint(args):
    commands = {"info": info, "trim": trim}
    if args.subcommand not in commands:
        print("usage: checkpoint {info, trim} ... (see --help)")
        return
    commands[args.subcommand](args)


def _split_exprs(exprs):
    return [e.strip() for e in exprs.split(",")]


def _entry_info(entry):
    info = [
        f"stage: {entry.idx_stage}",
        f"epoch: {entry.idx_epoch}",
        f"step: {entry.idx_step}",
    ]
    info += [f"{k}: {v:.04f}" for k, v in (entry.metrics or {}).items()]
    return ", ".join(info)


def info(args):
    compare = _split_exprs(args.sort or "{n_stage}, {n_epoch}, {n_steps}")

    for path in args.file:
        path = Path(path)

        if path.is_file():
            entry = Checkpoint.load(path).to_entry(path)
            print()
            print(f"File: '{path}', Model: {entry.model}")
            print(f"  {_entry_info(entry)}")
        else:
            for mgr in load_directory(path, compare):
                print()
                print(f"Directory: '{path}', Model: {mgr.model_id}")
                for entry in sorted(mgr.checkpoints, key=mgr._sort_key_best):
                    print(f"  {_entry_info(entry)}")


def trim(args):
    if args.keep_best and not args.compare:
        raise ValueError(
            "option --compare must be specified when --keep-best is specified")
    if not args.keep_best and not args.keep_latest:
        raise ValueError(
            "need to specify --keep-best or --keep-latest (or both)")

    compare = _split_exprs(args.compare or "{n_stage}, {n_epoch}, {n_steps}")

    for path in args.directory:
        for mgr in load_directory(path, compare):
            mgr.trim(args.keep_best, args.keep_latest)
