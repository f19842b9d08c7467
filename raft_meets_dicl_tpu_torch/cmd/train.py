"""The ``train`` subcommand (counterpart of
``raft_meets_dicl_tpu/cmd/train.py::_train``, its plain single-device path).

Creates the run directory ``<output>/<timestamp><suffix>`` with
``main.log``, ``model.txt`` (the module's repr) and ``config.json`` (seeds,
model, strategy, arguments), seeds the RNGs, loads the model and the
strategy and runs the ``TrainingContext`` on one device: ``cuda`` unless
the caller asks for the CPU; without CUDA it fails rather than training
elsewhere.

The flags of parts not ported yet (checkpoints and resume, inspect
configs, environment configs, meshes, wire formats, device augmentation)
do not exist; ROADMAP slice 2 items 4-10 bring them.
"""

import datetime
import logging
import re
import subprocess
from pathlib import Path

import torch

from .. import models, strategy, utils
from ..strategy.training import TrainingContext

_ROOT = Path(__file__).resolve().parents[2]


def _git_head():
    """The checkout's commit, or None outside a git checkout."""
    try:
        proc = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_ROOT,
                              capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def train(args):
    """Run the train command; returns the ``TrainingContext`` (its
    ``history`` holds every step's loss, lr, norms and time) with the run
    directory as ``path``."""
    timestamp = datetime.datetime.now()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "training on 'cuda' needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass --device cpu to train "
            "on the CPU")

    cfg_seeds = utils.config.load(args.seeds) if args.seeds else None
    cfg_model, cfg_strat = args.model, args.data
    if cfg_model is None:
        raise ValueError("no model configuration specified")
    if cfg_strat is None:
        raise ValueError("no strategy/data configuration specified")

    suffix = ""
    if args.suffix:
        suffix = args.suffix if re.match(r"^[./_-].*$", args.suffix) else f"-{args.suffix}"

    path_out = Path(args.output) / (timestamp.strftime("%G.%m.%dT%H.%M.%S") + suffix)
    path_out.mkdir(parents=True)
    handler = logging.FileHandler(path_out / "main.log")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)

    try:
        logging.info(f"starting: time is {timestamp}, writing to '{path_out}'")
        logging.info(f"description: {args.comment if args.comment else '<not available>'}")

        if args.reproduce or args.seeds:
            if cfg_seeds is None:
                raise ValueError("set --reproduce but no seeds specified")
            logging.info("seeding: using seeds from config")
            seeds = utils.seeds.from_config(cfg_seeds)
        else:
            seeds = utils.seeds.random_seeds()
        seeds.apply()

        logging.info(f"loading model configuration: file='{cfg_model}'")
        model = models.load(cfg_model)

        logging.info(f"loading strategy configuration: file='{cfg_strat}'")
        strat = strategy.load(cfg_strat)

        with open(path_out / "model.txt", "w") as fd:
            fd.write(repr(model.model.module))

        path_config = path_out / "config.json"
        logging.info(f"writing full configuration to '{path_config}'")
        utils.config.store(path_config, {
            "timestamp": timestamp.isoformat(),
            "commit": _git_head(),
            "comment": args.comment if args.comment else "",
            "cwd": str(Path.cwd()),
            "args": {k: v for k, v in vars(args).items() if k != "comment"},
            "seeds": seeds.get_config(),
            "model": model.get_config(),
            "strategy": strat.get_config(),
        })

        logging.info(f"device: {device}" + (
            f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))
        tctx = TrainingContext(
            path_out, strat, model.model, model.model.get_adapter(),
            model.loss, model.input, device=device, step_limit=args.steps)
        tctx.run(args.start_stage)
        return tctx
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()
