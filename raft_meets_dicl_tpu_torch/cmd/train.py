"""The ``train`` subcommand (counterpart of
``raft_meets_dicl_tpu/cmd/train.py::_train``, its plain single-device path).

Creates the run directory ``<output>/<timestamp><suffix>`` with
``main.log``, ``model.txt`` (the module's repr) and ``config.json`` (seeds,
model, strategy, inspector, arguments), seeds the RNGs, loads the model,
the strategy and the inspector (``-i``; default
``cfg/inspect/default.yaml``, as in JAX: TensorBoard summaries under
``tb.<model>``, per-epoch validation and metric-named checkpoints under
``checkpoints/``) and runs the ``TrainingContext`` on one device:
``cuda`` unless the caller asks for the CPU; without CUDA it fails rather
than training elsewhere.

``--checkpoint FILE`` starts from a checkpoint's weights;
``--resume FILE`` restores a checkpoint's full state and resumes where it
was written, ``--resume auto`` from the newest valid checkpoint of the
model under ``--output`` (corrupt ones quarantined). Both take the port's
files and the JAX package's.

The strategy's data graph is the JAX package's: ``augment`` with its 15
host augmentations, ``concat``, ``repeat``, ``subset``, ``cache``, the
forwards/backwards sources and the ``generic``, ``generic-backwards`` and
``multi`` layouts (``synth`` is refused). The flags of parts not ported
yet (environment configs, meshes, wire formats, device augmentation,
non-finite policies) do not exist; ROADMAP slice 2 items 7-10 and slice 7
entry 5 bring them.
"""

import datetime
import logging
import re
import subprocess
from pathlib import Path

import torch

from .. import inspect, models, strategy, utils
from ..strategy.training import TrainingContext

_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_INSPECT = _ROOT / "cfg" / "inspect" / "default.yaml"


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
    ``history`` holds every step's loss, lr, norms and time; its
    ``inspector`` and ``checkpoints`` the validation runs and saves) with
    the run directory as ``path``."""
    timestamp = datetime.datetime.now()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "training on 'cuda' needs a CUDA device, and "
            "torch.cuda.is_available() is False; pass --device cpu to train "
            "on the CPU")
    if args.checkpoint and args.resume:
        raise ValueError("cannot set both --checkpoint and --resume")

    cfg_seeds = utils.config.load(args.seeds) if args.seeds else None
    cfg_model, cfg_strat = args.model, args.data
    cfg_inspc = args.inspect if args.inspect is not None else DEFAULT_INSPECT
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

    inspector = chkptm = None
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

        logging.info(f"loading metrics/inspection configuration: "
                     f"file='{cfg_inspc}'")
        inspc = inspect.load(cfg_inspc)

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
            "inspect": inspc.get_config(),
        })

        logging.info(f"device: {device}" + (
            f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))
        inspector, chkptm = inspc.build(model.id, path_out)

        if args.checkpoint or args.resume:
            logging.warning("saved config not sufficient for "
                            "reproducibility due to checkpoint data")

        tctx = TrainingContext(
            path_out, strat, model.id, model.model, model.model.get_adapter(),
            model.loss, model.input, inspector, chkptm, device=device,
            step_limit=args.steps)

        chkpt = None
        if args.checkpoint:
            logging.info(f"loading checkpoint '{args.checkpoint}'")
            warm = strategy.Checkpoint.load(args.checkpoint)
            tctx._ensure_variables()
            warm.apply(module=model.model.module)

        if args.resume == "auto":
            found = strategy.find_auto_resume(
                Path(args.output), model=model.id, log=logging.getLogger())
            if found is None:
                raise ValueError(
                    f"--resume auto: no valid checkpoint for model "
                    f"'{model.id}' found under '{args.output}'")
            resume_path, chkpt = found
            logging.info(
                f"auto-resume: picking up from '{resume_path}' (stage "
                f"{chkpt.iteration.stage}, epoch {chkpt.iteration.epoch}, "
                f"step {chkpt.iteration.step})")
        elif args.resume:
            logging.info(f"loading checkpoint '{args.resume}'")
            chkpt = strategy.Checkpoint.load(args.resume)

        tctx.run(args.start_stage, args.start_epoch, chkpt)
        return tctx
    finally:
        if chkptm is not None:
            chkptm.wait()
        if inspector is not None:
            inspector.close()
        logging.getLogger().removeHandler(handler)
        handler.close()
