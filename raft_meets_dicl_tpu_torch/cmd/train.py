"""The ``train`` subcommand (counterpart of
``raft_meets_dicl_tpu/cmd/train.py::_train``, its plain single-device path).

Creates the run directory ``<output>/<timestamp><suffix>`` with
``main.log``, ``model.txt`` (the module's repr) and ``config.json`` (seeds,
model, strategy, inspector, environment, arguments), seeds the RNGs, loads
the model, the strategy and the inspector (``-i``; default
``cfg/inspect/default.yaml``, as in JAX: TensorBoard summaries under
``tb.<model>``, per-epoch validation and metric-named checkpoints under
``checkpoints/``) and runs the ``TrainingContext`` on one device:
``cuda`` unless the caller asks for the CPU; without CUDA it fails rather
than training elsewhere.

``-c FILE`` reads a full configuration (a run's own ``config.json``, or
one of ``cfg/full``): seeds, model, strategy, inspector and environment,
the strategy's paths relative to the file; ``-s/-e/-m/-d/-i`` override
its parts (``load_config_parts``, as in JAX). ``-e FILE`` reads an
:class:`Environment` (default ``cfg/env/default.yaml``): the loader's
arguments, the wire format and the deterministic switch.

``--checkpoint FILE`` starts from a checkpoint's weights;
``--resume FILE`` restores a checkpoint's full state and resumes where it
was written, ``--resume auto`` from the newest valid checkpoint of the
model under ``--output`` (corrupt ones quarantined). Both take the port's
files and the JAX package's.

The wire format (``models.wire``): ``--wire-format`` > ``RMD_WIRE_FORMAT``
> the environment's ``wire`` section. The loader: the environment's
``loader`` section, ``--loader-procs`` over its ``procs``, the stage's
``loader`` keys over both.

The strategy's data graph is the JAX package's: ``augment`` with its 15
host augmentations, ``concat``, ``repeat``, ``subset``, ``cache``, the
forwards/backwards sources and the ``generic``, ``generic-backwards`` and
``multi`` layouts (``synth`` is refused). The flags of parts not ported
yet (meshes, device augmentation, non-finite policies other than
``raise``) do not exist, and the environment sections that ask for them
are refused by name; ROADMAP slice 2 items 7-10 and slice 7 bring them.
"""

import datetime
import logging
import os
import re
import subprocess
from pathlib import Path

import torch

from .. import inspect, models, strategy, utils
from ..models.wire import WireFormat
from ..strategy.training import TrainingContext

_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_ENV = _ROOT / "cfg" / "env" / "default.yaml"
DEFAULT_INSPECT = _ROOT / "cfg" / "inspect" / "default.yaml"

def _refuse(what, item):
    raise NotImplementedError(f"environment: {what} is not ported yet "
                              f"(ROADMAP {item})")


class Environment:
    """Loader arguments, wire format and the deterministic switch (the JAX
    ``Environment``; its ``jax.deterministic`` maps onto torch's switches
    in :meth:`apply`).

    The sections of parts not ported yet are refused by name when set: a
    ``nonfinite`` policy other than ``raise`` and ``jax.debug-nans``
    (slice 2 item 7), ``parallel`` (items 8 and 10), ``compile``,
    ``augment`` and ``eval`` (slice 7).
    """

    @classmethod
    def load(cls, cfg):
        if isinstance(cfg, (Path, str)):
            cfg = utils.config.load(cfg)

        return cls(
            loader_args=cfg.get("loader", {}),
            wire=cfg.get("wire"),
            eval=cfg.get("eval", {}),
            nonfinite=cfg.get("nonfinite"),
            parallel=cfg.get("parallel", {}),
            compile=cfg.get("compile", {}),
            augment=cfg.get("augment"),
            debug_nans=cfg.get("jax", {}).get("debug-nans", False),
            deterministic=cfg.get("jax", {}).get("deterministic", False),
        )

    def __init__(self, loader_args=None, wire=None, eval=None,
                 nonfinite=None, parallel=None, compile=None, augment=None,
                 debug_nans=False, deterministic=False):
        self.loader_args = dict(loader_args or {})
        self.wire = wire
        WireFormat.from_config(wire)  # a bad preset fails here
        self.eval = dict(eval or {})
        self.nonfinite = nonfinite
        self.parallel = dict(parallel or {})
        self.compile = dict(compile or {})
        self.augment = augment
        self.debug_nans = bool(debug_nans)
        self.deterministic = bool(deterministic)

        policy = (nonfinite.get("policy", "raise")
                  if isinstance(nonfinite, dict) else nonfinite)
        if policy not in (None, "raise"):
            _refuse(f"the non-finite policy '{policy}'",
                    "slice 2 item 7, non-finite skip/rollback policies")
        if self.debug_nans:
            _refuse("'jax: debug-nans'",
                    "slice 2 item 7, non-finite policies and anomaly "
                    "detection")
        if self.parallel:
            _refuse("the 'parallel' section (meshes, in-step accumulation)",
                    "slice 2 items 10 and 8, DDP and in-step accumulation")
        if self.compile:
            _refuse("the 'compile' section", "slice 7 item 3, compile/")
        if self.augment:
            _refuse("the 'augment' section",
                    "slice 7 item 5, the on-device data engine")
        if self.eval:
            _refuse("the 'eval' section (validation shape buckets)",
                    "slice 7 item 7, the ops plane")

    def get_config(self):
        return {
            "loader": self.loader_args,
            "wire": self.wire,
            "eval": self.eval,
            "nonfinite": self.nonfinite,
            "parallel": self.parallel,
            "compile": self.compile,
            "augment": self.augment,
            "jax": {
                "debug-nans": self.debug_nans,
                "deterministic": self.deterministic,
            },
        }

    def apply(self):
        """``deterministic``: torch's deterministic algorithms on (an op
        with no deterministic form raises, and so do the port's two
        kernels that add with atomics), cuDNN deterministic and not
        benchmarking, and ``CUBLAS_WORKSPACE_CONFIG`` set for cuBLAS; run
        before the first cuBLAS call."""
        if not self.deterministic:
            return
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def load_config_parts(args):
    """Seeds, environment, model, strategy and inspector configs from
    ``--config`` plus the individual overrides (the JAX
    ``load_config_parts``): returns them with the base path the strategy's
    relative paths resolve against."""
    cfg_seeds = cfg_env = cfg_model = cfg_strat = cfg_inspc = None
    base_path = "./"

    if getattr(args, "config", None) is not None:
        logging.info(f"loading configuration: file='{args.config}'")
        config = utils.config.load(args.config)

        cfg_seeds = config.get("seeds")
        cfg_model = config.get("model")
        cfg_strat = config.get("strategy")
        cfg_inspc = config.get("inspect")
        cfg_env = config.get("environment")
        base_path = Path(args.config).parent

    if getattr(args, "seeds", None):
        cfg_seeds = utils.config.load(args.seeds)

    if getattr(args, "env", None):
        cfg_env = args.env
    if cfg_env is None:
        cfg_env = DEFAULT_ENV

    if getattr(args, "model", None) is not None:
        cfg_model = args.model
    if getattr(args, "data", None) is not None:
        cfg_strat = args.data
        base_path = "./"
    if getattr(args, "inspect", None) is not None:
        cfg_inspc = args.inspect
    if cfg_inspc is None:
        cfg_inspc = DEFAULT_INSPECT

    return cfg_seeds, cfg_env, cfg_model, cfg_strat, cfg_inspc, base_path


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

    cfg_seeds, cfg_env, cfg_model, cfg_strat, cfg_inspc, base_path = \
        load_config_parts(args)
    if cfg_model is None:
        raise ValueError("no model configuration specified")
    if cfg_strat is None:
        raise ValueError("no strategy/data configuration specified")

    # before anything touches cuBLAS: the deterministic switches
    env = Environment.load(cfg_env)
    env.apply()

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

        if isinstance(cfg_model, (str, Path)):
            logging.info(f"loading model configuration: file='{cfg_model}'")
        model = models.load(cfg_model)

        if isinstance(cfg_strat, (str, Path)):
            logging.info(f"loading strategy configuration: "
                         f"file='{cfg_strat}'")
            strat = strategy.load(cfg_strat)
        else:
            strat = strategy.load(base_path, cfg_strat)

        if isinstance(cfg_inspc, (str, Path)):
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
            "environment": env.get_config(),
        })

        logging.info(f"device: {device}" + (
            f" ({torch.cuda.get_device_name(device)})"
            if device.type == "cuda" else ""))
        inspector, chkptm = inspc.build(model.id, path_out)

        if args.checkpoint or args.resume:
            logging.warning("saved config not sufficient for "
                            "reproducibility due to checkpoint data")

        # wire format: CLI flag > RMD_WIRE_FORMAT > the environment's
        wire = WireFormat.from_config(
            getattr(args, "wire_format", None)
            or utils.env.get_str("RMD_WIRE_FORMAT") or env.wire)
        if wire is not None:
            logging.info(f"input wire format: {wire.describe()}")

        loader_args = dict(env.loader_args)
        if getattr(args, "loader_procs", None) is not None:
            loader_args["procs"] = args.loader_procs
        if env.deterministic:
            logging.info("deterministic algorithms: on")

        tctx = TrainingContext(
            path_out, strat, model.id, model.model, model.model.get_adapter(),
            model.loss, model.input, inspector, chkptm, device=device,
            step_limit=args.steps, loader_args=loader_args, wire=wire)

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
