"""Checkpointing: single-file checkpoints and the retention manager
(counterpart of ``raft_meets_dicl_tpu/strategy/checkpoint.py``).

The logical schema is the JAX package's: ``{model, iteration{stage, epoch,
step}, metrics, state{model, optimizer, scaler, lr-scheduler{instance,
epoch}}, metadata}``. Here ``state.model`` is the module's ``state_dict()``
(parameters and batch-norm buffers), ``state.optimizer`` the
``torch.optim`` optimizer's ``state_dict()`` and the schedulers'
entries their ``state_dict()`` (``{"last_step"}``, as in JAX).

File format: the 6-byte magic ``RMDP1\\n``, the little-endian CRC32 of the
payload, then the payload, a ``torch.save`` archive read back with
``torch.load(weights_only=True)``. The payload is serialized in memory, so
the same checkpoint always gives the same bytes. The port's magic is its
own: the JAX package's loader refuses these files (it quarantines them as
corrupt under ``--resume auto``), and the port tells the two kinds apart
by their magic. The JAX package's ``RMDT2`` (CRC32 + flax msgpack) and
``RMDT1`` (no checksum) files load too, through the port's own msgpack
reader (``utils.msgpack``); their state stays in the JAX layout (flax
variables, the optax state) until :meth:`Checkpoint.apply` maps it onto a
module and an optimizer through ``convert``.

Integrity: a bad magic, a CRC mismatch, a truncation or an undecodable
payload raises :class:`CheckpointCorrupt`. The recovery paths
(``CheckpointManager.load_valid``, :func:`find_auto_resume`) quarantine
such a file (rename to ``*.corrupt``) and fall back to the next valid one.

Writes are atomic (a temporary file, then a rename). ``create`` takes the
device->host snapshot on the caller's thread, then serializes and writes
on one shared background writer (``RMD_ASYNC_CHECKPOINT=0`` keeps the
whole save on the caller's thread).
"""

import concurrent.futures
import io
import logging
import os
import re
import struct
import sys
import time
import zlib
from collections import defaultdict
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .. import utils

MAGIC = b"RMDP1\n"          # the port's: CRC32 + torch.save payload
JAX_MAGIC = b"RMDT2\n"      # the JAX package's: CRC32 + flax msgpack
JAX_MAGIC_V1 = b"RMDT1\n"   # the JAX package's legacy form: no checksum
_CRC_LEN = 4

log = logging.getLogger("checkpoint")


class CheckpointCorrupt(ValueError):
    """A checkpoint file failed integrity verification (bad magic, CRC
    mismatch, truncation, or an undecodable payload)."""


def quarantine(path):
    """Rename a corrupt checkpoint out of the discovery namespace:
    ``foo.ckpt`` becomes ``foo.ckpt.corrupt`` (numbered if that exists),
    so retention scans and auto-resume stop considering it while the bytes
    stay on disk. Returns the new path, or None if the rename failed."""
    path = Path(path)
    dst = path.with_name(path.name + ".corrupt")
    n = 1
    while dst.exists():
        dst = path.with_name(f"{path.name}.corrupt{n}")
        n += 1
    try:
        os.replace(path, dst)
    except OSError:
        return None
    log.warning(f"quarantined corrupt checkpoint '{path}' as '{dst}'")
    return dst


# single background writer shared by all managers: one ordered lane keeps
# writes in creation order; non-daemon threads, so a clean interpreter exit
# waits for in-flight writes
_WRITER: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _writer():
    global _WRITER
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="chkpt-write")
    return _WRITER


def _write_atomic(path, payload):
    """Write via tmp file + rename so a reader (or a crash mid-write)
    never sees a truncated checkpoint."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    tmp.write_bytes(payload)
    os.replace(tmp, path)


def _to_host(tree):
    """Tensors -> detached CPU copies (synchronous: a copy from the card
    waits for the work that produces it); containers rebuilt as plain
    dicts, lists and tuples, strings interned. The pickle memo then
    depends on values only (equal strings always shared, nothing else),
    so equal checkpoints serialize to equal bytes."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, str):
        return sys.intern(tree)
    if isinstance(tree, dict):
        return {_to_host(k): _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def is_primary():
    """Rank 0 of ``torch.distributed`` when it is initialised, else True:
    only the primary process writes checkpoints."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


@dataclass
class Iteration:
    stage: int
    epoch: Optional[int]
    step: int

    @classmethod
    def from_dict(cls, cfg):
        return cls(stage=cfg["stage"], epoch=cfg.get("epoch"),
                   step=cfg["step"])

    def to_dict(self):
        return {"stage": self.stage, "epoch": self.epoch, "step": self.step}


@dataclass
class State:
    model: Any          # module state_dict (JAX files: flax variables)
    optimizer: Any      # optimizer state_dict (JAX files: optax state)
    scaler: Any
    lr_sched_inst: List[Any]
    lr_sched_epoch: List[Any]

    @classmethod
    def from_dict(cls, cfg):
        return cls(
            model=cfg["model"],
            optimizer=cfg["optimizer"],
            scaler=cfg["scaler"],
            lr_sched_inst=cfg["lr-scheduler"]["instance"],
            lr_sched_epoch=cfg["lr-scheduler"]["epoch"],
        )

    def to_dict(self):
        return {
            "model": self.model,
            "optimizer": self.optimizer,
            "scaler": self.scaler,
            "lr-scheduler": {
                "instance": self.lr_sched_inst,
                "epoch": self.lr_sched_epoch,
            },
        }


def _read(path):
    """(format, decoded payload) of a checkpoint file."""
    raw = Path(path).read_bytes()
    for magic, fmt in ((MAGIC, "torch"), (JAX_MAGIC, "jax")):
        if raw.startswith(magic):
            header = len(magic) + _CRC_LEN
            if len(raw) < header:
                raise CheckpointCorrupt(f"truncated checkpoint: {path}")
            (crc,) = struct.unpack("<I", raw[len(magic):header])
            payload = raw[header:]
            if zlib.crc32(payload) != crc:
                raise CheckpointCorrupt(
                    f"checkpoint checksum mismatch (bit rot or truncated "
                    f"write): {path}")
            break
    else:
        if not raw.startswith(JAX_MAGIC_V1):
            raise CheckpointCorrupt(f"not a checkpoint file: {path}")
        fmt, payload = "jax", raw[len(JAX_MAGIC_V1):]

    try:
        if fmt == "torch":
            cfg = torch.load(io.BytesIO(payload), map_location="cpu",
                             weights_only=True)
        else:
            cfg = utils.msgpack.restore(payload)
    except Exception as e:  # noqa: BLE001 - decoder errors vary
        raise CheckpointCorrupt(
            f"checkpoint payload undecodable: {path} ({e})") from e
    return fmt, cfg


@dataclass
class Checkpoint:
    model: str
    iteration: Iteration
    metrics: Optional[Dict[str, float]]
    state: State
    metadata: Dict[str, Any]
    # "torch": the port's layout; "jax": a JAX package file, its state in
    # the JAX layout until apply() converts it
    format: str = "torch"

    @classmethod
    def from_dict(cls, cfg, format="torch"):
        return cls(
            model=cfg["model"],
            iteration=Iteration.from_dict(cfg["iteration"]),
            metrics=cfg["metrics"],
            state=State.from_dict(cfg["state"]),
            metadata=cfg.get("metadata", {}),
            format=format,
        )

    @classmethod
    def load(cls, path):
        fmt, cfg = _read(path)
        return cls.from_dict(cfg, format=fmt)

    def to_dict(self):
        return {
            "model": self.model,
            "iteration": self.iteration.to_dict(),
            "metrics": self.metrics,
            "state": self.state.to_dict(),
            "metadata": self.metadata,
        }

    def to_entry(self, path):
        return CheckpointEntry(self.model, self.iteration.stage,
                               self.iteration.epoch, self.iteration.step,
                               self.metrics, path)

    def save(self, path, background=False):
        """Serialize to ``path`` atomically, in the port's format.

        The device->host snapshot runs on the caller's thread; with
        ``background=True`` the encode and the write run on the shared
        writer thread and a ``Future`` (resolving to the seconds they
        took) is returned, else None. A JAX-format checkpoint is applied
        to a module first; it is not re-saved as it stands.
        """
        if self.format != "torch":
            raise ValueError(
                "a JAX package checkpoint is saved in the port's format "
                "only after apply() has mapped it onto a module")
        state = _to_host(self.to_dict())

        def write():
            t0 = time.perf_counter()
            buffer = io.BytesIO()
            torch.save(state, buffer)
            payload = buffer.getvalue()
            crc = struct.pack("<I", zlib.crc32(payload))
            _write_atomic(path, MAGIC + crc + payload)
            return time.perf_counter() - t0

        if not background:
            write()
            return None
        return _writer().submit(write)

    def apply(self, module=None, optimizer=None, scaler=None,
              lr_sched_inst=(), lr_sched_epoch=()):
        """Restore state into ``module`` (strict ``load_state_dict``) and
        ``optimizer`` (a ``torch.optim`` optimizer or the trainer's
        ``spec.GradientTransform``, which also takes the gradient
        accumulation) in place, and the schedulers; pass None to skip a
        slot. A JAX-format checkpoint is mapped through ``convert`` first.
        Returns the scaler state (a copy of the stored one when ``scaler``
        is given, else ``scaler``)."""
        if module is not None or optimizer is not None:
            model_state, opt_state = self.state.model, self.state.optimizer
            if self.format == "jax":
                from .. import convert

                if module is None:
                    raise ValueError("a JAX package checkpoint maps its "
                                     "optimizer state through the module")
                model_state = convert.jax_variables_to_state_dict(
                    model_state, convert.rules_for(module))
                if optimizer is not None:
                    # a GradientTransform holds the torch optimizer
                    opt_state = convert.optax_state_to_torch(
                        opt_state, module,
                        getattr(optimizer, "optimizer", optimizer))
            if module is not None:
                module.load_state_dict(model_state, strict=True)
            if optimizer is not None:
                optimizer.load_state_dict(opt_state)

        for sched, state in zip(lr_sched_inst, self.state.lr_sched_inst):
            sched.load_state_dict(state)
        for sched, state in zip(lr_sched_epoch, self.state.lr_sched_epoch):
            sched.load_state_dict(state)

        return dict(self.state.scaler) if scaler is not None else scaler


@dataclass
class CheckpointEntry:
    model: str
    idx_stage: int
    idx_epoch: Optional[int]
    idx_step: int
    metrics: Optional[Dict[str, float]]
    path: Optional[Path]
    # in-flight background write; load() and deletion join it first
    pending: Optional[Any] = None
    # the background write raised: retention and recovery skip the entry
    failed: bool = False

    def wait(self):
        """Block until an in-flight background write has finished; a write
        that failed re-raises here (and marks the entry failed)."""
        if self.pending is not None:
            pending, self.pending = self.pending, None
            try:
                pending.result()
            except BaseException as e:
                self.failed = True
                raise RuntimeError(
                    f"background checkpoint write failed: '{self.path}' "
                    f"({type(e).__name__}: {e})") from e

    def write_failed(self):
        """Non-blocking: True once a finished background write is known
        to have raised."""
        if self.failed:
            return True
        if self.pending is not None and self.pending.done():
            if self.pending.exception() is not None:
                self.failed = True
        return self.failed

    def load(self) -> Checkpoint:
        self.wait()
        return Checkpoint.load(self.path)

    def __hash__(self):
        return hash((self.model, self.idx_stage, self.idx_epoch,
                     self.idx_step, self.path))

    def __eq__(self, o):
        if not isinstance(o, CheckpointEntry):
            return NotImplemented
        return (self.model == o.model and self.idx_stage == o.idx_stage
                and self.idx_epoch == o.idx_epoch
                and self.idx_step == o.idx_step and self.path == o.path)


class CheckpointManager:
    """Name-templated checkpoint store with best/latest retention.

    ``compare`` is a list of metric expressions (e.g.
    ``'{m_EndPointError_mean}'``) evaluated over a checkpoint's metrics;
    the lexicographically smallest wins. ``saves`` records each save made
    by :meth:`create` (path, step, bytes, blocking and background ms).
    """

    def __init__(self, model_id, path, name, compare, keep_latest=None,
                 keep_best=None):
        self.model_id = model_id
        self.path = Path(path)
        self.name = name
        self.compare = list(compare)
        self.checkpoints: List[CheckpointEntry] = []
        self.keep_latest = keep_latest
        self.keep_best = keep_best
        self.saves = []

    def _metric_args(self, entry):
        sanitize = re.compile(r"[\./\\\?!:-]")
        metrics = entry.metrics or {}
        return {"m_" + sanitize.sub("_", k): v for k, v in metrics.items()}

    def _iter_args(self, entry):
        return {
            "id_model": entry.model,
            "n_stage": entry.idx_stage,
            "n_epoch": entry.idx_epoch,
            "n_steps": entry.idx_step,
        }

    def _args(self, entry):
        return self._iter_args(entry) | self._metric_args(entry)

    def _sort_key_best(self, entry):
        args = self._args(entry)
        return [utils.expr.eval_math_expr(c, args) for c in self.compare]

    @staticmethod
    def _sort_key_latest(entry):
        return entry.idx_stage, entry.idx_epoch, entry.idx_step

    def _filtered(self, stage, epoch):
        chkpts = [c for c in self.checkpoints if not c.write_failed()]
        if stage is not None and epoch is not None:
            return [c for c in chkpts
                    if c.idx_stage == stage and c.idx_epoch == epoch]
        if stage is not None:
            return [c for c in chkpts if c.idx_stage == stage]
        if epoch is not None:
            raise ValueError("epoch can only be set if stage is set")
        return chkpts

    def get_best(self, stage=None, epoch=None) -> Optional[CheckpointEntry]:
        return min(self._filtered(stage, epoch), key=self._sort_key_best,
                   default=None)

    def get_latest(self, stage=None, epoch=None) -> Optional[CheckpointEntry]:
        return max(self._filtered(stage, epoch), key=self._sort_key_latest,
                   default=None)

    def load_valid(self, sort="latest", stage=None, log=None):
        """Load the best/latest checkpoint that verifies: a corrupt file is
        quarantined and dropped, an unusable one dropped, and the next one
        in ``sort`` order ("latest" or "best") tried. Returns ``(entry,
        Checkpoint)``, or None when nothing valid remains."""
        key = (self._sort_key_best if sort == "best"
               else self._sort_key_latest)
        ordered = sorted(self._filtered(stage, None), key=key,
                         reverse=sort != "best")
        for entry in ordered:
            try:
                return entry, entry.load()
            except CheckpointCorrupt as e:
                if log is not None:
                    log.error(f"quarantining corrupt checkpoint: {e}")
                quarantine(entry.path)
            except (RuntimeError, OSError) as e:
                if log is not None:
                    log.error(f"skipping unusable checkpoint "
                              f"'{entry.path}': {e}")
            self.checkpoints = [c for c in self.checkpoints
                                if c is not entry]
        return None

    def trim(self, n_best=1, n_latest=1, delete=True):
        if n_best is None and n_latest is None:
            return

        keep, remove = set(), set()
        for s in {c.idx_stage for c in self.checkpoints}:
            chkpts = [c for c in self.checkpoints if c.idx_stage == s]

            if n_best is not None:
                best = sorted(chkpts, key=self._sort_key_best)
                keep |= set(best[:n_best])
                remove |= set(best[n_best:])

            if n_latest is not None:
                latest = sorted(chkpts, key=self._sort_key_latest,
                                reverse=True)
                keep |= set(latest[:n_latest])
                remove |= set(latest[n_latest:])

        self.checkpoints = sorted(keep, key=self._sort_key_latest)

        if delete:
            for entry in remove - keep:
                # an in-flight write must finish before the unlink, or it
                # recreates the file
                entry.wait()
                entry.path.unlink(missing_ok=True)

    def create(self, log, ctx, stage, epoch, step, metrics):
        """Save a checkpoint of the live training context and trim. Only
        the primary process writes (:func:`is_primary`)."""
        if not is_primary():
            return

        # a failed background write surfaces at the next create()
        for entry in list(self.checkpoints):
            if entry.write_failed():
                self.checkpoints = [c for c in self.checkpoints
                                    if c is not entry]
                entry.wait()

        epoch_int = epoch if epoch is not None else stage.data.epochs
        entry = CheckpointEntry(self.model_id, stage.index, epoch_int, step,
                                metrics, None)

        args = self._args(entry) | {"id_stage": stage.id}
        args["id_model"] = args["id_model"].replace("/", "_").replace("-", ".")
        args["id_stage"] = args["id_stage"].replace("/", "_").replace("-", ".")

        entry.path = self.path / self.name.format_map(args)
        entry.path.parent.mkdir(parents=True, exist_ok=True)
        log.debug(f"saving checkpoint to '{entry.path}'")

        # blocking: the state snapshot (device->host) on this thread, plus
        # the write when synchronous; background: encode and write
        t0 = time.perf_counter()
        chkpt = ctx.snapshot_checkpoint(stage, epoch, metrics=metrics)
        record = {"path": str(entry.path), "step": step}
        self.saves.append(record)

        def finish(bg):
            record["background_ms"] = 1e3 * bg
            record["bytes"] = entry.path.stat().st_size
            return bg

        if utils.env.get_bool("RMD_ASYNC_CHECKPOINT"):
            write = chkpt.save(entry.path, background=True)
            record["blocking_ms"] = 1e3 * (time.perf_counter() - t0)
            # the same single-lane writer: runs after the write
            entry.pending = _writer().submit(
                lambda: finish(write.result()))
        else:
            chkpt.save(entry.path)
            record["blocking_ms"] = 1e3 * (time.perf_counter() - t0)
            finish(0.0)

        self.checkpoints.append(entry)
        self.trim(n_best=self.keep_best, n_latest=self.keep_latest)

    def wait(self):
        """Join every in-flight background write."""
        for entry in self.checkpoints:
            entry.wait()


def find_auto_resume(path, model=None, quarantine_corrupt=True, log=None):
    """The ``--resume auto`` engine: the newest valid ``*.ckpt`` under
    ``path`` (recursively; ``failed.ckpt`` dumps excluded) by ``(stage,
    epoch, step)``, the file's mtime breaking ties; the port's files and
    the JAX package's alike. Corrupt files are quarantined; ``model``
    restricts the search to one model id. Returns ``(file, Checkpoint)``
    or None."""
    path = Path(path)
    if not path.exists():
        return None

    candidates = [f for f in path.rglob("*.ckpt")
                  if f.is_file() and not f.name.startswith(".")
                  and f.name != "failed.ckpt"]
    candidates.sort(key=lambda f: f.stat().st_mtime, reverse=True)

    best = None
    best_key = None
    for file in candidates:
        try:
            chkpt = Checkpoint.load(file)
        except CheckpointCorrupt as e:
            if log is not None:
                log.error(f"auto-resume: quarantining corrupt checkpoint: {e}")
            if quarantine_corrupt:
                quarantine(file)
            continue
        except (KeyError, TypeError, OSError):
            continue  # some other .ckpt-named file; not ours
        if model is not None and chkpt.model != model:
            continue
        it = chkpt.iteration
        key = (it.stage, it.epoch if it.epoch is not None else -1, it.step,
               file.stat().st_mtime)
        if best_key is None or key > best_key:
            best, best_key = (file, chkpt), key
    return best


def load_directory(path, compare) -> List[CheckpointManager]:
    """Scan a directory into per-model CheckpointManagers."""
    name = "{id_model}-s{n_stage}_e{n_epoch}_b{n_steps}.ckpt"
    path = Path(path)

    checkpoints = defaultdict(list)
    for file in sorted(path.iterdir()):
        if not file.is_file():
            continue
        try:
            entry = Checkpoint.load(file).to_entry(file)
        except (ValueError, KeyError):
            continue
        checkpoints[entry.model].append(entry)

    mgrs = []
    for model in sorted(checkpoints):
        mgr = CheckpointManager(model, path, name, compare)
        mgr.checkpoints = checkpoints[model]
        mgrs.append(mgr)

    return mgrs
