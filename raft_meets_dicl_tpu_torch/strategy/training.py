"""The training loop: stages → epochs → instances (counterpart of
``raft_meets_dicl_tpu/strategy/training.py::TrainingContext``, its plain
path).

Per stage: with ``mode: best``, the best checkpoint of the previous stage
(by the manager's ``compare``) is loaded first; then the loader over the
stage's data, a fresh optimizer and schedulers (the scheduler expressions
see ``n_samples``, ``n_batches``, ``n_epochs``, ``n_accum``,
``batch_size``), the model's ``on_stage`` hook (``freeze_batchnorm``) and
the train step. Per instance: skip a batch the adapter marked invalid,
take the learning rate from the schedulers (epoch ones first, then
instance ones; the last one wins, as with chained torch schedulers), copy
the batch to the device (``non_blocking`` from pinned memory on the card)
and run the step. The inspector's callbacks run as in JAX: its epoch-,
stage- or step-frequency validation creates the checkpoints.

Resume (``run(start_stage, start_epoch, checkpoint)``) follows JAX's
arithmetic: a checkpoint at the end of epoch e resumes at epoch e + 1, one
at a stage's end starts the next stage. At a stage boundary only the
weights are restored (the optimizer and schedulers belong to the previous
stage); mid-stage the optimizer, the schedulers and the scaler slot too.

As in the JAX loop, the host never waits for a step it has just issued:
the step's loss, finite flag, skip count and norms stay on the device and
are fetched together every ``RMD_FINITE_CHECK_EVERY`` steps (default 10)
and at the end of each epoch; the inspector's train metrics are fetched
at the same point. Each fetch logs a loss/lr/grad-norm line, appends
every step since the last fetch to ``history`` and applies the
non-finite policy (:class:`NonFinitePolicy`). Under ``raise`` a
``failed.ckpt`` of the current state is written to the run directory,
then the run aborts. Under ``skip`` and ``rollback`` the step's guard
already dropped the poisoned updates on the device; the fetch reads the
skip count, logs the trips (with the recent batches' sample ids) and
escalates as JAX's ``_resolve_finite`` does: to a rollback to the newest
valid checkpoint (``rollback``) or to the abort. On the card each step's
time is the span between CUDA events recorded after consecutive steps
(no added synchronisation); on the CPU it is the host clock.

Gradient accumulation has JAX's two forms. ``accumulate=k`` (the
environment's ``parallel.accumulate``, ``--accumulate``) is in-step: the
loader batches ``k·B`` samples and the step runs them as k microbatches
with one update. A stage's ``gradient.accumulate: k`` is the optimizer's
(``optax.MultiSteps``): every call of the step is one microbatch, and the
loop counts the calls it ran, so that the instance schedulers,
``ctx.step`` and ``on_step_end`` move only on every k-th; an invalid batch
costs one microbatch and no count.

The loader's arguments are the environment's (``loader_args``), with the
stage's ``loader`` keys winning, as in JAX. With a wire format
(``models.wire.WireFormat``, bound here to the input's clip/range) the
stage's data is read un-normalized and the adapter encodes the images,
the flow and the valid mask in the loader's workers (JAX compresses the
last two at its device put, in its prefetch thread); the bytes that
cross the host→device copy are counted (each ``history`` entry's
``wire_bytes``), and the train step decodes the batch on the device. The
inspector's image summaries get the images decoded on the host, on the
steps that write them.

JAX also puts a mixed-precision model's host-normalized images as
bfloat16 when no wire format is set (``RMD_WIRE_BF16``). The port's
policy rounds the images to bfloat16 at the first convolution of each
encoder, which is all that reads them, so that put would change the
bytes only; ``tests/test_torch_port_wire.py`` holds the first step's loss
and gradients bit for bit with and without the rounding.

Fault injection (``testing.faults``): ``RMD_FAULT=nan_update@step=N``
passes a NaN learning rate to the step at step N. The stop-request
emergency checkpoints and the telemetry events of the JAX loop wait with
the ops plane (ROADMAP slice 7 item 7); the fields of JAX's
``nonfinite`` events go into the warnings logged here.
"""

import logging
import time
from collections import deque
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from .. import utils
from ..parallel import TrainState, make_train_step
from ..testing import faults
from .checkpoint import Checkpoint, Iteration, State
from .inspector import Inspector

log = logging.getLogger("train")

# steps between two reads of the pending steps' scalars (the JAX loop's
# default finite-check cadence; RMD_FINITE_CHECK_EVERY sets it)
FETCH_EVERY = 10


class NonFinitePolicy:
    """What to do when a training step produces non-finite values.

    ``raise`` (default) dumps a ``failed.ckpt`` and aborts the run.
    ``skip`` builds the skip guard into the train step: the poisoned
    update is dropped on the device (parameters, batch-norm statistics and
    optimizer state carry forward bit for bit) and training continues.
    ``rollback`` skips like ``skip`` but restores the newest valid
    checkpoint once trips persist. Both escalate: ``max_consecutive``
    consecutive tripped steps, or more than ``max_consecutive`` trips
    within a trailing ``window`` of steps, trigger the rollback (or,
    under ``skip`` or when no checkpoint survives, the abort), and
    ``max_rollbacks`` bounds how often a rollback may fire before the run
    gives up.
    """

    POLICIES = ("raise", "skip", "rollback")

    def __init__(self, policy="raise", max_consecutive=3, window=50,
                 max_rollbacks=3):
        if policy not in self.POLICIES:
            raise ValueError(
                f"invalid non-finite policy '{policy}', expected one of "
                f"{list(self.POLICIES)}")
        self.policy = policy
        self.max_consecutive = max(1, int(max_consecutive))
        self.window = max(1, int(window))
        self.max_rollbacks = max(0, int(max_rollbacks))

    @classmethod
    def from_config(cls, cfg):
        """``None`` | policy name | mapping with ``policy`` /
        ``max-consecutive`` / ``window`` / ``max-rollbacks`` keys (or
        their underscore spellings)."""
        if cfg is None:
            return cls()
        if isinstance(cfg, str):
            return cls(cfg)
        if isinstance(cfg, cls):
            return cfg
        return cls(
            cfg.get("policy", "raise"),
            cfg.get("max-consecutive", cfg.get("max_consecutive", 3)),
            cfg.get("window", 50),
            cfg.get("max-rollbacks", cfg.get("max_rollbacks", 3)),
        )

    def get_config(self):
        return {
            "policy": self.policy,
            "max-consecutive": self.max_consecutive,
            "window": self.window,
            "max-rollbacks": self.max_rollbacks,
        }


class _StepResult:
    """The train step's aux outputs behind the Result's ``final()``, the
    one view the inspector reads (the step keeps no iteration sequence)."""

    def __init__(self, aux):
        self.aux = aux

    def final(self):
        return self.aux["final"]


class TrainingContext:
    def __init__(self, path, strategy, model_id, model, model_adapter, loss,
                 input, inspector=None, checkpoints=None, device="cuda",
                 step_limit=None, loader_args=None, wire=None,
                 nonfinite=None, accumulate=1):
        self.path = Path(path)
        self.strategy = strategy
        self.model_id = model_id
        self.model = model
        self.model_adapter = model_adapter
        self.loss = loss
        self.input = input
        self.inspector = inspector if inspector is not None else Inspector()
        self.checkpoints = checkpoints
        self.device = torch.device(device)
        self.step_limit = step_limit
        self.loader_args = dict(loader_args or {})
        self.wire = (wire.bound(input.clip, input.range)
                     if wire is not None else None)
        # in-step accumulation: k microbatches of the stage's batch size
        # per step call and update
        self.accumulate = max(1, int(accumulate))

        # the non-finite policy; its counters restart with each stage
        self.nonfinite = NonFinitePolicy.from_config(nonfinite)
        self._nf_last_count = 0
        self._nf_consecutive = 0
        self._nf_window = deque()
        self._nf_rollbacks = 0
        # sample ids of the recent batches, logged with a trip (detection
        # is amortized, up to a fetch interval late)
        self._recent_samples = deque(maxlen=32)
        self.fetch_every = max(1, utils.env.get_int(
            "RMD_FINITE_CHECK_EVERY", FETCH_EVERY))
        # microbatches run in the stage (the MultiSteps boundary counter)
        self._accum = 0
        self._in_step = False
        self.rollbacks = []

        self.step = 0
        self.initialized = False
        # one entry per applied step, filled at each fetch
        self.history = []

        self.state = None
        self.data = None
        self.step_fn = None
        self.base_lr = 0.0
        self.last_lr = 0.0
        self.scaler = None
        self.lr_sched_inst = []
        self.lr_sched_epoch = []
        self.current_stage = None
        self.current_epoch = None
        self._pending = []
        self._last_mark = None

    # -- state (CheckpointManager.create reads it) ---------------------------

    def snapshot_checkpoint(self, stage, epoch, metrics=None,
                            source="training"):
        """A Checkpoint of the live state. Its tensors are the live ones:
        ``Checkpoint.save`` copies them to the host before it returns."""
        tx = self.state.tx if self.state is not None else None
        return Checkpoint(
            model=self.model_id,
            iteration=Iteration(stage.index, epoch, self.step),
            metrics=metrics,
            state=State(
                model=self.model.module.state_dict(),
                optimizer=tx.state_dict() if tx is not None else {},
                scaler=dict(self.scaler or {}),
                lr_sched_inst=[s.state_dict() for s in self.lr_sched_inst],
                lr_sched_epoch=[s.state_dict() for s in self.lr_sched_epoch],
            ),
            metadata={"timestamp": datetime.now().isoformat(),
                      "source": source},
        )

    # -- initialization ----------------------------------------------------

    def _ensure_variables(self):
        """Initialize the model's weights (once per run) from a seed drawn
        from the run-seeded numpy RNG, on the CPU so the same seed gives
        the same weights on every device, and move them to the device."""
        if self.initialized:
            return

        log.info("initializing model parameters")
        seed = int(np.random.randint(0, 2**31 - 1))
        self.model.init(torch.Generator().manual_seed(seed), self.device)
        self.initialized = True

    # -- main loop ----------------------------------------------------------

    def run(self, start_stage=None, start_epoch=None, checkpoint=None):
        n_stages = len(self.strategy.stages)

        if start_stage is None and checkpoint is not None:
            start_stage = checkpoint.iteration.stage
        if start_stage is None:
            start_stage = 0
        assert 0 <= start_stage < n_stages

        if start_epoch is None and checkpoint is not None:
            start_epoch = checkpoint.iteration.epoch + 1
        if start_epoch is None:
            start_epoch = 0

        if checkpoint is not None:
            self.step = checkpoint.iteration.step

        log.info(f"start training: running {n_stages} stages on device "
                 f"'{self.device}'")
        self._ensure_variables()
        self.inspector.setup(log, self)

        for i, stage in list(enumerate(self.strategy.stages))[start_stage:]:
            # checkpoint created at the end of a stage: skip to the next
            if start_epoch >= stage.data.epochs:
                start_epoch = 0
                continue

            log.info(f"stage {i + 1}/{n_stages}: starting '{stage.name}' "
                     f"({stage.id}) at step {self.step}")
            stage.index = i
            self.run_stage(stage, start_epoch, checkpoint)
            start_epoch = 0
            checkpoint = None

            if self.step_limit is not None and self.step >= self.step_limit:
                break

        self.inspector.flush()
        log.info(f"training loop complete, ran {self.step:,} steps over "
                 f"{n_stages} stages")

    def prepare_stage(self, stage):
        """``mode: best``: load the previous stage's best checkpoint
        (weights only); a corrupt one is quarantined and the next best
        used."""
        if self.strategy.mode != "best" or self.checkpoints is None:
            return

        found = self.checkpoints.load_valid(sort="best",
                                            stage=stage.index - 1, log=log)
        if found is None:
            return

        entry, chkpt = found
        log.info(f"loading best checkpoint from previous stage, "
                 f"file='{entry.path}'")
        chkpt.apply(module=self.model.module)

    def run_stage(self, stage, start_epoch=0, checkpoint=None):
        assert 0 <= start_epoch < stage.data.epochs

        self.current_stage = stage
        self.prepare_stage(stage)

        log.info(f"loading dataset: {stage.data.source.description()}")
        loader_args = self.loader_args | stage.loader_args
        loader_args.setdefault("pin_memory", self.device.type == "cuda")
        if self.wire is not None:
            log.info(f"wire format: {self.wire.describe()} "
                     "(device-side normalization)")
        input = self.input.apply(
            stage.data.source, normalize=self.wire is None,
        ).torch(wire=self.wire, wire_targets=True)
        if self.accumulate > 1:
            log.info(f"gradient accumulation: {self.accumulate} microbatches "
                     "per optimizer step (in-step)")
        self.data = input.loader(
            batch_size=stage.data.batch_size * self.accumulate,
            shuffle=stage.data.shuffle,
            drop_last=stage.data.drop_last,
            **loader_args,
        )
        log.info(f"dataset loaded: have {len(self.data)} batches over "
                 f"{len(input)} samples")
        if len(input) == 0:
            raise ValueError("dataset resolved to zero samples: "
                             f"{stage.data.source.description()}")

        # optimizer and schedulers, fresh per stage
        log.info("setting up optimizer")
        # the skip guard restores Adam's step count on the device
        guard = self.nonfinite.policy != "raise"
        tx, self.base_lr = stage.optimizer.build(
            self.model.module.parameters(), stage.gradient,
            capturable=guard and self.device.type == "cuda")
        self.scaler = stage.gradient.scaler.build()

        sched_vars = {
            "n_samples": len(input),
            "n_batches": len(self.data),
            "n_epochs": stage.data.epochs,
            "n_accum": stage.gradient.accumulate,
            "batch_size": stage.data.batch_size,
        }
        self.lr_sched_inst, self.lr_sched_epoch = stage.scheduler.build(
            self.base_lr, sched_vars)
        self.state = TrainState(self.model, tx)

        # a stage boundary (epoch 0) restores the weights only: the
        # optimizer and schedulers belong to the previous stage
        if checkpoint is not None:
            log.info("restoring data from checkpoint")
            if start_epoch == 0:
                checkpoint.apply(module=self.model.module)
            else:
                self.scaler = checkpoint.apply(
                    module=self.model.module, optimizer=tx,
                    scaler=self.scaler, lr_sched_inst=self.lr_sched_inst,
                    lr_sched_epoch=self.lr_sched_epoch)

        # stage hooks before the step is built: freeze_batchnorm
        self.model_adapter.on_stage(stage, **stage.model_on_stage_args)
        self.step_fn = make_train_step(
            self.model, self.loss, loss_args=stage.loss_args,
            model_args=stage.model_args, wire=self.wire,
            with_grads=bool(self.inspector.wants_gradients),
            nonfinite="skip" if guard else None,
            accumulate=self.accumulate)

        self._accum = 0
        self._in_step = False
        # the device's skip count restarts with the fresh state
        self._nf_last_count = 0
        self._nf_consecutive = 0
        self._nf_window.clear()

        self.inspector.on_stage_start(log, self, stage)

        log.info(f"running {stage.data.epochs} epochs")
        for epoch in range(start_epoch, stage.data.epochs):
            log.info(f"epoch {epoch + 1}/{stage.data.epochs}: starting at "
                     f"step {self.step}")
            self.run_epoch(stage, epoch)

            if self.step_limit is not None and self.step >= self.step_limit:
                break

        self.inspector.on_stage(log, self, stage)

    def run_epoch(self, stage, epoch):
        self.current_epoch = epoch
        self.model_adapter.on_epoch(stage, epoch, **stage.model_on_epoch_args)
        self.inspector.on_epoch_start(log, self, stage, epoch)

        # epoch-seeded host augmentation, set before the loader's
        # ``__iter__`` forks its workers, which inherit the value
        stage.data.source.set_epoch(epoch)

        self._last_mark = self._mark()
        for i, batch in enumerate(self.data):
            self.run_instance(stage, epoch, i, batch)
            if self.step_limit is not None and self.step >= self.step_limit:
                break
        self._fetch()

        for s in self.lr_sched_epoch:
            s.step()

        self.inspector.on_epoch(log, self, stage, epoch)

    def run_instance(self, stage, epoch, i, batch):
        img1, img2, flow, valid, meta = batch

        if not self._in_step:
            self.inspector.on_step_start(log, self, stage, epoch, i)
            self._in_step = True
        # an invalid batch costs one microbatch: the boundary counts the
        # microbatches that ran
        if not all(m.valid for m in meta):
            log.warning(f"step {self.step}: skipping batch due to invalid data")
            return

        lr = self.base_lr
        for s in self.lr_sched_epoch:
            lr = s.lr()
        for s in self.lr_sched_inst:
            lr = s.lr()
        self.last_lr = lr

        if faults.active() and faults.fire("nan_update",
                                           step=self.step) is not None:
            # a NaN rate poisons the update as a NaN gradient would
            log.warning(f"fault injection: NaN update at step {self.step}")
            lr = float("nan")

        self._recent_samples.append(
            (self.step, [f"{m.dataset_id}/{m.sample_id}" for m in meta]))

        self.inspector.on_batch_start(log, self, stage, epoch, i, img1, img2,
                                      flow, valid, meta)

        host = (img1, img2, flow, valid)
        nbytes = sum(x.nbytes for x in host)
        dev = [x.to(self.device, non_blocking=True) for x in host]
        self.state, aux = self.step_fn(self.state, lr, *dev)

        mark = self._mark()

        # what the inspector reads: the decoded flow and valid mask (the
        # step's), the images decoded on the host where it reads them
        target, mask = aux.pop("target"), aux.pop("valid")
        if self.wire is not None and self.inspector.wants_host_images(
                self.step):
            dev[0], dev[1] = (self.wire.decode_image(x) for x in (img1, img2))
        self._pending.append((self.step, lr, aux, self._last_mark, mark,
                              nbytes))
        self._last_mark = mark

        self.inspector.on_batch(log, self, stage, epoch, i, dev[0], dev[1],
                                target, mask, meta, _StepResult(aux),
                                aux["loss"])

        self._accum += 1
        if self._accum % stage.gradient.accumulate == 0:
            for s in self.lr_sched_inst:
                s.step()
            self.inspector.on_step_end(log, self, stage, epoch, i)
            self.step += 1
            self._in_step = False

        if len(self._pending) >= self.fetch_every:
            self._fetch()

    # -- amortized fetch -----------------------------------------------------

    def _mark(self):
        if self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def _fetch(self):
        """Read the pending steps' scalars in one device→host copy, log,
        record, flush the inspector's train metrics and apply the
        non-finite policy."""
        pending, self._pending = self._pending, []
        if not pending:
            return

        values = torch.stack([
            torch.stack([aux["loss"].float(), aux["finite"].float(),
                         aux["grad_norm"].float(), aux["update_norm"].float(),
                         aux["nonfinite_count"].float()])
            for _, _, aux, _, _, _ in pending]).cpu()
        rows = values.tolist()
        for (step, lr, _, start, end, nbytes), (loss, finite, gnorm, unorm,
                                                _) in zip(pending, rows):
            if self.device.type == "cuda":
                ms = start.elapsed_time(end)
            else:
                ms = 1e3 * (end - start)
            self.history.append({
                "step": step, "loss": loss, "finite": bool(finite),
                "lr": lr, "grad_norm": gnorm, "update_norm": unorm, "ms": ms,
                "wire_bytes": nbytes,
            })
        self.inspector.flush()

        last = self.history[-1]
        log.info(f"step {last['step']}: loss {last['loss']:.4f}, lr "
                 f"{last['lr']:.4e}, grad-norm {last['grad_norm']:.4f}, "
                 f"{last['ms']:.1f} ms")

        stage, epoch = self.current_stage, self.current_epoch
        if self.nonfinite.policy == "raise":
            bad = [h["step"] for h in self.history[-len(pending):]
                   if not h["finite"]]
            if bad:
                self._dump_failed(log, stage, epoch)
                raise RuntimeError(
                    f"non-finite flow values detected at step(s) {bad}")
            return

        # the newest step's flag and the cumulative skip count, as JAX
        # resolves its amortized finite fetch
        self._resolve_finite(log, (bool(rows[-1][1]), stage, epoch,
                                   int(rows[-1][4])),
                             "non-finite flow values detected")

    def _resolve_finite(self, log, prev, msg):
        """Apply the ``skip``/``rollback`` policy to one fetch (the JAX
        ``_resolve_finite``): ``prev`` is ``(finite, stage, epoch,
        nonfinite_count)`` of the newest fetched step. The poisoned
        updates were already dropped on the device; this reads the count,
        logs the trips and escalates when they persist."""
        finite, stage, epoch, count = prev

        if self.nonfinite.policy == "raise":
            if not bool(finite):
                self._dump_failed(log, stage, epoch)
                raise RuntimeError(msg)
            return

        finite = bool(finite)
        count = int(count) if count is not None else 0
        trips = count - self._nf_last_count
        self._nf_last_count = count

        if trips <= 0:
            self._nf_consecutive = 0
            return

        # consecutive estimate: exact at a fetch every step; otherwise the
        # newest step's flag decides whether the streak is still live
        self._nf_consecutive = (self._nf_consecutive + trips if not finite
                                else 0)
        self._nf_window.append((self.step, trips))
        horizon = self.step - self.nonfinite.window
        while self._nf_window and self._nf_window[0][0] < horizon:
            self._nf_window.popleft()
        in_window = sum(t for _, t in self._nf_window)

        log.warning(
            f"non-finite step: dropped {trips} optimizer update(s) "
            f"(policy '{self.nonfinite.policy}'; {in_window} trips in the "
            f"last {self.nonfinite.window} steps) [action=skip, step="
            f"{self.step}, trips={trips}, consecutive="
            f"{self._nf_consecutive}, window_trips={in_window}, "
            f"samples={self._samples()}]")

        if (self._nf_consecutive < self.nonfinite.max_consecutive
                and in_window <= self.nonfinite.max_consecutive):
            return

        if self.nonfinite.policy == "rollback":
            self._rollback(log, stage, epoch)
            return

        self._dump_failed(log, stage, epoch)
        raise RuntimeError(
            f"non-finite steps persist under policy 'skip' "
            f"({self._nf_consecutive} consecutive, {in_window} within "
            f"{self.nonfinite.window} steps): aborting ({msg})")

    def _rollback(self, log, stage, epoch):
        """Restore the newest valid checkpoint after persistent trips: the
        weights, the optimizer (with the accumulation) and the schedulers;
        the weights alone when the optimizer state does not fit (a
        checkpoint of another stage), with a fresh optimizer."""
        self._nf_rollbacks += 1
        if self._nf_rollbacks > self.nonfinite.max_rollbacks:
            self._dump_failed(log, stage, epoch)
            raise RuntimeError(
                f"non-finite steps persist after "
                f"{self.nonfinite.max_rollbacks} rollbacks: aborting")

        found = (self.checkpoints.load_valid(sort="latest", log=log)
                 if self.checkpoints is not None else None)
        if found is None:
            self._dump_failed(log, stage, epoch)
            raise RuntimeError(
                "non-finite steps persist and no valid checkpoint exists "
                "to roll back to")

        entry, chkpt = found
        from_step = self.step
        log.error(
            f"non-finite steps persist: rolling back to '{entry.path}' "
            f"(step {chkpt.iteration.step})")

        tx = self.state.tx
        try:
            self.scaler = chkpt.apply(
                module=self.model.module, optimizer=tx, scaler=self.scaler,
                lr_sched_inst=self.lr_sched_inst,
                lr_sched_epoch=self.lr_sched_epoch)
        except (KeyError, TypeError, ValueError):
            log.warning("rollback checkpoint has incompatible optimizer "
                        "state: restoring weights only")
            chkpt.apply(module=self.model.module)
            tx.reset()

        self.step = chkpt.iteration.step
        self._nf_consecutive = 0
        self._nf_window.clear()
        self.rollbacks.append({"path": str(entry.path), "from_step": from_step,
                               "to_step": chkpt.iteration.step})
        log.warning(
            f"rolled back [action=rollback, path={entry.path}, from_step="
            f"{from_step}, to_step={chkpt.iteration.step}, rollbacks="
            f"{self._nf_rollbacks}]")

    def _samples(self):
        return [{"step": s, "samples": ids}
                for s, ids in self._recent_samples]

    def _dump_failed(self, log, stage, epoch):
        """The post-mortem of an abort: the current state as
        ``failed.ckpt`` in the run directory (under ``raise`` with the
        poisoned updates); ``--resume auto`` never picks it."""
        log.error("detected non-finite values in final flow field")
        log.error(f"recent batches: {self._samples()}")
        failed = self.path / "failed.ckpt"
        epoch = epoch if epoch is not None else 0
        self.snapshot_checkpoint(stage, epoch).save(failed)
        log.error(f"wrote the failed state to '{failed}'")
