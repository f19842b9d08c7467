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
the step's loss, finite flag and norms stay on the device and are fetched
together every ``FETCH_EVERY`` steps and at the end of each epoch; the
inspector's train metrics are fetched at the same point. Each fetch logs
a loss/lr/grad-norm line, appends every step since the last fetch to
``history`` and applies the ``raise`` non-finite policy: a ``failed.ckpt``
of the current state is written to the run directory, then the run
aborts. On the card each step's time is the span between CUDA events
recorded after consecutive steps (no added synchronisation); on the CPU it
is the host clock.

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

Not ported yet, and refused by the train step: the ``skip``/``rollback``
policies, accumulation and meshes; emergency checkpoints on a stop request
wait with the ops plane (ROADMAP slice 7 item 7).
"""

import logging
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..parallel import TrainState, make_train_step
from .checkpoint import Checkpoint, Iteration, State
from .inspector import Inspector

log = logging.getLogger("train")

# steps between two reads of the pending steps' scalars (the JAX loop's
# default finite-check cadence)
FETCH_EVERY = 10


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
                 step_limit=None, loader_args=None, wire=None):
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
        optimizer = self.state.tx.optimizer if self.state is not None else None
        return Checkpoint(
            model=self.model_id,
            iteration=Iteration(stage.index, epoch, self.step),
            metrics=metrics,
            state=State(
                model=self.model.module.state_dict(),
                optimizer=optimizer.state_dict() if optimizer else {},
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
        self.data = input.loader(
            batch_size=stage.data.batch_size,
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
        tx, self.base_lr = stage.optimizer.build(
            self.model.module.parameters(), stage.gradient)
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
                    module=self.model.module, optimizer=tx.optimizer,
                    scaler=self.scaler, lr_sched_inst=self.lr_sched_inst,
                    lr_sched_epoch=self.lr_sched_epoch)

        # stage hooks before the step is built: freeze_batchnorm
        self.model_adapter.on_stage(stage, **stage.model_on_stage_args)
        self.step_fn = make_train_step(
            self.model, self.loss, loss_args=stage.loss_args,
            model_args=stage.model_args, wire=self.wire,
            with_grads=bool(self.inspector.wants_gradients))

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

        self.inspector.on_step_start(log, self, stage, epoch, i)
        if not all(m.valid for m in meta):
            log.warning(f"step {self.step}: skipping batch due to invalid data")
            return

        lr = self.base_lr
        for s in self.lr_sched_epoch:
            lr = s.lr()
        for s in self.lr_sched_inst:
            lr = s.lr()
        self.last_lr = lr

        self.inspector.on_batch_start(log, self, stage, epoch, i, img1, img2,
                                      flow, valid, meta)

        host = (img1, img2, flow, valid)
        nbytes = sum(x.nbytes for x in host)
        dev = [x.to(self.device, non_blocking=True) for x in host]
        self.state, aux = self.step_fn(self.state, lr, *dev)

        mark = self._mark()

        # what the inspector reads: the decoded flow and valid mask (the
        # step's), the images decoded on the host where it writes them
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

        for s in self.lr_sched_inst:
            s.step()
        self.inspector.on_step_end(log, self, stage, epoch, i)
        self.step += 1

        if len(self._pending) >= FETCH_EVERY:
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
        record, flush the inspector's train metrics and apply the ``raise``
        non-finite policy."""
        pending, self._pending = self._pending, []
        if not pending:
            return

        values = torch.stack([
            torch.stack([aux["loss"].float(), aux["finite"].float(),
                         aux["grad_norm"].float(), aux["update_norm"].float()])
            for _, _, aux, _, _, _ in pending]).cpu()
        for (step, lr, _, start, end, nbytes), (loss, finite, gnorm, unorm) \
                in zip(pending, values.tolist()):
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

        bad = [h["step"] for h in self.history[-len(pending):]
               if not h["finite"]]
        if bad:
            self._dump_failed()
            raise RuntimeError(
                f"non-finite flow values detected at step(s) {bad}")

    def _dump_failed(self):
        """The ``raise`` policy's post-mortem: the current state (the
        poisoned updates included) as ``failed.ckpt`` in the run
        directory; ``--resume auto`` never picks it."""
        log.error("detected non-finite values in final flow field")
        failed = self.path / "failed.ckpt"
        epoch = self.current_epoch if self.current_epoch is not None else 0
        self.snapshot_checkpoint(self.current_stage, epoch).save(failed)
        log.error(f"wrote the failed state to '{failed}'")
