"""The training loop: stages → epochs → instances (counterpart of
``raft_meets_dicl_tpu/strategy/training.py::TrainingContext``, its plain
path).

Per stage: the loader over the stage's data, a fresh optimizer and
schedulers (the scheduler expressions see ``n_samples``, ``n_batches``,
``n_epochs``, ``n_accum``, ``batch_size``), the model's ``on_stage`` hook
(``freeze_batchnorm``) and the train step. Per instance: skip a batch the
adapter marked invalid, take the learning rate from the schedulers (epoch
ones first, then instance ones; the last one wins, as with chained torch
schedulers), copy the batch to the device (``non_blocking`` from pinned
memory on the card) and run the step.

As in the JAX loop, the host never waits for a step it has just issued:
the step's loss, finite flag and norms stay on the device and are fetched
together every ``FETCH_EVERY`` steps and at the end of each epoch. Each
fetch logs a loss/lr/grad-norm line, appends every step since the last
fetch to ``history`` and applies the ``raise`` non-finite policy. On the
card each step's time is the span between CUDA events recorded after
consecutive steps (no added synchronisation); on the CPU it is the host
clock.

Not ported yet, and refused by name: validation, metrics and the
inspector (ROADMAP slice 2 item 5), checkpoints and ``mode: best`` across
stages (item 6); the ``skip``/``rollback`` policies, accumulation, wire
formats and meshes are refused by the train step.
"""

import logging
import time

import numpy as np
import torch

from ..parallel import TrainState, make_train_step

log = logging.getLogger("train")

# steps between two reads of the pending steps' scalars (the JAX loop's
# default finite-check cadence)
FETCH_EVERY = 10


class TrainingContext:
    def __init__(self, path, strategy, model, model_adapter, loss, input,
                 device="cuda", step_limit=None):
        for stage in strategy.stages:
            if stage.validation:
                raise NotImplementedError(
                    f"stage '{stage.id}' has validation entries: validation, "
                    "metrics and the inspector are not ported yet (ROADMAP "
                    "slice 2 item 5)")
        if strategy.mode == "best" and len(strategy.stages) > 1:
            raise NotImplementedError(
                "strategy mode 'best' restores the previous stage's best "
                "checkpoint: checkpoints are not ported yet (ROADMAP slice 2 "
                "item 6); use mode 'continuous'")

        self.path = path
        self.strategy = strategy
        self.model = model
        self.model_adapter = model_adapter
        self.loss = loss
        self.input = input
        self.device = torch.device(device)
        self.step_limit = step_limit

        self.step = 0
        self.initialized = False
        # one entry per applied step, filled at each fetch
        self.history = []

        self.state = None
        self.data = None
        self.step_fn = None
        self.base_lr = 0.0
        self.lr_sched_inst = []
        self.lr_sched_epoch = []
        self._pending = []
        self._last_mark = None

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

    def run(self, start_stage=None):
        n_stages = len(self.strategy.stages)
        start_stage = start_stage or 0
        assert 0 <= start_stage < n_stages

        log.info(f"start training: running {n_stages} stages on device "
                 f"'{self.device}'")
        self._ensure_variables()

        for i, stage in list(enumerate(self.strategy.stages))[start_stage:]:
            log.info(f"stage {i + 1}/{n_stages}: starting '{stage.name}' "
                     f"({stage.id}) at step {self.step}")
            self.run_stage(stage)

            if self.step_limit is not None and self.step >= self.step_limit:
                break

        log.info(f"training loop complete, ran {self.step:,} steps over "
                 f"{n_stages} stages")

    def run_stage(self, stage):
        log.info(f"loading dataset: {stage.data.source.description()}")
        loader_args = dict(stage.loader_args)
        loader_args.setdefault("pin_memory", self.device.type == "cuda")
        input = self.input.apply(stage.data.source).torch()
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

        # stage hooks before the step is built: freeze_batchnorm
        self.model_adapter.on_stage(stage, **stage.model_on_stage_args)
        self.step_fn = make_train_step(
            self.model, self.loss, loss_args=stage.loss_args,
            model_args=stage.model_args)

        log.info(f"running {stage.data.epochs} epochs")
        for epoch in range(stage.data.epochs):
            log.info(f"epoch {epoch + 1}/{stage.data.epochs}: starting at "
                     f"step {self.step}")
            self.run_epoch(stage, epoch)

            if self.step_limit is not None and self.step >= self.step_limit:
                break

    def run_epoch(self, stage, epoch):
        self.model_adapter.on_epoch(stage, epoch, **stage.model_on_epoch_args)

        self._last_mark = self._mark()
        for i, batch in enumerate(self.data):
            self.run_instance(stage, epoch, i, batch)
            if self.step_limit is not None and self.step >= self.step_limit:
                break
        self._fetch()

        for s in self.lr_sched_epoch:
            s.step()

    def run_instance(self, stage, epoch, i, batch):
        img1, img2, flow, valid, meta = batch

        if not all(m.valid for m in meta):
            log.warning(f"step {self.step}: skipping batch due to invalid data")
            return

        lr = self.base_lr
        for s in self.lr_sched_epoch:
            lr = s.lr()
        for s in self.lr_sched_inst:
            lr = s.lr()

        dev = [x.to(self.device, non_blocking=True)
               for x in (img1, img2, flow, valid)]
        self.state, aux = self.step_fn(self.state, lr, *dev)

        mark = self._mark()
        self._pending.append((self.step, lr, aux, self._last_mark, mark))
        self._last_mark = mark

        for s in self.lr_sched_inst:
            s.step()
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
        record and apply the ``raise`` non-finite policy."""
        pending, self._pending = self._pending, []
        if not pending:
            return

        values = torch.stack([
            torch.stack([aux["loss"].float(), aux["finite"].float(),
                         aux["grad_norm"].float(), aux["update_norm"].float()])
            for _, _, aux, _, _ in pending]).cpu()
        for (step, lr, _, start, end), (loss, finite, gnorm, unorm) in zip(
                pending, values.tolist()):
            if self.device.type == "cuda":
                ms = start.elapsed_time(end)
            else:
                ms = 1e3 * (end - start)
            self.history.append({
                "step": step, "loss": loss, "finite": bool(finite),
                "lr": lr, "grad_norm": gnorm, "update_norm": unorm, "ms": ms,
            })

        last = self.history[-1]
        log.info(f"step {last['step']}: loss {last['loss']:.4f}, lr "
                 f"{last['lr']:.4e}, grad-norm {last['grad_norm']:.4f}, "
                 f"{last['ms']:.1f} ms")

        bad = [h["step"] for h in self.history[-len(pending):]
               if not h["finite"]]
        if bad:
            log.error("detected non-finite values in final flow field (no "
                      "failed.ckpt is written: checkpoints are ROADMAP slice 2 "
                      "item 6)")
            raise RuntimeError(
                f"non-finite flow values detected at step(s) {bad}")
