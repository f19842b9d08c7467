"""SummaryInspector: TensorBoard summaries and validation-driven checkpoints
(counterpart of ``raft_meets_dicl_tpu/inspect/summary.py``).

- Train metrics are computed on the device from the train step's outputs
  (loss, final flow, the gradients when a metric asks for them) and
  queued with their step; :meth:`SummaryInspector.flush`, which the
  trainer calls where it reads its own step scalars back, fetches every
  queued value in one copy, reduces each step's and writes the scalars.
  No step waits for the device.
- Validation runs each stage's ``validation`` entries through the port's
  inference step (``evaluation.make_eval_fn``) plus the stage's loss on
  the raw output, reduces the metrics, writes them and the selected
  samples' images, and creates a checkpoint with the metric dict: the
  only place checkpoints are born during training, as in JAX.

Not ported yet, and refused by name: inspector hooks (intermediates and
gradient hooks; ROADMAP slice 2 item 7), the forwards-backwards occlusion
and confidence images (with ``video/``, slice 7), validation shape
buckets (an environment config, slice 7 ops plane).
"""

import logging
import time
from collections import OrderedDict, defaultdict
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .. import evaluation, metrics, visual
from ..strategy.checkpoint import CheckpointManager
from ..strategy.inspector import Inspector
from .writer import SummaryWriter


class MetricsGroup:
    """Frequency-gated accumulate-and-reduce over train batches. The
    values are kept as computed (device tensors) until the inspector's
    flush fetches them."""

    @classmethod
    def from_config(cls, cfg):
        return cls(
            int(cfg.get("frequency", 1)),
            str(cfg.get("prefix", "")),
            [metrics.Metric.from_config(m) for m in cfg.get("metrics", [])],
        )

    def __init__(self, frequency, prefix, mtx):
        self.frequency = frequency
        self.prefix = prefix
        self.metrics = mtx
        self.values = [[] for _ in self.metrics]

    def get_config(self):
        return {
            "frequency": self.frequency,
            "prefix": self.prefix,
            "metrics": [m.get_config() for m in self.metrics],
        }

    @property
    def wants_gradients(self):
        return any(m.type.startswith("grad-") for m in self.metrics)

    def reset(self):
        self.values = [[] for _ in self.metrics]

    def compute(self, ctx_m, estimate, target, valid, loss):
        for i, metric in enumerate(self.metrics):
            self.values[i].append(metric(ctx_m, estimate, target, valid, loss))

    def take(self):
        """The pending per-metric lists of computed dicts; resets."""
        values, self.values = self.values, [[] for _ in self.metrics]
        return values

    def reduce(self, fetched):
        """``fetched``: per metric, the list of fetched ``{key: float}``
        dicts of one step."""
        result = OrderedDict()
        for metric, dicts in zip(self.metrics, fetched):
            values = defaultdict(list)
            for d in dicts:
                for k, v in d.items():
                    values[k].append(v)
            for k, v in metric.reduce(values).items():
                result[f"{self.prefix}{k}"] = v
        return result


class ImagesSpec:
    @classmethod
    def from_config(cls, cfg):
        if cfg is None:
            return None
        return cls(cfg.get("frequency", 250), cfg.get("prefix", ""))

    def __init__(self, frequency, prefix):
        self.frequency = frequency
        self.prefix = prefix

    def get_config(self):
        return {"frequency": self.frequency, "prefix": self.prefix}


class CheckpointSpec:
    @classmethod
    def from_config(cls, cfg):
        keep = cfg.get("keep", {})
        return cls(
            cfg.get("path", "checkpoints"),
            cfg.get("name",
                    "{id_model}-s{n_stage}_e{n_epoch}_b{n_steps}.ckpt"),
            cfg.get("compare", "{n_steps}"),
            keep.get("latest"),
            keep.get("best"),
        )

    def __init__(self, path, name, compare, keep_latest=None, keep_best=None):
        self.path = Path(path)
        self.name = name
        self.compare = [compare] if isinstance(compare, str) else list(compare)
        self.keep_latest = keep_latest
        self.keep_best = keep_best

    def get_config(self):
        return {
            "path": str(self.path),
            "name": self.name,
            "compare": self.compare,
            "keep": {"latest": self.keep_latest, "best": self.keep_best},
        }

    def build(self, id, base_path):
        return CheckpointManager(
            id, Path(base_path) / self.path, self.name, self.compare,
            self.keep_latest, self.keep_best)


class ValidationMetricSpec:
    @classmethod
    def from_config(cls, cfg):
        return cls(
            metrics.Metric.from_config(cfg["metric"]),
            str(cfg.get("reduce", "mean")),
            bool(cfg.get("log", True)),
        )

    def __init__(self, metric, reduce, do_log):
        self.metric = metric
        self.reduce = reduce
        self.do_log = do_log

    def get_config(self):
        return {
            "reduce": self.reduce,
            "log": self.do_log,
            "metric": self.metric.get_config(),
        }

    def build(self):
        return ValidationMetric(self.metric, self.reduce, self.do_log)


class ValidationMetric:
    """Per-validation-run accumulator: one computed dict per batch,
    fetched together at the end of the pass."""

    def __init__(self, metric, reduce, do_log):
        if reduce not in ("mean",):
            raise ValueError("unsupported reduction type")

        self.metric = metric
        self.reduce = reduce
        self.do_log = do_log
        self.values = []

    def add(self, ctx_m, estimate, target, valid, loss):
        self.values.append(self.metric(ctx_m, estimate, target, valid, loss))

    def result(self, fetched):
        values = defaultdict(list)
        for d in fetched:
            for k, v in d.items():
                values[k].append(v)
        return [(k, float(np.mean(vs, axis=0))) for k, vs in values.items()]


class ValidationImages:
    @classmethod
    def from_config(cls, cfg):
        return cls(cfg.get("enabled", True), cfg.get("prefix", "Validation/"))

    def __init__(self, enabled, prefix):
        self.enabled = enabled
        self.prefix = prefix

    def get_config(self):
        return {"enabled": self.enabled, "prefix": self.prefix}


class Validation:
    """Base: frequency int (steps) or 'epoch' | 'stage'."""

    type: Optional[str] = None
    frequency: Union[str, int]

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid validation type '{cfg['type']}', expected "
                f"'{cls.type}'")

    @classmethod
    def from_config(cls, cfg):
        types = {StrategyValidation.type: StrategyValidation}
        return types[cfg["type"]].from_config(cfg)

    def __init__(self, frequency):
        if not isinstance(frequency, (str, int)) or (
                isinstance(frequency, str)
                and frequency not in ("epoch", "stage")):
            raise ValueError(
                "frequency must be either integer or one of 'epoch', 'stage'")
        self.frequency = frequency

    def get_config(self):
        raise NotImplementedError

    def run(self, log, ctx, writer, chkpt, stage, epoch):
        raise NotImplementedError


def make_val_step(model, loss_fn, model_args=None, loss_args=None):
    """``step(img1, img2, flow, valid) -> (final flow, loss)``: the port's
    inference step (``evaluation.make_eval_fn``) and the loss on its raw
    output, under ``torch.inference_mode()``."""
    fwd = evaluation.make_eval_fn(model, model_args)
    adapter = model.get_adapter()
    loss_args = dict(loss_args or {})

    def step(img1, img2, flow, valid):
        out, final = fwd(img1, img2)
        with torch.inference_mode():
            result = adapter.wrap_result(out, tuple(flow.shape[1:3]))
            loss = loss_fn(model, result.output(), flow, valid, **loss_args)
        return final, loss

    return step


class StrategyValidation(Validation):
    """Runs the stage's validation datasets, logs and writes the reduced
    metrics, and creates a checkpoint with the metric dict. Each pass is
    recorded in ``runs`` (its batches and seconds, the device work of the
    pass included)."""

    type = "strategy"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(
            cfg["frequency"],
            bool(cfg.get("checkpoint", True)),
            str(cfg.get("tb-metrics-prefix", "")),
            [ValidationMetricSpec.from_config(m)
             for m in cfg.get("metrics", [])],
            ValidationImages.from_config(cfg.get("images", {})),
        )

    def __init__(self, frequency, checkpoint, tb_metrics_pfx, mtx, images):
        super().__init__(frequency)
        self.checkpoint = checkpoint
        self.tb_metrics_pfx = tb_metrics_pfx
        self.metrics = mtx
        self.images = images
        self.runs = []

    def get_config(self):
        return {
            "type": self.type,
            "frequency": self.frequency,
            "checkpoint": self.checkpoint,
            "tb-metrics-prefix": self.tb_metrics_pfx,
            "metrics": [m.get_config() for m in self.metrics],
            "images": self.images.get_config(),
        }

    def run(self, log, ctx, writer, chkpt, stage, epoch):
        if not stage.validation:
            log.warning("no validation data specified, skipping this "
                        "validation step")
            return

        chkpmetrics = {}
        for i, val in enumerate(stage.validation):
            mtx = self._evaluate_one(ctx, writer, stage, val, epoch)
            kvmetrics = {}

            writer.set_fmtargs(dict(
                n_stage=stage.index,
                id_stage=stage.id.replace("/", "."),
                n_epoch=epoch,
                n_step=ctx.step,
                id_val=val.name,
            ))

            entries = []
            for m, res in mtx:
                kvmetrics |= dict(res)
                for k, v in res:
                    writer.add_scalar(self.tb_metrics_pfx + k, v, ctx.step)
                if m.do_log:
                    entries += [f"{k}: {v:.4f}" for k, v in res]

            if entries:
                log.info(f"validation ({val.name}): {', '.join(entries)}")

            # the first run's metrics are the main ones; every run's also
            # under its name
            if i == 0:
                chkpmetrics |= kvmetrics
            chkpmetrics |= {f"{val.name}:{k}": v
                            for k, v in kvmetrics.items()}

        if self.checkpoint:
            chkpt.create(log, ctx, stage, epoch, ctx.step, chkpmetrics)

    def _evaluate_one(self, ctx, writer, stage, val, epoch):
        images = set(val.images) if self.images.enabled else set()
        mtx = [m.build() for m in self.metrics]
        step = make_val_step(ctx.model, ctx.loss, stage.model_args,
                             stage.loss_args)

        input = ctx.input.apply(val.source).torch()
        data = input.loader(batch_size=val.batch_size, shuffle=False,
                            drop_last=False,
                            pin_memory=ctx.device.type == "cuda",
                            **getattr(ctx, "loader_args", {}))

        ctx_m = metrics.MetricContext(
            lr=ctx.last_lr, params=dict(ctx.model.module.named_parameters()))

        t0, n = None, 0
        for i, (img1, img2, flow, valid, meta) in enumerate(data):
            if t0 is None:
                t0 = time.perf_counter()
            dev = [x.to(ctx.device, non_blocking=True)
                   for x in (img1, img2, flow, valid)]
            est, loss = step(*dev)
            n += 1

            for m in mtx:
                m.add(ctx_m, est, dev[2], dev[3], loss)

            for j in images:  # expected to be a small set
                j_min, j_max = i * val.batch_size, (i + 1) * val.batch_size
                if not (j_min <= j < j_max):
                    continue

                writer.set_fmtargs(dict(
                    n_stage=stage.index,
                    id_stage=stage.id.replace("/", "."),
                    n_epoch=epoch,
                    n_step=ctx.step,
                    img_idx=j,
                    id_val=val.name,
                ))
                write_images(writer, self.images.prefix, j - j_min, img1,
                             img2, flow, est.cpu(), valid, meta, ctx.step)

        # one device->host copy for every metric of every batch
        fetched = metrics.fetch([d for m in mtx for d in m.values])
        out, k = [], 0
        for m in mtx:
            out.append((m, m.result(fetched[k:k + len(m.values)])))
            k += len(m.values)

        seconds = time.perf_counter() - t0 if t0 is not None else 0.0
        self.runs.append({"stage": stage.index, "epoch": epoch,
                          "step": ctx.step, "validation": val.name,
                          "batches": n, "seconds": seconds})
        return out


class InspectorSpec:
    @classmethod
    def from_config(cls, cfg):
        if cfg.get("hooks"):
            raise NotImplementedError(
                "inspector hooks are not ported yet (ROADMAP slice 2 item "
                "7)")
        return cls(
            [MetricsGroup.from_config(m) for m in cfg.get("metrics", [])],
            ImagesSpec.from_config(cfg.get("images")),
            CheckpointSpec.from_config(cfg.get("checkpoints", {})),
            [Validation.from_config(v) for v in cfg.get("validation", [])],
            cfg.get("tensorboard", {}).get("path", "tb.{id_model}"),
        )

    def __init__(self, mtx, images, checkpoints, validation, tb_path):
        self.metrics = mtx
        self.images = images
        self.checkpoints = checkpoints
        self.validation = validation
        self.tb_path = tb_path

    def get_config(self):
        return {
            "metrics": [g.get_config() for g in self.metrics],
            "hooks": [],
            "images": (self.images.get_config()
                       if self.images is not None else None),
            "checkpoints": self.checkpoints.get_config(),
            "validation": [v.get_config() for v in self.validation],
            "tensorboard": {"path": self.tb_path},
        }

    def build(self, id, base_path):
        base_path = Path(base_path)
        chkpts = self.checkpoints.build(id, base_path)

        args = {"id_model": id.replace("/", "_").replace("-", ".")}
        path = base_path / self.tb_path.format_map(args)
        logging.info(f"writing tensorboard summary to '{path}'")
        writer = SummaryWriter(path)

        insp = SummaryInspector(writer, self.metrics, self.images, chkpts,
                                self.validation)
        return insp, chkpts


class SummaryInspector(Inspector):
    def __init__(self, writer, mtx, images, checkpoints, validation):
        super().__init__()

        self.writer = writer
        self.metrics = mtx
        self.images = images
        self.checkpoints = checkpoints
        self.validation = list(validation)

        self.val_step = [v for v in validation
                         if not isinstance(v.frequency, str)]
        self.val_epoch = [v for v in validation if v.frequency == "epoch"]
        self.val_stage = [v for v in validation if v.frequency == "stage"]

        # (step, group, computed values) of steps not yet written
        self._queued = []

    @property
    def wants_gradients(self):
        """The trainer returns the gradients from its step iff a metric
        asks for them."""
        return any(g.wants_gradients for g in self.metrics)

    def wants_host_images(self, step):
        """Pixel values are read only on image-dump steps: the wire-format
        trainer decodes the images for those alone."""
        return self.images is not None and step % self.images.frequency == 0

    def _set_fmtargs(self, ctx, stage, epoch=None):
        self.writer.set_fmtargs(dict(
            n_stage=stage.index,
            id_stage=stage.id.replace("/", "."),
            n_epoch=epoch,
            n_step=ctx.step,
        ))

    def on_batch_start(self, log, ctx, stage, epoch, i, img1, img2, target,
                       valid, meta):
        self._set_fmtargs(ctx, stage, epoch)

    def on_batch(self, log, ctx, stage, epoch, i, img1, img2, target, valid,
                 meta, result, loss):
        """``img1``..``valid`` are the step's device tensors."""
        final = result.final()
        active = [m for m in self.metrics if ctx.step % m.frequency == 0]
        if active:
            ctx_m = metrics.MetricContext(
                lr=ctx.last_lr,
                params=dict(ctx.model.module.named_parameters()),
                grads=result.aux.get("grads"))
            for m in active:
                m.compute(ctx_m, final, target, valid, loss)

        if self.images is not None and ctx.step % self.images.frequency == 0:
            write_images(self.writer, self.images.prefix, 0, img1.cpu(),
                         img2.cpu(), target.cpu(), final.cpu(), valid.cpu(),
                         meta, ctx.step)

    def on_step_start(self, log, ctx, stage, epoch, i):
        for m in self.metrics:
            m.reset()

    def on_step_end(self, log, ctx, stage, epoch, i):
        # the tags are formatted now, with this step's arguments
        for m in self.metrics:
            values = m.take()
            if any(values):
                self._queued.append((ctx.step, m, values,
                                     dict(self.writer.fmt.fmtargs)))

        due = [v for v in self.val_step
               if ctx.step > 0 and ctx.step % v.frequency == 0]
        for val in due:
            self.flush()
            val.run(log, ctx, self.writer, self.checkpoints, stage, epoch)

    def flush(self):
        """Fetch every queued train metric in one copy, reduce each step's
        and write the scalars."""
        queued, self._queued = self._queued, []
        if not queued:
            return
        flat = [d for _, _, values, _ in queued for dicts in values
                for d in dicts]
        fetched = metrics.fetch(flat)
        k = 0
        fmtargs = dict(self.writer.fmt.fmtargs)
        for step, group, values, args in queued:
            per_metric = []
            for dicts in values:
                per_metric.append(fetched[k:k + len(dicts)])
                k += len(dicts)
            self.writer.set_fmtargs(args)
            for key, v in group.reduce(per_metric).items():
                self.writer.add_scalar(key, v, step)
        self.writer.set_fmtargs(fmtargs)
        self.writer.flush()

    def on_epoch_start(self, log, ctx, stage, epoch):
        self._set_fmtargs(ctx, stage, epoch)

    def on_epoch(self, log, ctx, stage, epoch):
        for val in self.val_epoch:
            val.run(log, ctx, self.writer, self.checkpoints, stage, epoch)
        self.writer.flush()

    def on_stage_start(self, log, ctx, stage):
        self._set_fmtargs(ctx, stage)

    def on_stage(self, log, ctx, stage):
        for val in self.val_stage:
            val.run(log, ctx, self.writer, self.checkpoints, stage, None)
        self.writer.flush()

    def close(self):
        self.flush()
        self.writer.close()


def write_images(writer, pfx, i, img1, img2, target, estimate, valid, meta,
                 step):
    """Un-pad, color-code and write one sample's images (NHWC host
    tensors or arrays): both frames, the ground truth and the estimate on
    one motion scale."""
    (h0, h1), (w0, w1) = meta[i].original_extents

    i1 = (np.asarray(img1[i]) + 1.0) / 2.0
    i2 = (np.asarray(img2[i]) + 1.0) / 2.0
    ft = np.asarray(target[i])
    fe = np.asarray(estimate[i])
    mask = np.asarray(valid[i], bool)

    i1, i2 = i1[h0:h1, w0:w1], i2[h0:h1, w0:w1]
    ft, fe = ft[h0:h1, w0:w1], fe[h0:h1, w0:w1]
    mask = mask[h0:h1, w0:w1]

    # shared motion scale across estimate and ground truth; invalid or
    # non-finite pixels must not inflate or NaN the scale
    def motion_max(f, m=None):
        norm = np.linalg.norm(f, axis=-1)
        if m is not None:
            norm = norm[m]
        norm = norm[np.isfinite(norm)]
        return float(norm.max()) if norm.size else 0.0

    mrm = max(motion_max(ft, mask), motion_max(fe), 1e-5)

    ft = visual.flow_to_rgba(ft, mrm=mrm, mask=mask)
    fe = visual.flow_to_rgba(fe, mrm=mrm)

    writer.add_image(f"{pfx}img1", i1, step, dataformats="HWC")
    writer.add_image(f"{pfx}img2", i2, step, dataformats="HWC")
    writer.add_image(f"{pfx}flow-gt", ft, step, dataformats="HWC")
    writer.add_image(f"{pfx}flow-est", fe, step, dataformats="HWC")
