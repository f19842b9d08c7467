"""Anomaly detection: non-finite or absurdly large activations or gradients
(counterpart of ``raft_meets_dicl_tpu/inspect/hooks/anomaly.py``).

On a trigger a warning names the offending tensor and, with
``save-checkpoint``, a debug checkpoint of the live state is written to
the run directory (the port's ``RMDP1`` format, JAX's file names): at
most one a step, the oldest deleted beyond ``max-checkpoints``. The
activation detector reads the inspector's auxiliary forward; the gradient
detector reads the train step's gradients every step, as one device
reduction over all of them (each tensor's largest magnitude) and one
fetch, where JAX copies every gradient to the host.
"""

import numpy as np
import torch

from .common import Hook

_DEFAULT_CHKPT_ACTIVATION = "anomaly_in_activation-b{n_step}.ckpt"
_DEFAULT_CHKPT_GRADIENT = "anomaly_in_gradient-b{n_step}.ckpt"


def _peak(x):
    """Largest magnitude, as float64 (NaN if any element is NaN)."""
    return x.detach().abs().max().double()


class _AnomalyDetector(Hook):
    def __init__(self, large, checkpoint, checkpoint_fmt, checkpoint_max):
        super().__init__("training")
        self.large = float(large)
        self.checkpoint = bool(checkpoint)
        self.checkpoint_fmt = checkpoint_fmt
        self.checkpoint_max = int(checkpoint_max)
        self.writer = None
        self._chkpts = []
        self._dumped_step = None

    def get_config(self):
        return {
            "type": self.type,
            "large": self.large,
            "checkpoint": self.checkpoint,
            "checkpoint-fmt": self.checkpoint_fmt,
            "checkpoint-max": self.checkpoint_max,
        }

    def register(self, ctx, writer):
        self.writer = writer
        return super().register(ctx, writer)

    def _check(self, log, ctx, kind, named):
        """``named``: ``[(name, shape, peak)]`` with each tensor's largest
        magnitude."""
        for name, shape, peak in named:
            peak = float(np.asarray(peak).reshape(-1)[0])
            reason = None
            if not np.isfinite(peak):
                reason = "non-finite"
            elif peak > self.large:
                reason = "large"

            if reason is not None:
                log.warning(
                    f"{kind} anomaly detected: {reason} value detected in "
                    f"'{name}', shape {tuple(shape)}"
                )
                self._dump_chkpt(log, ctx)

    def _dump_chkpt(self, log, ctx):
        # at most one dump per training step, rolling retention
        if not self.checkpoint or self._dumped_step == ctx.step:
            return

        path = ctx.path / self.writer.fmt(self.checkpoint_fmt)
        log.info(f"saving checkpoint to {path}")
        epoch = ctx.current_epoch if ctx.current_epoch is not None else 0
        ctx.snapshot_checkpoint(ctx.current_stage, epoch).save(path)

        self._chkpts.append(path)
        self._dumped_step = ctx.step

        while len(self._chkpts) > self.checkpoint_max:
            self._chkpts.pop(0).unlink(missing_ok=True)


class ActivationAnomalyDetector(_AnomalyDetector):
    type = "anomalydetect-activation"
    needs_intermediates = True

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(
            cfg.get("large", 1.0e10),
            cfg.get("save-checkpoint", False),
            cfg.get("checkpoint-fmt", _DEFAULT_CHKPT_ACTIVATION),
            cfg.get("max-checkpoints", 10),
            int(cfg.get("frequency", 1)),
        )

    def __init__(self, large=1.0e10, checkpoint=False,
                 checkpoint_fmt=_DEFAULT_CHKPT_ACTIVATION, checkpoint_max=10,
                 frequency=1):
        super().__init__(large, checkpoint, checkpoint_fmt, checkpoint_max)
        self.frequency = frequency

    def get_config(self):
        return super().get_config() | {"frequency": self.frequency}

    def reduce(self, x):
        return _peak(x).reshape(1)

    def on_intermediates(self, log, ctx, named):
        self._check(log, ctx, "activation", named)


class GradientAnomalyDetector(_AnomalyDetector):
    type = "anomalydetect-gradient"
    needs_grads = True

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(
            cfg.get("large", 1.0e10),
            cfg.get("save-checkpoint", False),
            cfg.get("checkpoint-fmt", _DEFAULT_CHKPT_GRADIENT),
            cfg.get("max-checkpoints", 10),
        )

    def __init__(self, large=1.0e10, checkpoint=False,
                 checkpoint_fmt=_DEFAULT_CHKPT_GRADIENT, checkpoint_max=10):
        super().__init__(large, checkpoint, checkpoint_fmt, checkpoint_max)

    def on_grads(self, log, ctx, grads):
        names = list(grads)
        if not names:
            return
        tensors = [grads[n].detach() for n in names]
        peaks = torch.stack(torch._foreach_max(torch._foreach_abs(tensors)))
        peaks = peaks.double().cpu().numpy()
        self._check(log, ctx, "gradient",
                    [(n, tuple(t.shape), p)
                     for n, t, p in zip(names, tensors, peaks)])
