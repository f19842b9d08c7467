"""Training strategy specification: stages, optimizers, schedulers, gradients.

Counterpart of ``raft_meets_dicl_tpu/strategy/spec.py``, with the same YAML
surface (``adam``/``adam-w``/``sgd`` with torch-style parameter names,
``one-cycle``/``multi-step`` schedulers with expression-evaluated
parameters, gradient accumulate/clip/scaler), built on ``torch.optim``:

- the JAX ``adam-w`` chain (``scale_by_adam → add_decayed_weights``, then
  ``× −lr``) is ``torch.optim.AdamW``; ``adam`` with a weight decay (L2
  folded into the gradient before the moments) is ``torch.optim.Adam``;
  ``sgd`` (decay, then ``optax.trace``) is ``torch.optim.SGD``;
- gradient clipping runs before the optimizer, as the first link of the
  JAX chain, and follows optax exactly: ``clip_by_global_norm`` scales by
  ``max/‖g‖`` only when ``‖g‖ ≥ max`` (``clip_grad_norm_`` would divide by
  ``‖g‖ + 1e-6``), other norm orders and value clipping as the JAX
  transforms;
- learning-rate schedulers are the JAX package's host-side objects,
  ported as they stand (``torch.optim.lr_scheduler.OneCycleLR`` counts
  its steps differently); the trainer writes the current rate into the
  optimizer before every update;
- a stage's ``gradient.accumulate: k`` is the JAX ``optax.MultiSteps``
  wrapper: each update call adds its gradient to a running mean (MultiSteps'
  Welford form, ``acc += (g - acc) / (n + 1)``, not a sum over k, so the
  rounding is JAX's), and every k-th call clips the mean and applies the
  optimizer to it; the calls between change no parameter. The count of
  calls lives on the host, the mean on the device; both go into the
  optimizer's checkpoint entry (``GradientTransform.state_dict``);
- the AMP ``GradScaler`` spec is kept for config parity and does
  nothing: the bf16 policy needs no loss scaling.
"""

from typing import List

import numpy as np
import torch

from .. import data, utils
from ..parallel.train import global_norm


class DataSpec:
    @classmethod
    def from_config(cls, path, cfg):
        return cls(
            source=data.load(path, cfg["source"]),
            epochs=int(cfg.get("epochs", 1)),
            batch_size=int(cfg.get("batch-size", 1)),
            drop_last=bool(cfg.get("drop-last", True)),
            shuffle=bool(cfg.get("shuffle", True)),
        )

    def __init__(self, source, epochs, batch_size, drop_last=True, shuffle=True):
        self.source = source
        self.epochs = epochs
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle

    def get_config(self):
        return {
            "source": self.source.get_config(),
            "epochs": self.epochs,
            "batch-size": self.batch_size,
            "drop-last": self.drop_last,
            "shuffle": self.shuffle,
        }


class ValidationSpec:
    @classmethod
    def from_config(cls, path, cfg):
        if cfg is None:
            return None

        return cls(
            name=cfg.get("name", "default"),
            source=data.load(path, cfg["source"]),
            batch_size=int(cfg.get("batch-size", 1)),
            images=set(cfg.get("images", {})),
        )

    def __init__(self, name, source, batch_size, images):
        self.name = name
        self.source = source
        self.batch_size = batch_size
        self.images = images

    def get_config(self):
        return {
            "name": self.name,
            "source": self.source.get_config(),
            "batch-size": self.batch_size,
            "images": list(self.images),
        }


class OptimizerSpec:
    """torch-style optimizer config → ``torch.optim`` optimizer.

    Parameter names are the torch ones (lr, betas, eps, weight_decay,
    momentum, nesterov), so the configs work verbatim; unknown ones raise.
    """

    def __init__(self, type, parameters={}):
        self.type = type
        self.parameters = dict(parameters)

    @classmethod
    def from_config(cls, cfg):
        return cls(cfg["type"], cfg.get("parameters", {}))

    def get_config(self):
        return {"type": self.type, "parameters": self.parameters}

    def build_optimizer(self, params, capturable=False):
        """The core optimizer over ``params``. Returns ``(optimizer,
        base_lr)``; the trainer overwrites the rate before every update,
        so host-side schedulers drive it. ``capturable`` keeps Adam's step
        count on the parameters' device (the skip guard restores it there
        without a host sync; ``parallel.train``)."""
        p = dict(self.parameters)
        lr = float(p.pop("lr", 1e-3))
        extra = {"capturable": True} if capturable else {}

        if self.type == "adam":
            b1, b2 = p.pop("betas", (0.9, 0.999))
            opt = torch.optim.Adam(
                params, lr=lr, betas=(float(b1), float(b2)),
                eps=float(p.pop("eps", 1e-8)),
                weight_decay=float(p.pop("weight_decay", 0.0)), **extra)

        elif self.type == "adam-w":
            b1, b2 = p.pop("betas", (0.9, 0.999))
            opt = torch.optim.AdamW(
                params, lr=lr, betas=(float(b1), float(b2)),
                eps=float(p.pop("eps", 1e-8)),
                weight_decay=float(p.pop("weight_decay", 1e-2)), **extra)

        elif self.type == "sgd":
            opt = torch.optim.SGD(
                params, lr=lr, momentum=float(p.pop("momentum", 0.0)),
                weight_decay=float(p.pop("weight_decay", 0.0)),
                nesterov=bool(p.pop("nesterov", False)))

        else:
            raise ValueError(f"unknown optimizer type '{self.type}'")

        if p:
            raise ValueError(f"unsupported optimizer parameters: {sorted(p)}")

        return opt, lr

    def build(self, params, gradient=None, capturable=False):
        """Full per-stage update: clip → optimizer core (→ MultiSteps).

        Returns ``(tx, base_lr)``; ``gradient`` is the stage GradientSpec.
        """
        params = list(params)
        opt, lr = self.build_optimizer(params, capturable)
        clip = gradient.clip if gradient is not None else None
        accumulate = gradient.accumulate if gradient is not None else 1
        return GradientTransform(params, opt, clip, accumulate), lr


class GradientTransform:
    """Clip, then the optimizer: the port's form of the JAX optax chain,
    with ``accumulate > 1`` wrapped as ``optax.MultiSteps``.

    ``update(lr)`` reads the parameters' ``.grad`` (a missing gradient
    counts as zeros, as JAX's gradient tree has every leaf). Without
    accumulation it clips them in place and applies the optimizer at
    ``lr``. With it, the gradient goes into the running mean, and every
    ``accumulate``-th call writes the mean into ``.grad``, clips and
    applies it, and zeroes the mean. Nothing is read back to the host.

    Under the skip guard (``parallel.make_train_step(nonfinite='skip')``,
    whose :meth:`snapshot` moves it there) the count of the group lives on
    the device, beside the running mean, so that a skipped call puts both
    back, as JAX's ``where`` puts back ``MultiSteps``' ``mini_step``. The
    host cannot then know which call closes a group: each call applies
    the clipped mean to the parameters and the optimizer state, and keeps
    the result only on the group's last call (optax's MultiSteps computes
    both branches and selects, too). ``proposed`` is each parameter's
    change before that selection, what the guard checks.
    """

    def __init__(self, params, optimizer, clip=None, accumulate=1):
        self.params = params
        self.optimizer = optimizer
        self.clip = clip
        self.accumulate = int(accumulate)
        self.reset_accumulation()

    def reset_accumulation(self):
        """No partial mean: the next call starts a new group of k."""
        self.mini_step = 0
        self.acc = None

    def grads(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def update(self, lr):
        """Returns whether the parameters were updated (False on the calls
        that only accumulate; with the count on the device, a 0-d bool
        tensor)."""
        grads = self.grads()
        if self.accumulate > 1 and torch.is_tensor(self.mini_step):
            return self._update_on_device(grads, lr)
        if self.accumulate > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            # optax.MultiSteps' running mean: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step += 1
            if self.mini_step < self.accumulate:
                return False
            torch._foreach_copy_(grads, self.acc)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0

        self._step(grads, lr)
        return True

    def _step(self, grads, lr):
        if self.clip is not None:
            self.clip.apply(grads)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def _update_on_device(self, grads, lr):
        """The MultiSteps call with the group's count a device tensor: the
        running mean, then the clipped mean applied and kept only where
        the count closes the group; the mean and the count go to zero
        there and move on elsewhere."""
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        count = self.mini_step
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, (count + 1).to(grads[0].dtype))
        torch._foreach_add_(self.acc, delta)
        emit = count == self.accumulate - 1

        before = self.snapshot()
        torch._foreach_copy_(grads, self.acc)
        self._step(grads, lr)
        self.proposed = torch._foreach_sub(
            [p.detach() for p in self.params],
            [before[("param", i)] for i in range(len(self.params))])
        # the parameters, the optimizer state, the mean and the count as
        # they were where the group goes on
        self.restore(emit, before)
        for a in self.acc:
            torch.where(emit, torch.zeros_like(a), a, out=a)
        self.mini_step = torch.where(emit, torch.zeros_like(count), count + 1)
        return emit

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def reset(self):
        """A fresh optimizer state and no partial mean (a rollback whose
        checkpoint's optimizer state does not fit)."""
        self.optimizer.state.clear()
        self.reset_accumulation()

    # -- the skip guard's copy of the state (parallel.train) -------------

    def _state_tensors(self):
        """``(slot, tensor)`` of every tensor an update changes: the
        parameters, each one's optimizer state, the running mean."""
        out = [(("param", i), p.detach()) for i, p in enumerate(self.params)]
        for i, p in enumerate(self.params):
            for key, value in self.optimizer.state.get(p, {}).items():
                if torch.is_tensor(value):
                    out.append((("state", i, key), value))
        for i, a in enumerate(self.acc or ()):
            out.append((("acc", i), a))
        if torch.is_tensor(self.mini_step):
            out.append((("mini_step",), self.mini_step))
        return out

    def snapshot(self):
        """Copies of everything an update changes (see :meth:`restore`).
        With accumulation the group's count moves to the device first, to
        be restored with the rest."""
        if self.accumulate > 1 and self.params \
                and not torch.is_tensor(self.mini_step):
            self.mini_step = torch.tensor(self.mini_step,
                                          device=self.params[0].device)
        slots = self._state_tensors()
        copies = [torch.empty_like(t) for _, t in slots]
        if copies:
            torch._foreach_copy_(copies, [t for _, t in slots])
        return {slot: c for (slot, _), c in zip(slots, copies)}

    @torch.no_grad()
    def restore(self, keep, snapshot):
        """Where ``keep`` (a 0-d bool tensor on the device) is false, put
        the :meth:`snapshot` back, bit for bit, without a host sync. State
        the update created (the optimizer's first step) goes back to zeros,
        the state the optimizer would create: Adam's zero moments and step
        0, SGD's momentum, whose first update from zeros is the gradient.
        The count of accumulated calls is restored with the mean (it is
        on the device once :meth:`snapshot` ran)."""
        for slot, t in self._state_tensors():
            old = snapshot.get(slot)
            if old is None:
                old = torch.zeros_like(t)
            torch.where(keep, t, old, out=t)

    # -- checkpoints -------------------------------------------------------

    def state_dict(self):
        """The optimizer's ``state_dict()``; with accumulation also
        ``accumulate``: the count of calls in the current group and the
        running mean, by parameter index."""
        state = self.optimizer.state_dict()
        if self.accumulate > 1:
            state["accumulate"] = {
                "mini_step": int(self.mini_step),
                "acc": {i: a for i, a in enumerate(self.acc or ())},
            }
        return state

    def load_state_dict(self, state):
        state = dict(state)
        accum = state.pop("accumulate", None)
        self.optimizer.load_state_dict(state)
        self.reset_accumulation()
        if accum is None or not int(accum["mini_step"]):
            return
        if self.accumulate <= 1:
            raise ValueError(
                "the checkpoint holds a partial gradient accumulation, and "
                "this stage does not accumulate")
        self.mini_step = int(accum["mini_step"])
        self.acc = [accum["acc"][i].to(p.device, p.dtype)
                    for i, p in enumerate(self.params)]


class ClipGradient:
    type = None

    @classmethod
    def from_config(cls, cfg):
        if cfg is None:
            return None

        types = {c.type: c for c in (ClipGradientNorm, ClipGradientValue)}
        return types[cfg["type"]]._from_config(cfg)

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid gradient clip type '{cfg['type']}', expected '{cls.type}'"
            )

    def get_config(self):
        raise NotImplementedError

    def apply(self, grads):
        """Clip ``grads`` (a list of tensors) in place."""
        raise NotImplementedError


class ClipGradientNorm(ClipGradient):
    """Clip by global gradient norm (any ord)."""

    type = "norm"

    @classmethod
    def _from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg["value"], float(cfg.get("ord", 2)))

    def __init__(self, value, ord=2.0):
        self.value = value
        self.ord = ord

    def get_config(self):
        ord_ = self.ord if self.ord not in (np.inf, -np.inf) else str(self.ord)
        return {"type": self.type, "value": self.value, "ord": ord_}

    @torch.no_grad()
    def apply(self, grads):
        value = float(self.value)
        if self.ord == 2.0:
            # optax.clip_by_global_norm: g / ‖g‖ * max unless ‖g‖ < max
            norm = global_norm(grads)
            keep = norm < value
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * value))
            return

        flat = torch.cat([g.abs().reshape(-1) for g in grads])
        norm = torch.linalg.vector_norm(flat, ord=self.ord)
        scale = torch.clamp(value / torch.clamp(norm, min=1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)


class ClipGradientValue(ClipGradient):
    type = "value"

    @classmethod
    def _from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(float(cfg["value"]))

    def __init__(self, value):
        self.value = value

    def get_config(self):
        return {"type": self.type, "value": self.value}

    @torch.no_grad()
    def apply(self, grads):
        for g in grads:
            g.clamp_(-self.value, self.value)


class GradientScalerSpec:
    """AMP GradScaler config, kept for parity; a no-op (bf16 policy)."""

    @classmethod
    def from_config(cls, cfg):
        if cfg is None:
            return cls(enabled=False)

        return cls(
            enabled=bool(cfg.get("enabled", True)),
            init_scale=float(cfg.get("init-scale", 65536.0)),
            growth_factor=float(cfg.get("growth-factor", 2.0)),
            backoff_factor=float(cfg.get("backoff-factor", 0.5)),
            growth_interval=int(cfg.get("growth-interval", 2000)),
        )

    def __init__(self, enabled=False, init_scale=65536.0, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=2000):
        self.enabled = enabled
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval

    def get_config(self):
        return {
            "enabled": self.enabled,
            "init-scale": self.init_scale,
            "growth-factor": self.growth_factor,
            "backoff-factor": self.backoff_factor,
            "growth-interval": self.growth_interval,
        }

    def build(self):
        """The scaler slot of a checkpoint, as the JAX package stores it;
        no loss scaling happens."""
        return {"enabled": self.enabled, "scale": self.init_scale}


class GradientSpec:
    @classmethod
    def from_config(cls, cfg):
        return cls(
            accumulate=int(cfg.get("accumulate", 1)),
            clip=ClipGradient.from_config(cfg.get("clip")),
            scaler=GradientScalerSpec.from_config(cfg.get("scaler")),
        )

    def __init__(self, accumulate=1, clip=None, scaler=None):
        if accumulate < 1:
            raise ValueError(f"invalid value for GradientSpec.accumulate: {accumulate}")

        self.accumulate = accumulate
        self.clip = clip
        self.scaler = scaler if scaler is not None else GradientScalerSpec()

    def get_config(self):
        return {
            "accumulate": self.accumulate,
            "clip": self.clip.get_config() if self.clip is not None else None,
            "scaler": self.scaler.get_config(),
        }


# -- learning-rate schedulers ----------------------------------------------


class LrScheduler:
    """Host-side stateful scheduler with torch-like step semantics.

    ``lr()`` returns the rate for the *next* optimizer update; ``step()``
    advances. State round-trips via ``state_dict``/``load_state_dict`` for
    checkpointing (``{"last_step"}``, as in the JAX package).
    """

    def __init__(self, base_lr):
        self.base_lr = base_lr
        self.last_step = 0

    def lr(self):
        raise NotImplementedError

    def step(self):
        self.last_step += 1

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, state):
        self.last_step = int(state["last_step"])


class OneCycleLr(LrScheduler):
    """torch OneCycleLR: warmup to max_lr, anneal to max_lr/div/final_div."""

    def __init__(self, base_lr, max_lr, total_steps, pct_start=0.3,
                 anneal_strategy="cos", div_factor=25.0, final_div_factor=1e4,
                 cycle_momentum=True, base_momentum=0.85, max_momentum=0.95,
                 three_phase=False):
        super().__init__(base_lr)

        if three_phase:
            raise NotImplementedError("three_phase one-cycle is not supported")

        self.max_lr = float(max_lr)
        self.total_steps = int(total_steps)
        self.pct_start = float(pct_start)
        self.anneal_strategy = anneal_strategy
        self.div_factor = float(div_factor)
        self.final_div_factor = float(final_div_factor)
        # momentum cycling is accepted for config parity but not applied
        self.cycle_momentum = cycle_momentum

        self.initial_lr = self.max_lr / self.div_factor
        self.min_lr = self.initial_lr / self.final_div_factor

    def _anneal(self, start, end, pct):
        if self.anneal_strategy == "linear":
            return start + (end - start) * pct
        # 'cos'
        return end + (start - end) / 2.0 * (1.0 + np.cos(np.pi * pct))

    def lr(self):
        up_steps = float(self.pct_start * self.total_steps) - 1.0
        down_steps = float(self.total_steps - up_steps) - 1.0

        step = min(self.last_step, self.total_steps - 1)
        if step <= up_steps:
            return self._anneal(self.initial_lr, self.max_lr, step / max(up_steps, 1))
        return self._anneal(
            self.max_lr, self.min_lr, (step - up_steps) / max(down_steps, 1)
        )


class MultiStepLr(LrScheduler):
    """torch MultiStepLR: multiply by gamma at each milestone."""

    def __init__(self, base_lr, milestones, gamma=0.1):
        super().__init__(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def lr(self):
        passed = sum(1 for m in self.milestones if m <= self.last_step)
        return self.base_lr * self.gamma**passed


class SchedulerSpec:
    """Typed scheduler config with expression-evaluated parameters.

    Expressions may reference ``n_samples``, ``n_batches``, ``n_epochs``,
    ``n_accum``, ``batch_size``.
    """

    _TYPES = {"one-cycle": OneCycleLr, "multi-step": MultiStepLr}

    @classmethod
    def from_config(cls, cfg):
        return cls(cfg["type"], cfg.get("parameters", {}))

    def __init__(self, type, parameters={}):
        if type not in self._TYPES:
            raise ValueError(f"unknown scheduler type '{type}'")
        self.type = type
        self.parameters = dict(parameters)

    def get_config(self):
        return {"type": self.type, "parameters": self.parameters}

    def _eval_param(self, value, vars):
        if isinstance(value, dict):
            return {k: self._eval_param(v, vars) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            return [self._eval_param(v, vars) for v in value]
        if not isinstance(value, str):
            return value
        try:
            return utils.expr.eval_math_expr(value, vars)
        except (TypeError, ValueError, KeyError, IndexError):
            # not an expression (e.g. 'linear', 'cos') — pass through
            return value

    def build(self, base_lr, variables):
        params = {k: self._eval_param(v, variables) for k, v in self.parameters.items()}

        if self.type == "one-cycle":
            max_lr = params.pop("max_lr", base_lr)
            return OneCycleLr(base_lr, max_lr, **params)
        return MultiStepLr(base_lr, **params)


class MultiSchedulerSpec:
    """Instance-level (per optimizer update) + epoch-level scheduler lists."""

    @classmethod
    def from_config(cls, cfg):
        return cls(
            instance=[SchedulerSpec.from_config(c) for c in cfg.get("instance", [])],
            epoch=[SchedulerSpec.from_config(c) for c in cfg.get("epoch", [])],
        )

    def __init__(self, instance=[], epoch=[]):
        self.instance = list(instance)
        self.epoch = list(epoch)

    def get_config(self):
        return {
            "instance": [s.get_config() for s in self.instance],
            "epoch": [s.get_config() for s in self.epoch],
        }

    def build(self, base_lr, variables):
        return (
            [s.build(base_lr, variables) for s in self.instance],
            [s.build(base_lr, variables) for s in self.epoch],
        )


# -- stage / strategy -------------------------------------------------------


class Stage:
    @classmethod
    def from_config(cls, path, cfg):
        valid = cfg.get("validation", [])
        if isinstance(valid, dict):
            valid = [valid]

        return cls(
            name=cfg["name"],
            id=cfg["id"],
            data=DataSpec.from_config(path, cfg["data"]),
            validation=[ValidationSpec.from_config(path, v) for v in valid],
            optimizer=OptimizerSpec.from_config(cfg["optimizer"]),
            model_args=cfg.get("model", {}).get("arguments", {}),
            model_on_epoch_args=cfg.get("model", {}).get("on-epoch", {}),
            model_on_stage_args=cfg.get("model", {}).get("on-stage", {}),
            loss_args=cfg.get("loss", {}).get("arguments", {}),
            gradient=GradientSpec.from_config(cfg.get("gradient", {})),
            scheduler=MultiSchedulerSpec.from_config(cfg.get("lr-scheduler", {})),
            loader_args=cfg.get("loader", {}),
        )

    def __init__(self, name, id, data, validation, optimizer, model_args={},
                 model_on_epoch_args={}, model_on_stage_args={}, loss_args={},
                 gradient=None, scheduler=None, loader_args={}):
        self.name = name
        self.id = id
        self.data = data
        self.validation = validation
        self.optimizer = optimizer
        self.model_args = dict(model_args)
        self.model_on_epoch_args = dict(model_on_epoch_args)
        self.model_on_stage_args = dict(model_on_stage_args)
        self.loss_args = dict(loss_args)
        self.gradient = gradient if gradient is not None else GradientSpec()
        self.scheduler = scheduler if scheduler is not None else MultiSchedulerSpec()
        self.loader_args = dict(loader_args)
        self.index = 0  # set by the training loop

    def get_config(self):
        return {
            "name": self.name,
            "id": self.id,
            "data": self.data.get_config(),
            "validation": [v.get_config() for v in self.validation],
            "optimizer": self.optimizer.get_config(),
            "model": {
                "arguments": self.model_args,
                "on-epoch": self.model_on_epoch_args,
                "on-stage": self.model_on_stage_args,
            },
            "loss": {"arguments": self.loss_args},
            "gradient": self.gradient.get_config(),
            "lr-scheduler": self.scheduler.get_config(),
            "loader": self.loader_args,
        }


class Strategy:
    """mode ``best`` restores the best checkpoint of the previous stage at
    each stage start; ``continuous`` keeps training the live weights."""

    mode: str
    stages: List[Stage]

    @classmethod
    def from_config(cls, path, cfg):
        from . import config as strategy_config

        mode = cfg.get("mode", "best")
        if mode not in ("best", "continuous"):
            raise ValueError("invalid value for mode, expected one of ['best', 'continuous']")

        stages = [strategy_config.load_stage(path, c) for c in cfg["stages"]]
        return cls(mode, stages)

    def __init__(self, mode, stages):
        self.mode = mode
        self.stages = stages

    def get_config(self):
        return {"mode": self.mode, "stages": [s.get_config() for s in self.stages]}
