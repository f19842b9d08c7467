"""Model framework core: Model/Loss wrappers, adapters, results.

Counterpart of ``raft_meets_dicl_tpu/models/model.py``. Where the JAX
wrapper is a pure function over an explicit variables pytree, a model
here owns its ``nn.Module`` (parameters and buffers live in it): ``init``
fills it from an explicit ``torch.Generator`` and places it on a device,
``apply`` runs it. The config-facing surface is the same: every
Model/Loss is built ``from_config`` and round-trips ``get_config``, and
per-call arguments merge over the config defaults at call time.
"""

import torch


class Result:
    """Wraps a model's raw forward output behind a uniform interface.

    ``output()`` is what the loss consumes (model-specific structure),
    ``final()`` is the finest full-resolution flow estimate,
    ``intermediate_flow()`` exposes per-level/iteration flows for inspection.
    """

    def output(self, batch_index=None):
        raise NotImplementedError

    def final(self):
        raise NotImplementedError

    def intermediate_flow(self):
        raise NotImplementedError


class ModelAdapter:
    """Decouples the trainer/evaluator from model-specific output shapes.

    Also relays stage/epoch lifecycle events to the model with config-bound
    default arguments merged in.
    """

    def __init__(self, model):
        self.model = model

    def wrap_result(self, result, original_shape) -> Result:
        raise NotImplementedError

    def on_stage(self, stage, **kwargs):
        self.model.on_stage(stage, **(self.model.on_stage_arguments | kwargs))

    def on_epoch(self, stage, epoch, **kwargs):
        self.model.on_epoch(stage, epoch,
                            **(self.model.on_epoch_arguments | kwargs))


class Model:
    """Config-constructible wrapper that owns an ``nn.Module``.

    Holds the module, default forward arguments (merged with per-call
    overrides in ``apply``), and the lifecycle-event argument sets of the
    config (relayed to ``on_stage``/``on_epoch`` by the adapter).
    """

    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(f"invalid model type '{cfg['type']}', expected '{cls.type}'")

    def __init__(self, module, arguments, on_epoch_arguments={}, on_stage_arguments={}):
        self.module = module
        self.arguments = dict(arguments)
        self.on_epoch_arguments = dict(on_epoch_arguments)
        self.on_stage_arguments = dict(on_stage_arguments)
        self.frozen_batchnorm = False

    def get_config(self):
        raise NotImplementedError

    def get_adapter(self) -> ModelAdapter:
        raise NotImplementedError

    def init(self, generator=None, device="cuda"):
        """Fill the module's parameters from ``generator`` (a seeded
        ``torch.Generator`` on the CPU, so the same seed gives the same
        weights on every device), move it to ``device`` in eval mode, and
        return it."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.module.reset_parameters(generator)
        return self.module.to(device).eval()

    def apply(self, img1, img2, train=False, **kwargs):
        """Run the forward pass with the config-default arguments merged
        under ``kwargs`` (JAX ``Model.apply`` contract).

        ``train`` drives dropout and batch-norm batch statistics; the
        stage's ``freeze_batchnorm`` (``on_stage``) keeps batch norm on its
        running statistics. Either way the raw output is returned: where
        the JAX wrapper hands back the updated ``batch_stats``, here they
        live in the module's buffers, updated in place.
        """
        args = self.arguments | kwargs
        return self.module(img1, img2, train=train,
                           frozen_bn=self.frozen_batchnorm, **args)

    def on_stage(self, stage, **kwargs):
        """Default stage hook: ``freeze_batchnorm`` as an apply-time switch
        (the JAX ``Model.on_stage``)."""
        self.frozen_batchnorm = bool(kwargs.get("freeze_batchnorm", False))

    def on_epoch(self, stage, epoch, **kwargs):
        pass

    def __call__(self, img1, img2, train=False, **kwargs):
        return self.apply(img1, img2, train=train, **kwargs)


class Loss:
    """Config-constructible loss with default-argument merging.

    ``compute`` is a function of (result-output, target, valid); the
    ``model`` argument carries the wrapper for losses that regularize
    parameters.
    """

    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(f"invalid loss type '{cfg['type']}', expected '{cls.type}'")

    def __init__(self, arguments):
        self.arguments = dict(arguments)

    def get_config(self):
        raise NotImplementedError

    def compute(self, model, result, target, valid, **kwargs):
        raise NotImplementedError

    def __call__(self, model, result, target, valid, **kwargs):
        return self.compute(model, result, target, valid, **(self.arguments | kwargs))
