"""Per-module activation statistics (mean/var) to TensorBoard
(counterpart of ``raft_meets_dicl_tpu/inspect/hooks/activation.py``).

The activations come from the inspector's auxiliary forward at
``frequency``; each is reduced to its mean and (biased) variance on the
device, in float64, as it is produced. Tags are JAX's:
``{prefix}{module}.{i}/mean`` and ``/var``, ``i`` counting the captured
activations at or below the module in JAX's order.
"""

from typing import List

import torch

from .common import Hook, matches


class ActivationStats(Hook):
    type = "activation-stats"
    needs_intermediates = True

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(
            cfg["modules"],
            cfg.get("prefix", "Train:S{n_stage}:{id_stage}/ActivationStats/"),
            int(cfg.get("frequency", 100)),
        )

    def __init__(self, modules: List[str],
                 prefix: str = "Train:S{n_stage}:{id_stage}/ActivationStats/",
                 frequency: int = 100):
        super().__init__("training")
        self.modules = list(modules)
        self.prefix = prefix
        self.frequency = frequency
        self.writer = None

    def get_config(self):
        return {
            "type": self.type,
            "prefix": self.prefix,
            "modules": self.modules,
            "frequency": self.frequency,
        }

    def register(self, ctx, writer):
        self.writer = writer
        return super().register(ctx, writer)

    def wants(self, name):
        # a named module, anything below it, or a module whose outputs
        # the name enumerates (``FeatureEncoderS3_0.1``)
        return any(matches(name, t) or t.startswith(name + ".")
                   for t in self.modules)

    def reduce(self, x):
        var, mean = torch.var_mean(x.detach().double(), correction=0)
        return torch.stack([mean, var])

    def on_intermediates(self, log, ctx, named):
        for target in self.modules:
            found = [v for n, _, v in named if matches(n, target)]
            for i, (mean, var) in enumerate(found):
                self.writer.add_scalar(
                    f"{self.prefix}{target}.{i}/mean", float(mean), ctx.step)
                self.writer.add_scalar(
                    f"{self.prefix}{target}.{i}/var", float(var), ctx.step)
