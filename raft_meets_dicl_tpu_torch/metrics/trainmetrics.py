"""Training-state metrics: loss, learning rate, gradient and parameter
statistics (counterpart of ``raft_meets_dicl_tpu/metrics/trainmetrics.py``).

Parameters and gradients arrive in the ``MetricContext`` as mappings of
the module's parameter names (``fnet.conv1.weight``; the JAX package
names flax paths) to tensors. The selection ('total' | 'all' | [names] |
{group: [prefixes]}) is the JAX package's; group statistics are computed
on the device like the per-tensor ones.
"""

from typing import List, Union

import torch

from . import functional as F
from .common import Metric


class Loss(Metric):
    type = "loss"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "Loss"))

    def __init__(self, key: str = "Loss"):
        self.key = key

    def get_config(self):
        return {"type": self.type, "key": self.key}

    def compute(self, ctx, estimate, target, valid, loss):
        return {self.key: loss}


class LearningRate(Metric):
    type = "learning-rate"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "LearningRate"))

    def __init__(self, key: str = "LearningRate"):
        self.key = key

    def get_config(self):
        return {"type": self.type, "key": self.key}

    def compute(self, ctx, estimate, target, valid, loss):
        return {self.key: float(ctx.lr) if ctx.lr is not None
                else float("nan")}

    def reduce(self, values):
        return {k: vs[-1] for k, vs in values.items()}


def _normalize_params(params):
    if not isinstance(params, (list, dict)) and params != "all":
        return [params]
    return params


class _TreeMetric(Metric):
    """Shared parameter-selection logic over a named-stat dict."""

    def __init__(self, key, params):
        self.key = key
        self.params = _normalize_params(params)

    def get_config(self):
        return {"type": self.type, "key": self.key, "parameters": self.params}

    def _select(self, stats, collect):
        """stats: {name: stat}; collect(list-of-stats) aggregates a group."""
        if self.params == "all":
            return dict(stats)
        if isinstance(self.params, dict):
            out = {}
            for group, prefixes in self.params.items():
                if list(prefixes) == ["total"]:
                    out[group] = stats["total"]
                    continue
                sel = [v for k, v in stats.items()
                       if k != "total" and any(k.startswith(p) for p in prefixes)]
                if not sel:
                    raise ValueError(
                        f"metric '{self.type}': parameter group '{group}' "
                        f"(prefixes {prefixes}) matches no parameter; "
                        f"available: {sorted(stats)[:10]}...")
                out[group] = collect(sel)
            return out
        return {name: stats[name] for name in self.params}


class GradientNorm(_TreeMetric):
    type = "grad-norm"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "GradientNorm/"), float(cfg.get("ord", 2)),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "GradientNorm/", ord: float = 2,
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, params)
        self.ord = ord

    def get_config(self):
        return super().get_config() | {"ord": self.ord}

    def _norms(self, named):
        norms = F.tree_norm(named, self.ord)
        sel = self._select(norms, lambda ns: torch.linalg.vector_norm(
            torch.stack(ns), ord=self.ord))
        return {f"{self.key}{k}": v for k, v in sel.items()}

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.grads is None else self._norms(ctx.grads)

    def reduce(self, values):
        return {k: vs[-1] for k, vs in values.items()}


class GradientMean(_TreeMetric):
    type = "grad-mean"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "GradientMean/"),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "GradientMean/",
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, params)

    @staticmethod
    def _collect(stats):
        total = sum(n for n, _ in stats) or 1
        return (total, sum((n / total) * m for n, m in stats))

    def _means(self, named):
        sel = self._select(F.tree_mean(named), self._collect)
        return {f"{self.key}{k}": m for k, (_, m) in sel.items()}

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.grads is None else self._means(ctx.grads)

    def reduce(self, values):
        return {k: vs[-1] for k, vs in values.items()}


class GradientMinMax(_TreeMetric):
    type = "grad-minmax"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "GradientMinMax/"),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "GradientMinMax/",
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, params)

    @staticmethod
    def _collect(stats):
        return (torch.min(torch.stack([lo for lo, _ in stats])),
                torch.max(torch.stack([hi for _, hi in stats])))

    def _minmax(self, named):
        mm = self._select(F.tree_minmax(named), self._collect)
        out = {f"{self.key}{k}/min": lo for k, (lo, _) in mm.items()}
        out |= {f"{self.key}{k}/max": hi for k, (_, hi) in mm.items()}
        return out

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.grads is None else self._minmax(ctx.grads)

    def reduce(self, values):
        return {k: min(vs) if k.endswith("/min") else max(vs)
                for k, vs in values.items()}


class ParameterNorm(GradientNorm):
    type = "param-norm"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "ParameterNorm/"), float(cfg.get("ord", 2)),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "ParameterNorm/", ord: float = 2,
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, ord, params)

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.params is None else self._norms(ctx.params)


class ParameterMean(GradientMean):
    type = "param-mean"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "ParameterMean/"),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "ParameterMean/",
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, params)

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.params is None else self._means(ctx.params)


class ParameterMinMax(GradientMinMax):
    type = "param-minmax"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls(cfg.get("key", "ParameterMinMax/"),
                   cfg.get("parameters", "total"))

    def __init__(self, key: str = "ParameterMinMax/",
                 params: Union[str, List[str]] = "total"):
        super().__init__(key, params)

    def compute(self, ctx, estimate, target, valid, loss):
        return {} if ctx.params is None else self._minmax(ctx.params)
