"""Metric registry base and the collector machinery (counterpart of
``raft_meets_dicl_tpu/metrics/common.py``).

``Metric.compute`` returns ``{key: value}`` where a value is a 0-d tensor
on the inputs' device (or a float); nothing is read back to the host there.
:func:`fetch` turns many such dicts into floats with one device->host
copy, and ``reduce`` works on the fetched floats.
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch


@dataclass
class MetricContext:
    """What train-time metrics may look at besides estimate and target:
    ``params``/``grads`` as mappings of name -> tensor, the current
    learning rate. Evaluation metrics receive an empty context."""

    lr: Optional[float] = None
    params: Any = None
    grads: Any = None


def fetch(dicts):
    """Floats of a list of ``{key: tensor or float}`` dicts, read back in
    one device->host copy (per device)."""
    tensors = [v for d in dicts for v in d.values()
               if isinstance(v, torch.Tensor)]
    host = {}
    by_device = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    for device, ts in by_device.items():
        values = torch.stack([t.detach().float().reshape(()) for t in ts])
        for t, v in zip(ts, values.cpu().tolist()):
            host[id(t)] = v
    return [{k: host[id(v)] if isinstance(v, torch.Tensor) else float(v)
             for k, v in d.items()} for d in dicts]


class Metric:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid metric type '{cfg['type']}', expected '{cls.type}'")

    @classmethod
    def from_config(cls, cfg):
        from . import flowmetrics, trainmetrics

        types = [
            flowmetrics.EndPointError,
            flowmetrics.FlAll,
            flowmetrics.AverageAngularError,
            flowmetrics.FlowMagnitude,
            trainmetrics.Loss,
            trainmetrics.LearningRate,
            trainmetrics.GradientNorm,
            trainmetrics.GradientMean,
            trainmetrics.GradientMinMax,
            trainmetrics.ParameterNorm,
            trainmetrics.ParameterMean,
            trainmetrics.ParameterMinMax,
        ]
        types = {t.type: t for t in types}

        return types[cfg["type"]].from_config(cfg)

    def get_config(self):
        raise NotImplementedError

    def compute(self, ctx, estimate, target, valid, loss):
        """``{key: 0-d tensor or float}``; ``estimate``/``target`` are NHWC
        flow tensors, ``valid`` the matching mask."""
        raise NotImplementedError

    def __call__(self, ctx, estimate, target, valid, loss):
        return self.compute(ctx, estimate, target, valid, loss)

    def reduce(self, values):
        """Reduce fetched per-step value lists ``{key: [floats]}``."""
        return {k: float(np.mean(vs)) for k, vs in values.items()}


class Metrics:
    """Ordered list of metrics evaluated together."""

    @classmethod
    def from_config(cls, cfg):
        return cls([Metric.from_config(c) for c in cfg])

    def __init__(self, metrics: List[Metric]):
        self.metrics = list(metrics)

    def get_config(self):
        return [m.get_config() for m in self.metrics]

    def __call__(self, ctx, estimate, target, valid, loss):
        result = OrderedDict()
        for metric in self.metrics:
            result.update(metric(ctx, estimate, target, valid, loss))
        return result


class Collector:
    type = None

    @classmethod
    def _typecheck(cls, cfg):
        if cfg["type"] != cls.type:
            raise ValueError(
                f"invalid collector type '{cfg['type']}', expected "
                f"'{cls.type}'")

    @classmethod
    def from_config(cls, cfg):
        types = {MeanCollector.type: MeanCollector}
        return types[cfg["type"]].from_config(cfg)

    def collect(self, metrics):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def __call__(self, metrics):
        self.collect(metrics)


class MeanCollector(Collector):
    """Running per-key mean over collected (fetched) metric dicts,
    NaN-skipping."""

    type = "mean"

    @classmethod
    def from_config(cls, cfg):
        cls._typecheck(cfg)
        return cls()

    def __init__(self):
        self.results = OrderedDict()

    def collect(self, metrics):
        for k, v in metrics.items():
            if np.isnan(v):
                continue
            self.results.setdefault(k, []).append(v)

    def result(self):
        return OrderedDict((k, float(np.mean(vs)))
                           for k, vs in self.results.items())


class Collectors:
    @classmethod
    def from_config(cls, cfg):
        return cls([Collector.from_config(c) for c in cfg])

    def __init__(self, collectors: List[Collector]):
        self.collectors = list(collectors)

    def collect(self, metrics):
        for collector in self.collectors:
            collector.collect(metrics)

    def results(self):
        return {c.type: c.result() for c in self.collectors}
