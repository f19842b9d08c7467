"""Metric registry (counterpart of ``raft_meets_dicl_tpu/metrics``): EPE,
Fl-all, AAE, flow magnitude, loss, learning rate, gradient/parameter
statistics, computed on the tensors' device and read back in batches."""

from . import functional
from .common import (
    Collector,
    Collectors,
    MeanCollector,
    Metric,
    MetricContext,
    Metrics,
    fetch,
)
from .flowmetrics import AverageAngularError, EndPointError, FlAll, FlowMagnitude
from .trainmetrics import (
    GradientMean,
    GradientMinMax,
    GradientNorm,
    LearningRate,
    Loss,
    ParameterMean,
    ParameterMinMax,
    ParameterNorm,
)

__all__ = [
    "functional",
    "Collector",
    "Collectors",
    "MeanCollector",
    "Metric",
    "MetricContext",
    "Metrics",
    "fetch",
    "AverageAngularError",
    "EndPointError",
    "FlAll",
    "FlowMagnitude",
    "GradientMean",
    "GradientMinMax",
    "GradientNorm",
    "LearningRate",
    "Loss",
    "ParameterMean",
    "ParameterMinMax",
    "ParameterNorm",
]
