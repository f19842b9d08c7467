"""Dot-product correlation module (counterpart of the JAX ``corr/dot.py``):
the window's cost is the normalized dot product of the feature vectors,
``ops.corr.windowed_correlation`` (the JAX function is plain XLA, no
kernel), then the DAP (``dap``).
"""

import torch.nn as nn

from ....ops.corr import windowed_correlation
from ..blocks.dicl import DisplacementAwareProjection
from .common import SoftArgMaxFlowRegression, SoftArgMaxFlowRegressionWithDap

__all__ = ["CorrelationModule", "SoftArgMaxFlowRegression",
           "SoftArgMaxFlowRegressionWithDap"]


class CorrelationModule(nn.Module):
    def __init__(self, radius, dap_init="identity"):
        super().__init__()
        self.radius = radius
        self.dap = DisplacementAwareProjection(radius, init=dap_init)

    @property
    def output_dim(self):
        return (2 * self.radius + 1) ** 2

    def forward(self, f1, f2, coords, dap=True, train=False, frozen_bn=False):
        b, h, w, _ = f1.shape
        k = 2 * self.radius + 1

        # dot(f1[p], f2[c + d]) / sqrt(C) over the window, channels (dx, dy)
        cost = windowed_correlation(f1, f2, coords, self.radius, scale=1.0)
        if dap:
            cost = self.dap(cost.reshape(b, h, w, k, k)).reshape(b, h, w,
                                                                  k * k)
        return cost
