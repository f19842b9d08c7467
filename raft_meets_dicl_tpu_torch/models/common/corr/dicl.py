"""DICL correlation module (counterpart of the JAX ``corr/dicl.py``):
sample the second frame's features on the (2r+1)² displaced window around
each centre, run the MatchingNet per displacement on the unstacked pair
(f1, window) and apply the displacement-aware projection.

Public layout is the JAX one (NHWC): f1, f2 (B, H, W, C); coords (B, H, W,
2); cost (B, H, W, (2r+1)²) float32 in the flat ``window_delta`` order.
"""

import torch.nn as nn

from ..blocks.dicl import DisplacementAwareProjection, MatchingNet
from .common import (
    SoftArgMaxFlowRegression,
    SoftArgMaxFlowRegressionWithDap,
    sample_window_fast,
)

__all__ = ["CorrelationModule", "SoftArgMaxFlowRegression",
           "SoftArgMaxFlowRegressionWithDap"]


class CorrelationModule(nn.Module):
    """``mnet`` (MatchingNet) + ``dap``. ``dtype`` (bf16 under the mixed
    policy) is the MatchingNet's compute dtype: f1 and the window are cast
    to it before the first conv; the cost and the DAP stay float32."""

    mnet_type = MatchingNet

    def __init__(self, feature_dim, radius, dap_init="identity",
                 norm_type="batch", mnet_scale=1, dtype=None):
        super().__init__()
        self.radius = radius
        self.compute_dtype = dtype
        self.mnet = self.mnet_type(feature_dim, norm_type=norm_type,
                                   scale=mnet_scale, dtype=dtype)
        self.dap = DisplacementAwareProjection(radius, init=dap_init)

    @property
    def output_dim(self):
        return (2 * self.radius + 1) ** 2

    def forward(self, f1, f2, coords, dap=True, train=False, frozen_bn=False):
        """The sampler kernel reads f2 in place when it is contiguous (else
        from a copy): the recurrent callers make it so once per level."""
        b, h, w, _ = f1.shape
        window = sample_window_fast(f2, coords, self.radius)
        if self.compute_dtype is not None:
            f1 = f1.to(self.compute_dtype)
            window = window.to(self.compute_dtype)

        cost = self.mnet((f1, window), train, frozen_bn)  # (B, H, W, du, dv)
        if dap:
            cost = self.dap(cost)
        return cost.reshape(b, h, w, self.output_dim)
