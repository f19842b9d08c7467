"""DICL correlation module with pair embeddings (counterpart of the JAX
``corr/dicl_emb.py``).

The sampled window (the sampler kernel) gains the window offsets as two
positional channels; the MatchingNet (``mnet``) and a pointwise pair
embedding (``emb``) both run on the unstacked (f1, window ++ offsets)
pair, their first convs split along the input channels. The (DAP'd) cost
softmax attends over the embeddings, and the module returns the cost
concatenated with the attended embedding: (B, H, W, (2r+1)² +
``embedding_dim``), the cost first.
"""

import torch
import torch.nn as nn

from ....ops.corr import window_delta
from ..blocks.dicl import (
    DisplacementAwareProjection,
    MatchingNet,
    PairEmbedding,
)
from . import common
from .common import sample_window_fast

__all__ = ["CorrelationModule", "SoftArgMaxFlowRegression",
           "SoftArgMaxFlowRegressionWithDap"]


class CorrelationModule(nn.Module):
    """``mnet`` + ``emb`` + ``dap``; ``dtype`` as ``corr/dicl.py``'s (f1,
    window and offsets cast to it; cost, embeddings and attention float32)."""

    def __init__(self, feature_dim, radius, embedding_dim=32,
                 dap_init="identity", norm_type="batch", dtype=None):
        super().__init__()
        self.radius = radius
        self.embedding_dim = embedding_dim
        self.compute_dtype = dtype
        pair_dim = 2 * feature_dim + 2
        self.mnet = MatchingNet(feature_dim, norm_type=norm_type, dtype=dtype,
                                input_dim=pair_dim)
        self.emb = PairEmbedding(pair_dim, embedding_dim, dtype=dtype)
        self.dap = DisplacementAwareProjection(radius, init=dap_init)

    @property
    def output_dim(self):
        return (2 * self.radius + 1) ** 2 + self.embedding_dim

    def forward(self, f1, f2, coords, dap=True, train=False, frozen_bn=False):
        b, h, w, _ = f1.shape
        k = 2 * self.radius + 1

        window = sample_window_fast(f2, coords, self.radius)
        # the offsets ride the per-displacement half, so the first convs'
        # channel order is the stacked [f1 | window | delta]
        delta = window_delta(self.radius, window.dtype, window.device)
        delta = delta[None, :, :, None, None, :].expand(b, k, k, h, w, 2)
        if self.compute_dtype is not None:
            f1 = f1.to(self.compute_dtype)
            window = window.to(self.compute_dtype)
            delta = delta.to(self.compute_dtype)
        per_item = torch.cat((window, delta), dim=-1)

        cost = self.mnet((f1, per_item), train, frozen_bn)  # (B, H, W, K, K)
        emb = self.emb((f1, per_item))                    # (B, K, K, H, W, E)

        score = self.dap(cost) if dap else cost
        score = torch.softmax(score.reshape(b, h, w, k * k), dim=-1)
        emb = emb.permute(0, 3, 4, 1, 2, 5).reshape(b, h, w, k * k, -1)
        attended = torch.einsum("bhwd,bhwde->bhwe", score, emb)

        return torch.cat((cost.reshape(b, h, w, k * k), attended), dim=-1)


class SoftArgMaxFlowRegression(common.SoftArgMaxFlowRegression):
    """The readout over the cost slice of the (cost ++ embedding) output."""

    def forward(self, out):
        k2 = (2 * self.radius + 1) ** 2
        return super().forward(out[..., :k2])


class SoftArgMaxFlowRegressionWithDap(common.SoftArgMaxFlowRegressionWithDap):
    """The DAP readout over the cost slice of the output."""

    def forward(self, out):
        k2 = (2 * self.radius + 1) ** 2
        return super().forward(out[..., :k2])
