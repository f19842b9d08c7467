"""Pooled pyramid encoders (counterpart of the JAX ``encoders/pool.py``):
the RAFT s3 trunk gives the 1/8 features, each coarser level is a 2x
average or max pool of the one before, with per-level channel dropout.

NCHW inside; parameter names are the s3 encoder's (``conv1``, ``norm1``,
``layer1.0...``, ``conv2``).
"""

import torch

from ....ops.pool import avg_pool2d, max_pool2d
from .raft import _StemEncoder
from ..util import Conv2d

_POOLS = {"avg": avg_pool2d, "max": max_pool2d}


class FeatureEncoderPool(_StemEncoder):
    """(B, 3, H, W) -> a tuple of ``levels`` maps, finest first, at 1/8 ..
    1/(8·2^(levels-1)), each ``output_dim`` channels."""

    def __init__(self, output_dim=128, levels=2, norm_type="batch",
                 dropout=0.0, pool_type="avg", dtype=None):
        if pool_type not in _POOLS:
            raise ValueError(f"invalid pool_type value: '{pool_type}'")
        super().__init__(norm_type, dropout, dtype)
        self.levels = levels
        self.pool = _POOLS[pool_type]
        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype, init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)

        x = self.conv2(self.stem(x, train, frozen_bn))
        outputs = []
        for i in range(self.levels):
            if i > 0:
                x = self.pool(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2)
            outputs.append(self.drop(x, train))

        if paired:
            return tuple(o[:n] for o in outputs), tuple(o[n:] for o in outputs)
        return tuple(outputs)
