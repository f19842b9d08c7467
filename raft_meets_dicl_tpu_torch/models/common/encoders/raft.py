"""RAFT feature/context encoder (counterpart of the JAX ``encoders/raft.py``).

Single-scale s3 (1/8 resolution): 7x7 stride-2 input conv, three residual
stages (64/96/128), 1x1 output conv. NCHW inside; parameter names follow
torch RAFT (``conv1``, ``norm1``, ``layer1.0...``, ``conv2``). The shared
batch for image pairs is kept: pass ``(img1, img2)`` and both are encoded
in one batched pass. Channel dropout (the JAX ``_drop2d``, torch
``Dropout2d``) applies only when ``train``; ``frozen_bn`` keeps batch norm
on its running statistics while its scale and bias still train.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks.raft import ResidualBlock
from ..norm import make_norm2d
from ..util import Conv2d


class FeatureEncoderS3(nn.Module):
    """Single-scale encoder: (B, 3, H, W) -> (B, output_dim, H/8, W/8)."""

    def __init__(self, output_dim=128, norm_type="instance", dropout=0.0,
                 dtype=None):
        super().__init__()
        self.dropout = dropout

        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype,
                            init="kaiming")
        self.norm1 = make_norm2d(norm_type, 64, 8, dtype)

        def stage(cin, cout, stride):
            return nn.Sequential(
                ResidualBlock(cin, cout, norm_type, stride=stride, dtype=dtype),
                ResidualBlock(cout, cout, norm_type, stride=1, dtype=dtype),
            )

        self.layer1 = stage(64, 64, 1)
        self.layer2 = stage(64, 96, 2)
        self.layer3 = stage(96, 128, 2)

        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype, init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)

        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        for block in (*self.layer1, *self.layer2, *self.layer3):
            x = block(x, train, frozen_bn)
        x = self.conv2(x)
        if self.dropout > 0:
            x = F.dropout2d(x, self.dropout, training=train)

        if paired:
            return x[:n], x[n:]
        return x
