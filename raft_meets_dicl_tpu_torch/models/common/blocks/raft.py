"""RAFT encoder building blocks (counterpart of the JAX ``blocks/raft.py``).

NCHW inside; parameter names follow torch RAFT (``conv1``, ``norm1``,
``downsample.0`` / ``.1``), which ``scripts/chkpt_convert.py`` maps onto
the JAX variable tree. The strided 3x3 conv pads (1, 1) like the JAX
block's explicit symmetric padding. ``train``/``frozen_bn`` reach the norms
as in the JAX block: batch statistics only when training with live batch
norm.
"""

import torch.nn as nn
import torch.nn.functional as F

from ..norm import make_norm2d
from ..util import Conv2d


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm + residual; strided 1x1 downsample path."""

    def __init__(self, in_planes, out_planes, norm_type="group", stride=1,
                 dtype=None):
        super().__init__()
        groups = out_planes // 8

        self.conv1 = Conv2d(in_planes, out_planes, 3, stride=stride,
                            padding=1, dtype=dtype, init="kaiming")
        self.conv2 = Conv2d(out_planes, out_planes, 3, dtype=dtype,
                            init="kaiming")
        self.norm1 = make_norm2d(norm_type, out_planes, groups, dtype)
        self.norm2 = make_norm2d(norm_type, out_planes, groups, dtype)

        self.downsample = None
        if stride > 1:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, out_planes, 1, stride=stride, dtype=dtype,
                       init="kaiming"),
                make_norm2d(norm_type, out_planes, groups, dtype),
            )

    def forward(self, x, train=False, frozen_bn=False):
        norm_train = train and not frozen_bn
        y = F.relu(self.norm1(self.conv1(x), norm_train))
        y = F.relu(self.norm2(self.conv2(y), norm_train))

        if self.downsample is not None:
            conv, norm = self.downsample
            x = norm(conv(x), norm_train)

        return F.relu(x + y)
