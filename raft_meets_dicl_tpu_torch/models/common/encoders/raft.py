"""RAFT feature/context encoders (counterpart of the JAX ``encoders/raft.py``).

Single-scale s3 (1/8 resolution): 7x7 stride-2 input conv, three residual
stages (64/96/128), 1x1 output conv. Pyramids p34/p35/p36 (2/3/4 levels,
1/8 .. 1/64): the same stem, then a per-level output head (``out3``,
``out4``, ...) and, between levels, a stride-2 residual stage of
160/192/224 channels (``layer4``, ``layer5``, ``layer6``).

NCHW inside; parameter names follow torch RAFT and the reference pyramids
(``conv1``, ``norm1``, ``layer1.0...``, ``conv2``, ``out3.conv1``). The
shared batch for image pairs is kept: pass ``(img1, img2)`` and both are
encoded in one batched pass. Channel dropout (the JAX ``_drop2d``, torch
``Dropout2d``) applies only when ``train``; ``frozen_bn`` keeps batch norm
on its running statistics while its scale and bias still train.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..blocks.raft import ResidualBlock
from ..norm import make_norm2d
from ..util import Conv2d


def _stage(cin, cout, stride, norm_type, dtype):
    return nn.Sequential(
        ResidualBlock(cin, cout, norm_type, stride=stride, dtype=dtype),
        ResidualBlock(cout, cout, norm_type, stride=1, dtype=dtype),
    )


class _StemEncoder(nn.Module):
    """The input conv and the first three residual stages (to 1/8, 128
    channels), shared by the single-scale and the pyramid encoders."""

    def __init__(self, norm_type, dropout, dtype):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, dtype=dtype,
                            init="kaiming")
        self.norm1 = make_norm2d(norm_type, 64, 8, dtype)
        self.layer1 = _stage(64, 64, 1, norm_type, dtype)
        self.layer2 = _stage(64, 96, 2, norm_type, dtype)
        self.layer3 = _stage(96, 128, 2, norm_type, dtype)

    def stem(self, x, train, frozen_bn):
        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        for block in (*self.layer1, *self.layer2, *self.layer3):
            x = block(x, train, frozen_bn)
        return x

    def drop(self, x, train):
        if self.dropout > 0:
            x = F.dropout2d(x, self.dropout, training=train)
        return x


class FeatureEncoderS3(_StemEncoder):
    """Single-scale encoder: (B, 3, H, W) -> (B, output_dim, H/8, W/8)."""

    def __init__(self, output_dim=128, norm_type="instance", dropout=0.0,
                 dtype=None):
        super().__init__(norm_type, dropout, dtype)
        self.conv2 = Conv2d(128, output_dim, 1, dtype=dtype, init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)

        x = self.drop(self.conv2(self.stem(x, train, frozen_bn)), train)

        if paired:
            return x[:n], x[n:]
        return x


class EncoderOutputNet(nn.Module):
    """Per-level output head: 3x3 conv + norm + relu + 1x1 conv."""

    def __init__(self, input_dim, output_dim, intermediate_dim=128,
                 norm_type="batch", dtype=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, intermediate_dim, 3, dtype=dtype,
                            init="kaiming")
        self.norm1 = make_norm2d(norm_type, intermediate_dim, 8, dtype)
        self.conv2 = Conv2d(intermediate_dim, output_dim, 1, dtype=dtype,
                            init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        return self.conv2(x)


class FeatureEncoderPyramid(_StemEncoder):
    """Pyramid encoder: (B, 3, H, W) -> a tuple of ``levels`` maps, finest
    first, at 1/8 .. 1/(8·2^(levels-1)), each ``output_dim`` channels.
    Head ``out{3+i}`` has 160 + 32·i intermediate channels."""

    STAGE_CHANNELS = (160, 192, 224)

    def __init__(self, output_dim=128, levels=3, norm_type="instance",
                 dropout=0.0, dtype=None):
        super().__init__(norm_type, dropout, dtype)
        self.levels = levels
        cin = 128
        for i in range(levels):
            setattr(self, f"out{i + 3}", EncoderOutputNet(
                cin, output_dim, intermediate_dim=160 + 32 * i,
                norm_type=norm_type, dtype=dtype))
            if i + 1 < levels:
                ch = self.STAGE_CHANNELS[min(i, len(self.STAGE_CHANNELS) - 1)]
                setattr(self, f"layer{i + 4}",
                        _stage(cin, ch, 2, norm_type, dtype))
                cin = ch

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)

        x = self.stem(x, train, frozen_bn)
        outputs = []
        for i in range(self.levels):
            out = getattr(self, f"out{i + 3}")(x, train, frozen_bn)
            outputs.append(self.drop(out, train))
            if i + 1 < self.levels:
                for block in getattr(self, f"layer{i + 4}"):
                    x = block(x, train, frozen_bn)

        if paired:
            return tuple(o[:n] for o in outputs), tuple(o[n:] for o in outputs)
        return tuple(outputs)
