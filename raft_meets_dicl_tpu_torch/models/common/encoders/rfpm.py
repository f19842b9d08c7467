"""RFPM encoders: residual feature pyramid modules (counterpart of the JAX
``encoders/rfpm.py``; "Detail Preserving Residual Feature Pyramid Modules
for Optical Flow", Long & Lang 2021) on the RAFT encoder base.

Three parallel pyramids (left: residual stages; center: residual-feature
downsampling with max-pool shortcuts; right: residual stages), repair
masks chaining left -> center -> right at every stage, and per-level
output nets over the three concatenated pyramids. ``levels=1`` is the
reference s3 (one 1/8 map), 2/3/4 are p34/p35/p36.

NCHW inside. Names: the stem ``conv1`` / ``norm1``; stage k ``stage{k}``
with ``left``, ``center``, ``right`` (two blocks each, residual blocks
named as the RAFT encoders', an RFD block as a residual block whose
``downsample`` follows a max pool), ``repair_c`` and ``repair_r`` (``conv1``
the mask, ``conv2`` the bias); the head at level L ``out{L}`` (``conv1``,
``norm1``, ``conv2``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ....ops.pool import max_pool2d
from ..blocks.raft import ResidualBlock
from ..norm import make_norm2d
from ..util import Conv2d

_STAGE_CHANNELS = (64, 96, 128, 160, 192, 224, 256)


class RfpmRfdBlock(ResidualBlock):
    """Residual feature downsampling: a strided residual block whose
    shortcut is a 2x max pool at ``stride``, then its 1x1 conv (stride 1)
    and norm."""

    def __init__(self, in_planes, out_planes, norm_type="group", stride=2):
        super().__init__(in_planes, out_planes, norm_type, stride=stride)
        self.pool_stride = stride
        self.downsample[0].stride = (1, 1)

    def forward(self, x, train=False, frozen_bn=False):
        norm_train = train and not frozen_bn
        y = F.relu(self.norm1(self.conv1(x), norm_train))
        y = F.relu(self.norm2(self.conv2(y), norm_train))

        conv, norm = self.downsample
        x = max_pool2d(x.permute(0, 2, 3, 1), 2, self.pool_stride)
        x = norm(conv(x.permute(0, 3, 1, 2)), norm_train)
        return F.relu(x + y)


class RfpmRepairMaskNet(nn.Module):
    """x · sigmoid(conv1(left)) + tanh(conv2(left))."""

    def __init__(self, channels):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, init="kaiming")
        self.conv2 = Conv2d(channels, channels, 3, init="kaiming")

    def forward(self, left, x):
        return (x * torch.sigmoid(self.conv1(left))
                + torch.tanh(self.conv2(left)))


class RfpmOutputNet(nn.Module):
    """Per-level head: 1x1 conv, norm, relu, 1x1 conv, channel dropout."""

    def __init__(self, input_dim, output_dim, hidden_dim=128,
                 norm_type="batch", dropout=0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Conv2d(input_dim, hidden_dim, 1, init="kaiming")
        self.norm1 = make_norm2d(norm_type, hidden_dim, 8)
        self.conv2 = Conv2d(hidden_dim, output_dim, 1, init="kaiming")

    def forward(self, x, train=False, frozen_bn=False):
        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        x = self.conv2(x)
        if self.dropout > 0:
            x = F.dropout2d(x, self.dropout, training=train)
        return x


class _Stage(nn.Module):
    """One pyramid stage across left / center / right, then the repair
    masks."""

    def __init__(self, c_in, c_out, stride, norm_type):
        super().__init__()

        def pair(first_rfd):
            first = (RfpmRfdBlock(c_in, c_out, norm_type, stride)
                     if first_rfd and stride > 1
                     else ResidualBlock(c_in, c_out, norm_type, stride=stride))
            return nn.Sequential(first, ResidualBlock(c_out, c_out, norm_type))

        self.left = pair(False)
        self.center = pair(True)
        self.right = pair(False)
        self.repair_c = RfpmRepairMaskNet(c_out)
        self.repair_r = RfpmRepairMaskNet(c_out)

    def forward(self, xl, xc, xr, train=False, frozen_bn=False):
        for block in self.left:
            xl = block(xl, train, frozen_bn)
        for block in self.center:
            xc = block(xc, train, frozen_bn)
        for block in self.right:
            xr = block(xr, train, frozen_bn)
        xc = self.repair_c(xl, xc)
        xr = self.repair_r(xc, xr)
        return xl, xc, xr


class FeatureEncoderRfpm(nn.Module):
    """(B, 3, H, W) -> ``levels`` maps at 1/8 .. 1/(8·2^(levels-1)), finest
    first (one map for ``levels=1``); an ``(img1, img2)`` pair runs as one
    batch."""

    def __init__(self, output_dim=32, levels=1, norm_type="batch",
                 dropout=0.0):
        super().__init__()
        self.levels = levels
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, init="kaiming")
        self.norm1 = make_norm2d(norm_type, 64, 8)
        ch = _STAGE_CHANNELS
        c_in = 64
        for stage in range(1, levels + 3):
            setattr(self, f"stage{stage}", _Stage(
                c_in, ch[stage - 1], 1 if stage == 1 else 2, norm_type))
            c_in = ch[stage - 1]
            if stage >= 3:
                setattr(self, f"out{stage}", RfpmOutputNet(
                    3 * c_in, output_dim, hidden_dim=3 * ch[stage],
                    norm_type=norm_type, dropout=dropout))

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)

        x = F.relu(self.norm1(self.conv1(x), train and not frozen_bn))
        xl = xc = xr = x
        outputs = []
        for stage in range(1, self.levels + 3):
            xl, xc, xr = getattr(self, f"stage{stage}")(xl, xc, xr, train,
                                                        frozen_bn)
            if stage >= 3:
                outputs.append(getattr(self, f"out{stage}")(
                    torch.cat((xl, xc, xr), dim=1), train, frozen_bn))

        outs = tuple(outputs)
        if paired:
            if len(outs) == 1:
                return outs[0][:n], outs[0][n:]
            return tuple(o[:n] for o in outs), tuple(o[n:] for o in outs)
        return outs[0] if len(outs) == 1 else outs
