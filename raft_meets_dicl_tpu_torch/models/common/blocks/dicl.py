"""DICL building blocks (counterpart of the JAX ``blocks/dicl.py``): conv
blocks, the per-displacement MatchingNet and the displacement-aware
projection (DAP). The GA-Net ``GaConv2x*`` blocks belong to the ``dicl``
encoders and are not ported yet (ROADMAP slice 4, item 4).

NCHW inside; parameter names follow the reference torch modules, which the
``raft+dicl`` rules of ``scripts/chkpt_convert.py`` map onto the JAX tree:
a conv block is ``(conv, norm)`` (``mnet.0.0`` / ``mnet.0.1``), the
MatchingNet a sequence of four conv blocks, one transposed block and the
output conv (``mnet.5``), the DAP ``conv1``.

The MatchingNet runs channels_last: the DICL window sampler writes the
(B·K², H, W, C)-contiguous window, whose NCHW view is channels_last, so it
reaches the first conv without a copy, and its gradient comes back the
same way.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..norm import make_norm2d
from ..util import Conv2d, ConvTranspose2d


class ConvBlock(nn.Sequential):
    """conv (no bias) -> norm -> relu, as ``(conv, norm)``.

    Input may also be a pair ``(shared, per_item)`` with shared (B, C1, H,
    W) and per_item (B·N, C2, H, W): the conv then splits along its input
    channels (shared first), computing the shared half once and
    broadcasting it over the N items, by linearity. Parameters are those of
    the conv over the concatenated channels.
    """

    def __init__(self, c_in, c_out, kernel_size=3, stride=1, norm_type="batch",
                 num_groups=8, dtype=None):
        super().__init__(
            Conv2d(c_in, c_out, kernel_size, stride=stride, dtype=dtype,
                   bias=False),
            make_norm2d(norm_type, c_out, num_groups, dtype),
        )

    def forward(self, x, train=False, frozen_bn=False):
        conv, norm = self
        if isinstance(x, tuple):
            shared, per_item = x
            c1 = shared.shape[1]
            ys = conv.conv(shared, conv.weight[:, :c1])     # (B, C, h, w)
            yp = conv.conv(per_item, conv.weight[:, c1:])   # (B·N, C, h, w)
            n = yp.shape[0] // ys.shape[0]
            x = (yp.unflatten(0, (ys.shape[0], n)) + ys[:, None]).flatten(0, 1)
        else:
            x = conv(x)
        return F.relu(norm(x, train and not frozen_bn))


class ConvBlockTransposed(nn.Sequential):
    """transposed conv (2x up, torch's k4/s2/p1 geometry, no bias) -> norm
    -> relu. flax's ``ConvTranspose(padding='SAME')`` of the JAX block is
    the same map with a spatially flipped kernel (``convert.py``)."""

    def __init__(self, c_in, c_out, norm_type="batch", num_groups=8,
                 dtype=None):
        super().__init__(
            ConvTranspose2d(c_in, c_out, 4, 2, 1, dtype=dtype),
            make_norm2d(norm_type, c_out, num_groups, dtype),
        )

    def forward(self, x, train=False, frozen_bn=False):
        conv, norm = self
        return F.relu(norm(conv(x), train and not frozen_bn))


class MatchingNet(nn.Sequential):
    """6-layer conv hourglass applied per displacement candidate.

    Input ``(B, du, dv, H, W, 2C)`` (stacked feature pairs), or the pair
    ``(f1, window)`` with f1 (B, H, W, C) and window (B, du, dv, H, W, C)
    unstacked: the first conv then computes the f1 half once and broadcasts
    it over the displacements, and the stacked volume never exists (JAX
    ``MatchingNet``; the same parameters). Output: the cost (B, H, W, du,
    dv) in float32. Displacements ride the batch axis through the convs,
    so a train-mode batch norm takes its statistics over B·du·dv maps.
    """

    def __init__(self, feature_dim, norm_type="batch", scale=1.0, dtype=None):
        c1 = int(scale * 96)
        c2 = int(scale * 128)
        c3 = int(scale * 64)
        c4 = int(scale * 32)
        super().__init__(
            ConvBlock(2 * feature_dim, c1, norm_type=norm_type, dtype=dtype),
            ConvBlock(c1, c2, stride=2, norm_type=norm_type, dtype=dtype),
            ConvBlock(c2, c2, norm_type=norm_type, dtype=dtype),
            ConvBlock(c2, c3, norm_type=norm_type, dtype=dtype),
            ConvBlockTransposed(c3, c4, norm_type=norm_type, num_groups=4,
                                dtype=dtype),
            Conv2d(c4, 1, 3, dtype=dtype),  # with bias, like the reference
        )

    def forward(self, mvol, train=False, frozen_bn=False):
        first, *blocks, out = self
        cl = torch.channels_last
        if isinstance(mvol, tuple):
            f1, window = mvol
            b, du, dv, h, w, c = window.shape
            per_item = window.reshape(b * du * dv, h, w, c).permute(0, 3, 1, 2)
            x = first((f1.permute(0, 3, 1, 2).contiguous(memory_format=cl),
                       per_item.contiguous(memory_format=cl)),
                      train, frozen_bn)
        else:
            b, du, dv, h, w, c = mvol.shape
            x = mvol.reshape(b * du * dv, h, w, c).permute(0, 3, 1, 2)
            x = first(x.contiguous(memory_format=cl), train, frozen_bn)
        for block in blocks:
            x = block(x, train, frozen_bn)
        x = out(x)                                       # (B·du·dv, 1, H, W)

        # the cost volume is the readout surface (soft-argmax, DAP): f32
        cost = x.reshape(b, du, dv, h, w).float()
        return cost.permute(0, 3, 4, 1, 2)               # (B, H, W, du, dv)


class DisplacementAwareProjection(nn.Module):
    """1x1 conv (no bias) mixing the du·dv displacement channels of a cost
    volume (B, H, W, du, dv) -> (B, H, W, du, dv). ``init='identity'``
    starts as a no-op projection."""

    def __init__(self, radius, init="identity"):
        super().__init__()
        if init not in ("identity", "standard"):
            raise ValueError(f"unknown init value '{init}'")
        k2 = (2 * radius + 1) ** 2
        self.conv1 = Conv2d(k2, k2, 1, bias=False,
                            init="identity" if init == "identity" else "lecun")

    def forward(self, x):
        b, h, w, du, dv = x.shape
        y = self.conv1(x.reshape(b, h, w, du * dv).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(b, h, w, du, dv)
