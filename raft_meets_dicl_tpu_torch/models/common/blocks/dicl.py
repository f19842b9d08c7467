"""DICL building blocks (counterpart of the JAX ``blocks/dicl.py``): conv
blocks, the per-displacement MatchingNet, the displacement-aware
projection (DAP) and the GA-Net ``GaConv2x*`` blocks of the ``dicl``
encoders.

NCHW inside; parameter names follow the reference torch modules, which the
``raft+dicl`` rules of ``scripts/chkpt_convert.py`` map onto the JAX tree:
a conv block is ``(conv, norm)`` (``mnet.0.0`` / ``mnet.0.1``), the
MatchingNet a sequence of four conv blocks, one transposed block and the
output conv (``mnet.5``), the DAP ``conv1``. The GA-Net blocks and the
``dicl/baseline`` modules follow the DICL-Flow reference
(``scripts/chkpt_convert.py``'s ``_dicl_rules``): a ``BasicConv`` is
``conv`` + ``bn``, a GA block ``conv1`` + ``conv2``.

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


def _split_first_conv(conv, shared, per_item):
    """``conv`` (a ``Conv2d``) over the channel concatenation [shared |
    per_item], with shared (B, C1, H, W) computed once and broadcast over
    the N items of per_item (B·N, C2, H, W), by linearity (the JAX split
    first conv); the bias, if any, is added after the two halves."""
    c1 = shared.shape[1]
    dt = conv.compute_dtype or torch.promote_types(shared.dtype,
                                                   conv.weight.dtype)

    def half(x, weight):
        return F.conv2d(x.to(dt), weight.to(dt), None, conv.stride,
                        conv.padding, conv.dilation)

    ys = half(shared, conv.weight[:, :c1])               # (B, C, h, w)
    yp = half(per_item, conv.weight[:, c1:])             # (B·N, C, h, w)
    n = yp.shape[0] // ys.shape[0]
    x = (yp.unflatten(0, (ys.shape[0], n)) + ys[:, None]).flatten(0, 1)
    if conv.bias is not None:
        x = x + conv.bias.to(dt)[:, None, None]
    return x


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
        x = _split_first_conv(conv, *x) if isinstance(x, tuple) else conv(x)
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


class BasicConv(nn.Module):
    """conv (no bias) -> norm -> relu as ``conv`` / ``bn`` (the DICL-Flow
    reference's ``BasicConv``; the JAX ``ConvBlock``). ``norm_type=None``
    leaves the norm out (``bn`` is None); ``transposed`` is the 2x up
    k4/s2/p1 transposed conv (``ConvBlockTransposed``)."""

    def __init__(self, c_in, c_out, kernel_size=3, stride=1, dilation=1,
                 norm_type="batch", num_groups=8, transposed=False):
        super().__init__()
        if transposed:
            self.conv = ConvTranspose2d(c_in, c_out, 4, 2, 1)
        else:
            self.conv = Conv2d(c_in, c_out, kernel_size, stride=stride,
                               dilation=dilation, bias=False)
        self.bn = (None if norm_type is None
                   else make_norm2d(norm_type, c_out, num_groups))

    def forward(self, x, train=False, frozen_bn=False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train and not frozen_bn)
        return F.relu(x)


class GaConv2xBlock(nn.Module):
    """Strided 3x3 downsample (``conv1``: conv, relu) fused with a
    same-resolution skip input (``conv2``: 3x3 conv, norm, relu over the
    concatenation, skip second)."""

    transposed = False

    def __init__(self, c_in, c_out, norm_type="batch"):
        super().__init__()
        if self.transposed:
            self.conv1 = BasicConv(c_in, c_out, norm_type=None,
                                   transposed=True)
        else:
            self.conv1 = BasicConv(c_in, c_out, stride=2, norm_type=None)
        self.conv2 = BasicConv(2 * c_out, c_out, norm_type=norm_type)

    def forward(self, x, res, train=False, frozen_bn=False):
        x = self.conv1(x)
        if x.shape != res.shape:
            raise ValueError(f"{type(self).__name__}: {tuple(x.shape)} does "
                             f"not meet the skip input {tuple(res.shape)}")
        return self.conv2(torch.cat((x, res), dim=1), train, frozen_bn)


class GaConv2xBlockTransposed(GaConv2xBlock):
    """2x transposed-conv upsample (``conv1``, torch's k4/s2/p1: flax's
    'SAME' with the kernel flip of ``convert.py``) fused with a
    same-resolution skip input, as ``GaConv2xBlock``."""

    transposed = True


def matching_input(mvol):
    """The MatchingNets' input as NCHW channels_last: the unstacked pair
    ``(f1 (B, H, W, C), window (B, du, dv, H, W, C'))`` stays a pair
    (f1, window folded to (B·du·dv, C', H, W)); the stacked volume (B, du,
    dv, H, W, C) folds the same way. Returns (input, (b, du, dv, h, w))."""
    cl = torch.channels_last
    if isinstance(mvol, tuple):
        f1, window = mvol
        b, du, dv, h, w, c = window.shape
        per_item = window.reshape(b * du * dv, h, w, c).permute(0, 3, 1, 2)
        x = (f1.permute(0, 3, 1, 2).contiguous(memory_format=cl),
             per_item.contiguous(memory_format=cl))
    else:
        b, du, dv, h, w, c = mvol.shape
        x = mvol.reshape(b * du * dv, h, w, c).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=cl)
    return x, (b, du, dv, h, w)


def cost_volume(x, dims):
    """(B·du·dv, 1, H, W) net output -> the float32 cost (B, H, W, du,
    dv)."""
    b, du, dv, h, w = dims
    return x.reshape(b, du, dv, h, w).float().permute(0, 3, 4, 1, 2)


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

    def __init__(self, feature_dim, norm_type="batch", scale=1.0, dtype=None,
                 input_dim=None):
        c1 = int(scale * 96)
        c2 = int(scale * 128)
        c3 = int(scale * 64)
        c4 = int(scale * 32)
        # input channels: the pair's 2C, unless the caller stacks more
        c_in = input_dim or 2 * feature_dim
        super().__init__(
            ConvBlock(c_in, c1, norm_type=norm_type, dtype=dtype),
            ConvBlock(c1, c2, stride=2, norm_type=norm_type, dtype=dtype),
            ConvBlock(c2, c2, norm_type=norm_type, dtype=dtype),
            ConvBlock(c2, c3, norm_type=norm_type, dtype=dtype),
            ConvBlockTransposed(c3, c4, norm_type=norm_type, num_groups=4,
                                dtype=dtype),
            Conv2d(c4, 1, 3, dtype=dtype),  # with bias, like the reference
        )

    def forward(self, mvol, train=False, frozen_bn=False):
        x, dims = matching_input(mvol)
        *blocks, out = self
        for block in blocks:
            x = block(x, train, frozen_bn)
        # the cost volume is the readout surface (soft-argmax, DAP): f32
        return cost_volume(out(x), dims)


class MatchingNet1x1(nn.Sequential):
    """Pointwise matching net (the JAX ``corr/dicl_1x1.py``): three 1x1
    conv blocks and a biased 1x1 output conv (``mnet.3``), per
    displacement, no spatial context. Input and output as ``MatchingNet``
    (the split first conv for the unstacked pair; the same parameters)."""

    def __init__(self, feature_dim, norm_type="batch", scale=1.0, dtype=None):
        c1 = int(scale * 96)
        c2 = int(scale * 128)
        c3 = int(scale * 64)
        super().__init__(
            ConvBlock(2 * feature_dim, c1, 1, norm_type=norm_type,
                      dtype=dtype),
            ConvBlock(c1, c2, 1, norm_type=norm_type, dtype=dtype),
            ConvBlock(c2, c3, 1, norm_type=norm_type, dtype=dtype),
            Conv2d(c3, 1, 1, dtype=dtype),  # with bias, like the reference
        )

    forward = MatchingNet.forward


class PairEmbedding(nn.Sequential):
    """Pointwise embedding of feature pairs (the JAX ``corr/dicl_emb.py``):
    1x1 convs 48 -> 64 -> ``output_dim`` with biases, relus between
    (``0``, ``1``, ``2``). Input as ``MatchingNet`` (the first conv split
    for the unstacked pair); output (B, du, dv, H, W, output_dim) float32,
    the attention readout's operand."""

    def __init__(self, input_dim, output_dim=32, dtype=None):
        super().__init__(
            Conv2d(input_dim, 48, 1, dtype=dtype),
            Conv2d(48, 64, 1, dtype=dtype),
            Conv2d(64, output_dim, 1, dtype=dtype),
        )

    def forward(self, fstack):
        x, (b, du, dv, h, w) = matching_input(fstack)
        first, second, out = self
        if isinstance(x, tuple):
            x = _split_first_conv(first, *x)
        else:
            x = first(x)
        x = out(F.relu(second(F.relu(x))))
        x = x.float().permute(0, 2, 3, 1)
        return x.reshape(b, du, dv, h, w, x.shape[-1])


class DisplacementAwareProjection(nn.Module):
    """1x1 conv (no bias) mixing the du·dv displacement channels of a cost
    volume (B, H, W, du, dv) -> (B, H, W, du, dv). ``radius`` is r (a
    square window) or the range (ru, rv); ``init='identity'`` starts as a
    no-op projection."""

    def __init__(self, radius, init="identity"):
        super().__init__()
        if init not in ("identity", "standard"):
            raise ValueError(f"unknown init value '{init}'")
        ru, rv = radius if isinstance(radius, (tuple, list)) else (radius,
                                                                   radius)
        k2 = (2 * ru + 1) * (2 * rv + 1)
        self.conv1 = Conv2d(k2, k2, 1, bias=False,
                            init="identity" if init == "identity" else "lecun")

    def forward(self, x):
        b, h, w, du, dv = x.shape
        y = self.conv1(x.reshape(b, h, w, du * dv).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(b, h, w, du, dv)
