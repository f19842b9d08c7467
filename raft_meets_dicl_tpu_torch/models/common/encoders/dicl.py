"""GA-Net feature encoders of the DICL family (counterpart of the JAX
``encoders/dicl.py``): one parametric hourglass, (depth, out_levels)
instances for the reference's s3, p26 and p34-p36.

A strided conv ladder down to ``depth``, a transposed-conv ladder back up,
a second strided ladder (each rung fused with the previous ladder's
same-resolution features), and a final up ladder with output heads at the
requested levels. Level 0 is H/2 (the stem), level i is H/2^(i+1).

NCHW inside; names follow the DICL-Flow reference (``scripts/
chkpt_convert.py``'s ``_dicl_rules``): stem ``conv0.{0,1,2}``, first down
ladder ``conv{i}a``, first up ladder ``deconv{i}a``, second down ladder
``conv{i}b``, final up ladder ``deconv{i}b`` with heads ``outconv{i}``
(the head after ``deconv{i}b``, at level i - 1).
"""

import torch
import torch.nn as nn

from ..blocks.dicl import BasicConv, GaConv2xBlock, GaConv2xBlockTransposed
from ..norm import BatchNorm2d

# channels per level: stem = 32 (H/2), then one stage per downsample
_CHANNELS = (32, 48, 64, 96, 128, 160, 192)


class FeatureEncoderGa(nn.Module):
    """Parametric GA-Net hourglass: down ``depth``, up, down, up with heads.

    Returns the features at ``out_levels``, finest first (a single map when
    one level is asked for): each through its output head, or with
    ``heads=False`` the final up ladder's raw features (the ladder's
    channels at that level, ``_CHANNELS[level]``). An ``(img1, img2)``
    pair runs as one batch of 2N, its live batch-norm statistics per image
    (``BatchNorm2d``'s ``splits``), as the reference encodes the two in
    separate calls."""

    def __init__(self, output_dim=32, depth=3, out_levels=(2,),
                 norm_type="batch", heads=True):
        super().__init__()
        out_levels = tuple(sorted(out_levels))
        if not (1 <= out_levels[0] and out_levels[-1] < depth):
            raise ValueError(f"out_levels {out_levels} must lie in 1 .. "
                             f"{depth - 1}")
        self.depth = depth
        self.out_levels = out_levels
        self.heads = heads
        ch = _CHANNELS
        self.conv0 = nn.Sequential(
            BasicConv(3, ch[0], norm_type=norm_type),
            BasicConv(ch[0], ch[0], stride=2, norm_type=norm_type),
            BasicConv(ch[0], ch[0], norm_type=norm_type))
        for i in range(1, depth + 1):
            setattr(self, f"conv{i}a", BasicConv(ch[i - 1], ch[i], stride=2,
                                                 norm_type=norm_type))
        for i in range(depth, 0, -1):
            setattr(self, f"deconv{i}a",
                    GaConv2xBlockTransposed(ch[i], ch[i - 1], norm_type))
        for i in range(1, depth + 1):
            setattr(self, f"conv{i}b",
                    GaConv2xBlock(ch[i - 1], ch[i], norm_type))
        for i in range(depth, out_levels[0], -1):
            setattr(self, f"deconv{i}b",
                    GaConv2xBlockTransposed(ch[i], ch[i - 1], norm_type))
            if heads and i - 1 in out_levels:
                setattr(self, f"outconv{i}",
                        BasicConv(ch[i - 1], output_dim, norm_type=norm_type))

    def _set_splits(self, splits):
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.splits = splits

    def forward(self, x, train=False, frozen_bn=False):
        paired = isinstance(x, (tuple, list))
        if paired:
            n = x[0].shape[0]
            x = torch.cat(x, dim=0)
        self._set_splits(2 if paired else 1)

        for block in self.conv0:
            x = block(x, train, frozen_bn)
        res = {0: x}
        for i in range(1, self.depth + 1):
            x = getattr(self, f"conv{i}a")(x, train, frozen_bn)
            res[i] = x
        for i in range(self.depth, 0, -1):
            x = getattr(self, f"deconv{i}a")(x, res[i - 1], train, frozen_bn)
            res[i - 1] = x
        for i in range(1, self.depth + 1):
            x = getattr(self, f"conv{i}b")(x, res[i], train, frozen_bn)
            res[i] = x

        outputs = {}
        for i in range(self.depth, self.out_levels[0], -1):
            x = getattr(self, f"deconv{i}b")(x, res[i - 1], train, frozen_bn)
            if i - 1 in self.out_levels:
                outputs[i - 1] = (getattr(self, f"outconv{i}")(
                    x, train, frozen_bn) if self.heads else x)
        outs = tuple(outputs[lvl] for lvl in self.out_levels)  # finest first

        if paired:
            if len(outs) == 1:
                return outs[0][:n], outs[0][n:]
            return tuple(o[:n] for o in outs), tuple(o[n:] for o in outs)
        return outs[0] if len(outs) == 1 else outs


def s3(output_dim, norm_type="batch", **kwargs):
    """Single-scale 1/8 (reference dicl/s3.py)."""
    return FeatureEncoderGa(output_dim=output_dim, depth=3, out_levels=(2,),
                            norm_type=norm_type, **kwargs)


def p26(output_dim, norm_type="batch", **kwargs):
    """1/4 .. 1/64 pyramid of the DICL baseline (reference dicl/p26.py)."""
    return FeatureEncoderGa(output_dim=output_dim, depth=6,
                            out_levels=(1, 2, 3, 4, 5), norm_type=norm_type,
                            **kwargs)


def pyramid(levels, output_dim, norm_type="batch", **kwargs):
    """1/8 .. 1/(8·2^(levels-1)) pyramids: levels 2/3/4 = p34/p35/p36."""
    out_levels = tuple(range(2, 2 + levels))
    return FeatureEncoderGa(output_dim=output_dim, depth=max(out_levels) + 1,
                            out_levels=out_levels, norm_type=norm_type,
                            **kwargs)
