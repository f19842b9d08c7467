"""Small shared helpers for the NN layer: a convolution with a compute
dtype, and the JAX package's initializers.

The JAX modules take a flax ``dtype`` (the compute dtype: bf16 under the
mixed-precision policy) while their parameters stay float32; ``Conv2d``
reproduces that by casting input, weight and bias to ``dtype`` at call
time. Initializers follow the flax defaults the JAX modules use, drawn
from an explicit ``torch.Generator``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's truncated normal rescales its stddev so that the truncated
# distribution (at +-2 std) keeps the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, generator):
    """flax ``lecun_normal``: truncated normal, variance 1/fan_in."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def kaiming_normal_(weight, generator):
    """The RAFT encoders' ``variance_scaling(2.0, 'fan_out', 'normal')``."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    nn.init.normal_(weight, 0.0, math.sqrt(2.0 / fan_out), generator=generator)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype and a named initializer.

    ``padding`` defaults to flax 'SAME' for stride 1 and odd kernels.
    ``dtype`` None computes in the promoted type of input and weight
    (float32), like flax ``dtype=None``.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=None, dtype=None, init="lecun"):
        ks = (kernel_size,) * 2 if isinstance(kernel_size, int) else tuple(kernel_size)
        if padding is None:
            padding = tuple(k // 2 for k in ks)
        super().__init__(in_channels, out_channels, ks, stride, padding)
        self.compute_dtype = dtype
        self.init_kind = init

    def init_parameters(self, generator):
        if self.init_kind == "kaiming":
            kaiming_normal_(self.weight, generator)
        else:
            lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


@torch.no_grad()
def init_parameters(module, generator):
    """Initialize every ``Conv2d`` and norm under ``module`` in module
    order (deterministic for a given generator state)."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.init_parameters(generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
            if isinstance(m, nn.BatchNorm2d):
                m.num_batches_tracked.zero_()
