"""Small shared helpers for the NN layer: convolutions with a compute
dtype, and the JAX package's initializers.

The JAX modules take a flax ``dtype`` (the compute dtype: bf16 under the
mixed-precision policy) while their parameters stay float32; ``Conv2d`` and
``ConvTranspose2d`` reproduce that by casting input, weight and bias to
``dtype`` at call time. Initializers follow the flax defaults the JAX
modules use, drawn from an explicit ``torch.Generator``.
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


def identity_1x1_init(weight):
    """(C, C, 1, 1) identity kernel: an identity-initialized 1x1 conv (the
    JAX ``identity_1x1_init``)."""
    with torch.no_grad():
        weight.copy_(torch.eye(weight.shape[0], dtype=weight.dtype)
                     .reshape(weight.shape))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a compute dtype and a named initializer.

    ``padding`` defaults to flax 'SAME' for stride 1 and odd kernels, at
    any ``dilation``.
    ``dtype`` None computes in the promoted type of input and weight
    (float32), like flax ``dtype=None``. ``init`` is ``lecun`` (flax's
    default), ``kaiming`` or ``identity`` (1x1, square).
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=None, dtype=None, init="lecun", bias=True,
                 dilation=1):
        ks = (kernel_size,) * 2 if isinstance(kernel_size, int) else tuple(kernel_size)
        if padding is None:
            padding = tuple(dilation * (k // 2) for k in ks)
        super().__init__(in_channels, out_channels, ks, stride, padding,
                         dilation, bias=bias)
        self.compute_dtype = dtype
        self.init_kind = init

    def init_parameters(self, generator):
        if self.init_kind == "kaiming":
            kaiming_normal_(self.weight, generator)
        elif self.init_kind == "identity":
            identity_1x1_init(self.weight)
        else:
            lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return self.conv(x, self.weight)

    def conv(self, x, weight):
        """This conv's geometry, bias and compute dtype with ``weight`` (a
        slice of its own input channels, for split convolutions)."""
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), weight.to(dt), bias, self.stride,
                        self.padding, self.dilation)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with a compute dtype (as ``Conv2d``), no bias,
    and flax's ``lecun_normal`` over its (in, out, kh, kw) kernel (fan-in
    ``in * kh * kw``, as flax counts its (kh, kw, in, out) kernel)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=False)
        self.compute_dtype = dtype

    def init_parameters(self, generator):
        fan_in = self.weight.shape[0] * self.weight[0, 0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding)


@torch.no_grad()
def init_parameters(module, generator):
    """Initialize every ``Conv2d`` and norm under ``module`` in module
    order (deterministic for a given generator state)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.init_parameters(generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
            if isinstance(m, nn.BatchNorm2d):
                m.num_batches_tracked.zero_()
