"""2D normalization with a string-typed factory (counterpart of the JAX
``common/norm.py``).

Hyperparameters follow the JAX modules: eps 1e-5; instance norm is
non-affine (flax ``GroupNorm(group_size=1)`` without scale/bias); batch
norm evaluates with its running statistics (flax ``batch_stats.mean/var``;
flax momentum 0.9 is torch momentum 0.1). Statistics and the normalization
itself run in float32 and the result is cast to the compute dtype, as the
flax norm layers do under ``dtype=bf16``.

Only inference is ported: batch norm always uses its running statistics.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_TYPES = ("group", "batch", "instance", "none")


def _out_dtype(x, dtype):
    return dtype or torch.promote_types(x.dtype, torch.float32)


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, num_channels, dtype=None):
        super().__init__(num_channels, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, False, 0.0, self.eps)
        return y.to(_out_dtype(x, self.compute_dtype))


class GroupNorm(nn.GroupNorm):
    def __init__(self, num_groups, num_channels, dtype=None):
        super().__init__(num_groups, num_channels, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(_out_dtype(x, self.compute_dtype))


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over H, W; no parameters."""

    def __init__(self, dtype=None):
        super().__init__()
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.instance_norm(x.float(), eps=1e-5)
        return y.to(_out_dtype(x, self.compute_dtype))


def make_norm2d(ty, num_channels, num_groups=8, dtype=None):
    """Factory matching the reference signature; ``none`` is an empty
    ``nn.Sequential`` (identity, no state) like torch RAFT."""
    if ty == "group":
        return GroupNorm(num_groups, num_channels, dtype=dtype)
    if ty == "batch":
        return BatchNorm2d(num_channels, dtype=dtype)
    if ty == "instance":
        return InstanceNorm2d(dtype=dtype)
    if ty == "none":
        return nn.Sequential()
    raise ValueError(f"unknown norm type '{ty}'")
