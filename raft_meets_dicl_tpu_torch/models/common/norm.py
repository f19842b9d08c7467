"""2D normalization with a string-typed factory (counterpart of the JAX
``common/norm.py``).

Hyperparameters follow the JAX modules: eps 1e-5; instance norm is
non-affine (flax ``GroupNorm(group_size=1)`` without scale/bias). Statistics
and the normalization itself run in float32 and the result is cast to the
compute dtype, as the flax norm layers do under ``dtype=bf16``.

Every norm takes ``(x, train=False)``, like the JAX ``Norm2d``; only batch
norm reads ``train``. Without it batch norm normalizes with its running
statistics (flax ``batch_stats.mean/var``). With it, it normalizes with
the batch statistics and updates the running ones as flax does: momentum
0.9 in flax terms (0.1 in torch terms) and the *biased* batch variance,
where ``F.batch_norm(training=True)`` would store the unbiased one.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

NORM_TYPES = ("group", "batch", "instance", "none")


def _out_dtype(x, dtype):
    return dtype or torch.promote_types(x.dtype, torch.float32)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with the flax running-statistics update.

    ``splits`` > 1 computes live statistics over that many equal chunks of
    the batch, one after the other (the second chunk's update reads the
    first's), as the JAX ``Norm2d(splits=...)`` does for encoders that fold
    an image pair into one batch.
    """

    def __init__(self, num_channels, dtype=None, splits=1):
        super().__init__(num_channels, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype
        self.splits = splits
        # False while a checkpointed forward is recomputed in the backward
        # (``frozen_running_stats``): it normalizes with the batch
        # statistics as the first run did and leaves the running ones
        self.update_stats = True

    def forward(self, x, train=False):
        xf = x.float()
        if not train:
            y = F.batch_norm(xf, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        elif self.splits > 1:
            y = torch.cat([self._batch_stats_norm(c)
                           for c in xf.chunk(self.splits)], dim=0)
        else:
            y = self._batch_stats_norm(xf)
        return y.to(_out_dtype(x, self.compute_dtype))

    def _batch_stats_norm(self, x):
        # PyTorch's own kernel, never cuDNN's: on channels_last input (the
        # MatchingNet's layout) cuDNN trains in its
        # CUDNN_BATCHNORM_SPATIAL_PERSISTENT mode, which left a float32
        # ctf-l3 train step's gradients 8.3e-3 (median relative L2) off the
        # CPU's on an H100, PyTorch's kernel 1.2e-4
        y, _, _ = torch.native_batch_norm(x, self.weight, self.bias, None,
                                          None, True, 0.0, self.eps)
        if not self.update_stats:
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def frozen_running_stats(module):
    """Within the block, the batch norms under ``module`` normalize with
    their batch statistics but leave their running statistics alone: a
    forward recomputed for the backward (``torch.utils.checkpoint``) then
    leaves them as the one forward did, as the JAX package's functional
    ``batch_stats`` under ``nn.remat`` do."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class GroupNorm(nn.GroupNorm):
    def __init__(self, num_groups, num_channels, dtype=None):
        super().__init__(num_groups, num_channels, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x, train=False):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.to(_out_dtype(x, self.compute_dtype))


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel normalization over H, W; no parameters."""

    def __init__(self, dtype=None):
        super().__init__()
        self.compute_dtype = dtype

    def forward(self, x, train=False):
        if x.shape[-2] * x.shape[-1] == 1:
            # one element per map: its mean is itself and its variance 0,
            # so the flax norm gives 0 (torch's function refuses the map)
            y = torch.zeros_like(x, dtype=torch.float32)
        else:
            y = F.instance_norm(x.float(), eps=1e-5)
        return y.to(_out_dtype(x, self.compute_dtype))


class NoNorm2d(nn.Module):
    """Identity (norm type ``none``); no parameters or buffers."""

    def forward(self, x, train=False):
        return x


def make_norm2d(ty, num_channels, num_groups=8, dtype=None):
    """Factory matching the reference signature."""
    if ty == "group":
        return GroupNorm(num_groups, num_channels, dtype=dtype)
    if ty == "batch":
        return BatchNorm2d(num_channels, dtype=dtype)
    if ty == "instance":
        return InstanceNorm2d(dtype=dtype)
    if ty == "none":
        return NoNorm2d()
    raise ValueError(f"unknown norm type '{ty}'")
