"""Shared pieces of the correlation modules: window sampling and the
soft-argmax flow readout (counterpart of the JAX ``corr/common.py``).

Windows are ordered like ``ops.corr.window_delta`` (axis 0 varies dx), so
every cost volume shares one channel layout. Not ported: the JAX
``RMD_DICL_FAST`` escape hatch (on the card the sampler kernel always
runs, on the CPU its plain version) and ``record_matching_bytes``, which
feeds the JAX package's telemetry (not ported, ROADMAP slice 7).
"""

import torch
import torch.nn as nn

from ....ops.corr import window_delta
from ....ops.sample import sample_window_fused
from ..blocks.dicl import DisplacementAwareProjection

# the JAX name of the DICL window lookup: here always the kernel pair
sample_window_fast = sample_window_fused


def soft_argmax_flow(cost, radius, temperature=1.0):
    """Softmax-weighted displacement readout: cost (B, H, W, (2r+1)²) ->
    flow (B, H, W, 2)."""
    k = 2 * radius + 1
    score = torch.softmax(cost / temperature, dim=-1)
    delta = window_delta(radius, cost.dtype, cost.device).reshape(k * k, 2)
    return torch.einsum("bhwd,dc->bhwc", score, delta)


class SoftArgMaxFlowRegression(nn.Module):
    """Flow readout from a cost volume (no parameters)."""

    def __init__(self, radius, temperature=1.0):
        super().__init__()
        self.radius = radius
        self.temperature = temperature

    def forward(self, cost):
        return soft_argmax_flow(cost, self.radius, self.temperature)


class SoftArgMaxFlowRegressionWithDap(nn.Module):
    """Flow readout with its own (trained, identity-initialized) DAP
    applied first."""

    def __init__(self, radius, temperature=1.0):
        super().__init__()
        self.radius = radius
        self.temperature = temperature
        self.dap = DisplacementAwareProjection(radius)

    def forward(self, cost):
        b, h, w, kk = cost.shape
        k = 2 * self.radius + 1
        vol = self.dap(cost.reshape(b, h, w, k, k))
        return soft_argmax_flow(vol.reshape(b, h, w, kk), self.radius,
                                self.temperature)
