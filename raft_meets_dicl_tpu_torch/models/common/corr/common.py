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
import torch.utils.checkpoint

from ....ops.corr import window_delta
from ....ops.sample import sample_window_fused
from ..blocks.dicl import DisplacementAwareProjection
from ..norm import frozen_running_stats

# the JAX name of the DICL window lookup: here always the kernel pair
sample_window_fast = sample_window_fused


def checkpointed(module, fn, *tensors):
    """``fn(*tensors)`` (a call of ``module``) with its activations dropped
    after the forward and recomputed in the backward, when autograd
    records; else a plain call. The JAX recurrent steps keep only the cost
    of each iteration (``nn.remat`` with ``save_only_these_names
    ('corr_features')``): a DICL train step at the shipped sizes keeps
    6-7 GB of MatchingNet activations per call otherwise, 48 calls a
    ``raft+dicl/ml`` step. The recompute leaves live batch-norm running
    statistics as the one forward left them (``frozen_running_stats``)
    and, on the card, launches the window sampler's forward again."""
    if not torch.is_grad_enabled():
        return fn(*tensors)
    calls = []

    def run(*args):
        calls.append(None)
        if len(calls) == 1:
            return fn(*args)
        with frozen_running_stats(module):
            return fn(*args)

    # the cost modules draw no random numbers
    return torch.utils.checkpoint.checkpoint(run, *tensors,
                                             use_reentrant=False,
                                             preserve_rng_state=False)


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
