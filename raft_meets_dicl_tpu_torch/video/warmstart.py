"""Temporal warm start: forward projection of a flow across frames
(counterpart of ``raft_meets_dicl_tpu/video/warmstart.py``).

A flow estimated for the pair (t-1, t) is a prior for (t, t+1), but in the
previous frame's coordinates: it has to move with the motion it describes
before it seeds the next frame's recurrence. The exact forward splat
scatters; as in JAX, the projection is the backward-sampled approximation

    out(p) = flow(p - flow(p))

(``ops.warp.warp_backwards(flow, -flow)``, first-order equal for smooth
motion), with samples that leave the frame masked to zero flow, so
disoccluded regions restart cold. Zero flow is a fixed point, so a zero
carry projects to exactly zero.

Two call forms, as in JAX: ``evaluation.make_warm_fn`` projects inside
its step (a raw cached carry goes straight in), and :func:`project_flow`
here is the twin for flows already outside a step: the sequence runner's
hidden-carry mode feeds continuation rungs, which take a projected
``flow_init``.
"""

import torch

from ..ops import warp


def project_flow(flow):
    """Forward-project a coarse flow field to the frame it points into.

    flow: (B, H, W, 2) coarse-grid flow in coarse-pixel units (a tensor).
    Returns the projected float32 field, zero where the backward sample
    leaves the image."""
    flow = flow.to(torch.float32)
    projected, _ = warp.warp_backwards(flow, -flow)
    return projected
