"""Flow upsampling: RAFT convex upsampling and align_corners bilinear resize.

Counterpart of ``raft_meets_dicl_tpu/ops/upsample.py``. NHWC layout at the
public functions. The neighbour softmax + convex combine of the 8x case
is the CUDA kernel ``ops.convex.convex_combine_8x``; only the neighbour
gather and the pixel shuffle run as torch ops.
"""

import torch
import torch.nn.functional as F

from .convex import convex_combine_8x


def _neighbors3x3(x):
    """Stack the 3x3 neighborhood of each pixel: (B,H,W,C) -> (B,H,W,9,C).

    Neighbor order is (dy, dx) row-major with zero padding — identical to
    ``F.unfold`` with a (3, 3) kernel and padding 1.
    """
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy: dy + h, dx: dx + w, :]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample_8x(flow, mask_logits, temperature=4.0):
    """Convex combination upsampling (reference Up8Network).

    flow: (B, H, W, 2) float32; mask_logits: (B, H, W, 576), channel layout
    (neighbor k, sub-row r, sub-col s). Returns (B, 8H, 8W, 2) float32; the
    flow is scaled by 8. (The JAX function's other factors have no caller
    on the ported path.)
    """
    b, h, w, c = flow.shape

    nbrs = _neighbors3x3(8 * flow)  # (B, H, W, 9, 2)
    up = convex_combine_8x(mask_logits, nbrs, temperature)
    # pixel shuffle of the (..., c*64 + r*8 + s) channels onto pixel
    # (8y + r, 8x + s)
    up = up.reshape(b, h, w, c, 8, 8).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, h * 8, w * 8, c)


def interpolate_bilinear(x, size):
    """Bilinear resize with ``align_corners=True`` semantics, NHWC; the
    output dtype follows ``x`` (computed in float32)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(size),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_flow_2x(flow):
    """Double a (B, H, W, 2) flow's resolution (align_corners bilinear) and
    its displacement values: the inter-level step of the coarse-to-fine
    models."""
    b, h, w, _ = flow.shape
    return 2.0 * interpolate_bilinear(flow, (2 * h, 2 * w))
