"""Coordinate grids, NHWC layout (counterpart of the JAX ``common/grid.py``).

Grids are (B, H, W, 2) with channel 0 = x, 1 = y, like the JAX package.
"""

import torch


def coordinate_grid(batch, h, w, dtype=torch.float32, device=None):
    """(B, H, W, 2) pixel-position grid; [..., 0] = x, [..., 1] = y."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    grid = torch.stack((xs, ys), dim=-1)
    return grid.expand(batch, h, w, 2)
