"""Coordinate grids and backwards warping, NHWC (counterpart of
``raft_meets_dicl_tpu/ops/warp.py``; reference
src/models/common/grid.py:4-12, src/models/common/warp.py:5-33).

Plain PyTorch over ``ops/sample.py::sample_bilinear``: the flow-image
writers of ``main evaluate`` warp on the host with it, and a model's warp
layer can use it on the device.
"""

import torch

from .sample import sample_bilinear


def coordinate_grid(batch, h, w, dtype=torch.float32, device=None):
    """(B, H, W, 2) grid of absolute pixel positions, channel 0 = x, 1 = y."""
    cy, cx = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack((cx, cy), dim=-1).expand(batch, h, w, 2)


def warp_backwards(img2, flow, eps=1e-5):
    """Warp img2 back to frame 1 along ``flow``; returns (warped, mask).

    img2: (B, H, W, C); flow: (B, H, W, 2). The mask flags pixels whose
    sample window lies fully inside the image (bilinear weight of valid
    pixels > 1 - eps), the reference's ones-image trick (warp.py:27-31).
    """
    b, h, w, c = img2.shape
    pos = coordinate_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    x = pos[..., 0].reshape(b, h * w)
    y = pos[..., 1].reshape(b, h * w)

    est = sample_bilinear(img2, x, y).reshape(b, h, w, c)
    ones = torch.ones((b, h, w, 1), dtype=img2.dtype, device=img2.device)
    mask = sample_bilinear(ones, x, y).reshape(b, h, w, 1) > (1.0 - eps)

    return est * mask, mask.expand(est.shape)
