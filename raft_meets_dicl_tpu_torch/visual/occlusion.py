"""Forwards-backwards product visualizations.

Occlusion masks render as a tinted overlay on the first frame (occluded
pixels stand out against the image that produced them); confidence maps
go through a colormap like the EPE visualization. Both return (H, W, 4)
float RGBA in [0, 1], the shared contract of this package. Own copy of
``raft_meets_dicl_tpu/visual/occlusion.py`` (host-side numpy).
"""

import numpy as np

from . import colormaps


def occlusion_overlay(img, occlusion, color=(1.0, 0.1, 0.1), strength=0.65):
    """Occlusion mask over ``img``: (H, W, 4) in [0, 1].

    ``img`` is (H, W, 3) in [0, 1] (or None for a plain mask render);
    ``occlusion`` (H, W) bool, True where the forwards-backwards check
    flagged the pixel. Occluded pixels blend toward ``color`` by
    ``strength``; the rest keep the (dimmed) image so the mask reads in
    context.
    """
    occlusion = np.asarray(occlusion, bool)
    rgba = np.zeros((*occlusion.shape, 4))
    rgba[..., 3] = 1.0

    if img is not None:
        rgba[..., :3] = np.clip(np.asarray(img, np.float64), 0.0, 1.0)

    tint = np.asarray(color, np.float64)
    rgba[occlusion, :3] = ((1.0 - strength) * rgba[occlusion, :3]
                           + strength * tint)
    return rgba


def confidence_to_rgba(confidence, cmap="viridis", vmin=0.0, vmax=1.0):
    """Colormapped confidence map (H, W, 4) in [0, 1].

    ``confidence`` is the (H, W) float map from the forwards-backwards
    products (1 = consistent, 0 = inconsistent/out-of-bounds); the
    default fixed [0, 1] normalization keeps frames of a sequence
    comparable.
    """
    conf = np.nan_to_num(np.asarray(confidence, np.float64))
    return colormaps.apply(cmap, colormaps.normalize(conf, vmin, vmax))
