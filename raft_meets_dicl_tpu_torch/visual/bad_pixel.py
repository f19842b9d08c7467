"""KITTI Fl bad-pixel (outlier) visualization.

A pixel is an outlier when EPE ≥ 3px AND ≥ 5% of the ground-truth
magnitude (the KITTI 2015 Fl criterion). Own copy of
``raft_meets_dicl_tpu/visual/bad_pixel.py`` (host-side numpy; reference
src/visual/bad_pixel.py:7-32).
"""

import numpy as np


def fl_error(uv, uv_target, mask=None, base_color=(0.0, 1.0, 0.0, 1.0),
             bp_color=(1.0, 0.0, 0.0, 1.0), mask_color=(0, 0, 0, 1),
             nan_color=(0, 0, 0, 1)):
    """Outlier map (H, W, 4): inliers ``base_color``, outliers ``bp_color``."""
    uv = np.asarray(uv, np.float64)
    uv_target = np.asarray(uv_target, np.float64)

    epe = np.linalg.norm(uv_target - uv, axis=-1)
    magnitude = np.linalg.norm(uv_target, axis=-1)

    bogus = ~np.isfinite(epe)
    outlier = (epe >= 3.0) & (epe >= 0.05 * magnitude)

    rgba = np.empty((*epe.shape, 4))
    rgba[...] = np.asarray(base_color, dtype=np.float64)
    rgba[outlier] = np.asarray(bp_color, dtype=np.float64)
    rgba[bogus] = np.asarray(nan_color, dtype=np.float64)

    if mask is not None:
        rgba[~np.asarray(mask, bool)] = np.asarray(mask_color, dtype=np.float64)

    return rgba
