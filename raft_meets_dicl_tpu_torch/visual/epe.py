"""End-point-error visualizations.

Absolute variant uses the logarithmic threshold palette of Menze et al.,
"Object Scene Flow" (as realized in cv-stuttgart/flow_library); relative
variant maps EPE through a colormap (``colormaps``: gray and viridis
built in, others from matplotlib). Own copy of
``raft_meets_dicl_tpu/visual/epe.py`` (host-side numpy; reference
src/visual/epe.py:9,55).
"""

import numpy as np

from . import colormaps

# (upper EPE threshold, RGB) — logarithmic scale, doubling per band
_ABS_BANDS = (
    (0.1875, (49, 53, 148)),
    (0.375, (69, 116, 180)),
    (0.75, (115, 173, 209)),
    (1.5, (171, 216, 233)),
    (3.0, (223, 242, 248)),
    (6.0, (254, 223, 144)),
    (12.0, (253, 173, 96)),
    (24.0, (243, 108, 67)),
    (48.0, (215, 48, 38)),
    (np.inf, (165, 0, 38)),
)


def end_point_error_abs(uv, uv_target, mask=None, mask_color=(0, 0, 0, 1),
                        nan_color=(0, 0, 0, 1)):
    """Banded absolute-EPE map (H, W, 4) in [0, 1]."""
    epe = np.linalg.norm(np.asarray(uv_target, np.float64) - uv, axis=-1)

    bogus = ~np.isfinite(epe)
    epe = np.nan_to_num(epe)

    rgba = np.zeros((*epe.shape, 4))
    rgba[..., 3] = 1.0
    for threshold, rgb in reversed(_ABS_BANDS):
        rgba[epe < threshold, :3] = np.asarray(rgb) / 255.0

    rgba[bogus] = np.asarray(nan_color, dtype=np.float64)
    if mask is not None:
        rgba[~np.asarray(mask, bool)] = np.asarray(mask_color, dtype=np.float64)

    return rgba


def end_point_error(uv, uv_target, mask=None, ord=2, cmap="gray", vmin=0.0,
                    vmax=None, mask_color=(0, 0, 0, 1)):
    """Colormapped EPE map (H, W, 4); default grayscale, auto-scaled."""
    d = np.linalg.norm(np.asarray(uv_target, np.float64) - uv, axis=-1, ord=ord)

    if mask is not None:
        mask = np.asarray(mask, bool)
        d = d * mask

    rgba = colormaps.apply(cmap, colormaps.normalize(d, vmin, vmax))

    if mask is not None:
        rgba[~mask] = np.asarray(mask_color, dtype=np.float64)

    return rgba
