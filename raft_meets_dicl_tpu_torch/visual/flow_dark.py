"""Dark-background flow color coding after Bruhn (2006).

Hue encodes direction (piecewise-remapped to emphasize horizontal motion),
value encodes magnitude on black. Own copy of
``raft_meets_dicl_tpu/visual/flow_dark.py`` (host-side numpy; reference
src/visual/flow_dark.py:9).
"""

import warnings

import numpy as np


def _hsv_to_rgb(h, s, v):
    """Vectorized HSV → RGB, all inputs/outputs in [0, 1]."""
    i = np.floor(h * 6.0).astype(np.int64) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    lut = np.stack([
        np.stack([v, t, p], -1),
        np.stack([q, v, p], -1),
        np.stack([p, v, t], -1),
        np.stack([p, q, v], -1),
        np.stack([t, p, v], -1),
        np.stack([v, p, q], -1),
    ], 0)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]


def flow_to_rgba(uv, mask=None, mrm=None, gamma=1.0, transform=None,
                 mask_color=(0, 0, 0, 1), nan_color=(0, 0, 0, 1)):
    """Color-code a flow field (H, W, 2) as RGBA on a dark background.

    ``transform`` may be 'log' or 'loglog' to compress the magnitude scale.
    """
    if transform not in (None, "log", "loglog"):
        raise ValueError("invalid value for parameter 'transform'")

    uv = np.array(uv, dtype=np.float64)
    u, v = uv[..., 0], uv[..., 1]

    if mask is not None:
        mask = np.asarray(mask, bool)
        u = np.where(mask, u, 0.0)
        v = np.where(mask, v, 0.0)

    bogus = ~(np.isfinite(u) & np.isfinite(v))
    if bogus.any():
        warnings.warn("encountered non-finite values in flow field",
                      RuntimeWarning, stacklevel=2)
        u = np.where(bogus, 0.0, u)
        v = np.where(bogus, 0.0, v)

    length = np.hypot(u, v) ** gamma
    if mrm is None:
        mrm = float(np.max(length if mask is None else length * mask)) or 1.0

    # direction → hue: [0,90)° stretches over 60 hue-degrees, [90,180) over
    # the next 60, [180,360) over the remaining 240 (Bruhn's remapping)
    deg = np.rad2deg(-np.arctan2(v, u)) % 360.0
    hue = np.where(
        deg < 90.0, deg * (60.0 / 90.0),
        np.where(deg < 180.0, (deg - 90.0) * (60.0 / 90.0) + 60.0,
                 (deg - 180.0) * (240.0 / 180.0) + 120.0),
    ) / 360.0

    value = length / mrm
    for _ in range(("log", "loglog").index(transform) + 1 if transform else 0):
        value = np.log10(9.0 * value + 1.0)
    value = np.clip(value, 0.0, 1.0)

    rgb = _hsv_to_rgb(hue, np.ones_like(hue), value)

    rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    rgba[bogus] = np.asarray(nan_color, dtype=np.float64)
    if mask is not None:
        rgba[~mask] = np.asarray(mask_color, dtype=np.float64)

    return rgba
