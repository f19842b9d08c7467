"""Middlebury optical-flow color coding.

Implements the color wheel of Baker et al., "A Database and Evaluation
Methodology for Optical Flow" (ICCV 2007) as published in the Middlebury
flow-code C++ reference (vision.middlebury.edu/flow/code/flow-code/).
Own copy of ``raft_meets_dicl_tpu/visual/flow_mb.py`` (host-side numpy).
"""

import warnings

import numpy as np

# (count, from-RGB, to-RGB) hue segments; counts follow the published
# Middlebury code (chosen there for perceptual uniformity)
_SEGMENTS = (
    (15, (1, 0, 0), (1, 1, 0)),   # red → yellow
    (6, (1, 1, 0), (0, 1, 0)),    # yellow → green
    (4, (0, 1, 0), (0, 1, 1)),    # green → cyan
    (11, (0, 1, 1), (0, 0, 1)),   # cyan → blue
    (13, (0, 0, 1), (1, 0, 1)),   # blue → magenta
    (6, (1, 0, 1), (1, 0, 0)),    # magenta → red
)

_WHEEL = None


def color_wheel():
    global _WHEEL
    if _WHEEL is None:
        parts = []
        for count, lo, hi in _SEGMENTS:
            t = np.arange(count, dtype=np.float64)[:, None] / count
            parts.append((1.0 - t) * np.asarray(lo) + t * np.asarray(hi))
        _WHEEL = np.concatenate(parts, axis=0)
    return _WHEEL


def flow_to_rgba(uv, mask=None, mrm=None, gamma=1.0, eps=1e-5,
                 mask_color=(0, 0, 0, 1), nan_color=(0, 0, 0, 1)):
    """Color-code a flow field (H, W, 2) as RGBA floats in [0, 1].

    ``mrm`` fixes the maximum range of motion used for normalization (so
    estimate and ground truth can share a scale); ``mask`` marks valid
    pixels; non-finite flow is rendered in ``nan_color`` with a warning.
    """
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

    radius = np.hypot(u, v) ** gamma
    if mrm is None:
        mrm = max(float(np.max(radius if mask is None else radius * mask)), eps)
    radius = np.clip(radius / mrm, 0.0, 1.0)

    wheel = color_wheel()
    n = wheel.shape[0]

    # angle in [-1, 1] → fractional wheel index; linear interpolation with
    # wrap-around between adjacent wheel entries
    angle = np.arctan2(-v, -u) / np.pi
    pos = (angle + 1.0) / 2.0 * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = (lo + 1) % n
    frac = (pos - lo)[..., None]

    rgb = (1.0 - frac) * wheel[lo] + frac * wheel[hi]

    # desaturate towards white for small motion
    rgb = 1.0 - radius[..., None] * (1.0 - rgb)

    rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
    rgba[bogus] = np.asarray(nan_color, dtype=np.float64)
    if mask is not None:
        rgba[~mask] = np.asarray(mask_color, dtype=np.float64)

    return rgba
