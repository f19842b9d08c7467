"""Correlation pyramid and windowed lookup in plain torch.

Counterpart of ``raft_meets_dicl_tpu/ops/corr.py`` (the parts on the
``raft/baseline`` and ``raft/fs`` paths). Same conventions: features NHWC
``(B, H, W, C)``; coords ``(B, H, W, 2)`` pixel positions with channel
0 = x, 1 = y; the per-level lookup windows are ``(dy, dx)``-ordered, and
the flat channel contract (``window_delta``, the motion encoder's first
conv) is ``(level, dx, dy)``.

Each pyramid level is one batched matmul against a pooled frame-2 map
(pooling commutes with the dot product). The bilinear window lookup is
the same hat-weight contraction as the JAX package: it equals
``F.grid_sample(align_corners=True, padding_mode='zeros')`` and needs no
coordinate normalization (exact on 1-pixel levels too).
"""

import math

import torch

from .quant import QuantizedLevel, zero_point


def _pool2x_spatial(fmap):
    """Average-pool the H, W axes of a (B, H, W, C) feature map by 2
    (floor semantics like ``F.avg_pool2d``). Accumulates in float32."""
    b, h, w, c = fmap.shape
    x = fmap[:, : h // 2 * 2, : w // 2 * 2].float()
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return x.to(fmap.dtype)


def correlation_pyramid_direct(fmap1, fmap2, num_levels=4, dtype=None):
    """Pyramid of all-pairs volumes ``(B, H, W, H2_l, W2_l)`` against
    progressively pooled frame-2 maps.

    Each level is a matmul in the feature dtype (bf16 under the mixed
    policy: float32 accumulation, one rounding), scaled by 1/sqrt(C) in
    float32 and cast to ``dtype``.
    """
    b, h, w, c = fmap1.shape
    scale = 1.0 / math.sqrt(c)
    f1 = fmap1.reshape(b, h * w, c)

    pyramid = []
    f2 = fmap2
    for lvl in range(num_levels):
        h2, w2 = f2.shape[1:3]
        corr = torch.matmul(f1, f2.reshape(b, h2 * w2, c).transpose(1, 2))
        corr = (corr.float() * scale).reshape(b, h, w, h2, w2)
        pyramid.append(corr.to(dtype) if dtype is not None else corr)
        if lvl + 1 < num_levels:
            f2 = _pool2x_spatial(f2)
    return pyramid


def correlation_volume(fmap1, fmap2_level, dtype=None, normalize=True):
    """Single-level all-pairs volume (B, H1, W1, H2, W2) against one
    (possibly pooled) frame-2 map, accumulated in float32, scaled by
    1/sqrt(C) unless ``normalize`` is False (the ``raft/fs`` convention),
    cast to ``dtype`` (float32 if None).

    An unscaled volume stored in a narrower ``dtype`` is one matmul in
    that dtype (float32 accumulation, one rounding, as the JAX einsum's
    cast); otherwise the matmul runs in float32.
    """
    b, h, w, c = fmap1.shape
    h2, w2 = fmap2_level.shape[1:3]
    f1 = fmap1.reshape(b, h * w, c)
    f2 = fmap2_level.reshape(b, h2 * w2, c)
    narrow = dtype not in (None, torch.float32) and not normalize
    if narrow:
        f1, f2 = f1.to(dtype), f2.to(dtype)
    else:
        f1, f2 = f1.float(), f2.float()
    corr = torch.matmul(f1, f2.transpose(1, 2)).reshape(b, h, w, h2, w2)
    if normalize:
        corr = corr / math.sqrt(c)
    return corr.to(dtype) if dtype is not None else corr


def window_offsets(radius, dtype=torch.float32, device=None):
    """(2r+1,) per-axis window offsets: -r, ..., 0, ..., r."""
    return torch.linspace(-radius, radius, 2 * radius + 1, dtype=dtype,
                          device=device)


def window_delta(radius, dtype=torch.float32, device=None):
    """(K, K, 2) window offsets; axis 0 varies x, axis 1 varies y:
    delta[a, b] = (dx_a, dy_b) (the flat channel order is dx-major)."""
    d = window_offsets(radius, dtype, device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")
    return torch.stack((dx, dy), dim=-1)


def _interp_matrix(positions, size):
    """Bilinear hat weights over an axis: (..., K) positions -> (..., K,
    size) with ``w[..., k, i] = max(0, 1 - |positions[..., k] - i|)``."""
    idx = torch.arange(size, dtype=positions.dtype, device=positions.device)
    return torch.clamp(1.0 - torch.abs(positions[..., None] - idx), min=0.0)


def _lookup_level(corr, x, y):
    """Bilinearly sample a (B, H1, W1, H2, W2) volume at per-position
    windows. x, y: (B, H1, W1, K) pixel positions along W2 / H2. Returns
    (B, H1, W1, K_dy, K_dx) in float32.

    Under the bf16 policy the hat weights are bf16 too and the first
    contraction rounds to bf16, as in the JAX package; the second, tiny
    one runs in float32.

    ``corr`` may be a ``quant.QuantizedLevel`` (the quantized tier): its
    integer values are converted and zero-shifted in bf16 (exact: they are
    integers of at most 8 bits), contracted with bf16 hat weights, t
    rounded to bf16, and the scale multiplies the (B, H1, W1, K, K) output
    once, as in the JAX branch.
    """
    if isinstance(corr, QuantizedLevel):
        values, scale = corr
        b, h1, w1, h2, w2 = values.shape
        k = x.shape[-1]
        wy = _interp_matrix(y, h2).to(torch.bfloat16).reshape(-1, k, h2)
        wx = _interp_matrix(x, w2).to(torch.bfloat16).reshape(-1, k, w2)
        deq = values.to(torch.bfloat16) - zero_point(values)
        t = torch.matmul(wy, deq.reshape(-1, h2, w2))      # bf16
        out = torch.matmul(t.float(), wx.float().transpose(1, 2))
        return out.reshape(b, h1, w1, k, k) * scale

    b, h1, w1, h2, w2 = corr.shape
    k = x.shape[-1]
    wy = _interp_matrix(y, h2).to(corr.dtype).reshape(-1, k, h2)
    wx = _interp_matrix(x, w2).to(corr.dtype).reshape(-1, k, w2)

    t = torch.matmul(wy, corr.reshape(-1, h2, w2))         # (N, K_dy, W2)
    out = torch.matmul(t.float(), wx.float().transpose(1, 2))  # (N, K_dy, K_dx)
    return out.reshape(b, h1, w1, k, k)


def lookup_pyramid_levels(pyramid, coords, radius, mask_costs=(),
                          first_level=0):
    """Windowed lookup, one (B, H, W, K_dy, K_dx) tensor per pyramid level.

    ``mask_costs`` zeroes whole levels by pyramid level id (i + 3, the
    downsampling octave), the reference convention. ``first_level``
    offsets the pyramid: ``pyramid[i]`` is octave ``first_level + i`` for
    its centre scaling and its ``mask_costs`` id (the ``raft/fs`` hybrid
    looks up only the coarse suffix through volumes).
    """
    d = window_offsets(radius, coords.dtype, coords.device)

    out = []
    for i, corr in enumerate(pyramid):
        lvl = first_level + i
        centers = coords / (2**lvl)
        x = centers[..., 0:1] + d  # (B, H, W, K) window positions along W2
        y = centers[..., 1:2] + d  # (B, H, W, K) window positions along H2
        level = _lookup_level(corr, x, y)
        if lvl + 3 in mask_costs:
            level = torch.zeros_like(level)
        out.append(level)

    return out


def flatten_levels(levels):
    """Per-level (dy, dx) windows -> (B, H, W, L*K*K) in the flat
    ``(level, dx, dy)`` channel contract."""
    b, h, w = levels[0].shape[:3]
    return torch.cat([lvl.transpose(3, 4).reshape(b, h, w, -1)
                      for lvl in levels], dim=-1)


def windowed_correlation(fmap1, fmap2_level, coords, radius, scale,
                         normalize=True):
    """On-the-fly windowed correlation, without the volume: for each
    position p with centre c = coords[p] / scale, the dot of f1[p] with
    f2_level bilinearly sampled (zero outside) at c + d for each d of the
    (2r+1)² window. (B, H, W, (2r+1)²) float32, channels (dx, dy)
    row-major; ``normalize`` divides by sqrt(C) (``raft/fs`` skips it).

    The plain per-level form the JAX ``_wcp_reference`` concatenates: the
    sampled window (B, H·W·K², C) is materialized in float32. f2 is read
    as float32 (exact), so the forward equals the JAX function and the
    gradient accumulates in float32, as the kernels' does, and rounds to
    the input dtype once (the JAX autograd of the bf16 gather sums in
    bf16).
    """
    from .sample import sample_bilinear

    b, h, w, c = fmap1.shape
    k = 2 * radius + 1
    delta = window_delta(radius, coords.dtype, coords.device)

    centers = coords[:, :, :, None, None, :] / scale + delta  # (B,H,W,K,K,2)
    x = centers[..., 0].reshape(b, h * w * k * k)
    y = centers[..., 1].reshape(b, h * w * k * k)

    sampled = sample_bilinear(fmap2_level.float(), x, y)
    sampled = sampled.reshape(b, h, w, k * k, c)
    corr = torch.einsum("bhwc,bhwkc->bhwk", fmap1.float(), sampled.float())
    if normalize:
        corr = corr / math.sqrt(c)
    return corr
