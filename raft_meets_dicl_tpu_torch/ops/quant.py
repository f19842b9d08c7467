"""Quantized matching tier: u8 / int8 correlation volumes (inference only).

Counterpart of ``raft_meets_dicl_tpu/ops/quant.py``, the same functions
and arithmetic. The windowed lookup streams the whole volume pyramid
every GRU iteration; the tier stores each level in one byte per element
and dequantizes inside the lookup (``ops/corr.py::_lookup_level``), the
per-sample scale applied once to the small (B, H, W, K, K) window output.

Two modes, both with per-level, per-sample symmetric scales:

- ``u8``: the pyramid is computed as the full-precision tier computes it,
  then each level is mapped onto the u8 grid with zero point 128:
  ``q = round(c / s) + 128``, ``c ≈ (q - 128) · s``.
- ``i8``: the correlation itself is an int8 dot. The features are
  range-equalized per (sample, channel) (``g1 = f1 / a``, ``g2 = f2 · a``
  with ``a = sqrt(amax|f1| / amax|f2|)`` leaves every dot unchanged),
  quantized to int8 per sample, contracted with exact integer
  accumulation, dequantized by the product of the scales, and each level
  is requantized to i8 for storage.

The int8 dot is an integer GEMM (``torch._int_mm``, int8 operands and
int32 accumulation: Hopper's int8 tensor cores on the card), so it is
exact whatever the process's TF32 switches say and touches none of them:
serving runs it on its dispatch thread beside other threads. On the card
the GEMM wants 2-D operands with more than 16 rows and the contraction
and column counts multiples of 8, so the operands are zero-padded up to
that (the coarse levels have 713 or 179 columns at 368x496) and the
padding cut off the result. The int32 result is returned as float32,
exact while every value stays below 2^24: C · 127² < 2^24 for C <= 1,040.

``torch.round`` rounds half to even, as ``jnp.round`` does. No autograd
path: training stays on the full-precision tier.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

#: quantized-volume modes accepted by ``normalize_mode``
MODES = ("u8", "i8")

#: guard against all-zero levels (synthetic inputs, masked costs)
_EPS = 1e-12

# the largest channel count whose int8 dot stays exact in float32
_EXACT_MAX_CHANNELS = (2**24 - 1) // (127 * 127)
# the card's int8 GEMM: rows above 16, contraction and columns multiples
# of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def normalize_mode(mode):
    """Canonicalize a quant-mode spec to ``'u8'``, ``'i8'``, or ``None``.

    Accepts the CLI/env spellings (``'u8'``/``'uint8'``,
    ``'i8'``/``'int8'``/``'s8'``, and ``'off'``/``'none'``/``'0'``/empty
    for disabled); ``True`` means the default mode (``'u8'``). Raises
    ``ValueError`` on anything else.
    """
    if mode is None or mode is False:
        return None
    if mode is True:
        return "u8"
    m = str(mode).strip().lower()
    if m in ("", "0", "off", "none", "false"):
        return None
    if m in ("u8", "uint8"):
        return "u8"
    if m in ("i8", "int8", "s8"):
        return "i8"
    raise ValueError(
        f"unknown quantization mode {mode!r}: expected one of "
        f"{MODES + ('off',)}")


class QuantizedLevel(NamedTuple):
    """One quantized pyramid level: integer values plus dequant scale. The
    zero point is implied by the dtype: 128 for uint8, 0 for int8."""

    values: torch.Tensor  # (B, H1, W1, H2, W2) uint8 or int8
    scale: torch.Tensor   # (B, 1, 1, 1, 1) float32, symmetric step size


def zero_point(values):
    """The implied zero point of a quantized tensor: 128 for u8, 0 for i8."""
    return 128 if values.dtype == torch.uint8 else 0


def _symmetric_scale(x, axes, clip):
    """Per-sample symmetric step size: ``clip * amax / 127`` over ``axes``."""
    amax = x.abs().amax(dim=axes, keepdim=True)
    return torch.clamp(amax * clip, min=_EPS) / 127.0


def quantize_level(corr, mode, clip=1.0):
    """Quantize one (B, H1, W1, H2, W2) volume level to a QuantizedLevel.

    Symmetric per-sample scale (a batch mixes unrelated requests). ``clip``
    shrinks the mapped range to a fraction of the observed abs-max; values
    beyond it saturate.
    """
    mode = normalize_mode(mode)
    if mode is None:
        raise ValueError("quantize_level requires an explicit mode")
    corr32 = corr.float()
    scale = _symmetric_scale(corr32, (1, 2, 3, 4), clip)
    q = torch.round(corr32 / scale)
    if mode == "u8":
        values = torch.clamp(q + 128.0, 0.0, 255.0).to(torch.uint8)
    else:
        values = torch.clamp(q, -127.0, 127.0).to(torch.int8)
    return QuantizedLevel(values=values, scale=scale)


def dequantize_level(level, dtype=torch.float32):
    """Reconstruct the float volume: ``(q - zero_point) * scale``."""
    deq = level.values.float() - zero_point(level.values)
    return (deq * level.scale).to(dtype)


def quantize_pyramid(pyramid, mode, clip=1.0):
    """Quantize every level of a volume pyramid (the ``u8`` tier path)."""
    return [quantize_level(corr, mode, clip=clip) for corr in pyramid]


def _quantize_features(fmap, clip):
    """Per-sample int8 feature quantization for the i8 correlation dots:
    ``(q, s)`` with q int8 (B, H, W, C) and s (B, 1, 1, 1)."""
    f = fmap.float()
    scale = _symmetric_scale(f, (1, 2, 3), clip)
    q = torch.clamp(torch.round(f / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _int8_dot(q1, q2):
    """All-pairs int8 dot (B, H, W, H2, W2): int32 accumulation of the
    int8 products (``torch._int_mm``), returned as float32 (every value an
    integer below 2^24)."""
    b, h, w, c = q1.shape
    h2, w2 = q2.shape[1:3]
    if c > _EXACT_MAX_CHANNELS:
        raise ValueError(f"int8 correlation: C = {c} exceeds the "
                         f"{_EXACT_MAX_CHANNELS} channels an exact float32 "
                         "result allows")
    m, n = h * w, h2 * w2
    a = q1.reshape(b, m, c)
    bt = q2.reshape(b, n, c)
    if a.is_cuda:
        pad_c = -c % _INT_MM_MULTIPLE
        a = F.pad(a, (0, pad_c, 0, max(_INT_MM_MIN_ROWS - m, 0)))
        bt = F.pad(bt, (0, pad_c, 0, -n % _INT_MM_MULTIPLE))
    acc = torch.empty((b, a.shape[1], bt.shape[1]), dtype=torch.int32,
                      device=a.device)
    for i in range(b):
        # (m, C) x (C, n), the right operand column-major
        torch._int_mm(a[i].contiguous(), bt[i].contiguous().t(), out=acc[i])
    return acc[:, :m, :n].float().reshape(b, h, w, h2, w2)


def correlation_pyramid_int8(fmap1, fmap2, num_levels=4, normalize=True,
                             clip=1.0):
    """All-pairs pyramid where the correlation itself runs as int8 dots:
    the quantized twin of ``corr.correlation_pyramid_direct`` (one dot
    against a progressively pooled frame-2 map a level), returning one
    i8 ``QuantizedLevel`` a level.

    Pooling runs on the float equalized maps, so each level's dot sees a
    freshly quantized pooled map.
    """
    from .corr import _pool2x_spatial

    f1 = fmap1.float()
    g2 = fmap2.float()
    c = f1.shape[-1]

    # per-(sample, channel) range equalizer over the spatial axes
    m1 = f1.abs().amax(dim=(1, 2), keepdim=True)
    m2 = g2.abs().amax(dim=(1, 2), keepdim=True)
    a = torch.sqrt(torch.clamp(m1, min=_EPS) / torch.clamp(m2, min=_EPS))
    g1 = f1 / a
    g2 = g2 * a

    # a 0-d CPU tensor: it combines with tensors on any device
    norm = (1.0 / torch.sqrt(torch.tensor(c, dtype=torch.float32))
            if normalize else torch.tensor(1.0))
    q1, s1 = _quantize_features(g1, clip)

    pyramid = []
    for lvl in range(num_levels):
        q2, s2 = _quantize_features(g2, clip)
        corr = _int8_dot(q1, q2) * (s1 * s2 * norm)[..., None]
        pyramid.append(quantize_level(corr, "i8", clip=clip))
        if lvl + 1 < num_levels:
            g2 = _pool2x_spatial(g2)
    return pyramid

