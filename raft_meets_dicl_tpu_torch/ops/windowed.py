"""Windowed correlation pyramid (``raft/fs``): per position and level, the
dot of f1 with f2_l bilinearly sampled on the (2r+1)² window around
coords / 2^l, without the all-pairs volume. Forward and both backward
halves (df1, df2) are hand-written CUDA kernels for Hopper.

Counterpart of ``raft_meets_dicl_tpu/ops/pallas.py::windowed_corr_pyramid``
(the Pallas kernels behind ``_wcp_fwd_tpu`` and ``_wcp_bwd_tpu``, paired by
the ``_wcp`` custom VJP; plain version ``_wcp_reference``); the kernel
sources, their bound and their design are in ``csrc/windowed_corr.cu``.

Layout contract (the JAX one): f1 (B, H, W, C); f2_levels a sequence of
(B, H/2^l, W/2^l, C) maps in f1's dtype, level 0 at f1's resolution;
coords (B, H, W, 2) level-0 pixel positions, channel 0 = x. The output is
(B, H, W, L·(2r+1)²) float32, channels in (level, dx, dy) order.

On CUDA tensors ``windowed_corr_pyramid`` launches the forward kernel
(once for all levels) or raises, and its gradient launches the df1 kernel
once and the df2 kernel once per level (``_WindowedCorrPyramid``); coords
get no gradient, as every caller detaches the lookup centres. On CPU
tensors it computes the plain version, ``windowed_corr_pyramid_reference``,
whose autograd is the backward there. ``launches``, ``df1_launches`` and
``df2_launches`` count kernel launches (CPU calls do not count).

The kernels take 8x8 tiles of positions; ``tile_paths`` says which tiles
take each kernel's tile path (its side limit: ``MAX_BOX``, or 0 for the
float32 forward and df1, which have none), and the launches count the
same on the card when given ``path_counts``.
"""

import ctypes
import math

import torch

from . import cuda_build
from .corr import windowed_correlation

# the radius the kernels are instantiated for: every shipped config's
# corr-radius. Another radius needs its instantiation in the source and a
# chip_smoke.py case that holds it against the plain version
KERNEL_RADIUS = 4
# the most pyramid levels one launch takes
KERNEL_MAX_LEVELS = 6
# the kernels' tiles (positions a side) and the largest bounding box side
# of a tile's taps that they take down their tile paths
# (csrc/windowed_corr.cu): df2 adds such a tile on the chip first, the
# bfloat16 forward and df1 contract it on the tensor cores, one box row of
# 48 bf16 pixels of 256 channels (about 25 KB) a stage of their
# shared-memory ring. A wider box takes the per-position (direct) path for
# that tile and level; the float32 forward and df1 have no tile path (side
# limit 0)
TILE = 8
MAX_BOX = 48

# kernel launches made by this process (forward, df1, df2); reset freely
launches = 0
df1_launches = 0
df2_launches = 0


def windowed_corr_pyramid_reference(f1, f2_levels, coords, radius):
    """Plain PyTorch version (the JAX ``_wcp_reference``): the per-level
    unnormalized ``windowed_correlation`` at coords / 2^l, concatenated.
    (B, H, W, L·K²) float32. Used for CPU tensors and as the kernels'
    reference; its autograd is the backward's reference.

    f1 is read as float32 once for all levels, so df1 sums the levels in
    float32 and rounds to f1's dtype once, as the kernels do."""
    f1 = f1.float()
    return torch.cat([
        windowed_correlation(f1, f2, coords, radius, float(2 ** lvl),
                             normalize=False)
        for lvl, f2 in enumerate(f2_levels)], dim=-1)


def _library():
    lib = cuda_build.load("windowed_corr")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.wcp_fwd_f32, lib.wcp_fwd_bf16, lib.wcp_df1_f32,
               lib.wcp_df1_bf16):
        # (f1 or dout, f2 pointers, (h2, w2) per level, n_levels, coords,
        #  out, b, h, w, c, radius, path_counts or None, stream)
        fn.argtypes = [ptr, ctypes.POINTER(ptr), ctypes.POINTER(i32), i32,
                       ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
        fn.restype = i32
    for fn in (lib.wcp_df2_f32, lib.wcp_df2_bf16):
        # (dout, f1, coords, df2, level, n_levels, h2, w2, b, h, w, c,
        #  radius, path_counts or None, stream)
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 9 + [ptr, ptr]
        fn.restype = i32
    return lib


def _check_inputs(f1, f2_levels, coords, radius):
    if f1.device.type != "cuda":
        raise ValueError(f"windowed_corr_pyramid: the kernels take CUDA "
                         f"tensors, got {f1.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"windowed_corr_pyramid: features must be float32 or "
                        f"bfloat16, got {f1.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"windowed_corr_pyramid: coords must be float32, got "
                        f"{coords.dtype}")
    if radius != KERNEL_RADIUS:
        raise ValueError(f"windowed_corr_pyramid: the kernels are built for "
                         f"radius {KERNEL_RADIUS}, got {radius}")
    if not 1 <= len(f2_levels) <= KERNEL_MAX_LEVELS:
        raise ValueError(f"windowed_corr_pyramid: the kernels take 1 to "
                         f"{KERNEL_MAX_LEVELS} levels, got {len(f2_levels)}")
    b, h, w, c = f1.shape
    if c % 32:
        raise ValueError(f"windowed_corr_pyramid: the kernels take a channel "
                         f"count that is a multiple of 32, got {c}")
    if tuple(coords.shape) != (b, h, w, 2) or coords.device != f1.device:
        raise ValueError(f"windowed_corr_pyramid: coords {tuple(coords.shape)}"
                         f" on {coords.device}, expected {(b, h, w, 2)} on "
                         f"{f1.device}")
    for f2 in f2_levels:
        if f2.dim() != 4 or f2.shape[0] != b or f2.shape[3] != c \
                or f2.dtype != f1.dtype or f2.device != f1.device:
            raise ValueError(f"windowed_corr_pyramid: level {tuple(f2.shape)} "
                             f"{f2.dtype} on {f2.device} does not match f1 "
                             f"{tuple(f1.shape)} {f1.dtype}")
        # the kernels index with 32-bit integers within an image, 64-bit
        # across the batch
        if f2.shape[1] * f2.shape[2] * c >= 2**31:
            raise ValueError("windowed_corr_pyramid: one image's level "
                             "exceeds 2^31 elements")


def _level_args(f2_levels):
    n = len(f2_levels)
    ptrs = (ctypes.c_void_p * n)(*(f2.data_ptr() for f2 in f2_levels))
    dims = (ctypes.c_int * (2 * n))(*(d for f2 in f2_levels
                                      for d in f2.shape[1:3]))
    return ptrs, dims


def _run(fn, device, *args):
    """Call a kernel entry point on PyTorch's current stream of ``device``
    and raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"windowed_corr_pyramid: kernel launch failed "
                           f"with CUDA error {err}")


def _kernel(lib, name, dtype):
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    return getattr(lib, f"{name}_{suffix}")


def _path_counts_arg(path_counts, levels, device):
    """The kernels' path_counts pointer (None: not counted): ``levels``
    rows of 3 contiguous int32 values on ``device``."""
    if path_counts is None:
        return None
    if path_counts.dtype != torch.int32 \
            or path_counts.numel() != 3 * levels \
            or path_counts.device != device \
            or not path_counts.is_contiguous():
        raise ValueError(f"windowed_corr_pyramid: path_counts must be "
                         f"{levels} x 3 contiguous int32 values on {device}")
    return path_counts.data_ptr()


def _launch(f1, f2_levels, coords, radius, path_counts=None):
    """Run the forward kernel over all levels: (B, H, W, L·K²) float32.
    With ``path_counts`` (an int32 CUDA tensor of L x 3 values) the kernel
    adds each level's tiles per path: tile, per-position, no in-bounds tap
    (the rule of ``tile_paths`` at ``MAX_BOX`` for bfloat16 inputs, 0 for
    float32)."""
    global launches

    _check_inputs(f1, f2_levels, coords, radius)
    counts = _path_counts_arg(path_counts, len(f2_levels), f1.device)
    f1, coords = cuda_build.aligned(f1), coords.contiguous()
    f2_levels = [cuda_build.aligned(f2) for f2 in f2_levels]
    b, h, w, c = f1.shape
    k = 2 * radius + 1
    out = torch.empty((b, h, w, len(f2_levels) * k * k), dtype=torch.float32,
                      device=f1.device)
    ptrs, dims = _level_args(f2_levels)
    _run(_kernel(_library(), "wcp_fwd", f1.dtype), f1.device, f1.data_ptr(),
         ptrs, dims, len(f2_levels), coords.data_ptr(), out.data_ptr(), b, h,
         w, c, radius, counts)
    launches += 1
    return out


def _launch_df1(dout, f1, f2_levels, coords, radius, path_counts=None):
    """Run the df1 kernel: ``dout`` (B, H, W, L·K²) -> df1 (B, H, W, C)
    float32, summed over the levels (one launch). ``path_counts`` as for
    ``_launch``."""
    global df1_launches

    _check_inputs(f1, f2_levels, coords, radius)
    counts = _path_counts_arg(path_counts, len(f2_levels), f1.device)
    dout = cuda_build.aligned(dout.float())
    coords = coords.contiguous()
    f2_levels = [cuda_build.aligned(f2) for f2 in f2_levels]
    b, h, w, c = f1.shape
    k = 2 * radius + 1
    if tuple(dout.shape) != (b, h, w, len(f2_levels) * k * k):
        raise ValueError(f"windowed_corr_pyramid backward: dout "
                         f"{tuple(dout.shape)}, expected "
                         f"{(b, h, w, len(f2_levels) * k * k)}")
    df1 = torch.empty((b, h, w, c), dtype=torch.float32, device=f1.device)
    ptrs, dims = _level_args(f2_levels)
    _run(_kernel(_library(), "wcp_df1", f1.dtype), f1.device,
         dout.data_ptr(), ptrs, dims, len(f2_levels), coords.data_ptr(),
         df1.data_ptr(), b, h, w, c, radius, counts)
    df1_launches += 1
    return df1


def _launch_df2(dout, f1, f2, coords, level, n_levels, radius,
                path_counts=None):
    """Run the df2 kernel for one level ``f2`` (only its shape is read):
    ``dout`` (B, H, W, n_levels·K²) -> df2_level (B, H2, W2, C) float32.
    With ``path_counts`` (an int32 CUDA tensor of 3 values) the kernel
    adds the tiles it took down each path: tile, direct, no in-bounds tap
    (the rule of ``tile_paths`` at ``MAX_BOX``)."""
    global df2_launches

    _check_inputs(f1, [f2], coords, radius)
    counts = _path_counts_arg(path_counts, 1, f1.device)
    f2_shape = tuple(f2.shape)
    dout = cuda_build.aligned(dout.float())
    f1, coords = cuda_build.aligned(f1), coords.contiguous()
    b, h, w, c = f1.shape
    k = 2 * radius + 1
    if tuple(dout.shape) != (b, h, w, n_levels * k * k) \
            or not 0 <= level < n_levels:
        raise ValueError(f"windowed_corr_pyramid backward: dout "
                         f"{tuple(dout.shape)} at level {level} of {n_levels}")
    df2 = torch.zeros(f2_shape, dtype=torch.float32, device=f1.device)
    _run(_kernel(_library(), "wcp_df2", f1.dtype), f1.device,
         dout.data_ptr(), f1.data_ptr(), coords.data_ptr(), df2.data_ptr(),
         level, n_levels, f2_shape[1], f2_shape[2], b, h, w, c, radius,
         counts)
    df2_launches += 1
    return df2


def tile_paths(coords, level, h2, w2, max_box, radius=KERNEL_RADIUS):
    """A kernel's choice of path for every tile of one level, computed from
    the centres as the kernels do: (tiles on the tile path, tiles on the
    per-position or direct path, tiles with no in-bounds tap).

    A tile is TILE x TILE positions of one image; its box is the
    bounding box of its windows' in-bounds taps at this level; it takes
    the tile path when both box sides are at most ``max_box`` pixels
    (``MAX_BOX``; 0 for the float32 forward and df1)."""
    b, h, w, _ = coords.shape
    cxy = coords.float() * (1.0 / 2 ** level)
    cx = cxy[..., 0].clamp(-(radius + 1.0), float(w2 + radius))
    cy = cxy[..., 1].clamp(-(radius + 1.0), float(h2 + radius))
    x0 = torch.floor(cx).long() - radius
    y0 = torch.floor(cy).long() - radius
    taps = 2 * radius + 1
    x_lo, x_hi = x0.clamp(min=0), (x0 + taps).clamp(max=w2 - 1)
    y_lo, y_hi = y0.clamp(min=0), (y0 + taps).clamp(max=h2 - 1)
    live = (x_lo <= x_hi) & (y_lo <= y_hi)
    big = 1 << 40
    t = TILE
    th, tw = -(-h // t), -(-w // t)

    def tile_reduce(v, fill, fn):
        v = torch.where(live, v, torch.full_like(v, fill))
        v = torch.nn.functional.pad(v, (0, tw * t - w, 0, th * t - h),
                                    value=fill)
        v = v.reshape(b, th, t, tw, t)
        return fn(fn(v, dim=4), dim=2)

    top = tile_reduce(y_lo, big, torch.amin)
    bottom = tile_reduce(y_hi, -big, torch.amax)
    left = tile_reduce(x_lo, big, torch.amin)
    right = tile_reduce(x_hi, -big, torch.amax)
    empty = top == big
    fits = (bottom - top + 1 <= max_box) & (right - left + 1 <= max_box)
    return (int((fits & ~empty).sum()), int((~fits & ~empty).sum()),
            int(empty.sum()))


class _WindowedCorrPyramid(torch.autograd.Function):
    """The CUDA triple: forward kernel; backward = df1 kernel + one df2
    kernel per level (the JAX ``_wcp_vjp_fwd`` / ``_wcp_vjp_bwd``). Saves
    f1, the levels and the coords, as the JAX residuals."""

    @staticmethod
    def forward(ctx, f1, coords, radius, *f2_levels):
        ctx.save_for_backward(f1, coords, *f2_levels)
        ctx.radius = radius
        return _launch(f1, f2_levels, coords, radius)

    @staticmethod
    def backward(ctx, dout):
        f1, coords, *f2_levels = ctx.saved_tensors
        r = ctx.radius
        df1 = _launch_df1(dout, f1, f2_levels, coords, r).to(f1.dtype)
        df2 = [_launch_df2(dout, f1, f2, coords, lvl, len(f2_levels),
                           r).to(f2.dtype)
               for lvl, f2 in enumerate(f2_levels)]
        return (df1, None, None, *df2)


def windowed_corr_pyramid(f1, f2_levels, coords, radius=4, mask_costs=(),
                          normalize=True):
    """Multi-level windowed correlation (B, H, W, L·(2r+1)²) float32,
    channels (level, dx, dy), level l sampled at coords / 2^l with zero
    padding; the same function as ``lookup_pyramid`` over the all-pairs
    volume pyramid, without the volume.

    ``normalize`` divides f1 by sqrt(C) first (rounded to f1's dtype, as
    the JAX function does); ``raft/fs`` passes False. ``mask_costs``
    zeroes whole levels by pyramid level id (l + 3). Differentiable in f1
    and the levels; coords get no gradient. On CUDA tensors the kernels
    run, on CPU tensors the plain version.
    """
    c = f1.shape[-1]
    k = 2 * radius + 1
    if normalize:
        f1 = (f1 / math.sqrt(c)).to(f1.dtype)
    coords = coords.detach()

    if f1.device.type == "cpu":
        out = windowed_corr_pyramid_reference(f1, f2_levels, coords, radius)
    elif f1.device.type == "cuda":
        out = _WindowedCorrPyramid.apply(f1, coords, radius, *f2_levels)
    else:
        raise ValueError(f"windowed_corr_pyramid: unsupported device "
                         f"{f1.device}")

    if mask_costs:
        keep = torch.cat([
            torch.full((k * k,), 0.0 if lvl + 3 in mask_costs else 1.0,
                       device=out.device)
            for lvl in range(len(f2_levels))])
        out = out * keep
    return out
