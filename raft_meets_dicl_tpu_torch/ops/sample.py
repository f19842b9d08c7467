"""DICL window sampling: the (2r+1)² displaced feature window around each
lookup centre, bilinearly sampled with zero padding, forward and backward
as hand-written CUDA kernels for Hopper.

Counterpart of ``raft_meets_dicl_tpu/ops/sample.py::sample_window`` (the
plain version) and ``raft_meets_dicl_tpu/ops/pallas.py::
sample_window_fused`` (the Pallas kernels ``_sw_fwd_kernel`` and
``_sw_bwd_kernel``, paired by its ``custom_vjp``); the kernel sources,
their bound and their design are in ``csrc/sample_window.cu``.

Layout contract (the JAX one): f2 (B, H2, W2, C); coords (B, H, W, 2)
pixel positions into f2's grid, channel 0 = x; the window is
(B, du, dv, H, W, C) with du varying dx, i.e. ``out[b, du, dv, y, x]``
samples f2 at ``coords[b, y, x] + (du - r, dv - r)``. That is contiguous
(B·K², H, W, C), so ``permute(0, 3, 1, 2)`` of its (B·K², H, W, C) view is
a channels_last NCHW tensor the matching net convolves without a copy.
The window has f2's dtype and is computed in float32 (one rounding).

On a CUDA tensor ``sample_window_fused`` launches the forward kernel or
raises, and the gradient launches the backward kernel (``_SampleWindow``
saves the coords and f2's shape; coords get no gradient, as every caller
detaches the lookup centres). On a CPU tensor it computes the plain
version, ``sample_window``, whose autograd is the backward there.
``launches`` and ``bwd_launches`` count kernel launches (CPU calls do not
count), so a run can show that its path went through the kernels.

``sample_bilinear`` (JAX ``ops/sample.py::sample_bilinear``) is plain
PyTorch: the windowed correlation's plain version samples with it.
"""

import ctypes

import torch

from . import cuda_build

# the radius the kernels are instantiated for: every shipped config's
# corr-radius. Another radius needs its instantiation in the source and a
# chip_smoke.py case that holds it against the plain version
KERNEL_RADIUS = 4

# kernel launches made by this process (forward, backward); reset freely
launches = 0
bwd_launches = 0


def sample_bilinear(img, x, y):
    """Sample ``img`` (B, H, W, C) at pixel positions ``x``, ``y`` (B, N)
    with zero padding outside: ``F.grid_sample(align_corners=True,
    padding_mode='zeros')`` semantics, the four corner terms summed in the
    JAX ``ops/sample.py::sample_bilinear`` order. Returns (B, N, C), float32
    for float32 positions (the corner values are promoted, as in JAX)."""
    b, h, w, c = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1
    y1 = y0 + 1

    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    flat = img.reshape(b, h * w, c)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * inb[..., None]

    return (gather(x0, y0) * (wx0 * wy0)[..., None]
            + gather(x1, y0) * (wx1 * wy0)[..., None]
            + gather(x0, y1) * (wx0 * wy1)[..., None]
            + gather(x1, y1) * (wx1 * wy1)[..., None])


def sample_window(f2, coords, radius):
    """Plain PyTorch version: gather the (K+1)² integer patch at each
    centre, then two lerps over the shared bilinear fractions (y first,
    then x). f2 (B, H2, W2, C), coords (B, H, W, 2) -> (B, K, K, H, W, C)
    in f2's dtype. Used for CPU tensors and as the kernels' reference.

    Centres are clamped to [-(r+1), dim + r] first, as the TPU kernel's
    ``_wcp_window`` does: a window that lies wholly outside stays wholly
    outside (exact zeros) and the integer conversion cannot overflow.
    """
    b, h, w = coords.shape[:3]
    h2, w2, c = f2.shape[-3:]
    k = 2 * radius + 1
    t = k + 1

    cx = coords[..., 0].reshape(b, -1).float().clamp(-(radius + 1.0),
                                                     w2 + float(radius))
    cy = coords[..., 1].reshape(b, -1).float().clamp(-(radius + 1.0),
                                                     h2 + float(radius))
    x0f = torch.floor(cx)
    y0f = torch.floor(cy)
    fx = (cx - x0f)[:, None, None, :, None]          # (B, 1, 1, P, 1)
    fy = (cy - y0f)[:, None, None, :, None]

    # tap axes ordered (tx, ty) so the lerped output is (dx, dy)-major
    taps = torch.arange(t, device=f2.device)
    ix = (x0f.long() - radius)[:, None, None, :] + taps[None, :, None, None]
    iy = (y0f.long() - radius)[:, None, None, :] + taps[None, None, :, None]
    inb = (ix >= 0) & (ix <= w2 - 1) & (iy >= 0) & (iy <= h2 - 1)
    idx = iy.clamp(0, h2 - 1) * w2 + ix.clamp(0, w2 - 1)   # (B, T, T, P)

    flat = f2.float().reshape(b, h2 * w2, c)
    patch = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    patch = patch.reshape(b, t, t, h * w, c)
    patch = torch.where(inb[..., None], patch, patch.new_zeros(()))

    ylerp = (1.0 - fy) * patch[:, :, 0:k] + fy * patch[:, :, 1:t]
    win = (1.0 - fx) * ylerp[:, 0:k] + fx * ylerp[:, 1:t]
    return win.reshape(b, k, k, h, w, c).to(f2.dtype)


def _library():
    lib = cuda_build.load("sample_window")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.sample_window_fwd_f32, lib.sample_window_fwd_bf16,
               lib.sample_window_bwd_f32, lib.sample_window_bwd_bf16):
        # (input, coords, output, b, h2, w2, c, h, w, radius, stream)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(x, f2_shape, coords, radius):
    """Checks shared by both kernels: ``x`` is f2 (forward) or the window
    gradient (backward); both carry f2's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"sample_window: the kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sample_window: f2 must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"sample_window: coords must be float32, got "
                        f"{coords.dtype}")
    if coords.device != x.device:
        raise ValueError(f"sample_window: f2 on {x.device}, coords on "
                         f"{coords.device}")
    if len(f2_shape) != 4 or coords.dim() != 4 or coords.shape[-1] != 2 \
            or coords.shape[0] != f2_shape[0]:
        raise ValueError(f"sample_window: f2 {tuple(f2_shape)} must be "
                         f"(B, H2, W2, C) and coords {tuple(coords.shape)} "
                         f"(B, H, W, 2)")
    if not (x.is_contiguous() and coords.is_contiguous()):
        raise ValueError("sample_window: inputs must be contiguous")
    if radius != KERNEL_RADIUS:
        raise ValueError(f"sample_window: the kernels are built for radius "
                         f"{KERNEL_RADIUS}, got {radius}")
    # the kernels index with 32-bit integers within an image, 64-bit
    # across the batch
    _, h2, w2, c = f2_shape
    h, w = coords.shape[1:3]
    if max(h2 * w2 * c, h * w * c * (2 * radius + 1) ** 2) >= 2**31:
        raise ValueError("sample_window: one image's window exceeds 2^31 "
                         "elements")


def _run(fn, device, *args):
    """Call a kernel entry point on PyTorch's current stream of ``device``
    and raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"sample_window: kernel launch failed with CUDA "
                           f"error {err}")


def _launch(f2, coords, radius):
    """Run the forward kernel: f2 (B, H2, W2, C), coords (B, H, W, 2) ->
    window (B, K, K, H, W, C) in f2's dtype."""
    global launches

    _check_inputs(f2, f2.shape, coords, radius)
    lib = _library()
    fn = (lib.sample_window_fwd_bf16 if f2.dtype == torch.bfloat16
          else lib.sample_window_fwd_f32)
    b, h2, w2, c = f2.shape
    h, w = coords.shape[1:3]
    k = 2 * radius + 1
    out = torch.empty((b, k, k, h, w, c), dtype=f2.dtype, device=f2.device)
    _run(fn, f2.device, f2.data_ptr(), coords.data_ptr(), out.data_ptr(),
         b, h2, w2, c, h, w, radius)
    launches += 1
    return out


def _launch_bwd(dout, coords, f2_shape, radius):
    """Run the backward kernel: the window's gradient ``dout`` (B, K, K, H,
    W, C) in f2's dtype and the saved coords -> ``df2`` (B, H2, W2, C)
    float32, every tap's share added with one atomic per position and
    channel. The caller casts it to f2's dtype."""
    global bwd_launches

    cuda_build.refuse_if_deterministic(
        "the sample_window backward kernel (csrc/sample_window.cu)")
    _check_inputs(dout, f2_shape, coords, radius)
    b, h2, w2, c = f2_shape
    k = 2 * radius + 1
    h, w = coords.shape[1:3]
    if tuple(dout.shape) != (b, k, k, h, w, c):
        raise ValueError(f"sample_window backward: window gradient shape "
                         f"{tuple(dout.shape)}, expected {(b, k, k, h, w, c)}")

    lib = _library()
    fn = (lib.sample_window_bwd_bf16 if dout.dtype == torch.bfloat16
          else lib.sample_window_bwd_f32)
    df2 = torch.zeros((b, h2, w2, c), dtype=torch.float32,
                      device=dout.device)
    _run(fn, dout.device, dout.data_ptr(), coords.data_ptr(), df2.data_ptr(),
         b, h2, w2, c, h, w, radius)
    bwd_launches += 1
    return df2


class _SampleWindow(torch.autograd.Function):
    """The CUDA pair: forward kernel, backward kernel. Saves the coords
    (the JAX residuals are ``(f2, coords)``; the backward needs only f2's
    shape and dtype)."""

    @staticmethod
    def forward(ctx, f2, coords, radius):
        ctx.save_for_backward(coords)
        ctx.f2_meta = (tuple(f2.shape), f2.dtype)
        ctx.radius = radius
        return _launch(f2, coords, radius)

    @staticmethod
    def backward(ctx, dout):
        (coords,) = ctx.saved_tensors
        shape, dtype = ctx.f2_meta
        df2 = _launch_bwd(dout.to(dtype).contiguous(), coords, shape,
                          ctx.radius)
        return df2.to(dtype), None, None


def sample_window_fused(f2, coords, radius=4):
    """The (2r+1)² displaced window of f2 around each centre, (B, du, dv,
    H, W, C) in f2's dtype (computed in float32), zero outside f2.

    Differentiable in f2; coords get no gradient (every caller detaches
    the lookup centres). On CUDA tensors the kernel pair runs (on
    contiguous copies of strided inputs), on CPU tensors the plain version.
    """
    if f2.device.type == "cpu":
        return sample_window(f2, coords.detach(), radius)
    if f2.device.type == "cuda":
        return _SampleWindow.apply(f2.contiguous(),
                                   coords.detach().contiguous(), radius)
    raise ValueError(f"sample_window_fused: unsupported device {f2.device}")
