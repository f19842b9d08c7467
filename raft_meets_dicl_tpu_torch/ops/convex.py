"""``convex_combine_8x``: the fused neighbour softmax + convex combine of
RAFT's 8x convex upsampling, forward and backward, as hand-written CUDA
kernels for Hopper.

Counterpart of ``raft_meets_dicl_tpu/ops/pallas.py::convex_combine_8x``
(the Pallas kernels ``_fwd_kernel`` and ``_bwd_kernel``, paired by its
``custom_vjp``); the kernel sources, their bound and their design are in
``csrc/convex_combine_8x.cu``.

Layout contract (torch RAFT's ``view(b, 1, 9, 8, 8, h, w)``): logits
channels are neighbour-major ``k * 64 + s`` (k = 3x3 neighbour row-major,
s = sub-pixel ``r * 8 + c``); window values ``k * 2 + c``; outputs
``chan * 64 + s``.

On a CUDA tensor the wrapper launches the forward kernel or raises, and
the gradient launches the backward kernel (``_ConvexCombine8x`` saves the
logits and the window, as the JAX residuals do, and recomputes the softmax).
On a CPU tensor it computes the plain version,
``convex_combine_8x_reference``, whose autograd is the backward there.
``launches`` and ``bwd_launches`` count kernel launches (CPU calls do not
count), so a run can show that its path went through the kernels.
"""

import ctypes

import torch

from . import cuda_build

_K = 9    # 3x3 neighbours
_S = 64   # 8x8 sub-pixels
_C = 2    # flow channels

# kernel launches made by this process (forward, backward); reset freely
launches = 0
bwd_launches = 0


def convex_combine_8x_reference(logits2d, win2d, inv_temp):
    """Plain PyTorch version: (M, 576) logits, (M, 18) window -> (M, 128)
    float32. Used for CPU tensors and as the kernel's reference."""
    x = logits2d.float().reshape(-1, _K, _S) * inv_temp
    p = torch.softmax(x, dim=1)                   # (M, 9, 64)
    w = win2d.float().reshape(-1, _K, _C)         # (M, 9, 2)
    out = torch.einsum("mks,mkc->mcs", p, w)
    return out.reshape(-1, _C * _S)


def _library():
    lib = cuda_build.load("convex_combine_8x")
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    for fn in (lib.convex_combine_8x_fwd_f32, lib.convex_combine_8x_fwd_bf16):
        fn.argtypes = [ptr, ptr, ptr, i64, f32, ptr]
        fn.restype = ctypes.c_int
    for fn in (lib.convex_combine_8x_bwd_f32, lib.convex_combine_8x_bwd_bf16):
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, f32, ptr]
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(logits2d, win2d):
    if logits2d.device.type != "cuda":
        raise ValueError(f"convex_combine_8x: the kernels take CUDA tensors, "
                         f"got {logits2d.device}")
    if logits2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"convex_combine_8x: logits must be float32 or "
                        f"bfloat16, got {logits2d.dtype}")
    if win2d.dtype != torch.float32:
        raise TypeError(f"convex_combine_8x: window must be float32, got "
                        f"{win2d.dtype}")
    if win2d.device != logits2d.device:
        raise ValueError(f"convex_combine_8x: logits on {logits2d.device}, "
                         f"window on {win2d.device}")
    if not (logits2d.is_contiguous() and win2d.is_contiguous()):
        raise ValueError("convex_combine_8x: inputs must be contiguous")


def _run(fn, device, *args):
    """Call a kernel entry point on PyTorch's current stream of ``device``
    and raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"convex_combine_8x: kernel launch failed with "
                           f"CUDA error {err}")


def _launch(logits2d, win2d, inv_temp):
    """Run the forward kernel: (M, 576) logits, (M, 18) window -> (M, 128)
    float32."""
    global launches

    _check_inputs(logits2d, win2d)
    lib = _library()
    fn = (lib.convex_combine_8x_fwd_bf16 if logits2d.dtype == torch.bfloat16
          else lib.convex_combine_8x_fwd_f32)
    rows = logits2d.shape[0]
    out = torch.empty((rows, _C * _S), dtype=torch.float32,
                      device=logits2d.device)
    _run(fn, logits2d.device, logits2d.data_ptr(), win2d.data_ptr(),
         out.data_ptr(), rows, float(inv_temp))
    launches += 1
    return out


def _launch_bwd(logits2d, win2d, dout2d, inv_temp):
    """Run the backward kernel: the saved (M, 576) logits and (M, 18)
    window and the (M, 128) float32 output gradient -> ``dlogits`` (M, 576)
    in the logits' dtype and ``dwin`` (M, 18) float32. ``dout2d`` must be
    contiguous float32: the caller makes it so."""
    global bwd_launches

    _check_inputs(logits2d, win2d)
    rows = logits2d.shape[0]
    if dout2d.dtype != torch.float32:
        raise TypeError(f"convex_combine_8x backward: output gradient must "
                        f"be float32, got {dout2d.dtype}")
    if tuple(dout2d.shape) != (rows, _C * _S):
        raise ValueError(f"convex_combine_8x backward: output gradient shape "
                         f"{tuple(dout2d.shape)}, expected ({rows}, "
                         f"{_C * _S})")
    if dout2d.device != logits2d.device or not dout2d.is_contiguous():
        raise ValueError("convex_combine_8x backward: output gradient must "
                         "be contiguous and on the logits' device")

    lib = _library()
    fn = (lib.convex_combine_8x_bwd_bf16 if logits2d.dtype == torch.bfloat16
          else lib.convex_combine_8x_bwd_f32)
    dlogits = torch.empty_like(logits2d)
    dwin = torch.empty_like(win2d)
    _run(fn, logits2d.device, logits2d.data_ptr(), win2d.data_ptr(),
         dout2d.data_ptr(), dlogits.data_ptr(), dwin.data_ptr(), rows,
         float(inv_temp))
    bwd_launches += 1
    return dlogits, dwin


class _ConvexCombine8x(torch.autograd.Function):
    """The CUDA pair: forward kernel, backward kernel. Saves the logits and
    the window (the JAX ``_combine_fwd`` residuals); the backward
    recomputes the softmax from them."""

    @staticmethod
    def forward(ctx, logits2d, win2d, inv_temp):
        ctx.save_for_backward(logits2d, win2d)
        ctx.inv_temp = inv_temp
        return _launch(logits2d, win2d, inv_temp)

    @staticmethod
    def backward(ctx, dout):
        logits2d, win2d = ctx.saved_tensors
        # the pixel shuffle's backward hands over a strided view; the
        # kernel reads rows, so this is a copy, never a fallback
        dlogits, dwin = _launch_bwd(logits2d, win2d, dout.contiguous(),
                                    ctx.inv_temp)
        return dlogits, dwin, None


def convex_combine_8x(mask_logits, win, temperature=4.0):
    """Fused softmax-over-neighbours + convex combine.

    mask_logits: (..., 576) float32 or bfloat16, channels ``k * 64 + s``.
    win: (..., 9, 2) neighbour flow windows (computed in float32). Returns
    (..., 128) float32, channels ``chan * 64 + s``. Differentiable in both
    inputs: ``dlogits`` comes back in the logits' dtype, ``dwin`` in
    float32, as in the JAX ``_combine_bwd``.
    """
    lead = mask_logits.shape[:-1]
    if mask_logits.shape[-1] != _K * _S:
        raise ValueError(f"convex_combine_8x: logits need {_K * _S} "
                         f"channels, got shape {tuple(mask_logits.shape)}")
    if tuple(win.shape) != (*lead, _K, _C):
        raise ValueError(f"convex_combine_8x: window shape {tuple(win.shape)}"
                         f" does not match logits {tuple(mask_logits.shape)}")
    inv_temp = 1.0 / temperature

    if mask_logits.device.type == "cpu":
        out = convex_combine_8x_reference(mask_logits.reshape(-1, _K * _S),
                                          win.reshape(-1, _K * _C), inv_temp)
    elif mask_logits.device.type == "cuda":
        if not mask_logits.is_contiguous():
            raise ValueError("convex_combine_8x: logits must be contiguous "
                             "(run the mask head channels_last)")
        out = _ConvexCombine8x.apply(mask_logits.view(-1, _K * _S),
                                     win.float().reshape(-1, _K * _C),
                                     inv_temp)
    else:
        raise ValueError(f"convex_combine_8x: unsupported device "
                         f"{mask_logits.device}")
    return out.reshape(*lead, _C * _S)
