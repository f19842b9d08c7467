"""The windowed-lookup contraction of one volume level, ``wy · corr ·
wxᵀ`` per position, as hand-written CUDA kernels for Hopper: stage 1
alone (``lookup_stage1``) and both stages fused (``lookup_fused``).

Counterpart of ``scripts/probe_fused_lookup.py`` in the JAX repository:
the Pallas kernels ``_stage1_kernel`` (``_pallas_stage1``) and
``_fused_kernel`` (``_pallas_fused``), and their plain XLA form
``_xla_lookup``. The bilinear window lookup of ``ops/corr.py::
_lookup_level`` is this contraction with hat matrices for wy and wx; the
kernel sources, their bound and their design are in
``csrc/fused_lookup.cu``.

Layout contract: wy (..., K, H2), corr (..., H2, W2), wx (..., K, W2),
float32 or bfloat16, one dtype, the same leading axes (the probe's
(B, NI, NJ)). ``lookup_stage1`` returns t = wy @ corr, (..., K, W2)
float32; ``lookup_fused`` rounds t to the inputs' dtype and returns
t @ wxᵀ, (..., K, K) float32 with axes (wy's k, wx's a). Both are dense:
they take any wy and wx, not only hat matrices.

On CPU tensors the wrappers compute the plain versions; on CUDA tensors
they launch the kernels or raise. There is no autograd (the Pallas
kernels have no VJP). The kernels are built for K = 9 (radius 4, every
shipped config's); another K is refused on the card. ``stage1_launches``
and ``fused_launches`` count kernel launches (CPU calls do not count).
``fused_plan`` is the fused kernel's rule for cutting positions into
stages and columns into warps (``kernel_fused_plan`` asks the built
library for the same).
"""

import ctypes

import torch

from . import cuda_build

# window rows the kernels are built for: 2 * radius + 1 at radius 4
KERNEL_K = 9
# the widest row the fused kernel takes: a position larger than a stage
# keeps its (K, W2) float32 t in shared memory beside the stage ring (at
# most 190 KB of a block's 227 KB up to this width; ``fused_plan``)
FUSED_MAX_W2 = 3211

# the fused kernel's plan constants (csrc/fused_lookup.cu)
_STAGES = 3             # kStages: ring buffers
_STAGE_CAP = 24 * 1024  # kStageCap: corr bytes a stage
_MAX_UNITS = 8          # kMaxUnits: whole positions a stage
_WY_CAP = 16 * 1024     # kWyCap: bytes of a stage's staged wy
_WX_CAP = 16 * 1024     # kWxCap: bytes of a stage's wx
_WY_PAD = 12            # kWyPad: floats a staged float32 wy row
_TILES_PER_WARP = 3     # kTilesPerWarp: 8-column tiles a bf16 warp item
_WARPS = 8              # kThreads / 32
MAX_SHARED_BYTES = 232448  # a block's shared memory on Hopper

# kernel launches made by this process; reset freely
stage1_launches = 0
fused_launches = 0


def lookup_stage1_reference(wy, corr):
    """Plain version of stage 1: ``wy @ corr`` in float32, (..., K, W2)
    (the probe's stage-1 einsum with float32 accumulation; bf16 products
    are exact in float32)."""
    return torch.matmul(wy.float(), corr.float())


def lookup_fused_reference(wy, corr, wx):
    """Plain version of both stages (the probe's ``_xla_lookup``): t in
    float32, rounded to the inputs' dtype, then ``t @ wxᵀ`` in float32,
    (..., K, K)."""
    t = lookup_stage1_reference(wy, corr).to(wy.dtype)
    return torch.matmul(t.float(), wx.float().transpose(-1, -2))


def _align16(x):
    return (x + 15) & ~15


def fused_plan(h2, w2, dtype):
    """How the fused kernel cuts positions of H2 x W2 (``make_plan`` in
    ``csrc/fused_lookup.cu`` with ``fused``; ``chip_smoke.py`` holds the
    two equal on the card). Returns a dict:

    - ``mode``: ``"whole"`` (``units`` whole positions a stage, their wy
      and wx copied after corr; bf16 runs both contractions on
      ``mma.sync``, float32 on FMAs and a shuffle reduce-scatter) or
      ``"rows"`` (a position in ``upp`` units of ``hc`` rows, its t summed
      in a shared (K, W2) tile before stage 2);
    - ``ipu``, ``gpi``: warps a position and granules a warp (bf16 whole
      mode: groups of three 8-column tiles; else 32-column chunks);
    - ``smem``: the block's shared-memory bytes (at most
      ``MAX_SHARED_BYTES`` for every shape the wrapper accepts)."""
    bf16 = dtype == torch.bfloat16
    es = 2 if bf16 else 4
    k = KERNEL_K

    def staged_wy(rows):
        return (k * (_align16(rows) + 8) * 2 if bf16
                else rows * _WY_PAD * 4)

    wx_unit = k * w2 * es
    pos_bytes = h2 * w2 * es
    if pos_bytes <= _STAGE_CAP and staged_wy(h2) <= _WY_CAP \
            and wx_unit <= _WX_CAP:
        mode, upp, hc = "whole", 1, h2
        units = min(_STAGE_CAP // pos_bytes, _WY_CAP // staged_wy(h2),
                    _WX_CAP // wx_unit, _MAX_UNITS)
        stage_elems = units * h2 * w2
    elif w2 * es <= _STAGE_CAP:
        hc = _STAGE_CAP // (w2 * es)
        while hc > 1 and staged_wy(hc) > _WY_CAP:
            hc //= 2
        mode, units, hc = "rows", 1, min(hc, h2)
        upp = -(-h2 // hc)
        stage_elems = hc * w2
    else:
        raise ValueError(f"lookup_fused: a row of {w2} values exceeds a "
                         "stage")
    whole = mode == "whole"
    stage_bytes = ((stage_elems * es + 47) & ~15) + (
        ((units * k * h2 * es + 47) & ~15)
        + ((units * wx_unit + 47) & ~15) if whole else 0)
    granules = (-(-(-(-w2 // 8)) // _TILES_PER_WARP) if bf16 and whole
                else -(-w2 // 32))
    warps = _WARPS // units if whole else _WARPS
    gpi = -(-granules // min(warps, granules))
    ipu = -(-granules // gpi)
    hp = _align16(hc) + 8
    swy = (0 if whole else k * hp * 2) if bf16 else units * hc * _WY_PAD * 4
    slots = 2 * units * ipu * k * k * 4
    # the ring, staged wy, slots, rows mode's t tile, the ring's barriers
    smem = _align16(_STAGES * stage_bytes + _align16(swy) + _align16(slots)
                    + (0 if whole else k * w2 * 4)) + _STAGES * 8
    return {"mode": mode, "units": units, "upp": upp, "hc": hc,
            "ipu": ipu, "gpi": gpi, "smem": smem}


def _library():
    lib = cuda_build.load("fused_lookup")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.lookup_stage1_f32, lib.lookup_stage1_bf16):
        # (wy, corr, out, n, k, h2, w2, stream)
        fn.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, ptr]
        fn.restype = i32
    for fn in (lib.lookup_fused_f32, lib.lookup_fused_bf16):
        # (wy, corr, wx, out, n, k, h2, w2, stream)
        fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr]
        fn.restype = i32
    # (h2, w2, bf16, fields out): the fused plan, host code only
    lib.lookup_fused_plan.argtypes = [i32, i32, i32, ptr]
    lib.lookup_fused_plan.restype = i32
    return lib


def kernel_fused_plan(h2, w2, dtype):
    """The fused plan as the built kernel library computes it (host code;
    needs the library, so nvcc): the keys of ``fused_plan``."""
    fields = (ctypes.c_int * 7)()
    err = _library().lookup_fused_plan(h2, w2, int(dtype == torch.bfloat16),
                                       ctypes.cast(fields, ctypes.c_void_p))
    if err != 0:
        raise ValueError(f"lookup_fused: no plan for ({h2}, {w2})")
    whole, units, upp, hc, ipu, gpi, smem = fields
    return {"mode": "whole" if whole else "rows", "units": units,
            "upp": upp, "hc": hc, "ipu": ipu, "gpi": gpi, "smem": smem}


def _check_inputs(wy, corr, wx=None):
    """What the kernels take: one float32 or bfloat16 dtype, K = 9, the
    same leading axes, H2 and W2 >= 1 (and, fused, W2 <= FUSED_MAX_W2),
    all on one CUDA device. Returns (N, H2, W2), N the positions."""
    name = "lookup_fused" if wx is not None else "lookup_stage1"
    tensors = (wy, corr) if wx is None else (wy, corr, wx)
    if wy.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != wy.dtype for t in tensors):
        raise TypeError(f"{name}: inputs must share one dtype, float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if wy.dim() < 2 or corr.dim() != wy.dim():
        raise ValueError(f"{name}: wy {tuple(wy.shape)} and corr "
                         f"{tuple(corr.shape)} must be (..., K, H2) and "
                         "(..., H2, W2)")
    lead = wy.shape[:-2]
    k, h2 = wy.shape[-2:]
    w2 = corr.shape[-1]
    if tuple(corr.shape) != (*lead, h2, w2) or (
            wx is not None and tuple(wx.shape) != (*lead, k, w2)):
        raise ValueError(f"{name}: wy {tuple(wy.shape)}, corr "
                         f"{tuple(corr.shape)}"
                         + (f", wx {tuple(wx.shape)}" if wx is not None
                            else "") + " do not match")
    if k != KERNEL_K:
        raise ValueError(f"{name}: the kernels are built for K = "
                         f"{KERNEL_K} (radius 4), got K = {k}")
    if h2 < 1 or w2 < 1:
        raise ValueError(f"{name}: empty volume level ({h2}, {w2})")
    if wx is not None and w2 > FUSED_MAX_W2:
        raise ValueError(f"{name}: W2 = {w2} exceeds the kernel's shared "
                         f"memory tile ({FUSED_MAX_W2})")
    if any(t.device.type != "cuda" or t.device != wy.device
           for t in tensors):
        raise ValueError(f"{name}: the kernels take CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    return lead.numel(), h2, w2


def _run(name, fn, device, *args):
    """Call a kernel entry point on PyTorch's current stream of ``device``
    and raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _launch_stage1(wy, corr):
    """Run the stage-1 kernel: (..., K, W2) float32."""
    global stage1_launches

    n, h2, w2 = _check_inputs(wy, corr)
    # the kernel streams wy and corr with 16-byte copies
    wy, corr = cuda_build.aligned(wy), cuda_build.aligned(corr)
    out = torch.empty((*wy.shape[:-1], w2), dtype=torch.float32,
                      device=wy.device)
    lib = _library()
    fn = (lib.lookup_stage1_bf16 if wy.dtype == torch.bfloat16
          else lib.lookup_stage1_f32)
    _run("lookup_stage1", fn, wy.device, wy.data_ptr(), corr.data_ptr(),
         out.data_ptr(), n, KERNEL_K, h2, w2)
    stage1_launches += 1
    return out


def _launch_fused(wy, corr, wx):
    """Run the fused kernel: (..., K, K) float32."""
    global fused_launches

    n, h2, w2 = _check_inputs(wy, corr, wx)
    # the kernel streams wy, corr and wx with bulk copies from 16-byte
    # boundaries
    wy, corr, wx = (cuda_build.aligned(t) for t in (wy, corr, wx))
    out = torch.empty((*wy.shape[:-1], KERNEL_K), dtype=torch.float32,
                      device=wy.device)
    lib = _library()
    fn = (lib.lookup_fused_bf16 if wy.dtype == torch.bfloat16
          else lib.lookup_fused_f32)
    _run("lookup_fused", fn, wy.device, wy.data_ptr(), corr.data_ptr(),
         wx.data_ptr(), out.data_ptr(), n, KERNEL_K, h2, w2)
    fused_launches += 1
    return out


def lookup_stage1(wy, corr):
    """t = wy @ corr per position, (..., K, W2) float32. On CPU tensors the
    plain version, on CUDA tensors the kernel."""
    if wy.device.type == "cpu":
        return lookup_stage1_reference(wy, corr)
    if wy.device.type == "cuda":
        return _launch_stage1(wy, corr)
    raise ValueError(f"lookup_stage1: unsupported device {wy.device}")


def lookup_fused(wy, corr, wx):
    """(wy @ corr, rounded to the inputs' dtype) @ wxᵀ per position,
    (..., K, K) float32. On CPU tensors the plain version, on CUDA tensors
    the kernel."""
    if wy.device.type == "cpu":
        return lookup_fused_reference(wy, corr, wx)
    if wy.device.type == "cuda":
        return _launch_fused(wy, corr, wx)
    raise ValueError(f"lookup_fused: unsupported device {wy.device}")
