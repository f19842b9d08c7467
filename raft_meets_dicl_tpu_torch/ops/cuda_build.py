"""Build and load the hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. At first use
it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the repository root (git-ignored) and
loaded with ``ctypes``. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and never confused
with a stale build. Nothing is built or loaded at import time.

There is no fallback: without ``nvcc`` the build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def find_nvcc():
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``; None
    when there is no CUDA toolkit."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    return shutil.which("nvcc")


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    ``(path, seconds spent compiling, compiler output)`` — the output holds
    ptxas's registers/shared-memory/spill report."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""

    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build the CUDA kernel '{name}': nvcc not found (needs "
            "the CUDA toolkit for sm_90a, from CUDA_HOME, /usr/local/cuda or "
            "PATH)")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building '{name}' (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    # atomic publish: a concurrent build never loads a half-written file
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(name):
    """The kernel library as a ``ctypes.CDLL``, built at first use and
    cached for the process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels' vector loads and
    16-byte asynchronous copies), copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_if_deterministic(kernel):
    """Raise when deterministic algorithms are on
    (``torch.use_deterministic_algorithms``, which ``main train -e`` sets
    for an environment's ``deterministic: true``): ``kernel`` sums with
    ``atomicAdd``, in an order that differs from run to run, which torch's
    switches do not reach."""
    import torch

    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            f"{kernel} adds its gradient with atomicAdd and has no "
            "deterministic form; a deterministic run (environment "
            "'deterministic: true', torch.use_deterministic_algorithms) "
            "cannot launch it")
