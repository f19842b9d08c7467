#!/usr/bin/env python3
"""Where the time of one ``raft/baseline`` forward goes in the PyTorch/CUDA
port, on one GPU.

    python3 scripts/profile_torch_forward.py [--shapes 1x368x496,4x448x1024]

For each batch x height x width it builds the port's model from the
shipped ``cfg/model/raft-baseline.yaml`` (bf16 policy, 12 iterations,
seeded weights), warms it up, then:

- times ``--repeats`` forwards on the host clock, each ending in a device
  synchronise (wall ms per forward);
- traces ``--repeats`` forwards with ``torch.profiler`` (CPU + CUDA) and
  sums the device time of every kernel: device-busy ms per forward, the
  idle share ``1 - busy / wall`` (wall from the untraced runs: tracing
  slows the host, not the kernels), kernel launches per forward, device
  time by kernel class (from kernel names) and the kernels with the most
  device time.

Prints one JSON line per shape, each with the card's name and power limit
from ``nvidia-smi``. Fails without CUDA.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from raft_meets_dicl_tpu_torch import evaluation, models  # noqa: E402


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# kernel-name substrings -> class, first match wins
_CLASSES = (
    ("convex_combine_8x", ("convex_combine_8x",)),
    ("normalization", ("bn_", "batch_norm", "norm")),
    ("convolution", ("fprop", "conv", "cudnn")),
    ("matmul", ("gemm", "gemv", "nvjet", "Kernel2")),
    ("copy/cast/cat", ("copy", "Cat")),
    ("elementwise/other", ("",)),
)


def _class_of(name):
    return next(c for c, keys in _CLASSES if any(k in name for k in keys))


def _kernel_times(prof):
    """(name, device us, calls) per CUDA kernel in the trace."""
    out = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out.append((evt.key, float(us), int(evt.count)))
    return sorted(out, key=lambda t: -t[1])


def profile_shape(spec, b, h, w, repeats, card):
    rng = np.random.default_rng(0)
    x1, x2 = (torch.from_numpy(rng.uniform(-1, 1, (b, h, w, 3))
                               .astype(np.float32)).cuda() for _ in range(2))
    step = evaluation.make_eval_fn(spec.model)
    for _ in range(3):
        step(x1, x2)
    torch.cuda.synchronize()

    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        step(x1, x2)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            step(x1, x2)
        torch.cuda.synchronize()
        traced_wall_ms = 1e3 * (time.perf_counter() - t0) / repeats

    kernels = _kernel_times(prof)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / repeats
    launches = sum(n for _, _, n in kernels) / repeats
    wall_ms = statistics.median(walls)
    by_class = {}
    for name, us, _ in kernels:
        c = _class_of(name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3 / repeats
    print(json.dumps({
        "shape": [b, h, w], "iterations": 12, "policy": "bf16",
        "wall_ms": wall_ms, "wall_ms_all": walls,
        "traced_wall_ms": traced_wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms) if kernels
        else "not measured",
        "kernel_launches": launches,
        "ms_per_forward_by_class": by_class,
        "top_kernels": [{"name": n[:120], "ms_per_forward": us / 1e3 / repeats,
                         "calls_per_forward": c / repeats}
                        for n, us, c in kernels[:15]],
        "card": card,
    }), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="1x368x496,4x448x1024",
                        help="comma-separated BxHxW list")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_forward: needs a CUDA GPU", file=sys.stderr)
        return 1

    card = _card()
    spec = models.load(ROOT / "cfg" / "model" / "raft-baseline.yaml")
    spec.model.init(torch.Generator().manual_seed(0), device="cuda")
    for shape in args.shapes.split(","):
        b, h, w = (int(v) for v in shape.lower().split("x"))
        profile_shape(spec, b, h, w, args.repeats, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
