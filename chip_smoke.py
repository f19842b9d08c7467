#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``raft_meets_dicl_tpu_torch`` — never JAX or the JAX package — on
the card and fails (non-zero exit, no result line) on any fault:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the path, compiled with ``nvcc`` for
   ``sm_90a`` from ``raft_meets_dicl_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with TF32 off (max |diff| <= 1e-5), and timed
   (CUDA events) beside its plain version and its bound;
4. model: ``raft/baseline`` in float32 at 1x368x496, 12 iterations, one
   seeded init, on the card against the same weights on the CPU, TF32 off;
   the kernel must launch exactly once per forward;
5. serve: the ``serve`` command (``main serve``) with the shipped
   ``cfg/model/raft-baseline.yaml`` (bf16 policy), buckets 368x496 and
   448x1024, batch 4, 16 requests at 50/s: every request completes, no
   errors or sheds, every flow finite, and the kernel launched once per
   dispatched batch (warm-up included).

Each phase prints one JSON line; then the ``kernels`` line, the card's
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores (the kernel's arithmetic) in operations/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# float32 operations per output sub-pixel of convex_combine_8x: 9 scale
# multiplies, 9 max, 9 subtracts, 9 exps, 9 sum adds, 18 multiply-adds
# (36 ops), 1 reciprocal and 2 multiplies
CONVEX_OPS_PER_SUBPIXEL = 9 * 5 + 36 + 3

# rows of the convex combine: iterations * batch * (H/8) * (W/8)
ENTRY_M = 12 * 1 * (368 // 8) * (496 // 8)         # 34,224
SERVE_SMALL_M = 12 * 4 * (368 // 8) * (496 // 8)   # 136,896
SERVE_M = 12 * 4 * (448 // 8) * (1024 // 8)        # 344,064
KERNEL_ROWS = (700, ENTRY_M, SERVE_SMALL_M, SERVE_M)

# px, final flow, card vs CPU in float32: about 11x the 9.2e-5 px that
# H100 runs of this phase read on flows up to 71 px (see PERF.md)
MODEL_MAX_ABS_DIFF = 1e-3
KERNEL_MAX_ABS_ERR = 1e-5


def emit(**fields):
    print(json.dumps(fields), flush=True)


def gpu_timer_ms(fn, launches=20, rounds=5):
    """Median per-call device time of ``fn``: each round queues ``launches``
    calls behind a device-side sleep (so the host's enqueue never starves
    the device) between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def set_tf32(enabled):
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    emit(phase="environment", nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return card


def phase_build():
    from raft_meets_dicl_tpu_torch.ops import cuda_build

    path, seconds, log = cuda_build.build("convex_combine_8x")
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit(phase="build", kernel="convex_combine_8x", seconds=round(seconds, 3),
         library=str(path.relative_to(ROOT)), ptxas=ptxas)


def phase_kernels(card):
    """convex_combine_8x against its plain version, both logits dtypes,
    at M = 700 (ragged), the entry shape and both serve buckets."""
    from raft_meets_dicl_tpu_torch.ops import convex

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for m in KERNEL_ROWS:
            logits = (4 * torch.randn(m, 576, device="cuda", generator=gen)
                      ).to(dtype)
            win = 8 * torch.randn(m, 9, 2, device="cuda", generator=gen)
            inv_temp = 0.25

            before = convex.launches
            out = convex.convex_combine_8x(logits, win, 4.0)
            torch.cuda.synchronize()
            if convex.launches != before + 1:
                raise AssertionError("convex_combine_8x did not launch")
            ref = convex.convex_combine_8x_reference(
                logits, win.reshape(m, 18), inv_temp)
            err = (out - ref).abs().max().item()
            if not err <= KERNEL_MAX_ABS_ERR:
                raise AssertionError(
                    f"convex_combine_8x {dtype} M={m}: max |diff| {err} > "
                    f"{KERNEL_MAX_ABS_ERR}")

            ms = gpu_timer_ms(lambda: convex.convex_combine_8x(logits, win, 4.0))
            plain_ms = gpu_timer_ms(lambda: convex.convex_combine_8x_reference(
                logits, win.reshape(m, 18), inv_temp))
            nbytes = (logits.numel() * logits.element_size()
                      + win.numel() * 4 + out.numel() * 4)
            ops = m * 64 * CONVEX_OPS_PER_SUBPIXEL
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
            ops_ms = 1e3 * ops / PEAK_F32_OPS_S
            case = dict(
                dtype=str(dtype).removeprefix("torch."), rows=m,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes)
            cases.append(case)
            emit(phase="kernel-check", kernel="convex_combine_8x",
                 tf32=False, card=card, **case)
    return cases


def _load_raft(mixed_precision):
    from raft_meets_dicl_tpu_torch import models, utils

    cfg = utils.config.load(ROOT / "cfg" / "model" / "raft-baseline.yaml")
    cfg["model"]["parameters"]["mixed-precision"] = mixed_precision
    return models.load(cfg)


def phase_model(card):
    """raft/baseline f32 at the entry shape: card vs CPU, same weights."""
    from raft_meets_dicl_tpu_torch import evaluation
    from raft_meets_dicl_tpu_torch.ops import convex

    set_tf32(False)
    rng = np.random.default_rng(0)
    img1 = torch.from_numpy(rng.uniform(-1, 1, (1, 368, 496, 3)).astype(np.float32))
    img2 = torch.from_numpy(rng.uniform(-1, 1, (1, 368, 496, 3)).astype(np.float32))

    cpu_spec = _load_raft(False)
    cpu_spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_spec = _load_raft(False)
    gpu_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    gpu_spec.model.module.to("cuda").eval()

    cpu_step = evaluation.make_eval_fn(cpu_spec.model)
    gpu_step = evaluation.make_eval_fn(gpu_spec.model)
    x1, x2 = img1.cuda(), img2.cuda()

    convex.launches = 0
    raw, flow_gpu = gpu_step(x1, x2)
    torch.cuda.synchronize()
    launches = convex.launches
    if launches != 1:
        raise AssertionError(f"model forward launched convex_combine_8x "
                             f"{launches} times, expected 1")
    if len(raw) != 12 or tuple(flow_gpu.shape) != (1, 368, 496, 2):
        raise AssertionError(f"unexpected output: {len(raw)} flows of "
                             f"{tuple(flow_gpu.shape)}")

    t0 = time.perf_counter()
    _, flow_cpu = cpu_step(img1, img2)
    cpu_s = time.perf_counter() - t0
    flow_gpu = flow_gpu.cpu()
    if not bool(torch.isfinite(flow_gpu).all()):
        raise AssertionError("non-finite flow on the card")
    diff = (flow_gpu - flow_cpu).abs().max().item()
    if not diff <= MODEL_MAX_ABS_DIFF:
        raise AssertionError(f"card vs CPU final flow max |diff| {diff} px > "
                             f"{MODEL_MAX_ABS_DIFF}")

    forward_f32_ms = gpu_timer_ms(lambda: gpu_step(x1, x2), launches=3)
    bf16_spec = _load_raft(True)
    bf16_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    bf16_spec.model.module.to("cuda").eval()
    bf16_step = evaluation.make_eval_fn(bf16_spec.model)
    forward_bf16_ms = gpu_timer_ms(lambda: bf16_step(x1, x2), launches=3)

    emit(phase="model", model="raft/baseline", shape=[1, 368, 496],
         iterations=12, tf32=False, max_abs_diff_px=diff,
         bound_px=MODEL_MAX_ABS_DIFF, max_abs_flow_px=flow_cpu.abs().max().item(),
         launches_per_forward=launches, forward_f32_ms=forward_f32_ms,
         forward_bf16_ms=forward_bf16_ms, cpu_forward_s=round(cpu_s, 3),
         card=card)


def phase_serve(card):
    """The serve command end to end with the shipped bf16-policy config."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.ops import convex

    # back to PyTorch's defaults (cuDNN TF32 on, matmul TF32 off): serving
    # does not change them, and its convs run bf16 under the policy anyway
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "serve.yaml"
        cfg.write_text(
            "serve:\n"
            f"  model: {ROOT / 'cfg' / 'model' / 'raft-baseline.yaml'}\n"
            "  buckets: 368x496,448x1024\n"
            "  batch-size: 4\n"
            "  max-wait-ms: 50\n"
            "  requests: 16\n"
            "  rate: 50\n")
        convex.launches = 0
        report = port_main.main(["serve", "-c", str(cfg)])
        launches = convex.launches

    expected = report["batches"] + len(report["warmup"])
    problems = []
    if report["completed"] != report["requests"] or report["requests"] != 16:
        problems.append(f"completed {report['completed']}/{report['requests']}")
    if report["errors"] or report["rejected"]:
        problems.append(f"errors {report['errors']}, rejected "
                        f"{report['rejected']}")
    if report["nonfinite"]:
        problems.append(f"{report['nonfinite']} non-finite flows")
    if launches != expected:
        problems.append(f"convex_combine_8x launched {launches} times, "
                        f"expected {expected} (batches + warm-up)")
    if problems:
        raise AssertionError("serve phase: " + "; ".join(problems))

    emit(phase="serve", model="raft/baseline (bf16 policy)",
         buckets="368x496,448x1024", batch=4, requests=report["requests"],
         completed=report["completed"], batches=report["batches"],
         launches=launches, p50_ms=report["p50_ms"], p99_ms=report["p99_ms"],
         pairs_per_sec=report["pairs_per_sec"], spans_ms=report["spans_ms"],
         card=card)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the port must be importable before anything is printed: a copy of
    # this script alone fails here, with no result line
    import raft_meets_dicl_tpu_torch  # noqa: F401

    card = phase_environment()
    phase_build()
    cases = phase_kernels(card)
    phase_model(card)
    launches = phase_serve(card)

    main_case = next(c for c in cases
                     if c["dtype"] == "bfloat16" and c["rows"] == SERVE_M)
    print(json.dumps({"kernels": [{
        "name": "convex_combine_8x",
        "route": "cuda",
        "source": "raft_meets_dicl_tpu_torch/csrc/convex_combine_8x.cu",
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:110",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the neighbour "
                        "softmax + convex combine",
        "shape": f"bf16 logits, M={SERVE_M} (serve bucket 448x1024, batch 4)",
        "cases": cases,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
