#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``raft_meets_dicl_tpu_torch`` — never JAX or the JAX package — on
the card and fails (non-zero exit, no result line) on any fault:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the path (``convex_combine_8x`` forward and
   backward, one source), compiled with ``nvcc`` for ``sm_90a`` from
   ``raft_meets_dicl_tpu_torch/csrc``; ptxas registers and spills printed;
3. kernels: the forward against its plain PyTorch version on the card, at
   the main paths' shapes, with TF32 off (max |diff| <= 1e-5), and timed
   (CUDA events) beside its plain version and its bound;
4. model: ``raft/baseline`` in float32 at 1x368x496, 12 iterations, one
   seeded init, on the card against the same weights on the CPU, TF32 off;
   the kernel must launch exactly once per forward;
5. serve: the ``serve`` command (``main serve``) with the shipped
   ``cfg/model/raft-baseline.yaml`` (bf16 policy), buckets 368x496 and
   448x1024, batch 4, 16 requests at 50/s: every request completes, no
   errors or sheds, every flow finite, and the kernel launched once per
   dispatched batch (warm-up included);
6. kernels, backward: the backward kernel against autograd of the plain
   version on the card, TF32 off, both logits dtypes, at M = 700, 34,224
   and 324,000 (the training shape): float32 outputs within 1e-5, bf16
   ``dlogits`` within one bf16 ulp of the plain result rounded to bf16
   (float32-level agreement plus one rounding:
   |diff| <= 1e-5 + one bf16 ulp); timed beside the plain backward and
   its bound;
7. train step: one float32 step (AdamW + clip, frozen batch norm) of
   full-width ``raft/baseline``, 12 iterations, at 2x128x192, on the card
   against the same weights and batch on the CPU, TF32 off: loss, every
   gradient tensor, the update and the updated parameters within the
   bounds below; each kernel launches exactly once in the step. The same
   step with TF32 convolutions and matmuls must break each of those
   bounds but the zero-gradient one, so that each can fail;
8. train: the ``train`` command (``main train``) on a synthetic
   generic-layout dataset written to a temporary directory (400x720 PNG
   frames of one scene, ``.flo`` flows), with the shipped model config
   (bf16 policy, frozen batch norm) and a strategy with ``s1-things.yaml``'s
   optimizer, one-cycle schedule and clip, batch 6, 12 steps: every loss
   finite, each kernel launched once per step; median step ms, pairs/s
   (at the median step and over the whole window) and peak device memory
   printed.

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
TRAIN_M = 12 * 6 * (400 // 8) * (720 // 8)         # 324,000
KERNEL_ROWS = (700, ENTRY_M, SERVE_SMALL_M, SERVE_M, TRAIN_M)
BWD_ROWS = (700, ENTRY_M, TRAIN_M)

# float32 operations per sub-pixel of the backward: the forward's softmax
# (9 scale multiplies, max, subtract, exp, sum; 1 reciprocal), 9 p
# multiplies, dp (9 x 3), sum p*dp (9 x 2), dlogits (9 x 3), dwin
# partials (18) and their reductions (18)
CONVEX_BWD_OPS_PER_SUBPIXEL = 9 * 5 + 1 + 9 + 27 + 18 + 27 + 18 + 18

# the synthetic training run: shipped model config, batch 6 at 400x720
TRAIN_SHAPE = (400, 720)
TRAIN_BATCH = 6
TRAIN_PAIRS = 60
TRAIN_STEPS = 12
STEP_SHAPE = (2, 128, 192)   # the card-vs-CPU train step

# px, final flow, card vs CPU in float32: about 11x the 9.2e-5 px that
# H100 runs of this phase read on flows up to 71 px (see PERF.md)
MODEL_MAX_ABS_DIFF = 1e-3
KERNEL_MAX_ABS_ERR = 1e-5

# the card-vs-CPU train step in float32 (bounds and readings in PERF.md)
STEP_LOSS_REL = 1e-4
STEP_GRAD_REL_L2 = 1e-2
# gradients that are zero by construction: norm below this share of the
# global norm on both sides (H100 runs read about 1e-9 of it, see PERF.md)
STEP_ZERO_GRAD = 1e-6
STEP_LR = 1.25e-4            # s1-things.yaml's max_lr
# AdamW's eps in this phase. s1-things.yaml's 1e-8 would make the first
# update lr * sign(g) for nearly every weight, so two runs could differ by
# at most 2 * lr per weight whatever their gradients: a check of the
# update that passes anything. At 1e-3 the clipped gradients (a global
# norm of 1 over 5.3M weights) move their weights about linearly, so the
# update carries the gradients' differences.
STEP_EPS = 1e-3
# the update (parameters after the step minus before), card vs CPU:
# relative L2 over all parameters, and the largest |diff| of a weight.
# H100 runs read 1.1e-4 and 1.2e-7 (see PERF.md).
STEP_UPDATE_REL_L2 = 1e-3
STEP_PARAM_MAX_ABS = 1e-6
# the bounds the same step with TF32 convolutions and matmuls must break
STEP_TF32_BREAKS = ("loss", "gradient", "update", "params")

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
             if "registers" in line or "spill" in line
             or "Compiling entry function" in line]
    emit(phase="build", kernel="convex_combine_8x", seconds=round(seconds, 3),
         library=str(path.relative_to(ROOT)), ptxas=ptxas)


def phase_kernels(card):
    """convex_combine_8x against its plain version, both logits dtypes,
    at M = 700 (ragged), the entry shape, both serve buckets and the
    training shape."""
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


def _bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (float32 tensor in, float32 out):
    2^(e - 7) for |x| in [2^e, 2^(e+1)); 0 where x is 0."""
    _, exp = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), exp - 8))


def phase_kernels_bwd(card):
    """The backward kernel against autograd of the plain version, both
    logits dtypes, at M = 700 (ragged), the entry shape and the training
    shape; timed beside the plain backward and the bound."""
    from raft_meets_dicl_tpu_torch.ops import convex

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for m in BWD_ROWS:
            logits = (4 * torch.randn(m, 576, device="cuda", generator=gen)
                      ).to(dtype)
            win = 8 * torch.randn(m, 18, device="cuda", generator=gen)
            dout = torch.randn(m, 128, device="cuda", generator=gen)
            inv_temp = 0.25

            before = convex.bwd_launches
            dlogits, dwin = convex._launch_bwd(logits, win, dout, inv_temp)
            torch.cuda.synchronize()
            if convex.bwd_launches != before + 1:
                raise AssertionError("convex_combine_8x backward did not "
                                     "launch")

            lg = logits.detach().requires_grad_(True)
            wn = win.detach().requires_grad_(True)
            ref_out = convex.convex_combine_8x_reference(lg, wn, inv_temp)
            ref_dl, ref_dw = torch.autograd.grad(ref_out, (lg, wn), dout,
                                                 retain_graph=True)
            if dlogits.dtype != dtype or dwin.dtype != torch.float32:
                raise AssertionError(f"backward dtypes {dlogits.dtype}, "
                                     f"{dwin.dtype}")
            dl_err = (dlogits.float() - ref_dl.float()).abs()
            dw_err = (dwin - ref_dw).abs().max().item()
            bound = torch.full_like(dl_err, KERNEL_MAX_ABS_ERR)
            if dtype == torch.bfloat16:
                # rule: |diff| <= 1e-5 + one bf16 ulp (at the larger of the
                # two magnitudes). Both sides compute the gradient in
                # float32, where they agree within 1e-5 as in the float32
                # case, and each rounds it to bf16 once, which adds at most
                # one ulp. (One ulp alone is too strict near zero, where
                # dp - sum(p * dp) cancels: there a float32-level
                # difference is many bf16 ulps of a tiny result.)
                bound += _bf16_ulp(torch.maximum(dlogits.float().abs(),
                                                 ref_dl.float().abs()))
            share = (dl_err / bound).max().item()
            if not (share <= 1.0 and dw_err <= KERNEL_MAX_ABS_ERR):
                raise AssertionError(
                    f"convex_combine_8x backward {dtype} M={m}: dlogits max "
                    f"|diff| {dl_err.max().item()} ({share} of its bound), "
                    f"dwin max |diff| {dw_err}")

            ms = gpu_timer_ms(
                lambda: convex._launch_bwd(logits, win, dout, inv_temp))
            plain_ms = gpu_timer_ms(lambda: torch.autograd.grad(
                ref_out, (lg, wn), dout, retain_graph=True))
            del ref_out
            nbytes = 2 * logits.numel() * logits.element_size() \
                + 2 * win.numel() * 4 + dout.numel() * 4
            ops = m * 64 * CONVEX_BWD_OPS_PER_SUBPIXEL
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
            ops_ms = 1e3 * ops / PEAK_F32_OPS_S
            case = dict(
                dtype=str(dtype).removeprefix("torch."), rows=m,
                max_abs_err=max(dl_err.max().item(), dw_err),
                dlogits_max_abs_err=dl_err.max().item(),
                dlogits_err_over_bound=share, dwin_max_abs_err=dw_err,
                ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes)
            cases.append(case)
            emit(phase="kernel-check-bwd", kernel="convex_combine_8x_bwd",
                 tf32=False, card=card, **case)
    return cases


def _relative_l2(a, b):
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _step_readings(spec, aux, cpu_spec, aux_cpu, before):
    """How far one train step (``spec``, ``aux``) lies from the CPU's:
    loss, every gradient tensor, the update and the parameters after it."""
    loss, loss_cpu = aux["loss"].item(), aux_cpu["loss"].item()
    # a conv bias right before an instance norm has a zero gradient by
    # construction (the norm removes the channel mean): both sides hold
    # rounding noise there, so those tensors are bounded in norm instead
    zero_floor = STEP_ZERO_GRAD * aux_cpu["grad_norm"].item()
    grads = {n: g.cpu() for n, g in aux["grads"].items()}
    zero = {n for n, g in aux_cpu["grads"].items() if g.norm() <= zero_floor}
    zero_max = max((max(g.norm().item(), grads[n].norm().item())
                    for n, g in aux_cpu["grads"].items() if n in zero),
                   default=0.0)
    grad_rel = {n: _relative_l2(grads[n], g)
                for n, g in aux_cpu["grads"].items() if n not in zero}
    worst = max(grad_rel, key=grad_rel.get)

    params = {n: p.detach().cpu()
              for n, p in spec.model.module.named_parameters()}
    params_cpu = dict(cpu_spec.model.module.named_parameters())
    update = torch.cat([(params[n] - before[n]).flatten() for n in before])
    update_cpu = torch.cat([(params_cpu[n].detach() - before[n]).flatten()
                            for n in before])
    return dict(
        loss=loss, loss_rel_diff=abs(loss - loss_cpu) / abs(loss_cpu),
        max_grad_rel_l2=grad_rel[worst], worst_grad=worst,
        median_grad_rel_l2=statistics.median(grad_rel.values()),
        zero_grad_tensors=len(zero), zero_grad_max_norm=zero_max,
        bound_zero_grad_norm=zero_floor, grad_norm=aux["grad_norm"].item(),
        update_norm=aux["update_norm"].item(),
        update_rel_l2=_relative_l2(update, update_cpu),
        param_max_abs_diff=max((params[n] - p.detach()).abs().max().item()
                               for n, p in params_cpu.items()))


def _step_problems(r):
    """The bounds a step's readings break, by name, with their readings."""
    problems = {}
    if not r["loss_rel_diff"] <= STEP_LOSS_REL:
        problems["loss"] = f"loss relative |diff| {r['loss_rel_diff']}"
    if not r["max_grad_rel_l2"] <= STEP_GRAD_REL_L2:
        problems["gradient"] = (f"gradient '{r['worst_grad']}' relative L2 "
                                f"{r['max_grad_rel_l2']}")
    if not r["zero_grad_max_norm"] <= r["bound_zero_grad_norm"]:
        problems["zero gradient"] = ("a zero-by-construction gradient has "
                                     f"norm {r['zero_grad_max_norm']}")
    if not r["update_rel_l2"] <= STEP_UPDATE_REL_L2:
        problems["update"] = f"update relative L2 {r['update_rel_l2']}"
    if not r["param_max_abs_diff"] <= STEP_PARAM_MAX_ABS:
        problems["params"] = ("params after the update max |diff| "
                              f"{r['param_max_abs_diff']}")
    return problems


def phase_train_step(card):
    """One float32 train step of full-width raft/baseline, 12 iterations,
    card vs CPU from the same weights and batch, frozen batch norm. The
    same step on the card with TF32 convolutions and matmuls is read
    against the same bounds, to show that they can fail."""
    from raft_meets_dicl_tpu_torch import parallel, strategy
    from raft_meets_dicl_tpu_torch.ops import convex

    set_tf32(False)
    rng = np.random.default_rng(2)
    b, h, w = STEP_SHAPE
    batch = [rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             (4 * rng.standard_normal((b, h, w, 2))).astype(np.float32),
             rng.uniform(size=(b, h, w)) > 0.1]
    batch = [torch.from_numpy(x) for x in batch]

    optimizer = strategy.spec.OptimizerSpec("adam-w", {
        "lr": STEP_LR, "weight_decay": 1e-4, "eps": STEP_EPS})
    gradient = strategy.spec.GradientSpec.from_config(
        {"clip": {"type": "norm", "value": 1.0}})

    cpu_spec = _load_raft(False)
    cpu_spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    weights = {n: t.clone()
               for n, t in cpu_spec.model.module.state_dict().items()}
    before = {n: p.detach().clone()
              for n, p in cpu_spec.model.module.named_parameters()}

    def run(device):
        spec = cpu_spec
        if device == "cuda":
            spec = _load_raft(False)
            spec.model.module.load_state_dict(weights)
            spec.model.module.to("cuda")
        spec.model.on_stage(None, freeze_batchnorm=True)
        tx, _ = optimizer.build(spec.model.module.parameters(), gradient)
        step = parallel.make_train_step(spec.model, spec.loss,
                                        with_grads=True)
        state = parallel.TrainState(spec.model, tx)
        _, aux = step(state, STEP_LR, *(x.to(device) for x in batch))
        return spec, aux

    convex.launches = convex.bwd_launches = 0
    gpu_spec, aux_gpu = run("cuda")
    torch.cuda.synchronize()
    launches = (convex.launches, convex.bwd_launches)
    if launches != (1, 1):
        raise AssertionError(f"train step launched the forward/backward "
                             f"kernels {launches} times, expected (1, 1)")
    set_tf32(True)
    tf32_spec, aux_tf32 = run("cuda")
    set_tf32(False)

    t0 = time.perf_counter()
    # the CPU reference in true float32: oneDNN's conv backward can be
    # ~4e-3 off a float64 run, the native convs are not
    with torch.backends.mkldnn.flags(enabled=False):
        _, aux_cpu = run("cpu")
    cpu_s = time.perf_counter() - t0

    readings = _step_readings(gpu_spec, aux_gpu, cpu_spec, aux_cpu, before)
    tf32 = _step_readings(tf32_spec, aux_tf32, cpu_spec, aux_cpu, before)
    emit(phase="train-step", model="raft/baseline", shape=list(STEP_SHAPE),
         iterations=12, tf32=False,
         optimizer=f"adam-w (eps {STEP_EPS}) + clip norm 1.0", lr=STEP_LR,
         frozen_bn=True, loss_cpu=aux_cpu["loss"].item(),
         grad_norm_cpu=aux_cpu["grad_norm"].item(),
         update_norm_cpu=aux_cpu["update_norm"].item(),
         bound_loss_rel=STEP_LOSS_REL, bound_grad_rel_l2=STEP_GRAD_REL_L2,
         bound_update_rel_l2=STEP_UPDATE_REL_L2,
         bound_param=STEP_PARAM_MAX_ABS, launches_fwd_bwd=list(launches),
         cpu_step_s=round(cpu_s, 3), card=card, **readings,
         tf32_readings=tf32, tf32_outside_bounds=_step_problems(tf32))
    problems = list(_step_problems(readings).values())
    # each bound must tell the TF32 step from the float32 one (H100 runs
    # read TF32 4.4x to 7.4x over them, see PERF.md), or it could not fail
    blind = set(STEP_TF32_BREAKS) - set(_step_problems(tf32))
    if blind:
        problems.append(f"the TF32 step stays inside the {sorted(blind)} "
                        "bounds")
    if problems:
        raise AssertionError("train step card vs CPU: " + "; ".join(problems))


def _write_training_tree(root):
    """A generic-layout dataset of one scene: TRAIN_PAIRS + 1 frames of a
    smooth random texture, each shifted by a constant (3, -2) px from the
    last, so every pair's flow is that shift; PNG frames, .flo flows."""
    import cv2

    from raft_meets_dicl_tpu_torch.data import io

    h, w = TRAIN_SHAPE
    dx, dy = 3, -2
    rng = np.random.default_rng(3)
    base = cv2.resize(rng.integers(0, 256, (h // 4, w // 4, 3), np.uint8),
                      (w, h), interpolation=cv2.INTER_CUBIC)
    flow = np.broadcast_to(np.array([dx, dy], np.float32), (h, w, 2))
    (root / "frames").mkdir(parents=True)
    (root / "flows").mkdir()
    for i in range(TRAIN_PAIRS + 1):
        frame = np.roll(base, (i * dy, i * dx), axis=(0, 1))
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"), frame)
        if i < TRAIN_PAIRS:
            io.write_flow_mb(root / "flows" / f"frame_{i:04d}.flo", flow)

    (root / "dataset.yaml").write_text(
        "name: synthetic scene\n"
        "id: synthetic\n"
        "path: .\n"
        "layout:\n"
        "  type: generic\n"
        "  images: 'frames/frame_{idx:04d}.png'\n"
        "  flows: 'flows/frame_{idx:04d}.flo'\n"
        "  key: 'synthetic/{idx:04d}'\n")
    # s1-things.yaml's optimizer, one-cycle schedule, clip and loss gamma
    (root / "strategy.yaml").write_text(
        "mode: continuous\n"
        "stages:\n"
        "  - name: synthetic scene, s1-things recipe\n"
        "    id: synthetic/s1\n"
        "    data:\n"
        "      epochs: 2\n"
        f"      batch-size: {TRAIN_BATCH}\n"
        "      source: {type: dataset, spec: dataset.yaml}\n"
        "    model:\n"
        "      on-stage: {freeze_batchnorm: true}\n"
        "    loss:\n"
        "      arguments: {gamma: 0.8}\n"
        "    optimizer:\n"
        "      type: adam-w\n"
        "      parameters: {lr: 0.000125, weight_decay: 0.0001, eps: 1.0e-8}\n"
        "    lr-scheduler:\n"
        "      instance:\n"
        "        - type: one-cycle\n"
        "          parameters: {max_lr: 0.000125, total_steps: '100000 + 100',\n"
        "                       pct_start: 0.05, cycle_momentum: false,\n"
        "                       anneal_strategy: linear}\n"
        "    gradient:\n"
        "      clip: {type: norm, value: 1.0}\n")


def phase_train(card):
    """The train command end to end with the shipped bf16-policy config."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.ops import convex

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _write_training_tree(tmp / "data")
        write_s = time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        convex.launches = convex.bwd_launches = 0
        t0 = time.perf_counter()
        tctx = port_main.main([
            "train", "-d", str(tmp / "data" / "strategy.yaml"),
            "-m", str(ROOT / "cfg" / "model" / "raft-baseline.yaml"),
            "-o", str(tmp / "runs"), "--limit-steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = (convex.launches, convex.bwd_launches)
        peak = torch.cuda.max_memory_allocated()
        run_files = sorted(p.name for p in tctx.path.iterdir())

        # the stage's loader alone for one epoch, as an epoch of the run
        # starts it: its worker processes start, then each batch arrives
        loader_ms = []
        t0 = time.perf_counter()
        for _ in tctx.data:
            loader_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()

    history = tctx.history
    steps = len(history)
    problems = []
    if steps != TRAIN_STEPS or tctx.step != TRAIN_STEPS:
        problems.append(f"ran {steps} steps, expected {TRAIN_STEPS}")
    if not all(np.isfinite(h["loss"]) and h["finite"] for h in history):
        problems.append("non-finite loss or flow: "
                        f"{[h['loss'] for h in history]}")
    if launches != (steps, steps):
        problems.append(f"forward/backward kernels launched {launches} "
                        f"times, expected {steps} each")
    if not {"config.json", "main.log", "model.txt"} <= set(run_files):
        problems.append(f"run directory holds {run_files}")
    if problems:
        raise AssertionError("train phase: " + "; ".join(problems))

    # the first step pays one-time costs (loader start, library warm-up):
    # the median leaves it out, the whole window's rate keeps it
    step_ms = [h["ms"] for h in history]
    median_ms = statistics.median(step_ms[1:])
    emit(phase="train", model="raft/baseline (bf16 policy, frozen BN)",
         shape=[TRAIN_BATCH, *TRAIN_SHAPE], iterations=12, steps=steps,
         losses=[h["loss"] for h in history],
         lrs=[h["lr"] for h in history],
         grad_norms=[h["grad_norm"] for h in history],
         step_ms=step_ms, median_step_ms=median_ms,
         pairs_per_sec=TRAIN_BATCH * 1e3 / median_ms,
         window_pairs_per_sec=TRAIN_BATCH * steps * 1e3 / sum(step_ms),
         wall_pairs_per_sec=TRAIN_BATCH * steps / wall_s,
         max_memory_allocated=peak, launches_fwd_bwd=list(launches),
         loader_workers=tctx.data.num_workers, loader_batch_ms=loader_ms,
         wall_s=round(wall_s, 3), dataset_write_s=round(write_s, 3),
         run_files=run_files, card=card)
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
    serve_launches = phase_serve(card)
    bwd_cases = phase_kernels_bwd(card)
    phase_train_step(card)
    train_fwd, train_bwd = phase_train(card)

    fwd_case = next(c for c in cases
                    if c["dtype"] == "bfloat16" and c["rows"] == TRAIN_M)
    bwd_case = next(c for c in bwd_cases
                    if c["dtype"] == "bfloat16" and c["rows"] == TRAIN_M)
    source = "raft_meets_dicl_tpu_torch/csrc/convex_combine_8x.cu"
    shape = (f"bf16 logits, M={TRAIN_M} (training, batch 6 at 400x720, "
             "12 iterations)")
    print(json.dumps({"kernels": [{
        "name": "convex_combine_8x",
        "route": "cuda",
        "source": source,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:110",
        "launches": train_fwd,
        "launches_by_path": {"serve": serve_launches, "train": train_fwd},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": fwd_case["ms"],
        "plain_ms": fwd_case["plain_ms"],
        "bound_ms": fwd_case["bound_ms"],
        "bound_by": fwd_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the neighbour "
                        "softmax + convex combine",
        "tolerance": "max |diff| <= 1e-5",
        "shape": shape,
        "cases": cases,
    }, {
        "name": "convex_combine_8x_bwd",
        "route": "cuda",
        "source": source,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:136",
        "launches": train_bwd,
        "launches_by_path": {"train": train_bwd},
        "max_abs_err": max(c["max_abs_err"] for c in bwd_cases),
        "ms": bwd_case["ms"],
        "plain_ms": bwd_case["plain_ms"],
        "bound_ms": bwd_case["bound_ms"],
        "bound_by": bwd_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the backward of "
                        "the neighbour softmax + convex combine",
        "tolerance": "float32 outputs max |diff| <= 1e-5; bf16 dlogits "
                     "|diff| <= 1e-5 + one bf16 ulp of the larger value",
        "shape": shape,
        "cases": bwd_cases,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
