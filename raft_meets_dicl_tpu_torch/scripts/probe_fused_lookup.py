"""Does a hand-written lookup kernel beat the batched-matmul lookup on the
card? The level-0 windowed lookup contraction, ``wy · corr · wxᵀ`` per
source position, timed four ways:

  A. the batched ``torch.matmul`` pair: what the port's model lookup runs
     (``ops/corr.py::_lookup_level``), the library call
  B. the stage-1 kernel (``ops.lookup.lookup_stage1``, t = wy @ corr)
  C. the fused kernel (``ops.lookup.lookup_fused``: t rounded to the
     inputs' dtype in registers, then t @ wxᵀ, in bf16 a second
     tensor-core product fed from the first's accumulators; t never
     reaches device memory)
  D. arm A over the u8-quantized volume (``ops.quant.quantize_level``,
     outside the timer): the volume is dequantized to the working dtype
     (a materialized copy in PyTorch), contracted, and the per-sample
     scale multiplies the (K, K) output, the quantized tier's lookup

    python -m raft_meets_dicl_tpu_torch.scripts.probe_fused_lookup \\
        [--dtype bf16|f32] [--steps 20] [--batch 6 --ni 50 --nj 90 \\
         --h2 50 --w2 90] [--device cuda|cpu]

Counterpart of the JAX repository's ``scripts/probe_fused_lookup.py``,
with the same inputs from ``np.random.RandomState(0)``: hat matrices
around random in-range centres for wy and wx, randn for corr. The
default shapes are its bench config, level 0 of batch 6 at 400x720.

Each arm prints its time per call, its rate (the dense contraction's
operations over that time) and its largest |difference|: B against the
plain stage 1, C and D against A, each beside its stated bound (below);
a difference over its bound, or any arm's error, ends the run with a
non-zero exit. On ``cuda`` (the default; without CUDA the run fails) times
are CUDA events over ``--steps`` calls after one warm-up call, TF32 and
cuBLAS's reduced-precision bf16 reductions are off for the whole run, and
every number is the card's, named with ``nvidia-smi``'s name and power
limit. ``--device cpu`` runs the plain versions for B and C on the host
clock (a check of the script, not a measurement). The last line is one
JSON object with every arm, the kernel launches and the device.

Bounds, elementwise, with S the same contraction of |wy|, |corr|, |wx|:
B: 2^-13 S1 (float32 sums in another order: at most 2 (n - 1) 2^-24 S
for n <= 1,024 terms); C: 2^-13 S + Σ_w ulp(t_A) |wx| (t rounded to bf16
after sums in another order can differ by one ulp; 0 in float32);
D: the same plus (step / 2) (Σ_h |wy|) (Σ_w |wx|) + scale · Σ_w
ulp(t_D) |wx| (each volume value is off by at most half a step).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import lookup, quant

ORDER_REL = 2.0 ** -13
RADIUS = 4


def make_inputs(b, ni, nj, h2, w2, dtype, device):
    """wy (B, NI, NJ, K, H2), corr (B, NI, NJ, H2, W2), wx (B, NI, NJ, K,
    W2) as the JAX probe builds them (float32 numpy, rounded to ``dtype``
    once)."""
    if h2 <= 10 or w2 <= 10:
        raise ValueError(f"the hat centres need H2, W2 > 10, got {h2}, {w2}")
    rs = np.random.RandomState(0)
    cy = rs.rand(b, ni, nj, 1) * (h2 - 10) + 5
    cx = rs.rand(b, ni, nj, 1) * (w2 - 10) + 5
    d = np.arange(-RADIUS, RADIUS + 1)
    wy = np.maximum(
        0.0, 1.0 - np.abs((cy + d)[..., None] - np.arange(h2))).astype("f4")
    wx = np.maximum(
        0.0, 1.0 - np.abs((cx + d)[..., None] - np.arange(w2))).astype("f4")
    corr = rs.randn(b, ni, nj, h2, w2).astype("f4")
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (wy, corr, wx))


def matmul_lookup(wy, corr, wx):
    """Arm A: the model lookup's two batched matmuls (t in the inputs'
    dtype, the second contraction in float32)."""
    t = torch.matmul(wy, corr)
    return torch.matmul(t.float(), wx.float().transpose(-1, -2))


def dequant_lookup(wy, values, scale, wx):
    """Arm D: the u8 volume dequantized to wy's dtype, arm A's matmuls,
    the per-sample scale on the (K, K) output."""
    deq = values.to(wy.dtype) - quant.zero_point(values)
    return matmul_lookup(wy, deq, wx) * scale


def bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (float32 in and out); 0 at 0."""
    _, exp = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), exp - 8))


def _time(fn, steps, device):
    """(ms per call over ``steps`` calls after one warm-up, the warm-up
    call's output)."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps, out
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / steps, out


def _share(err, bound):
    """Largest |err| and its largest share of the elementwise bound."""
    return err.max().item(), (err / bound.clamp(min=1e-30)).max().item()


def bf16_ulp_term(t, wx):
    """Σ_w ulp(t[k, w]) |wx[a, w]|: one bf16 ulp of t through stage 2."""
    return torch.matmul(bf16_ulp(t.float()), wx.float().abs()
                        .transpose(-1, -2))


def _card_name():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def probe(b, ni, nj, h2, w2, dtype, steps, device):
    """Run the four arms; returns the result dict (raises on an arm's
    error)."""
    bf16 = dtype == torch.bfloat16
    wy, corr, wx = make_inputs(b, ni, nj, h2, w2, dtype, device)
    k = 2 * RADIUS + 1
    n = b * ni * nj
    flops_s1 = 2 * n * k * h2 * w2
    flops_full = flops_s1 + 2 * n * k * w2 * k
    arms = {}

    def arm(name, fn, flops):
        ms, out = _time(fn, steps, device)
        arms[name] = {"ms": ms, "tflop_s": flops / ms / 1e9}
        return out

    lookup.stage1_launches = lookup.fused_launches = 0
    out_a = arm("A", lambda: matmul_lookup(wy, corr, wx), flops_full)
    out_b = arm("B", lambda: lookup.lookup_stage1(wy, corr), flops_s1)
    out_c = arm("C", lambda: lookup.lookup_fused(wy, corr, wx), flops_full)
    launches = {"lookup_stage1": lookup.stage1_launches,
                "lookup_fused": lookup.fused_launches}

    # D: quantization is a one-time cost at pyramid build, outside the timer
    level = quant.quantize_level(corr.float(), "u8")
    out_d = arm("D", lambda: dequant_lookup(wy, level.values, level.scale,
                                            wx), flops_full)

    absw = (wy.float().abs(), corr.float().abs(), wx.float().abs())
    s1 = lookup.lookup_stage1_reference(*absw[:2])
    err, share = _share((out_b - lookup.lookup_stage1_reference(wy, corr))
                        .abs(), ORDER_REL * s1)
    arms["B"].update(vs="plain stage 1", max_abs_diff=err, share=share)
    del s1

    s = lookup.lookup_fused_reference(*absw)
    t_a = torch.matmul(wy, corr)
    ulp_a = bf16_ulp_term(t_a, wx) if bf16 else torch.zeros_like(s)
    err, share = _share((out_c - out_a).abs(), ORDER_REL * s + ulp_a)
    arms["C"].update(vs="A", max_abs_diff=err, share=share)

    deq = level.values.to(dtype) - quant.zero_point(level.values)
    t_d = torch.matmul(wy, deq)
    ulp_d = (bf16_ulp_term(t_d, wx) * level.scale if bf16
             else torch.zeros_like(s))
    half_step = 0.5 * level.scale
    rows = absw[0].sum(-1, keepdim=True) * absw[2].sum(-1)[..., None, :]
    err, share = _share((out_d - out_a).abs(),
                        ORDER_REL * s + ulp_a + ulp_d + half_step * rows)
    arms["D"].update(vs="A", max_abs_diff=err, share=share,
                     step=level.scale.max().item(),
                     volume_bytes_ratio=corr.element_size())
    arms["A"].update(max_abs_diff=0.0)
    for name in "ABCD":
        if not torch.isfinite(torch.tensor(arms[name]["max_abs_diff"])):
            raise AssertionError(f"arm {name}: non-finite difference")
    return {"shape": {"b": b, "ni": ni, "nj": nj, "k": k, "h2": h2,
                      "w2": w2},
            "dtype": "bf16" if bf16 else "f32", "steps": steps,
            "arms": arms, "launches": launches,
            "flops": {"stage1": flops_s1, "full": flops_full}}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m raft_meets_dicl_tpu_torch.scripts.probe_fused_lookup",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--ni", type=int, default=50)
    ap.add_argument("--nj", type=int, default=90)
    ap.add_argument("--h2", type=int, default=50)
    ap.add_argument("--w2", type=int, default=90)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda, cuda:N or cpu [default: cuda; "
                         "fails without CUDA]")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("probe_fused_lookup: --device cuda but "
              "torch.cuda.is_available() is False; pass --device cpu to run "
              "the plain versions", file=sys.stderr)
        return 2
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32

    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction)
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        result = probe(args.batch, args.ni, args.nj, args.h2, args.w2, dtype,
                       args.steps, device)
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = \
            saved
    if device.type == "cuda":
        result["device"] = {"name": torch.cuda.get_device_name(device),
                            "nvidia_smi": _card_name()}
    else:
        result["device"] = {"name": "cpu (host clock; not a card timing)"}

    arms = result["arms"]
    labels = {"A": "torch.matmul pair (both stages)",
              "B": "stage-1 kernel",
              "C": "fused kernel (both stages)",
              "D": "u8 volume, dequant + matmul pair"}
    print(f"device: {result['device'].get('nvidia_smi', result['device']['name'])}; "
          f"{result['dtype']}, shape {result['shape']}")
    for name in "ABCD":
        a = arms[name]
        print(f"{name}  {labels[name]:<34} {a['ms']:9.4f} ms  "
              f"({a['tflop_s']:.3f} TFLOP/s)")
        if name != "A":
            print(f"   max |{name} - {a['vs']}| = {a['max_abs_diff']:.3e} "
                  f"({a['share']:.3g} of its bound)")
    print(f"   u8 step {arms['D']['step']:.3e}; volume bytes 1/"
          f"{arms['D']['volume_bytes_ratio']} of arm A")
    print(json.dumps({"probe": result}), flush=True)
    over = [name for name in "BCD" if not arms[name]["share"] <= 1.0]
    if over:
        print(f"probe_fused_lookup: arms {over} exceed their bounds",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
