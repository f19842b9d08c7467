#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``raft_meets_dicl_tpu_torch`` — never JAX or the JAX package — on
the card and fails (non-zero exit, no result line) on any fault:

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the paths (``convex_combine_8x``,
   ``sample_window``, ``windowed_corr`` and ``fused_lookup``, one source
   each), compiled
   with one ``nvcc`` per source, all started together, for ``sm_90a`` from
   ``raft_meets_dicl_tpu_torch/csrc``; ptxas registers and spills printed;
3. kernels: the forward against its plain PyTorch version on the card, at
   the main paths' shapes (raft/baseline's and ctf-l3's rows, both logits
   dtypes), with TF32 off (max |diff| <= 1e-5), and timed (CUDA events)
   beside its plain version and its bound;
4. model: ``raft/baseline`` in float32 at 1x368x496, 12 iterations, one
   seeded init, on the card against the same weights on the CPU, TF32 off;
   the kernel must launch exactly once per forward;
5. serve: the ``serve`` command (``main serve``) with the shipped
   ``cfg/model/raft-baseline.yaml`` (bf16 policy), buckets 368x496 and
   448x1024, batch 4, 16 requests at 50/s: every request completes, no
   errors or sheds, every flow finite, and the kernel launched once per
   dispatched batch (warm-up included);
6. kernels, backward: the backward kernel against autograd of the plain
   version on the card, TF32 off, both logits dtypes, at M = 700, 34,224,
   324,000 (raft/baseline training) and 92,160 (ctf-l3 training): float32
   outputs within 1e-5, bf16
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
   printed;
9. sampler kernels: ``sample_window`` forward and backward
   (``csrc/sample_window.cu``) against the plain version and its autograd
   on the card, TF32 off, at the ctf-l3 paths' shapes (training levels
   3-5 at b10 384x512, level 3 also bf16; the 448x1024 serve bucket's
   level 3; two ragged tiny cases with far out-of-bounds centres, whose
   windows must be exact zeros), each timed beside the plain version, its
   bound and ``F.grid_sample`` (in float32 checked against the plain
   version first; in bf16 timed if it takes bf16, its refusal printed if
   not);
10. ctf model: ``raft+dicl/ctf-l3`` in float32, full width, iterations
   (4, 3, 3), at 1x384x512, card vs CPU from one seeded init, TF32 off;
   the sampler launches exactly 10 times per forward, the combine once;
11. ctf serve: ``main serve`` with the shipped ctf-l3 config (f32),
   buckets 384x512 and 448x1024, batch 4, 16 requests;
12. ctf train step: one float32 step of full-width ctf-l3 at 2x128x192
   with live batch norm and s0-chairs' AdamW (at eps 1e-3) and clip, card
   vs CPU, bounds below; each sampler kernel launches 10 times, each
   combine kernel once; the same step with TF32 must break each bound;
13. ctf train: ``main train`` with the shipped ctf-l3 config and the
   s0-chairs stage settings (live batch norm, AdamW, one-cycle, clip),
   batch 10 at 384x512, 8 steps: every loss finite, 10 + 10 sampler and
   1 + 1 combine launches per step; median step ms, pairs/s, peak memory
   and whether cuDNN TF32 was on printed;
14. windowed-correlation kernels: ``windowed_corr_pyramid`` forward, df1
   and df2 (``csrc/windowed_corr.cu``) against the plain version and its
   autograd on the card, TF32 off, at raft/fs's shapes (level 0 of the
   1080x1920 serve bucket at batch 2 and of the 2560x1072 train crop, bf16;
   all 4 levels at 368x496 f32 and at 2560x1072 bf16; two ragged cases;
   all 4 levels at 2560x1072 again with a smooth flow and a motion
   boundary), far windows exact zeros; each timed beside the plain
   version and its bound; the tiles of each level down each path
   (``fwd_paths``, ``df1_paths``, ``df2_paths``: tile, per-position or
   direct, none in bounds), counted by the forward, df1 and df2 kernels,
   equal to the rule ``tile_paths`` computes from the centres at the
   kernels' side limit (``MAX_BOX``; 0 for the float32 forward and df1,
   which have no tile path), with the tile-path shares
   (``fwd_tile_share``, ``df1_tile_share``, ``df2_tile_share``); the
   counting forward launch equals the first bit for bit; one non-finite
   f2 pixel makes the bfloat16 df1's rows of the windows that hold it
   non-finite and leaves the rows of every tile whose box does not hold it
   bit for bit as they were (the tile path's product may carry it to the
   other rows of its tiles: counted as ``leaked_rows``);
15. fs model: ``raft/fs`` in float32, full width, 12 iterations, at
   1x368x496, card vs CPU from one seeded init at three budgets
   (``RMD_FS_VOLUME_GIB`` 0: every level windowed; 0.01: two; the
   default: none), each forward launching the kernel 12 times where a
   level is windowed; the same forward with TF32 must break the bound;
16. fs serve: ``main serve`` with the shipped raft/fs config (bf16
   policy), buckets 1080x1920 and 448x1024, batch 2, 16 requests: the
   kernel launches 12 times per dispatched 1080p batch (warm-up included)
   and never at 448x1024, as ``volume_level_split`` decides;
17. fs train step: one float32 step of full-width raft/fs at 2x128x192,
   frozen batch norm, the hd1k-1080p stage's AdamW (eps 1e-3) and clip,
   card vs CPU, with every level windowed (12 forward, 12 df1 and 48 df2
   launches) and again with every level on volumes (no windowed launch),
   both against the same bounds; the same steps with TF32 must break each
   bound;
18. fs train: ``main train`` with the shipped raft/fs config and the
   hd1k-1080p stage's optimizer, schedule and clip, batch 1 at 2560x1072,
   8 steps, default budget (level 0 windowed): every loss finite, 12 + 12
   + 12 windowed-correlation launches per step; then the same run with
   every level windowed (``RMD_FS_VOLUME_GIB`` 0): 12 + 12 + 48;
19. lookup kernels: ``lookup_stage1`` and ``lookup_fused``
   (``csrc/fused_lookup.cu``) against their plain versions on the card,
   TF32 and cuBLAS's reduced-precision bf16 reductions off, at the
   lookup probe's bench case (level 0 of batch 6 at 400x720, its hat
   inputs) in bf16 and f32, dense random weights, ragged, wide and
   widest-row cases (each of the fused kernel's modes and tile splits,
   its plan from the built library equal to ``lookup.fused_plan``), each
   timed beside the plain version, its bound and the ``torch.matmul`` pair
   (checked against the plain version too); at the dense cases corr set
   to +inf at one element of one position makes that position's fused
   outputs non-finite wherever the plain version's are and leaves every
   other position's bit for bit as on finite inputs; then the
   probe itself (``python -m raft_meets_dicl_tpu_torch.scripts.
   probe_fused_lookup``, bf16 and f32, its own process): all four arms
   within their bounds, each kernel launched once per timed call and once
   to warm up;
20. quantized tier: the int8 pyramid, the u8 pyramid and u8/i8 levels of
   identical inputs on the card and the CPU (the levels and int8 level 0
   bit for bit, pooled int8 levels one step at most; u8 values one step
   apart in a share TF32 on the volume matmul must exceed), then
   ``raft/baseline`` in float32 at 1x368x496, 12 iterations, with
   ``quant`` u8 and i8, and ``raft/fs`` with u8 at ``RMD_FS_VOLUME_GIB``
   0.01 (two quantized volume levels), card vs CPU from one seeded init,
   TF32 off, the card's volumes built from the CPU's feature maps: the
   first iteration's and the final flow within their bounds below, the
   same forward with TF32 outside the first's, and the tier's own effect
   (quantized vs the card's unquantized flow) larger than each; the card's
   run from its own features is read beside it;
21. lifecycle: ``raft/baseline`` (shipped bf16-policy config, frozen BN)
   through ``main train`` with ``cfg/inspect/default.yaml``: a two-stage
   ``mode: best`` strategy shaped like ``s1-things.yaml`` (no augment or
   concat), batch 6 at 400x720, 2 epochs of 2 steps a stage, each epoch
   validated on a 436x1024 tree (Sintel's size, batch 2, sample 0's
   images): every epoch's metric-named checkpoint kept, stage 2 started
   from stage 1's best by ``compare`` (the live weights bit for bit), a
   loaded checkpoint re-saved bit for bit, the validation scalars and four
   images a pass in the event file; the same run with ``compare`` on the
   step count, so stage 1's best is its first checkpoint and not its
   latest, stopped after stage 2's first step: stage 2 started from that
   checkpoint's weights bit for bit and not from stage 1's last ones; a
   run stopped by ``--limit-steps`` at the first epoch's end, then
   ``--resume auto``: the weights and buffers, the AdamW moments and step
   counts and the schedulers' steps restored bit for bit, the run
   finished; ``serve`` from the final checkpoint, 16 requests, request 0
   equal to the in-process forward of the checkpoint on its pair. The
   combine kernels' launches are read around each validation pass (one
   forward a batch, no backward), the train path's are the rest of each
   run (a forward and a backward a step), and serve's around the serve
   run (one a served or warm-up batch). Save times (blocking and
   background ms), file sizes, validation ms per batch with the pass's
   validation-step device ms and image-write host ms, and the resumed
   run's first step are printed;
22. augmented train: the shipped ``s1-things.yaml`` data graph through
   ``main train`` (shipped bf16-policy ``raft/baseline``, frozen BN):
   ``augment`` over ``concat`` of the FlyingThings clean and final passes,
   loaded through the shipped ``cfg/data`` sources and FlyingThings spec
   (``multi`` layout, PFM flows) with the spec's path at a 540x960
   FlyingThings3D-shaped tree (4 batches of 6 an epoch); its six
   augmentations, crop 720x400, batch 6, AdamW, one-cycle and clip as
   shipped; 2 epochs, 8 steps, its two validation entries on a 2-pair
   436x1024 tree. Run at the loader's default 4 workers and again at 16
   through ``-e cfg/env/w16.yaml`` (the environment's ``loader``): every
   loss finite, the combine kernels launched once forward and once
   backward a step and once a validation batch; in the default run the
   pairs the steps receive in epochs 0 and 1 equal, bit for bit, the
   stage's input pipeline run in this process after ``set_epoch(0)`` /
   ``set_epoch(1)``, every index once an epoch, and no pair of epoch 1
   equals one of epoch 0. Printed: median step ms and pairs/s (at the
   median and over the window), ``loader_batch_ms`` of the stage's loader
   alone, the CPU count, torch's and cv2's threads and the workers, one
   sample's host ms for its decode and each augmentation, and phase 8's
   median step beside these;
23. evaluate: ``main evaluate`` of the shipped ``raft/baseline`` config
   (bf16 policy, 12 iterations) from a checkpoint of its seeded initial
   weights written in the phase by the port's ``Checkpoint.save``, over
   the shipped ``cfg/data`` Sintel (clean, training) and KITTI 2015
   (training) sources with their specs' path at synthetic trees: Sintel
   436x1024, 2 scenes of 6 frames (10 pairs, .flo flows), batch 4, with
   a report and ``visual:flow`` images (3 batches, 3 combine launches),
   then with ``--fwbw`` and ``visual:occlusion`` (3 + 10 launches); KITTI
   8 pairs at 375x1242, 370x1224, 376x1241 and 374x1238 (16-bit
   ``flow_occ`` PNGs, 30% of pixels invalid), batch 4, ``--buckets
   376x1248`` (2 batches, 2 launches), then ``--buckets group`` (3
   batches, each remainder padded to 4, 3 launches). Each report and its
   JSONL hold every sample once in the loader's order; each sample's EPE
   and loss equal this process's recomputation (``make_eval_fn`` on the
   same batches, ``metrics/functional.py``, the config's loss) within
   1e-3 px + 1e-4 relative and 1e-4 relative; the pad waste equals the
   trees' extents'; every final flow and metric is finite; the combine
   kernel never launches backward. Then each of the 12 flow formats from
   a one-sample run (``--flow-only`` where the format reads no ground
   truth): every file decodes at 436x1024. Printed per sweep: samples/s,
   dispatch and drain ms per batch (``EvalRunStats.phases``), the
   forward's device ms per batch (CUDA events), host ms per sample for
   the loss and metrics and for the image write, the pad waste and the
   peak device memory;
24. wire-env: ``main serve -c cfg/serve/example.yaml`` as it ships (u8
   wire, buckets 384x1280 and 448x1024, batch 4, 32 requests at 50/s):
   every request served, no non-finite flow, the combine launched once a
   batch and once a warm-up bucket, request 0 within 1e-3 px of the
   in-process f32-path forward of its host-decoded images at the
   dispatched batch's shape; the same with ``--wire-format f32``
   (host->device bytes a batch, dispatch span, p50/p99 and pairs/s of
   both printed). ``main train`` (batch 6 at 400x720, 6 steps from fixed
   seeds) on the f32 wire, the bf16 wire of ``-e cfg/env/wire-bf16.yaml``
   and ``--wire-format u8``, over a tree whose frame 0 is a truncated PNG:
   33, 16.125 and 10.125 bytes a pixel cross each step, the first loss of
   bf16 and u8 within 2e-2 and 5e-2 of f32's (JAX's own tolerances), one
   substitution logged and counted a run, the combine kernels once
   forward and once backward a step. ``main evaluate --wire-format u8``
   over phase 23's Sintel tree: each sample's EPE and loss equal to this
   process's recomputation through the same wire, dispatch ms a batch
   printed beside phase 23's f32 sweep. Phase 22's s1-things run from
   fixed seeds, then rerun twice from its own ``config.json`` with ``-c
   ... --reproduce -e cfg/env/deterministic.yaml``, side by side, each in
   a process of its own: their losses equal bit for bit.

Each phase prints one JSON line (and a ``timing`` line); every phase runs
even after another failed, and a failure ends the run with exit code 1
and no result line. Then the ``kernels`` line (the nine kernels, each
with ``launches`` from its slice's main path, ``main train`` or the
probe's bf16 run, and ``launches_by_path``),
the card's ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
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

# rows of the convex combine: iterations * batch * (H/8) * (W/8); raft/
# baseline runs 12 iterations, ctf-l3 combines its finest level's 3
ENTRY_M = 12 * 1 * (368 // 8) * (496 // 8)         # 34,224
SERVE_SMALL_M = 12 * 4 * (368 // 8) * (496 // 8)   # 136,896
SERVE_M = 12 * 4 * (448 // 8) * (1024 // 8)        # 344,064
TRAIN_M = 12 * 6 * (400 // 8) * (720 // 8)         # 324,000
CTF_SERVE_SMALL_M = 3 * 4 * (384 // 8) * (512 // 8)   # 36,864
CTF_SERVE_M = 3 * 4 * (448 // 8) * (1024 // 8)        # 86,016
CTF_TRAIN_M = 3 * 10 * (384 // 8) * (512 // 8)        # 92,160
KERNEL_ROWS = (700, ENTRY_M, SERVE_SMALL_M, SERVE_M, TRAIN_M,
               CTF_SERVE_SMALL_M, CTF_SERVE_M, CTF_TRAIN_M)
BWD_ROWS = (700, ENTRY_M, TRAIN_M, CTF_TRAIN_M)

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

# the lifecycle phase: two stages of LIFE_EPOCHS epochs of LIFE_PAIRS pairs
# at batch TRAIN_BATCH (2 steps an epoch), each epoch validated on a
# Sintel-sized tree (LIFE_VAL_PAIRS pairs at batch 2: 2 batches a pass)
LIFE_EPOCHS = 2
LIFE_PAIRS = 12
LIFE_VAL_SHAPE = (436, 1024)
LIFE_VAL_PAIRS = 4
LIFE_VAL_BATCH = 2
# served request 0 against the in-process forward of the same checkpoint
# on the same pair at the dispatched batch's shape: the same kernels on the
# same inputs, so the bound is the model phase's card-vs-CPU one, which the
# two runs should read far below
LIFE_SERVE_MAX_ABS_PX = 1e-3
LIFE_BUCKETS = "368x496,448x1024"

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
# the median over gradient tensors of their relative L2: the worst tensor
# alone can hide a shift of them all. H100 runs read 1.6e-5 (TF32 5.8e-3).
STEP_MEDIAN_GRAD_REL_L2 = 1e-4
# the bounds the same step with TF32 convolutions and matmuls must break
STEP_TF32_BREAKS = ("loss", "gradient", "median gradient", "update", "params")
RAFT_STEP_BOUNDS = {"loss": STEP_LOSS_REL, "gradient": STEP_GRAD_REL_L2,
                    "median gradient": STEP_MEDIAN_GRAD_REL_L2,
                    "update": STEP_UPDATE_REL_L2, "params": STEP_PARAM_MAX_ABS}

# every kernel source, built by one nvcc each
KERNEL_SOURCES = ("convex_combine_8x", "sample_window", "windowed_corr",
                  "fused_lookup")

# -- raft+dicl/ctf-l3: the shipped config (f32, radius 4, 32 corr channels),
# the default iterations per level, coarse to fine
CTF_CFG = ROOT / "cfg" / "model" / "raft+dicl-ctf3l.yaml"
CTF_RADIUS = 4
CTF_LEVEL_ITERATIONS = (4, 3, 3)
CTF_ITERATIONS = sum(CTF_LEVEL_ITERATIONS)   # sampler launches per forward
CTF_MODEL_SHAPE = (384, 512)
CTF_BUCKETS = "384x512,448x1024"
# final flow, card vs CPU in float32, relative to the flow's largest |value|:
# 9x the 2.2e-6 (4.6e-4 px on 210 px) an H100 run read (see PERF.md)
CTF_MODEL_REL = 2e-5
CTF_STEP_SHAPE = (2, 128, 192)
CTF_LR = 4e-4                 # s0-chairs' lr (and one-cycle max_lr)
# The ctf-l3 step, card vs CPU in float32, live batch norm. An H100 run
# reads loss 1.3e-6, median gradient 1.9e-4, update 1.2e-2, params 7.0e-5
# and a worst gradient of 4.3e-2 (TF32: 1.6e-4, 0.15, 0.14, 4.6e-4, 0.23).
# The worst tensors are fnet's 1/32 stage and head (4x6 maps), the same
# with the plain sampler on the card: cuDNN's float32 convolutions set
# these bounds (PERF.md)
CTF_STEP_BOUNDS = {"loss": 1e-5, "gradient": 1e-1, "median gradient": 1e-3,
                   "update": 4e-2, "params": 2e-4}
# main train: s0-chairs' batch and crop, 8 batches of one epoch
CTF_TRAIN_SHAPE = (384, 512)
CTF_TRAIN_BATCH = 10
CTF_TRAIN_PAIRS = 80
CTF_TRAIN_STEPS = 8

# sampler cases (b, h2, w2, c, h, w): the ctf paths' levels, f2 and the
# centres on one grid. The training levels 3-5 at b10 384x512 (level 3 also
# in bf16, as under the mixed-precision policy), the 448x1024 serve
# bucket's level 3 at batch 4, and two ragged tiny cases (C = 5, and C = 40:
# one full and one masked 32-channel chunk)
SW_CASES = (
    {"name": "train level 3", "dtype": "float32",
     "shape": (10, 48, 64, 32, 48, 64)},
    {"name": "train level 3", "dtype": "bfloat16",
     "shape": (10, 48, 64, 32, 48, 64)},
    {"name": "train level 4", "dtype": "float32",
     "shape": (10, 24, 32, 32, 24, 32)},
    {"name": "train level 5", "dtype": "float32",
     "shape": (10, 12, 16, 32, 12, 16)},
    {"name": "serve 448x1024 level 3", "dtype": "float32",
     "shape": (4, 56, 128, 32, 56, 128)},
    {"name": "ragged", "dtype": "float32", "shape": (2, 13, 17, 5, 6, 7)},
    {"name": "ragged", "dtype": "bfloat16", "shape": (2, 13, 17, 40, 6, 7)},
)
SW_MAIN_CASE = 0      # the kernels line quotes the level-3 training case
# far out-of-bounds centres (b, y, x, cx, cy): their windows are exact zeros
SW_FAR = ((0, 0, 0, 1e4, -1e4), (1, 2, 3, -3e4, 5.5), (1, 5, 6, 40.0, 1e5))
# float32 operations per window value: the y lerp over K rows of K + 1 taps
# and the x lerp over K x K (3 each: two multiplies, one add), per K^2
# values; the backward runs both transposes and one add per tap
SW_K = 2 * CTF_RADIUS + 1
SW_OPS_PER_VALUE = 3 * (SW_K * (SW_K + 1) + SW_K * SW_K) / (SW_K * SW_K)
SW_BWD_OPS_PER_VALUE = SW_OPS_PER_VALUE + (SW_K + 1) ** 2 / (SW_K * SW_K)
# backward tolerance, relative to S, the sum of the magnitudes of the terms
# each df2 element adds (the plain backward of |dout|: the lerp weights are
# >= 0). Two orders of summing n float32 terms differ by at most
# 2 (n - 1) 2^-24 S; atomics add in any order. 2^-13 covers n <= 1,024
# terms per element; these inputs give about 400 (some 100 windows cover
# each tap, each through up to 4 lerp weights)
SW_BWD_ORDER_REL = 2.0 ** -13

# -- raft/fs: the shipped config (bf16 policy, 4 levels, radius 4, 256
# corr channels, 12 iterations); the windowed-correlation kernels
FS_CFG = ROOT / "cfg" / "model" / "raft-fs.yaml"
FS_RADIUS = 4
FS_ITERATIONS = 12
FS_LEVELS = 4
FS_CHANNELS = 256
# peak rates by input dtype for the windowed correlation's bound: a bf16
# dot runs on the tensor cores (989 TFLOP/s dense; the bf16 forward and df1
# do); a float32 one could not without TF32, which changes the result (67
# TFLOP/s)
PEAK_BF16_OPS_S = 989e12
# operations per position and level: 100 taps x C multiply-adds
WCP_TAPS = (2 * FS_RADIUS + 2) ** 2
# kernel cases (b, h, w at the 1/8 grid; levels windowed; channels): the
# 1080x1920 serve bucket at batch 2 and the 2560x1072 train crop at batch
# 1 (level 0 alone, the default budget's split), both levels-all forms
# (budget 0), the latter again with a smooth flow, and two ragged cases
# (odd sizes, other vector widths) with far out-of-bounds centres. Every
# case but the smooth one centres its windows on the grid plus 4 N(0, 1)
# px of noise drawn independently per position: neighbouring windows
# overlap little, the harder regime for the df2 kernel's tiles. The smooth
# flow (a field of up to 20 px at level 0 with one 40 px motion boundary)
# is what a trained model's flow looks like: its tiles' windows overlap,
# and the tiles astride the boundary take df2's direct path
WCP_CASES = (
    {"name": "serve 1080x1920 b2, level 0", "dtype": "bfloat16",
     "shape": (2, 135, 240), "levels": 1, "c": FS_CHANNELS},
    {"name": "train 2560x1072 b1, level 0", "dtype": "bfloat16",
     "shape": (1, 134, 320), "levels": 1, "c": FS_CHANNELS},
    {"name": "all levels 368x496 b1", "dtype": "float32",
     "shape": (1, 46, 62), "levels": 4, "c": FS_CHANNELS},
    {"name": "all levels 2560x1072 b1", "dtype": "bfloat16",
     "shape": (1, 134, 320), "levels": 4, "c": FS_CHANNELS},
    {"name": "ragged", "dtype": "float32", "shape": (2, 13, 17), "levels": 2,
     "c": 96},
    {"name": "ragged", "dtype": "bfloat16", "shape": (2, 11, 9), "levels": 2,
     "c": 64},
    {"name": "train 2560x1072 b1, smooth flow, all levels",
     "dtype": "bfloat16", "shape": (1, 134, 320), "levels": 4,
     "c": FS_CHANNELS, "flow": "smooth"},
)
WCP_MAIN_CASE = 1     # the kernels line quotes the 2560x1072 training case
# tolerance: |kernel - plain| <= 1e-5 max|plain| + 2^-13 S, S the plain
# function of |f1| and |f2_l| (backward: of |dout| too); the unnormalized
# dots reach |f1| |f2| at C = 256, so the bound scales with S
WCP_ORDER_REL = 2.0 ** -13
# raft/fs model phase: 1x368x496 in float32; budgets (GiB) and the split
# volume_level_split gives at its 46x62 grid (f32 volumes 32.5 / 8.1 / 1.9
# / 0.4 MB per level)
FS_MODEL_SHAPE = (368, 496)
# final flow, card vs CPU in float32, relative to the flow's largest
# |value|. raft's 1e-3 px does not hold here: the unnormalized correlation
# (|f1| |f2| at C = 256) drives the recurrence harder, and an H100 run
# read 3.9e-3 to 5.3e-3 px on 101.6 px flows (5.2e-5) at all three
# budgets, the volume-only one (no kernel) included; TF32 read 2.8-3.0 px
# (see PERF.md). 2e-4 is 3.8x the reading
FS_MODEL_REL = 2e-4
FS_MODEL_BUDGETS = (("0", 4), ("0.01", 2), (None, 0))
FS_SERVE_BUCKETS = ((1080, 1920), (448, 1024))
FS_SERVE_SPLITS = {"1080x1920": 1, "448x1024": 0}   # n_windowed at batch 2
FS_SERVE_BATCH = 2
FS_STEP_SHAPE = (2, 128, 192)
FS_LR = 1.25e-4               # the hd1k-1080p stage's lr and max_lr
FS_WEIGHT_DECAY = 1e-5
# The raft/fs step, card vs CPU in float32. An H100 run read, every level
# windowed: loss 4.6e-7, worst gradient 6.9e-3 (fnet's 1/4 stage), median
# 7.1e-4, update 1.4e-3, params 1.1e-6: 4-70x raft's readings, the
# unnormalized correlation's sensitivity; TF32 read 5.0e-4, 0.36, 2.1e-2,
# 8.1e-2, 5.0e-5. Each bound is ~4x its reading. The same step with every
# level on volumes (no windowed-correlation kernel) is held to the same
# bounds, and its readings are in PERF.md
FS_STEP_BOUNDS = {"loss": 1e-5, "gradient": 3e-2, "median gradient": 3e-3,
                  "update": 6e-3, "params": 5e-6}
FS_TRAIN_SHAPE = (1072, 2560)
FS_TRAIN_BATCH = 1
FS_TRAIN_PAIRS = 8
FS_TRAIN_STEPS = 8


# -- the lookup probe's kernels (csrc/fused_lookup.cu). Cases (b, ni, nj,
# h2, w2): the probe's bench case (level 0 of batch 6 at 400x720) in bf16
# and f32 with its own hat inputs; dense random wy, wx (every product
# counts); ragged ones (W2 37: a last 3-tile group of two tiles; W2 41:
# two groups, each with a lone third tile); wide ones (20x700: a position
# larger than a stage, the fused kernel's rows mode, in both dtypes) and
# the widest row the fused kernel takes (W2 3211), whose wx exceeds a
# stage's. lookup.fused_plan names each case's mode
LOOKUP_CASES = (
    {"name": "probe bench level 0", "kind": "hat", "dtype": "bfloat16",
     "shape": (6, 50, 90, 50, 90)},
    {"name": "probe bench level 0", "kind": "hat", "dtype": "float32",
     "shape": (6, 50, 90, 50, 90)},
    {"name": "dense", "kind": "dense", "dtype": "bfloat16",
     "shape": (2, 20, 30, 50, 90)},
    {"name": "dense", "kind": "dense", "dtype": "float32",
     "shape": (2, 20, 30, 50, 90)},
    {"name": "ragged", "kind": "dense", "dtype": "float32",
     "shape": (2, 7, 13, 11, 37)},
    {"name": "ragged", "kind": "hat", "dtype": "bfloat16",
     "shape": (2, 7, 13, 11, 37)},
    {"name": "ragged", "kind": "dense", "dtype": "bfloat16",
     "shape": (1, 3, 7, 13, 41)},
    {"name": "wide", "kind": "dense", "dtype": "float32",
     "shape": (1, 2, 3, 20, 700)},
    {"name": "wide", "kind": "dense", "dtype": "bfloat16",
     "shape": (1, 2, 3, 20, 700)},
    {"name": "widest row", "kind": "dense", "dtype": "bfloat16",
     "shape": (1, 1, 2, 3, 3211)},
    {"name": "widest row", "kind": "dense", "dtype": "float32",
     "shape": (1, 1, 2, 3, 3211)},
)
LOOKUP_MAIN_CASE = 0      # the kernels line quotes the bf16 bench case
# tolerance: |kernel - plain| <= 2^-13 S elementwise, S the same function
# of |wy|, |corr| (and |wx|): float32 sums of n <= 1,024 terms in other
# orders; the fused result of bf16 inputs adds one bf16 ulp of t carried
# through |wx| (t rounds after sums in another order)
LOOKUP_ORDER_REL = 2.0 ** -13
# the non-finite pin of the dense cases: corr = +inf at row 0, column 2 of
# position 2·(N // 4) + 1, the second of a bf16 stage's two positions: the
# first one's last, partial 16-row k tile reads that row as one past H2
# (masked), and its last row's column tiles read the element as a column
# past W2 (reaching only t's columns past W2, which stage 2 zeroes)
LOOKUP_PIN = (0, 2)
# timed calls of each arm in the probe runs (launches: one warm-up more)
PROBE_STEPS = 20

# -- the quantized tier: float32 forwards at 1x368x496, 12 iterations, card
# vs CPU from one seeded init each. The int8 pyramid of identical inputs:
# level 0 bit for bit, pooled levels one step at most in this share
QUANT_MODEL_SHAPE = (368, 496)
QUANT_INT8_MAX_SHARE = 1e-3
# the u8 pyramid of the same features, card vs CPU: one step at most, in
# at most this share of a level's values (TF32 on the volume matmul must
# move more)
QUANT_U8_MAX_SHARE = 1e-4
# (run, model, quant, RMD_FS_VOLUME_GIB, launches per forward): raft/fs at
# 0.01 GiB windows levels 0-1 and quantizes the volumes of levels 2-3
QUANT_RUNS = (
    ("raft u8", "raft", "u8", None, {"convex_combine_8x": 1}),
    ("raft i8", "raft", "i8", None, {"convex_combine_8x": 1}),
    ("fs u8", "fs", "u8", "0.01",
     {"convex_combine_8x": 1, "windowed_corr_pyramid": FS_ITERATIONS}),
)
# card vs CPU flows, relative to their largest |value|, with the card's
# volumes built from the CPU's feature maps (features a few ulps apart
# quantize one step apart here and there; those runs are read beside:
# 1.2e-3 / 2.6e-3 / 3.6e-3 px on the first iteration). The first iteration
# looks the volumes up at integer positions, where the hat weights are
# exact: H100 runs read 1.5e-5 / 1.8e-5 px on 6.7 px (raft u8 / i8) and
# 3.7e-5 px on 9.1 px (raft/fs u8), 2.3e-6-4.1e-6 of the flow; TF32 read
# 1.1e-2 / 1.1e-2 / 3.2e-2 px. From the second iteration on, the quantized
# lookup rounds its hat weights and t to bf16 (as the JAX tier does), so
# it jumps where a position crosses a rounding point, and 12 iterations
# carry the card-vs-CPU differences far: 0.074 / 0.065 px on 70 px and
# 0.81 px on 92 px on the final flow, TF32 only 1.8x / 4x further. So
# TF32 must break the first iteration's bound (4.9-8.7x the readings); the
# final flow's is 2.4x / 1.7x its readings and under the tier's own effect
# (0.29 / 0.37 / 3.6 px)
QUANT_MODEL_REL = {
    "first": {"raft u8": 2e-5, "raft i8": 2e-5, "fs u8": 2e-5},
    "final": {"raft u8": 2.5e-3, "raft i8": 2.5e-3, "fs u8": 1.5e-2},
}

# augmented training (phase 22): the shipped s1-things.yaml over a
# FlyingThings3D-shaped tree of AUG_PAIRS pairs a pass (4 batches of 6 an
# epoch over clean + final), AUG_EPOCHS epochs; validation on
# AUG_VAL_PAIRS pairs at Sintel's size; each augmentation timed on
# AUG_PROBE_SAMPLES samples
S1_THINGS = ROOT / "cfg" / "strategy" / "baseline" / "raft" / "s1-things.yaml"
AUG_FRAME_SHAPE = (540, 960)
AUG_PAIRS = 12
AUG_EPOCHS = 2
AUG_VAL_PAIRS = 2
AUG_PROBE_SAMPLES = 3
EVAL_SINTEL_SHAPE = (436, 1024)
EVAL_SINTEL_SCENES = 2
EVAL_SINTEL_FRAMES = 6        # per scene: 5 pairs
EVAL_BATCH = 4
# the KITTI 2015 sizes of the tree, two pairs each (seq order)
EVAL_KITTI_SIZES = ((375, 1242), (370, 1224), (376, 1241), (374, 1238))
EVAL_KITTI_BUCKET = "376x1248"
EVAL_KITTI_INVALID = 0.3      # share of flow pixels without ground truth
# the report's per-sample metrics against this process's recomputation
# from make_eval_fn on the same batches (the same weights, kernels and
# padding on the same card): EPE within 1e-3 px + 1e-4 relative, the loss
# within 1e-4 relative (a forward of the bf16 policy in another order
# moves them by bf16 roundings; a sample matched to another's flow misses
# by pixels)
EVAL_EPE_ATOL = 1e-3
EVAL_EPE_REL = 1e-4
EVAL_LOSS_REL = 1e-4


# readings a phase hands to a later one, which prints them beside its own
SHARED = {}


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
    """Every kernel source, one ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from raft_meets_dicl_tpu_torch.ops import cuda_build

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(cuda_build.build, KERNEL_SOURCES))
    for name, (path, seconds, log) in zip(KERNEL_SOURCES, builds):
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line
                 or "Compiling entry function" in line]
        emit(phase="build", kernel=name, seconds=round(seconds, 3),
             library=str(path.relative_to(ROOT)), ptxas=ptxas)


def phase_kernels(card):
    """convex_combine_8x against its plain version, both logits dtypes,
    at M = 700 (ragged) and the rows of raft/baseline's entry shape, serve
    buckets and training, and of ctf-l3's serve buckets and training."""
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
    return launches


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
    logits dtypes, at M = 700 (ragged), raft/baseline's entry and training
    rows and ctf-l3's training rows; timed beside the plain backward and
    the bound."""
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


def _step_problems(r, bounds):
    """The bounds a step's readings break, by name, with their readings."""
    problems = {}
    if not r["loss_rel_diff"] <= bounds["loss"]:
        problems["loss"] = f"loss relative |diff| {r['loss_rel_diff']}"
    if not r["max_grad_rel_l2"] <= bounds["gradient"]:
        problems["gradient"] = (f"gradient '{r['worst_grad']}' relative L2 "
                                f"{r['max_grad_rel_l2']}")
    if not r["median_grad_rel_l2"] <= bounds["median gradient"]:
        problems["median gradient"] = ("median gradient relative L2 "
                                       f"{r['median_grad_rel_l2']}")
    if not r["zero_grad_max_norm"] <= r["bound_zero_grad_norm"]:
        problems["zero gradient"] = ("a zero-by-construction gradient has "
                                     f"norm {r['zero_grad_max_norm']}")
    if not r["update_rel_l2"] <= bounds["update"]:
        problems["update"] = f"update relative L2 {r['update_rel_l2']}"
    if not r["param_max_abs_diff"] <= bounds["params"]:
        problems["params"] = ("params after the update max |diff| "
                              f"{r['param_max_abs_diff']}")
    return problems


def _zero_counts():
    from raft_meets_dicl_tpu_torch.ops import convex, lookup, sample, windowed

    convex.launches = convex.bwd_launches = 0
    sample.launches = sample.bwd_launches = 0
    windowed.launches = windowed.df1_launches = windowed.df2_launches = 0
    lookup.stage1_launches = lookup.fused_launches = 0


def _counts():
    """Every kernel's launch count, by the name in the kernels line."""
    from raft_meets_dicl_tpu_torch.ops import convex, lookup, sample, windowed

    return {"convex_combine_8x": convex.launches,
            "convex_combine_8x_bwd": convex.bwd_launches,
            "sample_window": sample.launches,
            "sample_window_bwd": sample.bwd_launches,
            "windowed_corr_pyramid": windowed.launches,
            "windowed_corr_pyramid_df1": windowed.df1_launches,
            "windowed_corr_pyramid_df2": windowed.df2_launches,
            "lookup_stage1": lookup.stage1_launches,
            "lookup_fused": lookup.fused_launches}


def _expect(**launches):
    """Every kernel's expected launch count: ``launches``, else 0."""
    names = ("convex_combine_8x", "convex_combine_8x_bwd", "sample_window",
             "sample_window_bwd", "windowed_corr_pyramid",
             "windowed_corr_pyramid_df1", "windowed_corr_pyramid_df2",
             "lookup_stage1", "lookup_fused")
    return {name: launches.get(name, 0) for name in names}


def _step_card_vs_cpu(load_spec, shape, lr, frozen_bn, seed,
                      weight_decay=1e-4):
    """One float32 train step (AdamW at ``weight_decay`` and eps
    STEP_EPS, clip norm 1.0) of the model ``load_spec()`` builds, on the
    card with TF32 off, on the card with TF32 convolutions and matmuls, and
    on the CPU, from the same seeded weights and batch. Returns the card's
    and the TF32 step's readings against the CPU, the card step's kernel
    launches, the CPU's aux and seconds."""
    from raft_meets_dicl_tpu_torch import parallel, strategy

    set_tf32(False)
    rng = np.random.default_rng(seed)
    b, h, w = shape
    batch = [rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             (4 * rng.standard_normal((b, h, w, 2))).astype(np.float32),
             rng.uniform(size=(b, h, w)) > 0.1]
    batch = [torch.from_numpy(x) for x in batch]

    optimizer = strategy.spec.OptimizerSpec("adam-w", {
        "lr": lr, "weight_decay": weight_decay, "eps": STEP_EPS})
    gradient = strategy.spec.GradientSpec.from_config(
        {"clip": {"type": "norm", "value": 1.0}})

    cpu_spec = load_spec()
    cpu_spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    weights = {n: t.clone()
               for n, t in cpu_spec.model.module.state_dict().items()}
    before = {n: p.detach().clone()
              for n, p in cpu_spec.model.module.named_parameters()}

    def run(device):
        spec = cpu_spec
        if device == "cuda":
            spec = load_spec()
            spec.model.module.load_state_dict(weights)
            spec.model.module.to("cuda")
        spec.model.on_stage(None, freeze_batchnorm=frozen_bn)
        tx, _ = optimizer.build(spec.model.module.parameters(), gradient)
        step = parallel.make_train_step(spec.model, spec.loss,
                                        with_grads=True)
        state = parallel.TrainState(spec.model, tx)
        _, aux = step(state, lr, *(x.to(device) for x in batch))
        return spec, aux

    _zero_counts()
    gpu_spec, aux_gpu = run("cuda")
    torch.cuda.synchronize()
    launches = _counts()
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
    return readings, tf32, launches, aux_cpu, cpu_s


def _check_step(name, readings, tf32, bounds):
    problems = list(_step_problems(readings, bounds).values())
    # each bound must tell the TF32 step from the float32 one, or it could
    # not fail
    blind = set(STEP_TF32_BREAKS) - set(_step_problems(tf32, bounds))
    if blind:
        problems.append(f"the TF32 step stays inside the {sorted(blind)} "
                        "bounds")
    if problems:
        raise AssertionError(f"{name} card vs CPU: " + "; ".join(problems))


def phase_train_step(card):
    """One float32 train step of full-width raft/baseline, 12 iterations,
    card vs CPU from the same weights and batch, frozen batch norm. The
    same step on the card with TF32 convolutions and matmuls is read
    against the same bounds, to show that they can fail."""
    readings, tf32, launches, aux_cpu, cpu_s = _step_card_vs_cpu(
        lambda: _load_raft(False), STEP_SHAPE, STEP_LR, True, 2)
    launches = (launches["convex_combine_8x"],
                launches["convex_combine_8x_bwd"])
    if launches != (1, 1):
        raise AssertionError(f"train step launched the forward/backward "
                             f"kernels {launches} times, expected (1, 1)")
    emit(phase="train-step", model="raft/baseline", shape=list(STEP_SHAPE),
         iterations=12, tf32=False,
         optimizer=f"adam-w (eps {STEP_EPS}) + clip norm 1.0", lr=STEP_LR,
         frozen_bn=True, loss_cpu=aux_cpu["loss"].item(),
         grad_norm_cpu=aux_cpu["grad_norm"].item(),
         update_norm_cpu=aux_cpu["update_norm"].item(),
         bounds=RAFT_STEP_BOUNDS, launches_fwd_bwd=list(launches),
         cpu_step_s=round(cpu_s, 3), card=card, **readings,
         tf32_readings=tf32,
         tf32_outside_bounds=_step_problems(tf32, RAFT_STEP_BOUNDS))
    # H100 runs read TF32 4.4x to 7.4x over the bounds (see PERF.md)
    _check_step("raft train step", readings, tf32, RAFT_STEP_BOUNDS)
    return launches


def _write_training_tree(root, shape, pairs, strategy):
    """A generic-layout dataset of one scene: ``pairs`` + 1 frames of a
    smooth random texture, each shifted by a constant (3, -2) px from the
    last, so every pair's flow is that shift; PNG frames, .flo flows; and
    ``strategy`` as strategy.yaml beside it."""
    import cv2

    from raft_meets_dicl_tpu_torch.data import io

    h, w = shape
    dx, dy = 3, -2
    rng = np.random.default_rng(3)
    base = cv2.resize(rng.integers(0, 256, (h // 4, w // 4, 3), np.uint8),
                      (w, h), interpolation=cv2.INTER_CUBIC)
    flow = np.broadcast_to(np.array([dx, dy], np.float32), (h, w, 2))
    (root / "frames").mkdir(parents=True)
    (root / "flows").mkdir()
    for i in range(pairs + 1):
        frame = np.roll(base, (i * dy, i * dx), axis=(0, 1))
        cv2.imwrite(str(root / "frames" / f"frame_{i:04d}.png"), frame)
        if i < pairs:
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
    (root / "strategy.yaml").write_text(strategy)


def _strategy(name, batch, on_stage, max_lr, gamma=None,
              weight_decay=0.0001, total_steps="100000 + 100"):
    """One stage on the synthetic scene: AdamW (eps 1e-8), the one-cycle
    schedule and clip of the shipped stages."""
    loss = f"    loss:\n      arguments: {{gamma: {gamma}}}\n" if gamma else ""
    return (
        "mode: continuous\n"
        "stages:\n"
        f"  - name: synthetic scene, {name} recipe\n"
        f"    id: synthetic/{name}\n"
        "    data:\n"
        "      epochs: 2\n"
        f"      batch-size: {batch}\n"
        "      source: {type: dataset, spec: dataset.yaml}\n"
        "    model:\n"
        f"      on-stage: {{freeze_batchnorm: {on_stage}}}\n"
        + loss +
        "    optimizer:\n"
        "      type: adam-w\n"
        f"      parameters: {{lr: {max_lr}, weight_decay: {weight_decay}, "
        "eps: 1.0e-8}\n"
        "    lr-scheduler:\n"
        "      instance:\n"
        "        - type: one-cycle\n"
        f"          parameters: {{max_lr: {max_lr}, total_steps: "
        f"'{total_steps}',\n"
        "                       pct_start: 0.05, cycle_momentum: false,\n"
        "                       anneal_strategy: linear}\n"
        "    gradient:\n"
        "      clip: {type: norm, value: 1.0}\n")


def _run_train(strategy, model_cfg, out, steps, *extra):
    """``main train`` of ``strategy`` with ``model_cfg``, stopped after
    ``steps`` steps; returns its context, its wall seconds, the peak
    device memory and every kernel's launches in the run."""
    from raft_meets_dicl_tpu_torch import main as port_main

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    tctx = port_main.main([
        "train", "-d", str(strategy), "-m", str(model_cfg), "-o", str(out),
        "--limit-steps", str(steps), *extra])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return tctx, wall_s, torch.cuda.max_memory_allocated(), _counts()


def _loader_batch_ms(tctx):
    """The stage's loader alone for one epoch, as an epoch of the run
    starts it: its worker processes start, then each batch arrives."""
    loader_ms = []
    t0 = time.perf_counter()
    for _ in tctx.data:
        loader_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
    return loader_ms


def _run_readings(tctx, batch, steps, wall_s):
    """A run's steps, losses and rates; problems if it did not run
    ``steps`` finite steps."""
    history = tctx.history
    problems = []
    if len(history) != steps or tctx.step != steps:
        problems.append(f"ran {len(history)} steps, expected {steps}")
    if not all(np.isfinite(h["loss"]) and h["finite"] for h in history):
        problems.append("non-finite loss or flow: "
                        f"{[h['loss'] for h in history]}")

    # the first step pays one-time costs (loader start, library warm-up):
    # the median leaves it out, the whole window's rate keeps it
    step_ms = [h["ms"] for h in history]
    median_ms = statistics.median(step_ms[1:])
    readings = dict(
        steps=len(history), losses=[h["loss"] for h in history],
        lrs=[h["lr"] for h in history],
        grad_norms=[h["grad_norm"] for h in history],
        step_ms=step_ms, median_step_ms=median_ms,
        pairs_per_sec=batch * 1e3 / median_ms,
        window_pairs_per_sec=batch * len(history) * 1e3 / sum(step_ms),
        wall_pairs_per_sec=batch * len(history) / wall_s)
    return readings, problems


def _train_command(model_cfg, shape, batch, pairs, steps, strategy):
    """The train command end to end on a synthetic tree in a temporary
    directory; returns its readings and problems."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _write_training_tree(tmp / "data", shape, pairs, strategy)
        write_s = time.perf_counter() - t0

        tctx, wall_s, peak, launches = _run_train(
            tmp / "data" / "strategy.yaml", model_cfg, tmp / "runs", steps)
        run_files = sorted(p.name for p in tctx.path.iterdir())
        loader_ms = _loader_batch_ms(tctx)

    run, problems = _run_readings(tctx, batch, steps, wall_s)
    if not {"config.json", "main.log", "model.txt"} <= set(run_files):
        problems.append(f"run directory holds {run_files}")
    readings = dict(
        shape=[batch, *shape], **run,
        max_memory_allocated=peak, launches=launches,
        loader_workers=tctx.data.num_workers, loader_batch_ms=loader_ms,
        wall_s=round(wall_s, 3), dataset_write_s=round(write_s, 3),
        run_files=run_files)
    return readings, problems


def phase_train(card):
    """The train command end to end with the shipped bf16-policy config."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    readings, problems = _train_command(
        ROOT / "cfg" / "model" / "raft-baseline.yaml", TRAIN_SHAPE,
        TRAIN_BATCH, TRAIN_PAIRS, TRAIN_STEPS,
        _strategy("s1-things", TRAIN_BATCH, "true", 0.000125, gamma=0.8))
    steps = readings["steps"]
    launches = (readings["launches"]["convex_combine_8x"],
                readings["launches"]["convex_combine_8x_bwd"])
    if launches != (steps, steps):
        problems.append(f"forward/backward kernels launched {launches} "
                        f"times, expected {steps} each")
    if problems:
        raise AssertionError("train phase: " + "; ".join(problems))
    emit(phase="train", model="raft/baseline (bf16 policy, frozen BN)",
         iterations=12, card=card, **readings)
    # phase 22 prints it beside its own, augmented run
    SHARED["train_median_step_ms"] = readings["median_step_ms"]
    return launches


# -- raft+dicl/ctf-l3 -----------------------------------------------------------


def _sw_inputs(case, gen):
    """f2 and centres for one sampler case: the level's grid plus a smooth
    random flow of a few px and a few far out-of-bounds centres."""
    b, h2, w2, c, h, w = case["shape"]
    dtype = getattr(torch, case["dtype"])
    f2 = torch.randn(b, h2, w2, c, device="cuda", generator=gen).to(dtype)
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    grid = torch.stack((xs * (w2 / w), ys * (h2 / h)), dim=-1).float()
    coords = grid + 4 * torch.randn(b, h, w, 2, device="cuda", generator=gen)
    for bi, y, x, cx, cy in SW_FAR:
        coords[bi, y, x] = torch.tensor([cx, cy])
    return f2, coords.contiguous()


def _sw_bound(out, ref, dtype, scale=0.0):
    """|diff| <= 1e-5 + ``scale`` (+ one bf16 ulp of the larger value for
    bf16 outputs); returns the largest |diff| and its share of the bound."""
    err = (out.float() - ref.float()).abs()
    bound = KERNEL_MAX_ABS_ERR + scale
    if dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(torch.maximum(out.float().abs(),
                                                ref.float().abs()))
    return err.max().item(), (err / bound).max().item()


def _grid_sample_window(f2, coords, radius):
    """The library call for the window: ``F.grid_sample`` over a (B,
    K·K·H, W) grid of normalized positions (built here, outside any
    timing); returns the call and a view of its output in the window's
    (B, K, K, H, W, C) layout."""
    import torch.nn.functional as F

    b, h2, w2, c = f2.shape
    h, w = coords.shape[1:3]
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device="cuda", dtype=torch.float32)
    gx = coords[..., 0][:, None, None] + d[None, :, None, None, None]
    gy = coords[..., 1][:, None, None] + d[None, None, :, None, None]
    gx, gy = torch.broadcast_tensors(gx, gy)          # (B, K, K, H, W)
    grid = torch.stack((2 * gx / (w2 - 1) - 1, 2 * gy / (h2 - 1) - 1), -1)
    # the grid in f2's dtype, as F.grid_sample takes it
    grid = grid.reshape(b, k * k * h, w, 2).to(f2.dtype).contiguous()
    f2n = f2.permute(0, 3, 1, 2)

    def call(inp=f2n):
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    def as_window(out):
        return out.reshape(b, c, k, k, h, w).permute(0, 2, 3, 4, 5, 1)

    return call, as_window


def phase_sw_kernels(card):
    """Both sample_window kernels against their plain version (autograd of
    it for the backward) on the card, TF32 off, at the ctf paths' shapes;
    timed beside the plain version, the bound and ``F.grid_sample``."""
    from raft_meets_dicl_tpu_torch.ops import sample

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(4)
    r = CTF_RADIUS
    k = 2 * r + 1
    cases = []
    for case in SW_CASES:
        dtype = getattr(torch, case["dtype"])
        f2, coords = _sw_inputs(case, gen)
        before = sample.launches
        out = sample.sample_window_fused(f2, coords, r)
        torch.cuda.synchronize()
        if sample.launches != before + 1:
            raise AssertionError("sample_window did not launch")
        ref = sample.sample_window(f2, coords, r)
        err, share = _sw_bound(out, ref, dtype)
        if not share <= 1.0 or any(
                out[bi, :, :, y, x].abs().max().item() != 0
                for bi, y, x, _, _ in SW_FAR):
            raise AssertionError(f"sample_window {case}: max |diff| {err} "
                                 f"({share} of its bound), or a far "
                                 "out-of-bounds window not exact zeros")

        dout = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
        before = sample.bwd_launches
        df2 = sample._launch_bwd(dout, coords, tuple(f2.shape), r).to(dtype)
        torch.cuda.synchronize()
        if sample.bwd_launches != before + 1:
            raise AssertionError("sample_window backward did not launch")
        f2r = f2.detach().requires_grad_(True)
        ref_out = sample.sample_window(f2r, coords, r)
        (ref_df2,) = torch.autograd.grad(ref_out, f2r, dout,
                                         retain_graph=True)
        # rule: |diff| <= 1e-5 + SW_BWD_ORDER_REL * S (the kernel's atomics
        # and the plain scatter add the same float32 terms in other
        # orders), plus one bf16 ulp for a bf16 df2 (each side rounds its
        # float32 sum once)
        f2f = f2.detach().float().requires_grad_(True)
        (s,) = torch.autograd.grad(sample.sample_window(f2f, coords, r), f2f,
                                   dout.abs().float())
        bwd_err, bwd_share = _sw_bound(df2, ref_df2, dtype,
                                       SW_BWD_ORDER_REL * s)
        if not bwd_share <= 1.0:
            raise AssertionError(f"sample_window backward {case}: max |diff| "
                                 f"{bwd_err} ({bwd_share} of its bound)")
        bwd_err_over_s = ((df2.float() - ref_df2.float()).abs()
                          / s.clamp(min=1e-30)).max().item()
        del s, f2f

        ms = gpu_timer_ms(lambda: sample.sample_window_fused(f2, coords, r))
        plain_ms = gpu_timer_ms(lambda: sample.sample_window(f2, coords, r))
        bwd_ms = gpu_timer_ms(lambda: sample._launch_bwd(
            dout, coords, tuple(f2.shape), r).to(dtype))
        plain_bwd_ms = gpu_timer_ms(lambda: torch.autograd.grad(
            ref_out, f2r, dout, retain_graph=True))
        del ref_out

        lib = {}
        if dtype == torch.float32:
            # the library call computes the same window (coordinates go
            # through [-1, 1] and back, so it is checked at 1e-4)
            call, as_window = _grid_sample_window(f2, coords, r)
            lib_err = (as_window(call()) - ref).abs().max().item()
            if not lib_err <= 1e-4:
                raise AssertionError(f"grid_sample window differs by {lib_err}")
            f2n = f2.permute(0, 3, 1, 2).detach().requires_grad_(True)
            lib_out = call(f2n)
            dlib = dout.permute(0, 5, 1, 2, 3, 4).reshape(lib_out.shape)
            lib = dict(
                library_err=lib_err, library_ms=gpu_timer_ms(call),
                library_bwd_ms=gpu_timer_ms(lambda: torch.autograd.grad(
                    lib_out, f2n, dlib, retain_graph=True)))
            del lib_out
        else:
            # whether the library call takes bf16 (its grid then rounds to
            # bf16, so its window is far off: timed, not checked)
            call, as_window = _grid_sample_window(f2, coords, r)
            try:
                lib_err = (as_window(call()).float()
                           - ref.float()).abs().max().item()
                f2n = f2.permute(0, 3, 1, 2).detach().requires_grad_(True)
                lib_out = call(f2n)
                dlib = dout.permute(0, 5, 1, 2, 3, 4).reshape(lib_out.shape)
                lib = dict(
                    library_err=lib_err, library_ms=gpu_timer_ms(call),
                    library_bwd_ms=gpu_timer_ms(lambda: torch.autograd.grad(
                        lib_out, f2n, dlib, retain_graph=True)))
                del lib_out
            except RuntimeError as e:
                lib = dict(library_refused=str(e).splitlines()[0])

        b, h2, w2, c, h, w = case["shape"]
        positions = b * h * w
        out_bytes = out.numel() * out.element_size()
        in_bytes = f2.numel() * f2.element_size() + coords.numel() * 4
        fwd_ms_b = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES_S
        fwd_ms_o = 1e3 * out.numel() * SW_OPS_PER_VALUE / PEAK_F32_OPS_S
        bwd_ms_b = 1e3 * (out_bytes + coords.numel() * 4
                          + f2.numel() * f2.element_size()) / PEAK_BYTES_S
        bwd_ms_o = 1e3 * out.numel() * SW_BWD_OPS_PER_VALUE / PEAK_F32_OPS_S
        record = dict(
            case=case["name"], dtype=case["dtype"], f2=[b, h2, w2, c],
            coords=[b, h, w, 2], radius=r, positions=positions,
            max_abs_err=err, err_over_bound=share, ms=ms, plain_ms=plain_ms,
            bound_ms=max(fwd_ms_b, fwd_ms_o),
            bound_by="bytes" if fwd_ms_b >= fwd_ms_o else "operations",
            bytes=in_bytes + out_bytes, bwd_max_abs_err=bwd_err,
            bwd_err_over_bound=bwd_share, bwd_err_over_s=bwd_err_over_s,
            bwd_ms=bwd_ms,
            plain_bwd_ms=plain_bwd_ms, bwd_bound_ms=max(bwd_ms_b, bwd_ms_o),
            bwd_bound_by="bytes" if bwd_ms_b >= bwd_ms_o else "operations",
            **lib)
        cases.append(record)
        emit(phase="kernel-check", kernel="sample_window", tf32=False,
             card=card, **record)
    return cases


def _load_ctf(mixed_precision=False):
    from raft_meets_dicl_tpu_torch import models, utils

    cfg = utils.config.load(CTF_CFG)
    cfg["model"]["parameters"]["mixed-precision"] = mixed_precision
    return models.load(cfg)


def phase_ctf_model(card):
    """raft+dicl/ctf-l3 f32, full width, iterations (4, 3, 3), at
    1x384x512: card vs CPU, same seeded weights, TF32 off."""
    from raft_meets_dicl_tpu_torch import evaluation

    set_tf32(False)
    rng = np.random.default_rng(5)
    h, w = CTF_MODEL_SHAPE
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3))
                                   .astype(np.float32)) for _ in range(2))

    cpu_spec = _load_ctf()
    cpu_spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_spec = _load_ctf()
    gpu_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    gpu_spec.model.module.to("cuda").eval()

    cpu_step = evaluation.make_eval_fn(cpu_spec.model)
    gpu_step = evaluation.make_eval_fn(gpu_spec.model)
    x1, x2 = img1.cuda(), img2.cuda()

    _zero_counts()
    raw, flow_gpu = gpu_step(x1, x2)
    torch.cuda.synchronize()
    launches = _counts()
    expected = _expect(sample_window=CTF_ITERATIONS, convex_combine_8x=1)
    if launches != expected:
        raise AssertionError(f"ctf forward launched {launches}, expected "
                             f"{expected}")
    if [len(level) for level in raw] != [4, 3, 3] \
            or tuple(flow_gpu.shape) != (1, h, w, 2):
        raise AssertionError(f"unexpected output: {[len(x) for x in raw]} "
                             f"flows per level, final {tuple(flow_gpu.shape)}")

    t0 = time.perf_counter()
    _, flow_cpu = cpu_step(img1, img2)
    cpu_s = time.perf_counter() - t0
    flow_gpu = flow_gpu.cpu()
    if not bool(torch.isfinite(flow_gpu).all()):
        raise AssertionError("non-finite flow on the card")
    diff = (flow_gpu - flow_cpu).abs().max().item()
    scale = flow_cpu.abs().max().item()
    if not diff <= CTF_MODEL_REL * max(scale, 1.0):
        raise AssertionError(f"ctf card vs CPU final flow max |diff| {diff} "
                             f"px > {CTF_MODEL_REL} of {scale} px")

    forward_f32_ms = gpu_timer_ms(lambda: gpu_step(x1, x2), launches=3)
    bf16_spec = _load_ctf(True)
    bf16_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    bf16_spec.model.module.to("cuda").eval()
    bf16_step = evaluation.make_eval_fn(bf16_spec.model)
    forward_bf16_ms = gpu_timer_ms(lambda: bf16_step(x1, x2), launches=3)

    emit(phase="ctf-model", model="raft+dicl/ctf-l3", shape=[1, h, w],
         iterations=list(CTF_LEVEL_ITERATIONS), tf32=False,
         max_abs_diff_px=diff, max_abs_flow_px=scale,
         bound_rel=CTF_MODEL_REL, launches_per_forward=launches,
         forward_f32_ms=forward_f32_ms, forward_bf16_ms=forward_bf16_ms,
         cpu_forward_s=round(cpu_s, 3), card=card)
    return launches


def phase_ctf_serve(card):
    """The serve command end to end with the shipped ctf-l3 config (f32)."""
    from raft_meets_dicl_tpu_torch import main as port_main

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Path(tmp) / "serve.yaml"
        cfg.write_text(
            "serve:\n"
            f"  model: {CTF_CFG}\n"
            f"  buckets: {CTF_BUCKETS}\n"
            "  batch-size: 4\n"
            "  max-wait-ms: 50\n"
            "  requests: 16\n"
            "  rate: 50\n")
        _zero_counts()
        report = port_main.main(["serve", "-c", str(cfg)])
        launches = _counts()

    dispatched = report["batches"] + len(report["warmup"])
    expected = _expect(sample_window=CTF_ITERATIONS * dispatched,
                       convex_combine_8x=dispatched)
    problems = []
    if report["completed"] != report["requests"] or report["requests"] != 16:
        problems.append(f"completed {report['completed']}/{report['requests']}")
    if report["errors"] or report["rejected"]:
        problems.append(f"errors {report['errors']}, rejected "
                        f"{report['rejected']}")
    if report["nonfinite"]:
        problems.append(f"{report['nonfinite']} non-finite flows")
    if launches != expected:
        problems.append(f"kernels launched {launches}, expected {expected} "
                        "(batches + warm-up)")
    if problems:
        raise AssertionError("ctf serve phase: " + "; ".join(problems))

    emit(phase="ctf-serve", model="raft+dicl/ctf-l3 (f32)",
         buckets=CTF_BUCKETS, batch=4, requests=report["requests"],
         completed=report["completed"], batches=report["batches"],
         launches=launches, p50_ms=report["p50_ms"], p99_ms=report["p99_ms"],
         pairs_per_sec=report["pairs_per_sec"], spans_ms=report["spans_ms"],
         card=card)
    return launches


def phase_ctf_train_step(card):
    """One float32 train step of full-width ctf-l3, iterations (4, 3, 3),
    with live batch norm (s0-chairs' freeze_batchnorm: false) and
    s0-chairs' optimizer, card vs CPU; the same step with TF32 must break
    each bound."""
    readings, tf32, launches, aux_cpu, cpu_s = _step_card_vs_cpu(
        _load_ctf, CTF_STEP_SHAPE, CTF_LR, False, 6)
    expected = _expect(sample_window=CTF_ITERATIONS,
                       sample_window_bwd=CTF_ITERATIONS,
                       convex_combine_8x=1, convex_combine_8x_bwd=1)
    emit(phase="ctf-train-step", model="raft+dicl/ctf-l3",
         shape=list(CTF_STEP_SHAPE), iterations=list(CTF_LEVEL_ITERATIONS),
         tf32=False, optimizer=f"adam-w (eps {STEP_EPS}) + clip norm 1.0",
         lr=CTF_LR, frozen_bn=False, loss_cpu=aux_cpu["loss"].item(),
         grad_norm_cpu=aux_cpu["grad_norm"].item(),
         update_norm_cpu=aux_cpu["update_norm"].item(),
         bounds=CTF_STEP_BOUNDS, launches=launches,
         cpu_step_s=round(cpu_s, 3), card=card, **readings,
         tf32_readings=tf32,
         tf32_outside_bounds=_step_problems(tf32, CTF_STEP_BOUNDS))
    if launches != expected:
        raise AssertionError(f"ctf train step launched {launches}, expected "
                             f"{expected}")
    _check_step("ctf train step", readings, tf32, CTF_STEP_BOUNDS)
    return launches


def phase_ctf_train(card):
    """The train command with the shipped ctf-l3 config and the s0-chairs
    stage settings, batch 10 at 384x512."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    readings, problems = _train_command(
        CTF_CFG, CTF_TRAIN_SHAPE, CTF_TRAIN_BATCH, CTF_TRAIN_PAIRS,
        CTF_TRAIN_STEPS,
        _strategy("s0-chairs", CTF_TRAIN_BATCH, "false", CTF_LR))
    steps = readings["steps"]
    expected = _expect(sample_window=CTF_ITERATIONS * steps,
                       sample_window_bwd=CTF_ITERATIONS * steps,
                       convex_combine_8x=steps, convex_combine_8x_bwd=steps)
    if readings["launches"] != expected:
        problems.append(f"kernels launched {readings['launches']}, expected "
                        f"{expected}")
    if problems:
        raise AssertionError("ctf train phase: " + "; ".join(problems))
    emit(phase="ctf-train", model="raft+dicl/ctf-l3 (f32, live BN)",
         iterations=list(CTF_LEVEL_ITERATIONS),
         cudnn_tf32=torch.backends.cudnn.allow_tf32,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32, card=card,
         **readings)
    return readings["launches"]


# -- raft/fs ----------------------------------------------------------------


@contextlib.contextmanager
def _volume_budget(gib):
    """``RMD_FS_VOLUME_GIB`` set to ``gib`` (None: unset, the default 4.0)
    for the block, restored after it."""
    saved = os.environ.pop("RMD_FS_VOLUME_GIB", None)
    if gib is not None:
        os.environ["RMD_FS_VOLUME_GIB"] = gib
    try:
        yield
    finally:
        os.environ.pop("RMD_FS_VOLUME_GIB", None)
        if saved is not None:
            os.environ["RMD_FS_VOLUME_GIB"] = saved


def _wcp_inputs(case, gen):
    """f1, the pooled f2 levels and the centres for one case: the level-0
    grid plus a smooth random flow of a few px and the far centres."""
    from raft_meets_dicl_tpu_torch.ops.pool import avg_pool2d

    b, h, w = case["shape"]
    c = case["c"]
    dtype = getattr(torch, case["dtype"])
    f1 = torch.randn(b, h, w, c, device="cuda", generator=gen).to(dtype)
    levels = [torch.randn(b, h, w, c, device="cuda", generator=gen).to(dtype)]
    for _ in range(case["levels"] - 1):
        levels.append(avg_pool2d(levels[-1], 2))
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    grid = torch.stack((xs, ys), dim=-1).float()
    if case.get("flow") == "smooth":
        coords = (grid + _smooth_flow(h, w, gen))[None].repeat(b, 1, 1, 1)
    else:
        coords = grid + 4 * torch.randn(b, h, w, 2, device="cuda",
                                        generator=gen)
    for p, centre in zip(_wcp_far(case), SW_FAR):
        coords[p] = torch.tensor(centre[3:])
    return f1, levels, coords.contiguous()


def _smooth_flow(h, w, gen):
    """(h, w, 2) level-0 displacements: a low-frequency field of up to
    20 px (two random-phase sinusoids per axis, a period of about the
    grid) plus 40 px of x motion on one side of a slanted boundary."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device="cuda", dtype=torch.float32) / h,
        torch.arange(w, device="cuda", dtype=torch.float32) / w,
        indexing="ij")
    phase = 2 * math.pi * torch.rand(4, device="cuda", generator=gen)
    u = 12 * torch.sin(2 * math.pi * xs + phase[0]) \
        + 8 * torch.cos(2 * math.pi * 0.7 * ys + phase[1])
    v = 12 * torch.sin(2 * math.pi * 0.8 * ys + phase[2]) \
        + 8 * torch.cos(2 * math.pi * xs + phase[3])
    moving = (xs - 0.45) + 0.6 * (ys - 0.5) > 0
    return torch.stack((u + 40.0 * moving, v), dim=-1)


def _wcp_far(case):
    """The positions that get SW_FAR's far centres in this case's shape."""
    b, h, w = case["shape"]
    return [(min(bi, b - 1), min(y, h - 1), min(x, w - 1))
            for bi, y, x, _, _ in SW_FAR]


def _wcp_share(out, ref, scale, bf16=False):
    """Largest |diff| and its share of 1e-5 max|ref| + 2^-13 scale (+ one
    bf16 ulp of the larger value where the plain result is bf16)."""
    err = (out.float() - ref.float()).abs()
    bound = KERNEL_MAX_ABS_ERR * ref.float().abs().max() \
        + WCP_ORDER_REL * scale
    if bf16:
        bound = bound + _bf16_ulp(torch.maximum(out.float().abs(),
                                                ref.float().abs()))
    return err.max().item(), (err / bound).max().item()


def _wcp_bound(nbytes, ops, dtype):
    """The least time for ``nbytes`` moved and ``ops`` done on inputs of
    ``dtype``, in ms, and what bounds it."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_S
    peak = PEAK_BF16_OPS_S if dtype == torch.bfloat16 else PEAK_F32_OPS_S
    ops_ms = 1e3 * ops / peak
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _tile_share(paths):
    """Per level, the share of the tiles with an in-bounds tap that took
    the tile path."""
    return [p[0] / max(1, p[0] + p[1]) for p in paths]


def phase_wcp_kernels(card):
    """The three windowed_corr_pyramid kernels against the plain version
    and its autograd on the card, TF32 off, at the raft/fs paths' shapes;
    each timed beside the plain version and its bound."""
    from raft_meets_dicl_tpu_torch.ops import windowed

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    r = FS_RADIUS
    cases = []
    for case in WCP_CASES:
        dtype = getattr(torch, case["dtype"])
        bf16 = dtype == torch.bfloat16
        f1, levels, coords = _wcp_inputs(case, gen)
        n_lvl = len(levels)
        before = windowed.launches
        out = windowed.windowed_corr_pyramid(f1, levels, coords, r,
                                             normalize=False)
        torch.cuda.synchronize()
        if windowed.launches != before + 1:
            raise AssertionError("windowed_corr_pyramid did not launch")
        # the forward's tiles per path, counted by the kernel, against the
        # kernels' rule at the forward's and df1's side limit; the counting
        # launch gives the same output bit for bit
        limit = windowed.MAX_BOX if bf16 else 0
        rule = [list(windowed.tile_paths(coords, i, *lvl.shape[1:3], limit,
                                         radius=r))
                for i, lvl in enumerate(levels)]
        counts = torch.zeros(n_lvl, 3, dtype=torch.int32, device="cuda")
        counted = windowed._launch(f1, levels, coords, r, path_counts=counts)
        fwd_paths = counts.tolist()
        if fwd_paths != rule or not torch.equal(counted, out):
            raise AssertionError(f"windowed_corr_pyramid {case}: tiles per "
                                 f"path {fwd_paths}, the rule says {rule}, "
                                 "or the counting launch differs")
        del counted
        ref = windowed.windowed_corr_pyramid_reference(f1, levels, coords, r)
        s_fwd = windowed.windowed_corr_pyramid_reference(
            f1.abs(), [x.abs() for x in levels], coords, r)
        err, share = _wcp_share(out, ref, s_fwd)
        del s_fwd
        b, h, w = case["shape"]
        if not share <= 1.0 or any(out[p].abs().max().item() != 0
                                   for p in _wcp_far(case)):
            raise AssertionError(f"windowed_corr_pyramid {case}: max |diff| "
                                 f"{err} ({share} of its bound), or a far "
                                 "window not exact zeros")

        dout = torch.randn(out.shape, device="cuda", generator=gen)
        before = (windowed.df1_launches, windowed.df2_launches)
        counts = torch.zeros(n_lvl, 3, dtype=torch.int32, device="cuda")
        df1 = windowed._launch_df1(dout, f1, levels, coords, r,
                                   path_counts=counts)
        df1_counts = counts
        counts = torch.zeros(n_lvl, 3, dtype=torch.int32, device="cuda")
        df2 = [windowed._launch_df2(dout, f1, lvl, coords, i, n_lvl, r,
                                    path_counts=counts[i])
               for i, lvl in enumerate(levels)]
        torch.cuda.synchronize()
        # the tiles down each df1 and df2 path, counted by the kernels,
        # against their rule computed from the centres
        df1_paths = df1_counts.tolist()
        paths = counts.tolist()
        df2_rule = [list(windowed.tile_paths(coords, i, *lvl.shape[1:3],
                                             windowed.MAX_BOX, radius=r))
                    for i, lvl in enumerate(levels)]
        if df1_paths != rule or paths != df2_rule:
            raise AssertionError(f"windowed_corr_pyramid backward {case}: "
                                 f"df1 tiles per path {df1_paths} (the rule "
                                 f"says {rule}), df2 {paths} ({df2_rule})")
        if (windowed.df1_launches, windowed.df2_launches) \
                != (before[0] + 1, before[1] + n_lvl):
            raise AssertionError("windowed_corr_pyramid backward did not "
                                 "launch")
        # rule: the kernels' float32 gradients against the plain autograd
        # (float32 sums, rounded once to the inputs' dtype: one bf16 ulp),
        # 1e-5 of the largest plain value + 2^-13 S
        f1r = f1.detach().requires_grad_(True)
        lvr = [x.detach().requires_grad_(True) for x in levels]
        ref_out = windowed.windowed_corr_pyramid_reference(f1r, lvr, coords,
                                                           r)
        ref_grads = torch.autograd.grad(ref_out, [f1r, *lvr], dout,
                                        retain_graph=True)
        f1a = f1.detach().float().abs().requires_grad_(True)
        lva = [x.detach().float().abs().requires_grad_(True) for x in levels]
        s_bwd = torch.autograd.grad(
            windowed.windowed_corr_pyramid_reference(f1a, lva, coords, r),
            [f1a, *lva], dout.abs())
        df1_err, df1_share = _wcp_share(df1, ref_grads[0], s_bwd[0], bf16)
        df2_err, df2_share = 0.0, 0.0
        for got, exp, scale in zip(df2, ref_grads[1:], s_bwd[1:]):
            e, sh = _wcp_share(got, exp, scale, bf16)
            df2_err, df2_share = max(df2_err, e), max(df2_share, sh)
        del s_bwd, f1a, lva
        if not (df1_share <= 1.0 and df2_share <= 1.0):
            raise AssertionError(f"windowed_corr_pyramid backward {case}: "
                                 f"df1 {df1_err} ({df1_share} of its bound), "
                                 f"df2 {df2_err} ({df2_share})")

        ms = gpu_timer_ms(lambda: windowed._launch(f1, levels, coords, r))
        df1_ms = gpu_timer_ms(lambda: windowed._launch_df1(
            dout, f1, levels, coords, r))
        df2_ms = [gpu_timer_ms(lambda: windowed._launch_df2(
            dout, f1, lvl, coords, i, n_lvl, r))
            for i, lvl in enumerate(levels)]
        plain_ms = gpu_timer_ms(
            lambda: windowed.windowed_corr_pyramid_reference(
                f1, levels, coords, r), launches=2, rounds=3)
        plain_bwd_ms = gpu_timer_ms(lambda: torch.autograd.grad(
            ref_out, [f1r, *lvr], dout, retain_graph=True),
            launches=2, rounds=3)
        del ref_out, ref_grads

        c = case["c"]
        positions = b * h * w
        size = f1.element_size()
        f1_bytes = f1.numel() * size
        f2_bytes = [x.numel() * size for x in levels]
        coords_bytes = coords.numel() * 4
        out_bytes = out.numel() * 4
        ops_level = 2 * WCP_TAPS * c * positions
        fwd = _wcp_bound(f1_bytes + sum(f2_bytes) + coords_bytes + out_bytes,
                         ops_level * n_lvl, dtype)
        bwd1 = _wcp_bound(out_bytes + sum(f2_bytes) + coords_bytes
                          + f1.numel() * 4, ops_level * n_lvl, dtype)
        # df2 of level l: its dout columns, f1, coords, df2_l in float32
        bwd2 = [_wcp_bound(out_bytes // n_lvl + f1_bytes + coords_bytes
                           + x.numel() * 4, ops_level, dtype) for x in levels]
        record = dict(
            case=case["name"], dtype=case["dtype"], f1=list(f1.shape),
            levels=[list(x.shape) for x in levels], radius=r,
            positions=positions, max_abs_err=err, err_over_bound=share,
            ms=ms, plain_ms=plain_ms, bound_ms=fwd[0], bound_by=fwd[1],
            fwd_paths=fwd_paths,
            fwd_tile_share=_tile_share(fwd_paths),
            df1_max_abs_err=df1_err, df1_err_over_bound=df1_share,
            df1_ms=df1_ms, df1_bound_ms=bwd1[0], df1_bound_by=bwd1[1],
            df1_paths=df1_paths,
            df1_tile_share=_tile_share(df1_paths),
            df2_max_abs_err=df2_err, df2_err_over_bound=df2_share,
            df2_ms=df2_ms, df2_paths=paths, df2_tile_share=_tile_share(paths),
            df2_bound_ms=[x[0] for x in bwd2],
            df2_bound_by=[x[1] for x in bwd2],
            plain_bwd_ms=plain_bwd_ms)
        cases.append(record)
        emit(phase="kernel-check", kernel="windowed_corr_pyramid",
             tf32=False, card=card, **record)
        del f1, levels, coords, out, ref, dout, df1, df2, f1r, lvr
        torch.cuda.empty_cache()
    emit(phase="kernel-check", kernel="windowed_corr_pyramid_df1",
         check="one non-finite f2 pixel", card=card,
         **_wcp_df1_nonfinite(gen))
    return cases


def _wcp_df1_nonfinite(gen, n=32, pixel=(7, 7)):
    """The bfloat16 df1 with one infinite f2 pixel, on an n x n grid of
    integer centres (every tile on the tile path). The tile path's product
    multiplies the pixel by the zero weights of the windows that do not
    hold it too (0 * inf = NaN), so it may reach every df1 row of the
    tiles whose box holds it, where the plain version confines it to the
    windows that hold it. Held: the rows of those windows are non-finite,
    and the rows of every other tile equal a launch on the finite inputs
    bit for bit; returns the row counts."""
    from raft_meets_dicl_tpu_torch.ops import windowed

    r, c, t = FS_RADIUS, FS_CHANNELS, windowed.TILE
    f1 = torch.randn(1, n, n, c, device="cuda", generator=gen).bfloat16()
    f2 = torch.randn(1, n, n, c, device="cuda", generator=gen).bfloat16()
    ys, xs = torch.meshgrid(torch.arange(n, device="cuda"),
                            torch.arange(n, device="cuda"), indexing="ij")
    coords = torch.stack((xs, ys), dim=-1)[None].float().contiguous()
    dout = torch.randn(1, n, n, (2 * r + 1) ** 2, device="cuda",
                       generator=gen)
    finite = windowed._launch_df1(dout, f1, [f2], coords, r)
    py, px = pixel
    f2[0, py, px] = float("inf")
    counts = torch.zeros(1, 3, dtype=torch.int32, device="cuda")
    got = windowed._launch_df1(dout, f1, [f2], coords, r,
                               path_counts=counts)
    # windows x - r .. x + r + 1 (integer centres); a tile's box is its
    # windows' union, clipped to the grid
    lo_y, lo_x = (ys - r).clamp(min=0), (xs - r).clamp(min=0)
    hi_y, hi_x = (ys + r + 1).clamp(max=n - 1), (xs + r + 1).clamp(max=n - 1)
    in_window = (lo_y <= py) & (py <= hi_y) & (lo_x <= px) & (px <= hi_x)

    def tiles(v, fn):
        v = fn(fn(v.reshape(n // t, t, n // t, t), dim=3), dim=1)
        return v.repeat_interleave(t, 0).repeat_interleave(t, 1)

    in_box = (tiles(lo_y, torch.amin) <= py) \
        & (py <= tiles(hi_y, torch.amax)) \
        & (tiles(lo_x, torch.amin) <= px) & (px <= tiles(hi_x, torch.amax))
    bad = ~torch.isfinite(got[0]).all(-1)
    same = (got[0] == finite[0]).all(-1)
    record = dict(tiles=counts.tolist(), window_rows=int(in_window.sum()),
                  box_rows=int(in_box.sum()), nonfinite_rows=int(bad.sum()),
                  leaked_rows=int((bad & ~in_window).sum()))
    if counts.tolist() != [[(n // t) ** 2, 0, 0]] \
            or not bool(bad[in_window].all()) \
            or not bool(same[~in_box].all()) or bool(bad[~in_box].any()):
        raise AssertionError(f"windowed_corr_pyramid df1 with one infinite "
                             f"f2 pixel: {record}")
    return record


def _load_fs(mixed_precision=False):
    from raft_meets_dicl_tpu_torch import models, utils

    cfg = utils.config.load(FS_CFG)
    cfg["model"]["parameters"]["mixed-precision"] = mixed_precision
    return models.load(cfg)


def phase_fs_model(card):
    """raft/fs in float32, full width, 12 iterations, at 1x368x496, card vs
    CPU from one seeded init, TF32 off, at three budgets: every level
    windowed, the hybrid (2 + 2) and the default (every level a volume)."""
    from raft_meets_dicl_tpu_torch import evaluation
    from raft_meets_dicl_tpu_torch.models.impls.raft_fs import (
        volume_level_split,
    )

    set_tf32(False)
    rng = np.random.default_rng(8)
    h, w = FS_MODEL_SHAPE
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3))
                                   .astype(np.float32)) for _ in range(2))
    cpu_spec = _load_fs()
    cpu_spec.model.init(torch.Generator().manual_seed(0), device="cpu")
    gpu_spec = _load_fs()
    gpu_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    gpu_spec.model.module.to("cuda").eval()
    bf16_spec = _load_fs(True)
    bf16_spec.model.module.load_state_dict(cpu_spec.model.module.state_dict())
    bf16_spec.model.module.to("cuda").eval()
    cpu_step = evaluation.make_eval_fn(cpu_spec.model)
    gpu_step = evaluation.make_eval_fn(gpu_spec.model)
    bf16_step = evaluation.make_eval_fn(bf16_spec.model)
    x1, x2 = img1.cuda(), img2.cuda()

    runs, problems, launches = [], [], {}
    for gib, n_win in FS_MODEL_BUDGETS:
        with _volume_budget(gib):
            split = volume_level_split((1, h // 8, w // 8), FS_LEVELS, 4)
            if split != n_win:
                raise AssertionError(f"budget {gib}: split {split}, expected "
                                     f"{n_win}")
            _zero_counts()
            raw, flow_gpu = gpu_step(x1, x2)
            torch.cuda.synchronize()
            counts = _counts()
            t0 = time.perf_counter()
            _, flow_cpu = cpu_step(img1, img2)
            cpu_s = time.perf_counter() - t0
            # the same forward with TF32 convolutions and matmuls, which
            # the bound must tell apart
            set_tf32(True)
            flow_tf32 = gpu_step(x1, x2)[1].cpu()
            set_tf32(False)
            forward_f32_ms = gpu_timer_ms(lambda: gpu_step(x1, x2),
                                          launches=3)
            forward_bf16_ms = gpu_timer_ms(lambda: bf16_step(x1, x2),
                                           launches=3)
        expected = _expect(
            convex_combine_8x=1,
            windowed_corr_pyramid=FS_ITERATIONS if n_win else 0)
        flow_gpu = flow_gpu.cpu()
        diff = (flow_gpu - flow_cpu).abs().max().item()
        tf32_diff = (flow_tf32 - flow_cpu).abs().max().item()
        run = dict(budget_gib=gib, n_windowed=n_win, max_abs_diff_px=diff,
                   tf32_max_abs_diff_px=tf32_diff,
                   max_abs_flow_px=flow_cpu.abs().max().item(),
                   launches_per_forward=counts,
                   forward_f32_ms=forward_f32_ms,
                   forward_bf16_ms=forward_bf16_ms,
                   cpu_forward_s=round(cpu_s, 3))
        runs.append(run)
        launches[f"budget {gib}"] = counts
        if counts != expected:
            problems.append(f"budget {gib}: launched {counts}, expected "
                            f"{expected}")
        if len(raw) != FS_ITERATIONS or tuple(flow_gpu.shape) != (1, h, w, 2):
            problems.append(f"budget {gib}: {len(raw)} flows of "
                            f"{tuple(flow_gpu.shape)}")
        if not bool(torch.isfinite(flow_gpu).all()):
            problems.append(f"budget {gib}: non-finite flow on the card")
        bound = FS_MODEL_REL * max(run["max_abs_flow_px"], 1.0)
        run["bound_px"] = bound
        if not diff <= bound:
            problems.append(f"budget {gib}: card vs CPU final flow max "
                            f"|diff| {diff} px > {bound}")
        if not tf32_diff > bound:
            problems.append(f"budget {gib}: the TF32 forward stays inside "
                            f"the bound ({tf32_diff} px)")
    emit(phase="fs-model", model="raft/fs", shape=[1, h, w],
         iterations=FS_ITERATIONS, tf32=False, bound_rel=FS_MODEL_REL,
         runs=runs, card=card)
    if problems:
        raise AssertionError("fs model phase: " + "; ".join(problems))
    return launches["budget 0"]


def phase_fs_serve(card):
    """The serve command with the shipped raft/fs config (bf16 policy):
    the 1080x1920 bucket runs level 0 on the kernel, 448x1024 none."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.models.impls.raft_fs import (
        volume_level_split,
    )

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    buckets = ",".join(f"{h}x{w}" for h, w in FS_SERVE_BUCKETS)
    with tempfile.TemporaryDirectory() as tmp, _volume_budget(None):
        cfg = Path(tmp) / "serve.yaml"
        cfg.write_text(
            "serve:\n"
            f"  model: {FS_CFG}\n"
            f"  buckets: {buckets}\n"
            f"  batch-size: {FS_SERVE_BATCH}\n"
            "  max-wait-ms: 50\n"
            "  requests: 16\n"
            "  rate: 50\n")
        _zero_counts()
        report = port_main.main(["serve", "-c", str(cfg)])
        launches = _counts()
        # each dispatched batch (warm-up included) launches the forward
        # kernel once per iteration where its split windows a level
        windowed, dispatched, splits = 0, 0, {}
        for h, w in FS_SERVE_BUCKETS:
            key = f"{h}x{w}"
            n = report["batches_by_bucket"].get(key, 0) + 1   # + warm-up
            splits[key] = volume_level_split(
                (FS_SERVE_BATCH, h // 8, w // 8), FS_LEVELS, 2)
            windowed += FS_ITERATIONS * n * (splits[key] > 0)
            dispatched += n

    expected = _expect(convex_combine_8x=dispatched,
                       windowed_corr_pyramid=windowed)
    problems = []
    if report["completed"] != report["requests"] or report["requests"] != 16:
        problems.append(f"completed {report['completed']}/{report['requests']}")
    if report["errors"] or report["rejected"]:
        problems.append(f"errors {report['errors']}, rejected "
                        f"{report['rejected']}")
    if report["nonfinite"]:
        problems.append(f"{report['nonfinite']} non-finite flows")
    if splits != FS_SERVE_SPLITS:
        problems.append(f"splits {splits}, expected {FS_SERVE_SPLITS}")
    if not all(report["batches_by_bucket"].get(key)
               for key, n in FS_SERVE_SPLITS.items() if n):
        problems.append("no batch of a windowed bucket was dispatched")
    if launches != expected:
        problems.append(f"kernels launched {launches}, expected {expected} "
                        "(batches + warm-up)")
    if problems:
        raise AssertionError("fs serve phase: " + "; ".join(problems))

    emit(phase="fs-serve", model="raft/fs (bf16 policy)", buckets=buckets,
         batch=FS_SERVE_BATCH, requests=report["requests"],
         completed=report["completed"], batches=report["batches"],
         batches_by_bucket=report["batches_by_bucket"], n_windowed=splits,
         launches=launches, p50_ms=report["p50_ms"], p99_ms=report["p99_ms"],
         pairs_per_sec=report["pairs_per_sec"], spans_ms=report["spans_ms"],
         warmup=report["warmup"], card=card)
    return launches


def phase_fs_train_step(card):
    """One float32 train step of full-width raft/fs, 12 iterations, frozen
    batch norm, the hd1k-1080p stage's AdamW (at eps 1e-3) and clip, card
    vs CPU, twice from the same seed: every level windowed (budget 0, the
    kernels) and every level on volumes (the default budget, no
    windowed-correlation kernel), so that the step's gap to the CPU can be
    told apart from the kernels'. The same step with TF32 must break each
    bound."""
    from raft_meets_dicl_tpu_torch.models.impls.raft_fs import (
        volume_level_split,
    )

    b, h, w = FS_STEP_SHAPE
    steps = {}
    for gib, n_win in (("0", FS_LEVELS), (None, 0)):
        with _volume_budget(gib):
            split = volume_level_split((b, h // 8, w // 8), FS_LEVELS, 4)
            readings, tf32, launches, aux_cpu, cpu_s = _step_card_vs_cpu(
                _load_fs, FS_STEP_SHAPE, FS_LR, True, 9, FS_WEIGHT_DECAY)
        expected = _expect(
            windowed_corr_pyramid=FS_ITERATIONS if n_win else 0,
            windowed_corr_pyramid_df1=FS_ITERATIONS if n_win else 0,
            windowed_corr_pyramid_df2=FS_ITERATIONS * n_win,
            convex_combine_8x=1, convex_combine_8x_bwd=1)
        emit(phase="fs-train-step", model="raft/fs",
             shape=list(FS_STEP_SHAPE), iterations=FS_ITERATIONS,
             budget_gib=4.0 if gib is None else float(gib),
             n_windowed=split, tf32=False,
             optimizer=f"adam-w (eps {STEP_EPS}, weight decay "
                       f"{FS_WEIGHT_DECAY}) + clip norm 1.0",
             lr=FS_LR, frozen_bn=True, loss_cpu=aux_cpu["loss"].item(),
             grad_norm_cpu=aux_cpu["grad_norm"].item(),
             update_norm_cpu=aux_cpu["update_norm"].item(),
             bounds=FS_STEP_BOUNDS, launches=launches,
             cpu_step_s=round(cpu_s, 3), card=card, **readings,
             tf32_readings=tf32,
             tf32_outside_bounds=_step_problems(tf32, FS_STEP_BOUNDS))
        if split != n_win:
            raise AssertionError(f"fs train step: split {split} at budget "
                                 f"{gib}, expected {n_win}")
        if launches != expected:
            raise AssertionError(f"fs train step (n_win {n_win}) launched "
                                 f"{launches}, expected {expected}")
        _check_step(f"fs train step (n_win {n_win})", readings, tf32,
                    FS_STEP_BOUNDS)
        steps[n_win] = launches
    return steps[FS_LEVELS]


def _fs_train(card, gib, n_windowed):
    """The train command with the shipped raft/fs config (bf16 policy,
    frozen batch norm) and the hd1k-1080p stage's optimizer, schedule and
    clip, batch 1 at 2560x1072, at ``RMD_FS_VOLUME_GIB`` ``gib``, whose
    split must window ``n_windowed`` levels."""
    from raft_meets_dicl_tpu_torch.models.impls.raft_fs import (
        volume_level_split,
    )

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = FS_TRAIN_SHAPE
    with _volume_budget(gib):
        n_win = volume_level_split((FS_TRAIN_BATCH, h // 8, w // 8),
                                   FS_LEVELS, 2)
        readings, problems = _train_command(
            FS_CFG, FS_TRAIN_SHAPE, FS_TRAIN_BATCH, FS_TRAIN_PAIRS,
            FS_TRAIN_STEPS,
            _strategy("hd1k-1080p", FS_TRAIN_BATCH, "true", FS_LR,
                      weight_decay=FS_WEIGHT_DECAY,
                      total_steps="{n_epochs} * {n_batches} + 100"))
    steps = readings["steps"]
    expected = _expect(
        windowed_corr_pyramid=FS_ITERATIONS * steps,
        windowed_corr_pyramid_df1=FS_ITERATIONS * steps,
        windowed_corr_pyramid_df2=FS_ITERATIONS * n_win * steps,
        convex_combine_8x=steps, convex_combine_8x_bwd=steps)
    if n_win != n_windowed:
        problems.append(f"split {n_win} at {h}x{w}, expected {n_windowed}")
    if readings["launches"] != expected:
        problems.append(f"kernels launched {readings['launches']}, expected "
                        f"{expected}")
    if problems:
        raise AssertionError("fs train phase: " + "; ".join(problems))
    emit(phase="fs-train", model="raft/fs (bf16 policy, frozen BN)",
         volume_gib=gib, iterations=FS_ITERATIONS, n_windowed=n_win,
         cudnn_tf32=torch.backends.cudnn.allow_tf32,
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32, card=card,
         **readings)
    return readings["launches"]


def phase_fs_train(card):
    """``main train`` of raft/fs at 2560x1072, default budget (level 0
    windowed: 12 forward, 12 df1 and 12 df2 launches a step)."""
    return _fs_train(card, None, 1)


def phase_fs_train_all_levels(card):
    """The same run with every level windowed (``RMD_FS_VOLUME_GIB`` 0:
    12 forward, 12 df1 and 48 df2 launches a step)."""
    return _fs_train(card, "0", FS_LEVELS)


# -- the lookup probe (phase 19) and the quantized tier (phase 20) ------------

def _lookup_inputs(case, gen):
    """wy, corr, wx for one case: the probe's own hat inputs
    (``make_inputs``, ``np.random.RandomState(0)``) or dense randn ones."""
    from raft_meets_dicl_tpu_torch.scripts import probe_fused_lookup as probe

    b, ni, nj, h2, w2 = case["shape"]
    dtype = getattr(torch, case["dtype"])
    if case["kind"] == "hat":
        return probe.make_inputs(b, ni, nj, h2, w2, dtype, "cuda")
    return tuple(torch.randn(*shape, device="cuda", generator=gen).to(dtype)
                 for shape in ((b, ni, nj, 9, h2), (b, ni, nj, h2, w2),
                               (b, ni, nj, 9, w2)))


def _lookup_share(out, ref, bound):
    err = (out - ref).abs()
    return err.max().item(), (err / bound.clamp(min=1e-30)).max().item()


def _lookup_pin(lookup, wy, corr, wx, out):
    """The fused kernel with corr = +inf at LOOKUP_PIN of one position
    (see there): that position's outputs non-finite wherever the plain
    version's are (every one: 0 · inf is NaN), every other position's bit
    for bit as ``out`` (the same inputs, finite)."""
    h2, w2 = corr.shape[-2:]
    flat = corr.reshape(-1, h2, w2).clone()
    p = 2 * (flat.shape[0] // 4) + 1
    flat[(p, *LOOKUP_PIN)] = float("inf")
    pinned = flat.reshape(corr.shape)
    got = lookup.lookup_fused(wy, pinned, wx).reshape(-1, 9, 9)
    plain = lookup.lookup_fused_reference(wy, pinned, wx).reshape(-1, 9, 9)
    torch.cuda.synchronize()
    nonfinite = ~torch.isfinite(got[p])
    others = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    others[p] = False
    record = dict(position=p, element=list(LOOKUP_PIN),
                  nonfinite=int(nonfinite.sum()),
                  plain_nonfinite=int((~torch.isfinite(plain[p])).sum()),
                  others_unchanged=bool(torch.equal(
                      got[others], out.reshape(-1, 9, 9)[others])))
    if not (torch.equal(nonfinite, ~torch.isfinite(plain[p]))
            and record["others_unchanged"]):
        raise AssertionError(f"lookup_fused non-finite pin: {record}")
    return record


def _lookup_probe_run(dtype):
    """The port's probe entry point as a user runs it (its own process,
    so its launch counts start at 0): returns its result line."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "raft_meets_dicl_tpu_torch.scripts.probe_fused_lookup",
         "--dtype", dtype, "--steps", str(PROBE_STEPS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"probe --dtype {dtype} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])["probe"]
    expected = {"lookup_stage1": PROBE_STEPS + 1,
                "lookup_fused": PROBE_STEPS + 1}
    if result["launches"] != expected:
        raise AssertionError(f"probe --dtype {dtype}: launches "
                             f"{result['launches']}, expected {expected}")
    for name in "BCD":
        if not result["arms"][name]["share"] <= 1.0:
            raise AssertionError(f"probe --dtype {dtype}: arm {name} "
                                 f"{result['arms'][name]}")
    return result


def phase_lookup_kernels(card):
    """lookup_stage1 and lookup_fused against their plain versions on the
    card, TF32 and cuBLAS's reduced-precision bf16 reductions off, at the
    probe's bench case (bf16, f32), dense, ragged and wide cases; each
    timed beside the plain version, its bound and the torch.matmul pair
    (arm A). Then the probe entry point itself, bf16 (the main path) and
    f32, as subprocesses."""
    from raft_meets_dicl_tpu_torch.ops import lookup
    from raft_meets_dicl_tpu_torch.scripts.probe_fused_lookup import (
        bf16_ulp_term,
    )

    set_tf32(False)
    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(19)
    cases = []
    try:
        for case in LOOKUP_CASES:
            dtype = getattr(torch, case["dtype"])
            bf16 = dtype == torch.bfloat16
            wy, corr, wx = _lookup_inputs(case, gen)
            b, ni, nj, h2, w2 = case["shape"]
            # the fused kernel's plan as the built library computes it,
            # equal to the rule the CPU tests pin
            plan = lookup.fused_plan(h2, w2, dtype)
            if lookup.kernel_fused_plan(h2, w2, dtype) != plan:
                raise AssertionError(
                    f"lookup {case}: the kernel's fused plan "
                    f"{lookup.kernel_fused_plan(h2, w2, dtype)} is not "
                    f"lookup.fused_plan's {plan}")
            before = (lookup.stage1_launches, lookup.fused_launches)
            t = lookup.lookup_stage1(wy, corr)
            out = lookup.lookup_fused(wy, corr, wx)
            torch.cuda.synchronize()
            if (lookup.stage1_launches, lookup.fused_launches) \
                    != (before[0] + 1, before[1] + 1):
                raise AssertionError("lookup kernels did not launch")
            absw = (wy.float().abs(), corr.float().abs(), wx.float().abs())
            ref_t = lookup.lookup_stage1_reference(wy, corr)
            s1 = lookup.lookup_stage1_reference(*absw[:2])
            err_t, share_t = _lookup_share(t, ref_t, LOOKUP_ORDER_REL * s1)
            ref = lookup.lookup_fused_reference(wy, corr, wx)
            s = lookup.lookup_fused_reference(*absw)
            ulp = (bf16_ulp_term(ref_t.to(dtype), wx) if bf16
                   else torch.zeros_like(s))
            err, share = _lookup_share(out, ref, LOOKUP_ORDER_REL * s + ulp)
            # the library call computes the same functions (stage 1 in the
            # inputs' dtype: bf16 t, one rounding)
            lib_t = torch.matmul(wy, corr)
            lib = torch.matmul(lib_t.float(), wx.float().transpose(-1, -2))
            lib_t_err, lib_t_share = _lookup_share(
                lib_t.float(), ref_t, LOOKUP_ORDER_REL * s1
                + (_bf16_ulp(ref_t) if bf16 else 0.0))
            lib_err, lib_share = _lookup_share(lib, ref,
                                               LOOKUP_ORDER_REL * s + ulp)
            del absw, s1, s, ulp, lib_t, lib
            if not max(share_t, share, lib_t_share, lib_share) <= 1.0:
                raise AssertionError(
                    f"lookup {case}: stage 1 {err_t} ({share_t} of its "
                    f"bound), fused {err} ({share}), library {lib_t_share} "
                    f"/ {lib_share}")
            pin = (_lookup_pin(lookup, wy, corr, wx, out)
                   if case["kind"] == "dense" else None)

            ms_t = gpu_timer_ms(lambda: lookup.lookup_stage1(wy, corr))
            ms = gpu_timer_ms(lambda: lookup.lookup_fused(wy, corr, wx))
            plain_t_ms = gpu_timer_ms(
                lambda: lookup.lookup_stage1_reference(wy, corr))
            plain_ms = gpu_timer_ms(
                lambda: lookup.lookup_fused_reference(wy, corr, wx))
            lib_t_ms = gpu_timer_ms(lambda: torch.matmul(wy, corr))
            lib_ms = gpu_timer_ms(lambda: torch.matmul(
                torch.matmul(wy, corr).float(),
                wx.float().transpose(-1, -2)))

            n, k = b * ni * nj, 9
            size = wy.element_size()
            ops_t = 2 * n * k * h2 * w2
            bound_t = _wcp_bound((wy.numel() + corr.numel()) * size
                                 + t.numel() * 4, ops_t, dtype)
            bound = _wcp_bound((wy.numel() + corr.numel() + wx.numel())
                               * size + out.numel() * 4,
                               ops_t + 2 * n * k * k * w2, dtype)
            record = dict(
                case=case["name"], kind=case["kind"], dtype=case["dtype"],
                shape=dict(zip(("b", "ni", "nj", "h2", "w2"), case["shape"])),
                stage1_max_abs_err=err_t, stage1_err_over_bound=share_t,
                stage1_ms=ms_t, stage1_plain_ms=plain_t_ms,
                stage1_library_ms=lib_t_ms, stage1_bound_ms=bound_t[0],
                stage1_bound_by=bound_t[1],
                fused_max_abs_err=err, fused_err_over_bound=share,
                fused_ms=ms, fused_plain_ms=plain_ms, fused_library_ms=lib_ms,
                fused_bound_ms=bound[0], fused_bound_by=bound[1],
                library_err_over_bound=max(lib_t_share, lib_share),
                fused_plan=plan, **({"nonfinite_pin": pin} if pin else {}))
            cases.append(record)
            emit(phase="kernel-check", kernel="lookup", tf32=False,
                 card=card, **record)
            del wy, corr, wx, t, out, ref_t, ref
            torch.cuda.empty_cache()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = True

    probe = {}
    for dtype in ("bf16", "f32"):
        probe[dtype] = _lookup_probe_run(dtype)
        emit(phase="lookup-probe", card=card, **probe[dtype])
    return {"cases": cases, "probe": probe,
            "paths": {"probe": probe["bf16"]["launches"],
                      "probe_f32": probe["f32"]["launches"]}}


def _quant_forward(model, weights, quant, img1, img2, device,
                   features=None):
    """One eval forward of ``model`` (``"raft"`` or ``"fs"``, float32) with
    ``weights`` and ``quant``. The feature maps each volume is built from
    (the inputs of ``correlation_pyramid_direct`` and
    ``correlation_pyramid_int8`` in raft, of each ``correlation_volume``
    in raft/fs) are recorded; with ``features`` (another run's record)
    they are replaced by those, so the volumes are computed on this device
    from the other's features. Returns ((first iteration's flow, final
    flow) on the CPU, the record, launches)."""
    from raft_meets_dicl_tpu_torch import evaluation
    from raft_meets_dicl_tpu_torch.models.impls import raft, raft_fs

    targets = ([(raft, "correlation_pyramid_direct"),
                (raft.quant_ops, "correlation_pyramid_int8")]
               if model == "raft" else [(raft_fs, "correlation_volume")])
    seen = []

    def wrap(original):
        def call(f1, f2, *args, **kwargs):
            if features is not None:
                f1, f2 = (f.to(f1.device) for f in features[len(seen)])
            seen.append((f1.cpu(), f2.cpu()))
            return original(f1, f2, *args, **kwargs)
        return call

    spec = _load_raft(False) if model == "raft" else _load_fs()
    spec.model.module.load_state_dict(weights)
    spec.model.module.to(device).eval()
    step = evaluation.make_eval_fn(spec.model, {"quant": quant})
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]
    for obj, name, original in saved:
        setattr(obj, name, wrap(original))
    try:
        _zero_counts()
        raw, flow = step(img1.to(device), img2.to(device))
        if device == "cuda":
            torch.cuda.synchronize()
        counts = _counts()
    finally:
        for obj, name, original in saved:
            setattr(obj, name, original)
    return (raw[0].cpu(), flow.cpu()), seen, counts


def phase_quant(card):
    """The quantized matching tier on the card against the CPU, TF32 off:
    the int8 and u8 pyramids and u8/i8 levels of identical inputs (the int8
    dot is exact), then the raft/baseline f32 forward with u8 and i8 and
    raft/fs with u8 at a split with volumes, each against the CPU's forward
    from the same weights (the card's volumes from the CPU's features) and
    against the card's unquantized flow; the same forward with TF32 must
    break the first iteration's bound."""
    from raft_meets_dicl_tpu_torch.ops import quant
    from raft_meets_dicl_tpu_torch.ops.corr import correlation_pyramid_direct

    set_tf32(False)
    # 1. identical inputs: the card's quantized pyramid is the CPU's
    rng = np.random.default_rng(20)
    f1, f2 = (torch.from_numpy(rng.standard_normal(
        (1, 46, 62, 256)).astype(np.float32)) for _ in range(2))
    f2[..., 7] *= 30.0
    cpu = quant.correlation_pyramid_int8(f1, f2, 4)
    gpu = quant.correlation_pyramid_int8(f1.cuda(), f2.cuda(), 4)
    pyramid = []
    for lvl, (c, g) in enumerate(zip(cpu, gpu)):
        step = (g.values.cpu().int() - c.values.int()).abs()
        scale_rel = ((g.scale.cpu() - c.scale).abs() / c.scale).max().item()
        pyramid.append(dict(level=lvl, shape=list(c.values.shape),
                            max_step=step.max().item(),
                            share_differing=(step > 0).float().mean().item(),
                            scale_rel_diff=scale_rel))
        if (lvl == 0 and step.max().item() != 0) or step.max().item() > 1 \
                or (step > 0).float().mean().item() > QUANT_INT8_MAX_SHARE:
            raise AssertionError(f"int8 pyramid level {lvl}: {pyramid[-1]}")
    vol = torch.from_numpy(rng.standard_normal(
        (2, 46, 62, 23, 31)).astype(np.float32))
    for mode in ("u8", "i8"):
        c, g = quant.quantize_level(vol, mode), \
            quant.quantize_level(vol.cuda(), mode)
        if not (torch.equal(c.values, g.values.cpu())
                and torch.equal(c.scale, g.scale.cpu())):
            raise AssertionError(f"quantize_level {mode}: card != CPU")
    # the u8 pyramid of one pair of feature maps: the card's float32 volume
    # matmul sums in another order than the CPU's, so a value at a
    # rounding tie may land one step apart; TF32 on that matmul moves many
    u8 = {}
    cpu = quant.quantize_pyramid(correlation_pyramid_direct(f1, f2, 4), "u8")
    for tf32 in (False, True):
        set_tf32(tf32)
        gpu = quant.quantize_pyramid(
            correlation_pyramid_direct(f1.cuda(), f2.cuda(), 4), "u8")
        steps = [(g.values.cpu().int() - c.values.int()).abs()
                 for c, g in zip(cpu, gpu)]
        u8["tf32" if tf32 else "f32"] = dict(
            max_step=max(s.max().item() for s in steps),
            share_differing=max((s > 0).float().mean().item()
                                for s in steps))
    set_tf32(False)
    if not (u8["f32"]["max_step"] <= 1
            and u8["f32"]["share_differing"] <= QUANT_U8_MAX_SHARE
            < u8["tf32"]["share_differing"]):
        raise AssertionError(f"u8 pyramid card vs CPU: {u8} (share bound "
                             f"{QUANT_U8_MAX_SHARE}, which TF32 must break)")

    # 2. the models, one seeded init each
    rng = np.random.default_rng(21)
    h, w = QUANT_MODEL_SHAPE
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (1, h, w, 3))
                                   .astype(np.float32)) for _ in range(2))
    weights = {}
    for model, spec in (("raft", _load_raft(False)), ("fs", _load_fs())):
        spec.model.init(torch.Generator().manual_seed(0), device="cpu")
        weights[model] = spec.model.module.state_dict()

    runs, problems, launches = [], [], {}
    for name, model, quant_mode, gib, expected in QUANT_RUNS:
        def forward(quant_mode, device, features=None):
            return _quant_forward(model, weights[model], quant_mode, img1,
                                  img2, device, features)

        with _volume_budget(gib):
            plain, _, _ = forward(None, "cuda")
            t0 = time.perf_counter()
            with torch.backends.mkldnn.flags(enabled=False):
                cpu, feats, _ = forward(quant_mode, "cpu")
            cpu_s = time.perf_counter() - t0
            own, _, counts = forward(quant_mode, "cuda")
            # the card's volumes from the CPU's features: what is left is
            # the volume matmul's summation order, the quantized lookup and
            # the recurrence, without the value flips that features a few
            # ulps apart cause
            held, _, _ = forward(quant_mode, "cuda", feats)
            set_tf32(True)
            tf32, _, _ = forward(quant_mode, "cuda", feats)
            set_tf32(False)
        run = dict(run=name, quant=quant_mode, budget_gib=gib,
                   launches_per_forward=counts, cpu_forward_s=round(cpu_s, 3))
        # [0]: the first iteration (looked up at integer positions: exact
        # hat weights); [1]: the final flow
        for it, label in ((0, "first"), (1, "final")):
            scale = max(cpu[it].abs().max().item(), 1.0)
            run[label] = dict(
                max_abs_flow_px=scale,
                bound_px=QUANT_MODEL_REL[label][name] * scale,
                max_abs_diff_px=(held[it] - cpu[it]).abs().max().item(),
                own_features_max_abs_diff_px=(own[it] - cpu[it]).abs().max()
                .item(),
                tf32_max_abs_diff_px=(tf32[it] - cpu[it]).abs().max().item(),
                quant_effect_px=(own[it] - plain[it]).abs().max().item())
        runs.append(run)
        launches[name] = counts
        first, final = run["first"], run["final"]
        if counts != _expect(**expected):
            problems.append(f"{name}: launched {counts}, expected "
                            f"{_expect(**expected)}")
        if not all(torch.isfinite(f).all() for f in (*own, *cpu)):
            problems.append(f"{name}: non-finite flow")
        for label, r in (("first", first), ("final", final)):
            if not r["max_abs_diff_px"] <= r["bound_px"]:
                problems.append(f"{name}: {label} flow card vs CPU "
                                f"{r['max_abs_diff_px']} px > {r['bound_px']}")
            if not r["quant_effect_px"] > r["bound_px"]:
                problems.append(f"{name}: the tier moves the {label} flow no "
                                f"further than the bound "
                                f"({r['quant_effect_px']} px)")
        if not first["tf32_max_abs_diff_px"] > first["bound_px"]:
            problems.append(f"{name}: the TF32 forward stays inside the first "
                            f"iteration's bound "
                            f"({first['tf32_max_abs_diff_px']} px)")
    emit(phase="quant", shape=[1, h, w], iterations=12, tf32=False,
         int8_pyramid=pyramid, u8_pyramid=u8, runs=runs, card=card)
    if problems:
        raise AssertionError("quant phase: " + "; ".join(problems))
    return launches


# -- the training lifecycle: validation, checkpoints, resume, serving -----------


def _life_strategy():
    """Two stages shaped like s1-things.yaml (its optimizer, one-cycle
    schedule, clip and loss gamma; a ``dataset`` source instead of its
    augment/concat), ``mode: best``, each with LIFE_EPOCHS epochs and a
    validation entry on the Sintel-sized tree (sample 0's images)."""
    stages = ""
    for k in (1, 2):
        stages += (
            f"  - name: synthetic scene, stage {k}\n"
            f"    id: synthetic/s{k}\n"
            "    data:\n"
            f"      epochs: {LIFE_EPOCHS}\n"
            f"      batch-size: {TRAIN_BATCH}\n"
            "      source: {type: dataset, spec: dataset.yaml}\n"
            "    validation:\n"
            f"      - name: sintel-sized\n"
            f"        batch-size: {LIFE_VAL_BATCH}\n"
            "        images: [0]\n"
            "        source: {type: dataset, spec: val/dataset.yaml}\n"
            "    model:\n"
            "      on-stage: {freeze_batchnorm: true}\n"
            "    loss:\n"
            "      arguments: {gamma: 0.8}\n"
            "    optimizer:\n"
            "      type: adam-w\n"
            "      parameters: {lr: 0.000125, weight_decay: 0.0001, "
            "eps: 1.0e-8}\n"
            "    lr-scheduler:\n"
            "      instance:\n"
            "        - type: one-cycle\n"
            "          parameters: {max_lr: 0.000125, total_steps: "
            "'100000 + 100',\n"
            "                       pct_start: 0.05, cycle_momentum: false,\n"
            "                       anneal_strategy: linear}\n"
            "    gradient:\n"
            "      clip: {type: norm, value: 1.0}\n")
    return "mode: best\nstages:\n" + stages


def _tree_equal(a, b):
    """Bit for bit: tensors by dtype, shape and values, the rest by ==."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


CONVEX_KERNELS = ("convex_combine_8x", "convex_combine_8x_bwd")


@contextlib.contextmanager
def _life_probes():
    """Record, through the port's own callbacks, the live state where each
    stage starts (``SummaryInspector.on_stage_start``: after a ``mode:
    best`` load or a resume's restore, before the stage's first step) and
    each validation pass (``StrategyValidation.run``): its batches, the
    combine kernels' launches read before and after it, the device time
    of its validation steps (CUDA events around each, read after the
    pass) and the host time of its image writes."""
    from raft_meets_dicl_tpu_torch.inspect import summary
    from raft_meets_dicl_tpu_torch.strategy import checkpoint

    probes = {"stages": [], "validations": []}
    originals = (summary.SummaryInspector.on_stage_start,
                 summary.StrategyValidation.run, summary.make_val_step,
                 summary.write_images)
    on_stage_start, validate, make_val_step, write_images = originals
    current = {}

    def record(self, log, ctx, stage):
        probes["stages"].append({
            "stage": stage.index, "step": ctx.step,
            "model": checkpoint._to_host(ctx.model.module.state_dict()),
            "optimizer": checkpoint._to_host(
                ctx.state.tx.optimizer.state_dict()),
            "lr_sched_inst": [s.state_dict() for s in ctx.lr_sched_inst]})
        return on_stage_start(self, log, ctx, stage)

    def counted(self, log, ctx, writer, chkpt, stage, epoch):
        current.update(events=[], image_ms=0.0)
        runs, before = len(self.runs), _counts()
        validate(self, log, ctx, writer, chkpt, stage, epoch)
        after = _counts()
        for _, end in current["events"]:
            end.synchronize()
        probes["validations"].append({
            "stage": stage.index, "epoch": epoch,
            "batches": sum(r["batches"] for r in self.runs[runs:]),
            "seconds": sum(r["seconds"] for r in self.runs[runs:]),
            "launches": tuple(after[k] - before[k] for k in CONVEX_KERNELS),
            "step_ms": [a.elapsed_time(b) for a, b in current["events"]],
            "image_ms": current["image_ms"]})
        current.clear()

    def timed_val_step(*args, **kwargs):
        step = make_val_step(*args, **kwargs)

        def run(*inputs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*inputs)
            end.record()
            current["events"].append((start, end))
            return out
        return run

    def timed_write_images(*args, **kwargs):
        # the train path's images too; only a validation pass's are timed
        t0 = time.perf_counter()
        write_images(*args, **kwargs)
        if current:
            current["image_ms"] += 1e3 * (time.perf_counter() - t0)

    (summary.SummaryInspector.on_stage_start, summary.StrategyValidation.run,
     summary.make_val_step, summary.write_images) = (
        record, counted, timed_val_step, timed_write_images)
    try:
        yield probes
    finally:
        (summary.SummaryInspector.on_stage_start,
         summary.StrategyValidation.run, summary.make_val_step,
         summary.write_images) = originals


def _life_train(data, out, *extra,
                inspect=ROOT / "cfg" / "inspect" / "default.yaml"):
    """``main train`` of the shipped raft/baseline config with the inspect
    config ``inspect``; returns the context, the probes and the
    combine kernels' launches in the whole run."""
    from raft_meets_dicl_tpu_torch import main as port_main

    with _life_probes() as probes:
        _zero_counts()
        tctx = port_main.main([
            "train", "-d", str(data / "strategy.yaml"),
            "-m", str(ROOT / "cfg" / "model" / "raft-baseline.yaml"),
            "-i", str(inspect),
            "-o", str(out), *extra])
        torch.cuda.synchronize()
        counts = _counts()
    launches = tuple(counts[k] for k in CONVEX_KERNELS)
    return tctx, probes, launches


def _life_run_problems(name, tctx, probes, launches, steps):
    """A run's steps, finite losses and kernel launches, split by path:
    each validation pass's launches (read around it) must be one forward
    per batch and no backward; the rest of the run's launches, the train
    path's, one forward and one backward per step. Returns the problems
    and the run's (train, validation) launches and validation batches."""
    problems = []
    passes = probes["validations"]
    val = tuple(sum(v["launches"][i] for v in passes) for i in (0, 1))
    train = tuple(a - b for a, b in zip(launches, val))
    batches = sum(v["batches"] for v in passes)
    runs = [run for v in tctx.inspector.val_epoch for run in v.runs]
    if len(tctx.history) != steps:
        problems.append(f"{name}: {len(tctx.history)} steps, expected {steps}")
    if not all(np.isfinite(h["loss"]) and h["finite"] for h in tctx.history):
        problems.append(f"{name}: non-finite loss or flow")
    if len(passes) != len(runs) or not passes:
        problems.append(f"{name}: {len(passes)} validation passes probed, "
                        f"{len(runs)} recorded")
    for v in passes:
        if v["launches"] != (v["batches"], 0):
            problems.append(
                f"{name}: the validation pass of stage {v['stage']}, epoch "
                f"{v['epoch']} launched the combine kernels {v['launches']} "
                f"times, expected ({v['batches']} batches, 0)")
    if train != (steps, steps):
        problems.append(f"{name}: the train path launched the combine "
                        f"kernels {train} times, expected ({steps}, {steps})")
    return problems, {"train": train, "validation": val,
                      "validation_batches": batches}


def _life_validation_readings(probes):
    return [dict(stage=v["stage"], epoch=v["epoch"], batches=v["batches"],
                 ms_per_batch=1e3 * v["seconds"] / v["batches"],
                 step_device_ms=v["step_ms"], image_write_ms=v["image_ms"],
                 launches=list(v["launches"]))
            for v in probes["validations"]]


def _life_event_problems(tctx, validations):
    """The validation scalars of both stages and four images of sample 0
    per validation pass, in the run's event file."""
    from raft_meets_dicl_tpu_torch.inspect import writer

    events = writer.read_events(tctx.inspector.writer.path)
    values = [v for e in events for v in e.get("values", [])]
    tags = {v["tag"] for v in values}
    problems = []
    for s in (0, 1):
        pfx = f"Validation:S{s}:synthetic.s{s + 1}:sintel-sized/"
        missing = {f"{pfx}EndPointError/mean", f"{pfx}Fl-all",
                   f"{pfx}Loss"} - tags
        if missing:
            problems.append(f"event file lacks {sorted(missing)}")
    images = [v["tag"] for v in values if "image" in v
              and v["tag"].startswith("Validation:")]
    if len(images) != 4 * validations or {
            t.rsplit("/", 1)[1] for t in images} != {
            "img1", "img2", "flow-gt", "flow-est"}:
        problems.append(f"event file holds {len(images)} validation images, "
                        f"expected 4 per pass ({4 * validations})")
    return problems, len(events)


def phase_lifecycle(card):
    """The training lifecycle of raft/baseline (shipped bf16-policy
    config, frozen BN) on the card through the CLI, with
    cfg/inspect/default.yaml: a two-stage ``mode: best`` run with per-epoch
    validation on a 436x1024 tree and metric-named checkpoints; the same
    run with an inspect config whose ``compare`` makes stage 1's first
    checkpoint its best, stopped at stage 2's first step; a run stopped by
    ``--limit-steps`` at the first epoch's end and resumed by ``--resume
    auto``; ``serve`` from the final checkpoint."""
    from raft_meets_dicl_tpu_torch import evaluation, models
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.serve import loadgen
    from raft_meets_dicl_tpu_torch.strategy import checkpoint
    from raft_meets_dicl_tpu_torch.utils import config

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    steps_per_epoch = LIFE_PAIRS // TRAIN_BATCH
    steps = 2 * LIFE_EPOCHS * steps_per_epoch
    problems = []
    readings = {}
    paths = {"train": [0, 0], "validation": [0, 0]}

    def run_problems(name, tctx, probes, launches, n):
        p, split = _life_run_problems(name, tctx, probes, launches, n)
        problems.extend(p)
        for path in paths:
            paths[path] = [a + b for a, b in zip(paths[path], split[path])]
        return split

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        _write_training_tree(data, TRAIN_SHAPE, LIFE_PAIRS, _life_strategy())
        _write_training_tree(data / "val", LIFE_VAL_SHAPE, LIFE_VAL_PAIRS, "")

        # 1. the whole run: 4 validations, 4 checkpoints
        tctx, probes, launches = _life_train(data, tmp / "fresh")
        split = run_problems("fresh run", tctx, probes, launches, steps)
        mgr = tctx.checkpoints
        files = sorted(p.name for p in mgr.path.iterdir())
        # every epoch's checkpoint: default.yaml keeps the 2 latest and
        # the 2 best of each stage, and each stage has LIFE_EPOCHS <= 2
        expected = [f"raft_baseline-s{s}_e{e}_b"
                    f"{(s * LIFE_EPOCHS + e + 1) * steps_per_epoch}-epe"
                    for s in (0, 1) for e in range(LIFE_EPOCHS)]
        if len(files) != len(expected) or not all(
                any(f.startswith(x) for f in files) for x in expected):
            problems.append(f"checkpoints {files}, expected {expected}")
        best = mgr.get_best(stage=0)
        stage2 = next(s for s in probes["stages"] if s["stage"] == 1)
        if not _tree_equal(stage2["model"], best.load().state.model):
            problems.append("stage 2 did not start from stage 1's best "
                            f"checkpoint '{best.path.name}'")
        final = mgr.get_latest()
        resaved = tmp / "resaved.ckpt"
        checkpoint.Checkpoint.load(final.path).save(resaved)
        if resaved.read_bytes() != final.path.read_bytes():
            problems.append("a checkpoint re-saved after loading differs "
                            "from its file")
        p, n_events = _life_event_problems(tctx, len(probes["validations"]))
        problems += p
        readings["fresh"] = dict(
            steps=len(tctx.history), launches=list(launches),
            train_launches=list(split["train"]),
            validation_launches=list(split["validation"]),
            validation_batches=split["validation_batches"],
            checkpoints=files, best_of_stage_1=best.path.name,
            event_records=n_events, saves=mgr.saves,
            validation=_life_validation_readings(probes),
            losses=[h["loss"] for h in tctx.history])

        # 2. stage 1's best is not its latest: default.yaml with a
        # ``compare`` on the step count (the earliest checkpoint is best),
        # stopped after stage 2's first step; stage 2 must start from
        # stage 1's first checkpoint, not from its live weights
        cfg = config.load(ROOT / "cfg" / "inspect" / "default.yaml")
        cfg["checkpoints"]["compare"] = ["{n_steps}"]
        config.store(tmp / "inspect-earliest.yaml", cfg)
        n = LIFE_EPOCHS * steps_per_epoch + 1
        tctx, probes, launches = _life_train(
            data, tmp / "earliest", "--limit-steps", str(n),
            inspect=tmp / "inspect-earliest.yaml")
        split = run_problems("earliest-best run", tctx, probes, launches, n)
        best = tctx.checkpoints.get_best(stage=0)
        last = tctx.checkpoints.get_latest(stage=0)
        starts = [s for s in probes["stages"] if s["stage"] == 1]
        if (best is None or last is None or best.idx_epoch != 0
                or last.idx_epoch != LIFE_EPOCHS - 1 or len(starts) != 1):
            problems.append(
                f"earliest-best run: stage 1's best {best and best.path.name}"
                f", latest {last and last.path.name}, {len(starts)} stage-2 "
                "starts; expected epoch 0 best, the last epoch latest, 1")
        else:
            start = starts[0]["model"]
            if not _tree_equal(start, best.load().state.model):
                problems.append(
                    "earliest-best run: stage 2 did not start from stage "
                    f"1's best checkpoint '{best.path.name}'")
            if _tree_equal(start, last.load().state.model):
                problems.append(
                    "earliest-best run: stage 2 started from stage 1's "
                    f"latest weights '{last.path.name}', not its best")
        readings["earliest_best"] = dict(
            steps=len(tctx.history), launches=list(launches),
            train_launches=list(split["train"]),
            validation_launches=list(split["validation"]),
            best_of_stage_1=best and best.path.name,
            latest_of_stage_1=last and last.path.name,
            validation=_life_validation_readings(probes))

        # 3. stopped at the first epoch's end, then --resume auto
        out = tmp / "resume"
        stopped, probes, launches = _life_train(
            data, out, "--limit-steps", str(steps_per_epoch))
        stop = run_problems("stopped run", stopped, probes, launches,
                            steps_per_epoch)
        saved = stopped.checkpoints.get_latest()
        resumed, probes, launches = _life_train(data, out, "--resume",
                                                "auto")
        res = run_problems("resumed run", resumed, probes, launches,
                           steps - steps_per_epoch)
        chkpt = saved.load()
        restored = probes["stages"][0]
        if restored["step"] != steps_per_epoch or resumed.step != steps:
            problems.append(f"resumed at step {restored['step']} and ended "
                            f"at {resumed.step}")
        for what, live, stored in (
                ("parameters and batch-norm buffers", restored["model"],
                 chkpt.state.model),
                ("AdamW moments and step counts",
                 restored["optimizer"]["state"], chkpt.state.optimizer["state"]),
                ("schedulers' steps", restored["lr_sched_inst"],
                 chkpt.state.lr_sched_inst)):
            if not _tree_equal(live, stored):
                problems.append(f"--resume auto did not restore the {what} "
                                f"of '{saved.path.name}' bit for bit")
        readings["resume"] = dict(
            checkpoint=saved.path.name,
            stopped_train_launches=list(stop["train"]),
            stopped_validation_launches=list(stop["validation"]),
            resumed_train_launches=list(res["train"]),
            resumed_validation_launches=list(res["validation"]),
            adam_step=float(next(iter(
                chkpt.state.optimizer["state"].values()))["step"]),
            sched_last_step=chkpt.state.lr_sched_inst[0]["last_step"],
            first_step_ms=resumed.history[0]["ms"],
            step_ms=[h["ms"] for h in resumed.history])

        # 4. serve the final checkpoint; request 0 against the in-process
        # forward of the same checkpoint on its pair, at the dispatched
        # batch's shape (request 0 tiled, as the batcher fills)
        served = resumed.checkpoints.get_latest().path
        cfg = tmp / "serve.yaml"
        cfg.write_text(
            "serve:\n"
            f"  model: {ROOT / 'cfg' / 'model' / 'raft-baseline.yaml'}\n"
            f"  checkpoint: {served}\n"
            f"  buckets: {LIFE_BUCKETS}\n"
            "  batch-size: 4\n"
            "  requests: 16\n"
            "  rate: 50\n")
        _zero_counts()
        report = port_main.main(["serve", "-c", str(cfg)])
        torch.cuda.synchronize()
        serve_launches = _counts()["convex_combine_8x"]

        spec = models.load(ROOT / "cfg" / "model" / "raft-baseline.yaml")
        spec.model.init(torch.Generator().manual_seed(0), "cuda")
        checkpoint.Checkpoint.load(served).apply(module=spec.model.module)
        bucket = tuple(int(x) for x in LIFE_BUCKETS.split(",")[0].split("x"))
        raw = loadgen.synthetic_pair(bucket, np.random.default_rng(0))
        pair = [torch.from_numpy(np.repeat(2 * x[None] - 1, 4, 0)).cuda()
                for x in raw]
        _, flow = evaluation.make_eval_fn(spec.model)(*pair)
        diff = float(np.abs(flow[0].cpu().numpy()
                            - report["results"][0].flow).max())

    expected = report["batches"] + len(report["warmup"])
    if report["completed"] != 16 or report["errors"] or report["rejected"]:
        problems.append(f"serve completed {report['completed']}/16, errors "
                        f"{report['errors']}, rejected {report['rejected']}")
    if report["nonfinite"]:
        problems.append(f"serve: {report['nonfinite']} non-finite flows")
    if serve_launches != expected:
        problems.append(f"serve launched the combine {serve_launches} times, "
                        f"expected {expected}")
    if not diff <= LIFE_SERVE_MAX_ABS_PX:
        problems.append(f"served request 0 is {diff} px from the in-process "
                        f"forward (bound {LIFE_SERVE_MAX_ABS_PX} px)")
    readings["serve"] = dict(
        checkpoint=served.name, completed=report["completed"],
        batches=report["batches"], launches=serve_launches,
        p50_ms=report["p50_ms"], p99_ms=report["p99_ms"],
        request0_max_abs_diff_px=diff, bound_px=LIFE_SERVE_MAX_ABS_PX)

    emit(phase="lifecycle", model="raft/baseline (bf16 policy, frozen BN)",
         train_shape=[TRAIN_BATCH, *TRAIN_SHAPE],
         validation_shape=[LIFE_VAL_BATCH, *LIFE_VAL_SHAPE], card=card,
         **readings)
    if problems:
        raise AssertionError("lifecycle phase: " + "; ".join(problems))
    # the combine kernels' launches of the three paths, each read around
    # its own work and summed over the runs
    return {
        "train": dict(zip(CONVEX_KERNELS, paths["train"])),
        "validation": dict(zip(CONVEX_KERNELS, paths["validation"])),
        "serve": {"convex_combine_8x": serve_launches},
    }


# -- augmented training: the shipped s1-things.yaml data graph ---------------


def _write_things_tree(root, pairs):
    """A FlyingThings3D-shaped tree: ``pairs`` + 1 frames of one sequence
    (TRAIN/A/0000, left camera, from frame 0006) at 540x960 in both passes
    (final: clean blurred), each frame a smooth random texture shifted by a
    constant (3, -2) px from the last; 3-channel PFM flows into the future
    and into the past for every frame (hard links of one file each)."""
    import cv2

    from raft_meets_dicl_tpu_torch.data import io

    h, w = AUG_FRAME_SHAPE
    dx, dy = 3, -2
    frames = range(6, 6 + pairs + 1)
    seq = Path("TRAIN") / "A" / "0000"
    for direction, sign in (("Future", 1), ("Past", -1)):
        d = root / "optical_flow" / seq / f"into_{direction.lower()}" / "left"
        d.mkdir(parents=True)
        flow = np.zeros((h, w, 3), np.float32)
        flow[..., :2] = (sign * dx, sign * dy)
        first = d / f"OpticalFlowInto{direction}_{frames[0]:04d}_L.pfm"
        io.write_pfm(first, flow)
        for i in frames[1:]:
            os.link(first, d / f"OpticalFlowInto{direction}_{i:04d}_L.pfm")

    rng = np.random.default_rng(4)
    base = cv2.resize(rng.integers(0, 256, (h // 4, w // 4, 3), np.uint8),
                      (w, h), interpolation=cv2.INTER_CUBIC)
    for pass_ in ("clean", "final"):
        d = root / f"frames_{pass_}pass" / seq / "left"
        d.mkdir(parents=True)
        for k, i in enumerate(frames):
            frame = np.roll(base, (k * dy, k * dx), axis=(0, 1))
            if pass_ == "final":
                frame = cv2.GaussianBlur(frame, (5, 5), 1.5)
            cv2.imwrite(str(d / f"{i:04d}.png"), frame)


def _s1_things(tmp):
    """The shipped s1-things.yaml, its two FlyingThings sources and the
    shipped FlyingThings spec, copied under ``tmp/cfg`` with the spec's
    ``path`` at ``tmp/things``, 2 epochs and the validation entries on the
    tree at ``tmp/val``. Returns the strategy's path."""
    from raft_meets_dicl_tpu_torch.utils import config

    cfg = tmp / "cfg"
    spec = config.load(ROOT / "cfg" / "data" / "dataset"
                       / "ufreiburg-flyingthings3d.yaml")
    config.store(cfg / "data" / "dataset" / "ufreiburg-flyingthings3d.yaml",
                 spec | {"path": str(tmp / "things")})
    for pass_ in ("clean", "final"):
        name = f"ufreiburg-flyingthings3d-{pass_}.train.yaml"
        config.store(cfg / "data" / name,
                     config.load(ROOT / "cfg" / "data" / name))

    strategy = config.load(S1_THINGS)
    stage, = strategy["stages"]
    stage["data"]["epochs"] = AUG_EPOCHS
    for entry in stage["validation"]:
        entry["source"] = {"type": "dataset",
                           "spec": str(tmp / "val" / "dataset.yaml")}
    path = cfg / "strategy" / "baseline" / "raft" / S1_THINGS.name
    config.store(path, strategy)
    return path


@contextlib.contextmanager
def _recorded_batches():
    """The batches each train step receives, with their epoch (the
    tensors themselves, read after the run)."""
    from raft_meets_dicl_tpu_torch.strategy import training

    batches = []
    original = training.TrainingContext.run_instance

    def run_instance(self, stage, epoch, i, batch):
        batches.append((epoch, batch))
        return original(self, stage, epoch, i, batch)

    training.TrainingContext.run_instance = run_instance
    try:
        yield batches
    finally:
        training.TrainingContext.run_instance = original


def _pair_digest(img1, img2, flow, valid):
    """One pair's four arrays, bit for bit, as one digest."""
    import hashlib

    h = hashlib.blake2b()
    for x in (img1, img2, flow, valid):
        x = np.ascontiguousarray(x)
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())
    return h.hexdigest()


def _epoch_problems(tctx, batches):
    """Each pair the steps received in epoch e against the stage's own
    input pipeline run in this process after ``set_epoch(e)``: every pair
    must equal one index's, bit for bit, every index once an epoch, and no
    pair of epoch 1 may equal one of epoch 0. Returns the problems and the
    indices in the order the steps received them."""
    source = tctx.data.source   # the stage's adapter over its data graph
    expected = {}
    for epoch in (0, 1):
        tctx.current_stage.data.source.set_epoch(epoch)
        expected[epoch] = {
            _pair_digest(*(x[0] for x in source[i][:4])): i
            for i in range(len(source))}
    problems, order, repeated = [], {0: [], 1: []}, 0
    for epoch, (img1, img2, flow, valid, _) in batches:
        for r in range(img1.shape[0]):
            digest = _pair_digest(img1[r].numpy(), img2[r].numpy(),
                                  flow[r].numpy(), valid[r].numpy())
            order[epoch].append(expected[epoch].get(digest))
            repeated += digest in expected[1 - epoch]
    if repeated:
        problems.append(f"{repeated} pairs of one epoch equal pairs of the "
                        "other")
    for epoch, indices in order.items():
        if sorted(i for i in indices if i is not None) != \
                list(range(len(source))) or None in indices:
            problems.append(
                f"epoch {epoch}'s pairs are not the in-process pipeline's "
                f"at set_epoch({epoch}) (matched indices {indices})")
    return problems, order


def _augmentation_ms(augment):
    """Host ms of one sample's decode and of each augmentation, in this
    process, on AUG_PROBE_SAMPLES samples (medians; the draws are the
    samples' own)."""
    decode, ms = [], {}
    for k in range(AUG_PROBE_SAMPLES):
        t0 = time.perf_counter()
        sample = augment.source[k]
        decode.append(1e3 * (time.perf_counter() - t0))
        rng = augment._rng_for(sample[4][0])
        for aug in augment.augmentations:
            t0 = time.perf_counter()
            sample = aug(*sample, rng=rng)
            ms.setdefault(aug.type, []).append(
                1e3 * (time.perf_counter() - t0))
    per_aug = {k: statistics.median(v) for k, v in ms.items()}
    return {"decode_ms": statistics.median(decode), "augment_ms": per_aug,
            "augment_total_ms": sum(per_aug.values())}


def phase_augmented_train(card):
    """The shipped s1-things.yaml data graph through ``main train`` on the
    card (shipped bf16-policy raft/baseline, frozen BN): augment over
    concat of the FlyingThings clean and final passes (multi layout, PFM
    flows) on a 540x960 tree, its six augmentations, crop 720x400, batch 6,
    AdamW, one-cycle and clip as shipped; 2 epochs of 4 steps, validated
    each epoch on a 436x1024 tree. Run at the loader's default 4 workers
    and again at 16 through ``-e cfg/env/w16.yaml``.
    The combine kernels launch once forward and once backward a step and
    once a validation batch; the pairs the steps receive in epochs 0 and 1
    (default run) are the stage's pipeline's at ``set_epoch(0)`` and
    ``set_epoch(1)`` in this process, bit for bit."""
    import cv2

    from raft_meets_dicl_tpu_torch.utils import config

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    model_cfg = ROOT / "cfg" / "model" / "raft-baseline.yaml"
    stage, = config.load(S1_THINGS)["stages"]
    batch = stage["data"]["batch-size"]
    width, height = next(a["size"] for a in stage["data"]["source"][
        "augmentations"] if a["type"] == "crop")
    steps = AUG_EPOCHS * 2 * AUG_PAIRS // batch
    val_batches = AUG_EPOCHS * len(stage["validation"]) * -(
        -AUG_VAL_PAIRS // stage["validation"][0]["batch-size"])
    problems, readings = [], {}
    paths = {"train": [0, 0], "validation": [0, 0]}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _write_things_tree(tmp / "things", AUG_PAIRS)
        _write_training_tree(tmp / "val", LIFE_VAL_SHAPE, AUG_VAL_PAIRS, "")
        write_s = time.perf_counter() - t0

        strategy = _s1_things(tmp)
        for name, extra in (("default_workers", ()),
                            ("wide_workers",
                             ("-e", str(ENV_DIR / "w16.yaml")))):
            with _recorded_batches() as batches, _life_probes() as probes:
                tctx, wall_s, peak, counts = _run_train(
                    strategy, model_cfg, tmp / name, steps, *extra)
            run, p = _run_readings(tctx, batch, steps, wall_s)
            problems += [f"{name}: {x}" for x in p]

            launches = tuple(counts[k] for k in CONVEX_KERNELS)
            passes = probes["validations"]
            val = tuple(sum(v["launches"][i] for v in passes)
                        for i in (0, 1))
            train = tuple(a - b for a, b in zip(launches, val))
            n_val = sum(v["batches"] for v in passes)
            if train != (steps, steps):
                problems.append(f"{name}: the train path launched the "
                                f"combine kernels {train} times, expected "
                                f"({steps}, {steps})")
            if val != (n_val, 0) or n_val != val_batches:
                problems.append(f"{name}: validation launched the combine "
                                f"kernels {val} times over {n_val} "
                                f"batches, expected ({val_batches}, 0)")
            for path, split in (("train", train), ("validation", val)):
                paths[path] = [a + b for a, b in zip(paths[path], split)]
            shapes = {tuple(b[0].shape) for _, b in batches}
            if shapes != {(batch, height, width, 3)}:
                problems.append(f"{name}: batches of shapes {shapes}")

            extra = {}
            if name == "default_workers":
                # the epoch reaches the forked workers
                p, order = _epoch_problems(tctx, batches)
                problems += [f"{name}: {x}" for x in p]
                extra = dict(epoch_indices=order, host=_augmentation_ms(
                    tctx.current_stage.data.source))
            readings[name] = dict(
                **run, max_memory_allocated=peak,
                train_launches=list(train), validation_launches=list(val),
                validation=_life_validation_readings(probes),
                loader_workers=tctx.data.num_workers,
                loader_batch_ms=_loader_batch_ms(tctx),
                wall_s=round(wall_s, 3), **extra)
            del batches[:]

    # the loader's sustained pace: its workers each decode and augment
    # whole batches, so one arrives every batch * (one sample's host ms) /
    # workers; it sets the pace where that exceeds phase 8's step (a run
    # of 4 batches an epoch decodes them all at once at the epoch's start,
    # so its steps do not show it)
    phase8 = SHARED.get("train_median_step_ms")
    host = readings["default_workers"]["host"]
    sample_ms = host["decode_ms"] + host["augment_total_ms"]
    for r in readings.values():
        r["sustained_batch_ms"] = batch * sample_ms / r["loader_workers"]
        r["loader_sets_pace"] = (None if phase8 is None
                                 else r["sustained_batch_ms"] > phase8)
    emit(phase="augmented-train",
         model="raft/baseline (bf16 policy, frozen BN)",
         strategy=S1_THINGS.name,
         shape=[batch, height, width], frames=list(AUG_FRAME_SHAPE),
         pairs_per_epoch=2 * AUG_PAIRS, cpu_count=os.cpu_count(),
         torch_threads=torch.get_num_threads(),
         cv2_threads=cv2.getNumThreads(),
         train_median_step_ms=phase8, dataset_write_s=round(write_s, 3),
         card=card, **readings)
    if problems:
        raise AssertionError("augmented train phase: " + "; ".join(problems))
    return {"train": dict(zip(CONVEX_KERNELS, paths["train"])),
            "validation": dict(zip(CONVEX_KERNELS, paths["validation"]))}


def _write_sintel_tree(root):
    """An MPI-Sintel-shaped tree: EVAL_SINTEL_SCENES scenes of
    EVAL_SINTEL_FRAMES frames (frame_0001...) at 436x1024 in the clean
    pass, each frame a smooth random texture shifted by (3, -2) px from
    the last; .flo flows of that shift for every frame but the last."""
    import cv2

    from raft_meets_dicl_tpu_torch.data import io

    h, w = EVAL_SINTEL_SHAPE
    dx, dy = 3, -2
    flow = np.broadcast_to(np.array([dx, dy], np.float32), (h, w, 2))
    rng = np.random.default_rng(5)
    for s in range(EVAL_SINTEL_SCENES):
        scene = f"scene_{s}"
        frames = root / "training" / "clean" / scene
        flows = root / "training" / "flow" / scene
        frames.mkdir(parents=True)
        flows.mkdir(parents=True)
        base = cv2.resize(rng.integers(0, 256, (h // 4, w // 4, 3), np.uint8),
                          (w, h), interpolation=cv2.INTER_CUBIC)
        for k in range(EVAL_SINTEL_FRAMES):
            i = k + 1
            cv2.imwrite(str(frames / f"frame_{i:04d}.png"),
                        np.roll(base, (k * dy, k * dx), axis=(0, 1)))
            if k < EVAL_SINTEL_FRAMES - 1:
                io.write_flow_mb(flows / f"frame_{i:04d}.flo", flow)


def _write_kitti_tree(root):
    """A KITTI-2015-shaped tree: one pair a sequence (``{seq}_10.png``,
    ``{seq}_11.png`` in ``training/image_2``), two sequences at each of
    EVAL_KITTI_SIZES, the second frame the first shifted by (3, -2) px;
    16-bit ``flow_occ`` PNGs of that shift with EVAL_KITTI_INVALID of the
    pixels invalid, written by the port's ``write_flow_kitti``."""
    import cv2

    from raft_meets_dicl_tpu_torch.data import io

    dx, dy = 3, -2
    images = root / "training" / "image_2"
    flows = root / "training" / "flow_occ"
    images.mkdir(parents=True)
    flows.mkdir(parents=True)
    rng = np.random.default_rng(6)
    seq = 0
    for h, w in EVAL_KITTI_SIZES:
        for _ in range(2):
            base = cv2.resize(
                rng.integers(0, 256, (h // 4, w // 4, 3), np.uint8), (w, h),
                interpolation=cv2.INTER_CUBIC)
            cv2.imwrite(str(images / f"{seq:06d}_10.png"), base)
            cv2.imwrite(str(images / f"{seq:06d}_11.png"),
                        np.roll(base, (dy, dx), axis=(0, 1)))
            flow = np.broadcast_to(np.array([dx, dy], np.float32), (h, w, 2))
            valid = rng.random((h, w)) >= EVAL_KITTI_INVALID
            io.write_flow_kitti(flows / f"{seq:06d}_10.png", flow, valid)
            seq += 1


def _eval_sources(tmp):
    """The shipped Sintel (clean, training) and KITTI 2015 (training) data
    sources and dataset specs, copied under ``tmp/cfg`` with each spec's
    ``path`` at its tree; a one-sample subset of the Sintel source. Returns
    the three sources' paths."""
    from raft_meets_dicl_tpu_torch.utils import config

    cfg = tmp / "cfg" / "data"
    paths = {}
    for name, source, spec, tree in (
            ("sintel", "mpi-sintel-clean.train-full.yaml", "mpi-sintel.yaml",
             tmp / "sintel"),
            ("kitti", "kitti-2015.train.yaml", "kitti-2015.yaml",
             tmp / "kitti")):
        config.store(cfg / "dataset" / spec,
                     config.load(ROOT / "cfg" / "data" / "dataset" / spec)
                     | {"path": str(tree)})
        config.store(cfg / source, config.load(ROOT / "cfg" / "data" / source))
        paths[name] = cfg / source
    paths["sample"] = cfg / "sintel-one-sample.yaml"
    config.store(paths["sample"], {
        "type": "subset", "size": 1, "seed": 0,
        "source": "mpi-sintel-clean.train-full.yaml"})
    return paths


@contextlib.contextmanager
def _eval_probes():
    """Record, around the port's own functions, each ``main evaluate``
    run's forwards (CUDA events around each call of the step, on the
    stream it runs on; a dispatched batch's or, from the command, a
    reversed pair's), the yielded samples' final flows
    (finite or not, read after the run), the host ms of the per-sample
    loss and metrics (their enqueue and the batch's fetch) and of each
    flow-image write."""
    from raft_meets_dicl_tpu_torch import evaluation, metrics
    from raft_meets_dicl_tpu_torch.cmd import eval as eval_cmd
    from raft_meets_dicl_tpu_torch.models import model as model_mod

    probes = {}
    originals = (evaluation.make_eval_fn, evaluation.evaluate,
                 metrics.fetch, metrics.Metrics.__call__,
                 model_mod.Loss.__call__, eval_cmd.save_flow_image)
    (make_eval_fn, evaluate, fetch, metrics_call, loss_call,
     save_flow_image) = originals

    def reset():
        probes.update(forwards=[], finite=[], metrics_ms=0.0,
                      image_ms=[], samples=0, in_sweep=False)

    def timed_eval_fn(*args, **kwargs):
        step = make_eval_fn(*args, **kwargs)

        def run(img1, img2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(img1, img2)
            end.record()
            # the sweep's batches, or the command's reversed pairs
            probes["forwards"].append((probes["in_sweep"], start, end))
            return out
        return run

    def observed(*args, **kwargs):
        samples = evaluate(*args, **kwargs)
        while True:
            probes["in_sweep"] = True
            try:
                sample = next(samples)
            except StopIteration:
                return
            finally:
                probes["in_sweep"] = False
            probes["finite"].append(torch.isfinite(sample.final).all())
            probes["samples"] += 1
            yield sample

    def timed(fn, key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            ms = 1e3 * (time.perf_counter() - t0)
            if key == "image_ms":
                probes[key].append(ms)
            else:
                probes[key] += ms
            return out
        return run

    (evaluation.make_eval_fn, evaluation.evaluate, metrics.fetch,
     metrics.Metrics.__call__, model_mod.Loss.__call__,
     eval_cmd.save_flow_image) = (
        timed_eval_fn, observed, timed(fetch, "metrics_ms"),
        timed(metrics_call, "metrics_ms"), timed(loss_call, "metrics_ms"),
        timed(save_flow_image, "image_ms"))
    probes["reset"] = reset
    reset()
    try:
        yield probes
    finally:
        (evaluation.make_eval_fn, evaluation.evaluate, metrics.fetch,
         metrics.Metrics.__call__, model_mod.Loss.__call__,
         eval_cmd.save_flow_image) = originals


def _eval_recompute(spec, source, buckets, batch, wire=None):
    """Each sample's id, EPE and loss, recomputed in this process with the
    model of ``spec`` (on the card): the source's batches from the input
    pipeline (the same padding, shape buckets, grouping and wire format as
    ``main evaluate``), the forward of ``make_eval_fn``, the EPE of
    ``metrics/functional.py`` and the loss of the model config, on each
    sample's own slice."""
    from raft_meets_dicl_tpu_torch import data, evaluation
    from raft_meets_dicl_tpu_torch.metrics import functional
    from raft_meets_dicl_tpu_torch.models.input import ShapeBuckets

    model = spec.model
    adapter = model.get_adapter()
    step = evaluation.make_eval_fn(model, wire=wire)
    buckets = ShapeBuckets.from_config(buckets)
    loader = spec.input.apply(data.load(source), buckets=buckets,
                              normalize=wire is None).torch(
        wire=wire).loader(batch_size=batch, num_workers=0,
                          group_by_shape=buckets is not None)
    out = {}
    with torch.inference_mode():
        for img1, img2, flow, valid, meta in loader:
            n = img1.shape[0]
            pad = batch - n if buckets is not None else 0
            i1, i2 = img1.cuda(), img2.cuda()
            if pad:
                i1 = torch.cat([i1, i1[-1:].expand(pad, *i1.shape[1:])])
                i2 = torch.cat([i2, i2[-1:].expand(pad, *i2.shape[1:])])
            raw, final = step(i1, i2)
            result = adapter.wrap_result(raw, tuple(img1.shape[1:3]))
            flow, valid = flow.cuda(), valid.cuda()
            for b in range(n):
                epe = functional.end_point_error(
                    final[b:b + 1], flow[b:b + 1], valid[b:b + 1])["mean"]
                loss = spec.loss(model, result.output(b), flow[b:b + 1],
                                 valid[b:b + 1])
                out[str(meta[b].sample_id)] = (epe.item(), loss.item())
    return out


def phase_evaluate(card):
    """``main evaluate`` of raft/baseline (shipped bf16-policy config, 12
    iterations) from a checkpoint of its seeded initial weights, over the
    shipped Sintel and KITTI 2015 data specs pointed at synthetic trees:
    Sintel-shaped (436x1024, 2 scenes of 6 frames: 10 pairs, .flo flows)
    at batch 4 with a report and visual:flow images, then with --fwbw and
    visual:occlusion; KITTI-shaped (8 pairs at four sizes, 16-bit
    flow_occ PNGs with invalid pixels) at batch 4 with --buckets 376x1248,
    then --buckets group. Each report and its JSONL hold every sample
    once, in the loader's order, with its EPE and loss equal to this
    process's recomputation; the pad waste is the trees' extents'; every
    flow and metric is finite; the combine kernel launches once a
    dispatched batch (and once a reversed pair), never backward. Then
    each of the 12 flow formats from a one-sample run."""
    import cv2

    from raft_meets_dicl_tpu_torch import data, models
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.cmd.eval import FLOW_FORMATS
    from raft_meets_dicl_tpu_torch.data import io
    from raft_meets_dicl_tpu_torch.strategy import checkpoint
    from raft_meets_dicl_tpu_torch.utils import config

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    model_cfg = ROOT / "cfg" / "model" / "raft-baseline.yaml"

    # batches and pad waste from the trees' extents: the model pads to
    # multiples of 8 (Sintel 436x1024 to 440x1024; KITTI to 376x1248,
    # 376x1224, 376x1248 and 376x1240); without buckets the last batch
    # runs short, with them every batch is filled to EVAL_BATCH
    def pad8(n):
        return -(-n // 8) * 8

    def batches(n):
        return -(-n // EVAL_BATCH)

    sintel_h, sintel_w = EVAL_SINTEL_SHAPE
    sintel_pairs = EVAL_SINTEL_SCENES * (EVAL_SINTEL_FRAMES - 1)
    sintel_waste = 1 - sintel_h * sintel_w / (pad8(sintel_h) * pad8(sintel_w))
    kitti_real = 2 * sum(h * w for h, w in EVAL_KITTI_SIZES)
    bucket_h, bucket_w = (int(x) for x in EVAL_KITTI_BUCKET.split("x"))
    kitti_pairs = 2 * len(EVAL_KITTI_SIZES)
    groups = {}
    for h, w in EVAL_KITTI_SIZES:
        groups[pad8(h), pad8(w)] = groups.get((pad8(h), pad8(w)), 0) + 2
    group_batches = sum(batches(n) for n in groups.values())
    group_total = sum(batches(n) * EVAL_BATCH * h * w
                      for (h, w), n in groups.items())
    runs = (
        # name, source, extra arguments, batches, launches, pad waste
        ("sintel", "sintel", ["-f", "flows", "--flow-format",
                              "visual:flow"],
         batches(sintel_pairs), batches(sintel_pairs), sintel_waste),
        ("sintel_fwbw", "sintel", ["--fwbw", "-f", "flows", "--flow-format",
                                   "visual:occlusion"],
         batches(sintel_pairs), batches(sintel_pairs) + sintel_pairs,
         sintel_waste),
        ("kitti_buckets", "kitti", ["--buckets", EVAL_KITTI_BUCKET],
         batches(kitti_pairs), batches(kitti_pairs),
         1 - kitti_real / (batches(kitti_pairs) * EVAL_BATCH * bucket_h
                           * bucket_w)),
        ("kitti_group", "kitti", ["--buckets", "group"],
         group_batches, group_batches, 1 - kitti_real / group_total),
    )
    problems, readings = [], {}
    launches = {"evaluate": 0, "evaluate_formats": 0}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        _write_sintel_tree(tmp / "sintel")
        _write_kitti_tree(tmp / "kitti")
        sources = _eval_sources(tmp)
        spec = models.load(config.load(model_cfg))
        spec.model.init(torch.Generator().manual_seed(0), "cpu")
        weights = {k: v.clone() for k, v in
                   spec.model.module.state_dict().items()}
        ckpt = tmp / "raft-baseline-init.ckpt"
        checkpoint.Checkpoint(
            model=spec.id, iteration=checkpoint.Iteration(0, None, 0),
            metrics=None,
            state=checkpoint.State(weights, {}, {}, [], []),
            metadata={"source": "seeded init"}).save(ckpt)
        # the checkpoint's weights on the card, for the recomputation
        reference = models.load(config.load(model_cfg))
        reference.model.init(torch.Generator().manual_seed(0), "cuda")
        reference.model.module.load_state_dict(weights)
        setup_s = time.perf_counter() - t0

        def evaluate(source, *extra):
            torch.cuda.reset_peak_memory_stats()
            probes["reset"]()
            _zero_counts()
            t0 = time.perf_counter()
            report = port_main.main([
                "evaluate", "-d", str(source), "-m", str(model_cfg),
                "-c", str(ckpt), "-b", str(EVAL_BATCH), *extra])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            samples_per_sec = report["stats"].samples_per_sec()
            counts = _counts()
            forwards = [(sweep, a.elapsed_time(b))
                        for sweep, a, b in probes["forwards"]]
            finite = bool(torch.stack(probes["finite"]).all()) \
                if probes["finite"] else None
            return report, counts, dict(
                wall_s=wall_s, samples_per_sec=samples_per_sec,
                forwards=forwards, finite=finite,
                samples_seen=probes["samples"],
                metrics_ms=probes["metrics_ms"],
                image_ms=list(probes["image_ms"]),
                max_memory_allocated=torch.cuda.max_memory_allocated())

        with _eval_probes() as probes:
            for name, src, extra, batches, expected, waste in runs:
                out = tmp / name
                extra = [x if x != "flows" else str(out / "flows")
                         for x in extra]
                report, counts, r = evaluate(
                    sources[src], "-o", str(out / "report.json"), *extra)
                stats = report["stats"]
                fwd = counts["convex_combine_8x"]
                launches["evaluate"] += fwd
                if (fwd, counts["convex_combine_8x_bwd"]) != (expected, 0):
                    problems.append(
                        f"{name}: combine launches {fwd} forward, "
                        f"{counts['convex_combine_8x_bwd']} backward, "
                        f"expected {expected}, 0")
                if any(v for k, v in counts.items()
                       if not k.startswith("convex")):
                    problems.append(f"{name}: other kernels {counts}")
                if stats.batches != batches:
                    problems.append(f"{name}: {stats.batches} batches, "
                                    f"expected {batches}")
                if not math.isclose(stats.pad_waste_ratio(), waste,
                                    abs_tol=1e-12):
                    problems.append(
                        f"{name}: pad waste {stats.pad_waste_ratio()}, "
                        f"the extents give {waste}")
                if r["finite"] is not True:
                    problems.append(f"{name}: a final flow is not finite")

                # ids once each in loader order, EPE and loss as
                # recomputed here; the JSONL equal to the report
                bucket_arg = (extra[extra.index("--buckets") + 1]
                              if "--buckets" in extra else None)
                expected_metrics = _eval_recompute(
                    reference, sources[src], bucket_arg, EVAL_BATCH)
                stored = config.load(out / "report.json")
                jsonl = [json.loads(x) for x in
                         (out / "report.samples.jsonl").read_text()
                         .splitlines()]
                ids = [s["id"] for s in stored["samples"]]
                if ids != list(expected_metrics):
                    problems.append(f"{name}: report ids {ids}, loader "
                                    f"order {list(expected_metrics)}")
                if jsonl != stored["samples"]:
                    problems.append(f"{name}: the JSONL differs from the "
                                    "report")
                epe_diff, loss_rel = [], []
                for s in stored["samples"]:
                    m = s["metrics"]
                    if not all(math.isfinite(v) for v in m.values()):
                        problems.append(f"{name}: {s['id']} metrics {m}")
                    epe, loss = expected_metrics.get(s["id"], (math.nan,) * 2)
                    epe_diff.append(abs(m["EndPointError/mean"] - epe))
                    loss_rel.append(abs(m["Loss"] - loss) / abs(loss))
                    if not (epe_diff[-1] <= EVAL_EPE_ATOL
                            + EVAL_EPE_REL * abs(epe)
                            and loss_rel[-1] <= EVAL_LOSS_REL):
                        problems.append(
                            f"{name}: {s['id']} EPE {m['EndPointError/mean']}"
                            f" loss {m['Loss']}, recomputed {epe}, {loss}")
                if "--fwbw" in extra and not all(
                        "fwbw" in s for s in stored["samples"]):
                    problems.append(f"{name}: samples without fwbw products")
                images = sorted((out / "flows").rglob("*.png")) \
                    if "-f" in extra else []
                if "-f" in extra and len(images) != stats.samples:
                    problems.append(f"{name}: {len(images)} flow images for "
                                    f"{stats.samples} samples")

                batch_fwd = [ms for sweep, ms in r["forwards"] if sweep]
                readings[name] = dict(
                    samples=stats.samples, batches=stats.batches,
                    buckets=stats.buckets,
                    samples_per_sec=r["samples_per_sec"],
                    wall_s=round(r["wall_s"], 3),
                    dispatch_ms_per_batch=1e3 * stats.phases["dispatch"]
                    / stats.batches,
                    drain_ms_per_batch=1e3 * stats.phases["drain"]
                    / stats.batches,
                    forward_device_ms=batch_fwd,
                    reversed_forward_device_ms=[
                        ms for sweep, ms in r["forwards"] if not sweep],
                    metrics_host_ms_per_sample=r["metrics_ms"]
                    / stats.samples,
                    image_write_ms_per_sample=(
                        statistics.mean(r["image_ms"]) if r["image_ms"]
                        else None),
                    pad_waste_ratio=stats.pad_waste_ratio(),
                    pad_waste_expected=waste,
                    max_epe_diff=max(epe_diff),
                    max_loss_rel_diff=max(loss_rel),
                    summary=stored["summary"]["mean"],
                    launches=fwd,
                    max_memory_allocated=r["max_memory_allocated"])

            # every flow format once, from a one-sample run
            formats = {}
            for fmt in FLOW_FORMATS:
                out = tmp / "formats" / fmt.replace(":", "_")
                extra = ["-f", str(out)] + (["--fwbw"] if fmt in (
                    "visual:occlusion", "visual:confidence") else [])
                if fmt not in ("visual:epe", "visual:bp-fl",
                               "visual:flow:gt"):
                    extra.append("--flow-only")
                _, counts, r = evaluate(sources["sample"], "--flow-format",
                                        fmt, *extra)
                fwd = counts["convex_combine_8x"]
                launches["evaluate_formats"] += fwd
                files = sorted(p for p in out.rglob("*") if p.is_file())
                decoded = []
                for p in files:
                    if p.suffix == ".flo":
                        x = io.read_flow_mb(p)
                    elif fmt == "flow:kitti":
                        x, _ = io.read_flow_kitti(p)
                    else:
                        x = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
                    decoded.append(None if x is None else x.shape[:2])
                # the intermediates are written uncropped, as in JAX
                want, shape = 1, EVAL_SINTEL_SHAPE
                if fmt == "visual:intermediate:flow":
                    want = reference.model.arguments["iterations"]
                    shape = (pad8(sintel_h), pad8(sintel_w))
                if len(files) != want or set(decoded) != {shape}:
                    problems.append(f"format {fmt}: files {len(files)}, "
                                    f"decoded shapes {set(decoded)}")
                if fwd != 1 + ("--fwbw" in extra):
                    problems.append(f"format {fmt}: {fwd} combine launches")
                formats[fmt] = dict(files=len(files),
                                    bytes=sum(p.stat().st_size
                                              for p in files),
                                    image_write_ms=r["image_ms"],
                                    launches=fwd)

    if "sintel" in readings:
        # phase 24 prints it beside its u8 sweep
        SHARED["evaluate_sintel_dispatch_ms_per_batch"] = \
            readings["sintel"]["dispatch_ms_per_batch"]
    emit(phase="evaluate", model="raft/baseline (bf16 policy, 12 "
         "iterations, seeded init)", batch=EVAL_BATCH,
         sintel_tree=[EVAL_SINTEL_SCENES, EVAL_SINTEL_FRAMES,
                      *EVAL_SINTEL_SHAPE],
         kitti_sizes=EVAL_KITTI_SIZES, setup_s=round(setup_s, 3),
         card=card, formats=formats, **readings)
    if problems:
        raise AssertionError("evaluate phase: " + "; ".join(problems))
    return {path: {"convex_combine_8x": n} for path, n in launches.items()}


# -- phase 24: environments and wire formats ------------------------------------

SERVE_EXAMPLE = ROOT / "cfg" / "serve" / "example.yaml"
SEEDS = ROOT / "cfg" / "seeds" / "fixed.yaml"
ENV_DIR = ROOT / "cfg" / "env"
# the wire train runs: one epoch of WIRE_STEPS batches at TRAIN_BATCH x
# TRAIN_SHAPE, frame 0 of the tree a truncated PNG (pair 0 healed once a
# run)
WIRE_STEPS = 6
# the first step's loss of a wire run against the f32 wire run's, from the
# same seeds: JAX's own tolerances (tests/test_wire.py)
WIRE_LOSS_REL = {"bf16": 2e-2, "u8": 5e-2}
# bytes per pixel that cross a train step's host->device copy: two RGB
# images, 2-channel flow and the valid mask
WIRE_BYTES_PER_PX = {"f32": 33.0, "bf16": 16.125, "u8": 10.125}
# served request 0 (u8 wire, decoded on the card) against the in-process
# forward of its host-decoded images on the f32 path, at the dispatched
# batch's shape: the same kernels, and the two decodes do the same float32
# operations, so the bound is phase 21's, which the run should read far
# below
WIRE_SERVE_MAX_ABS_PX = LIFE_SERVE_MAX_ABS_PX
# the deterministic reruns: steps of the s1-things run, from its config
DET_STEPS = 2
HEAL_LOG = "substituting a neighbor"


def _serve_example(*extra):
    """``main serve -c cfg/serve/example.yaml`` as shipped; returns the
    report, the combine kernel's launches and the host→device bytes of
    each dispatched batch by bucket, read from the arrays the session
    copies (``ServeSession.run``'s inputs)."""
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.serve.session import ServeSession

    original, copied = ServeSession.run, {}

    def run(self, img1, img2):
        h, w = img1.shape[1:3]
        copied.setdefault(f"{h}x{w}", set()).add(img1.nbytes + img2.nbytes)
        return original(self, img1, img2)

    ServeSession.run = run
    try:
        _zero_counts()
        report = port_main.main(["serve", "-c", str(SERVE_EXAMPLE), *extra])
        torch.cuda.synchronize()
    finally:
        ServeSession.run = original
    return report, _counts(), copied


def _serve_problems(name, report, counts, requests):
    problems = []
    if report["completed"] != requests or report["requests"] != requests:
        problems.append(f"{name}: completed {report['completed']}/"
                        f"{report['requests']}")
    if report["errors"] or report["rejected"]:
        problems.append(f"{name}: errors {report['errors']}, rejected "
                        f"{report['rejected']}")
    if report["nonfinite"]:
        problems.append(f"{name}: {report['nonfinite']} non-finite flows")
    expected = _expect(convex_combine_8x=report["batches"]
                       + len(report["warmup"]))
    if counts != expected:
        problems.append(f"{name}: launches {counts}, expected {expected}")
    return problems


def _wire_serve(card):
    """The shipped serve config as it ships (u8 wire), then the same with
    ``--wire-format f32``; request 0 of the u8 run against the in-process
    forward of its host-decoded images on the f32 path."""
    from raft_meets_dicl_tpu_torch import evaluation, models
    from raft_meets_dicl_tpu_torch.models.input import ShapeBuckets
    from raft_meets_dicl_tpu_torch.models.wire import WireFormat
    from raft_meets_dicl_tpu_torch.serve import loadgen
    from raft_meets_dicl_tpu_torch.utils import config

    shipped = config.load(SERVE_EXAMPLE)["serve"]
    # in the session's order: the load generator's first shape is the
    # first of these
    buckets = ShapeBuckets.from_config(shipped["buckets"]).sizes
    batch, requests = shipped["batch-size"], shipped["requests"]
    problems, readings, paths = [], {}, {}
    for wire, extra in (("u8", ()), ("f32", ("--wire-format", "f32"))):
        report, counts, copied = _serve_example(*extra)
        name = f"serve_{wire}"
        problems += _serve_problems(name, report, counts, requests)
        itemsize = {"u8": 1, "f32": 4}[wire]
        expected = {f"{h}x{w}": {2 * batch * h * w * 3 * itemsize}
                    for h, w in buckets}
        if not copied or any(v != expected.get(k) for k, v in copied.items()):
            problems.append(f"{name}: host→device bytes a batch {copied}, "
                            f"expected {expected}")
        readings[name] = dict(
            wire=report["wire"], batches=report["batches"],
            batches_by_bucket=report["batches_by_bucket"],
            launches=counts["convex_combine_8x"],
            h2d_bytes_per_batch={k: sorted(v) for k, v in copied.items()},
            dispatch_ms=report["spans_ms"].get("dispatch"),
            p50_ms=report["p50_ms"], p99_ms=report["p99_ms"],
            pairs_per_sec=report["pairs_per_sec"], warmup=report["warmup"])
        paths[f"wire_{name}"] = {"convex_combine_8x":
                                 counts["convex_combine_8x"]}
        if wire == "u8":
            served = report["results"][0].flow

    spec = models.load(config.load(SERVE_EXAMPLE.parent / shipped["model"]))
    spec.model.init(torch.Generator().manual_seed(0), "cuda")
    wire = WireFormat.from_config("u8", clip=spec.input.clip,
                                  range=spec.input.range)
    raw = loadgen.synthetic_pair(buckets[0], np.random.default_rng(0))
    pair = [torch.from_numpy(np.repeat(wire.decode_images_host(
        wire.encode_image(x))[None], batch, 0)).cuda() for x in raw]
    _, flow = evaluation.make_eval_fn(spec.model)(*pair)
    diff = float(np.abs(flow[0].cpu().numpy() - served).max())
    if not diff <= WIRE_SERVE_MAX_ABS_PX:
        problems.append(f"served request 0 (u8) is {diff} px from the "
                        "in-process f32-path forward of its host-decoded "
                        f"images (bound {WIRE_SERVE_MAX_ABS_PX} px)")
    readings["request0_max_abs_diff_px"] = diff
    readings["request0_bound_px"] = WIRE_SERVE_MAX_ABS_PX
    return readings, problems, paths


def _heal_lines(tctx):
    return sum(HEAL_LOG in line for line in
               (tctx.path / "main.log").read_text().splitlines())


def _wire_train(tmp):
    """``main train`` at TRAIN_BATCH x TRAIN_SHAPE from fixed seeds on a
    tree whose frame 0 is a truncated PNG: the f32 wire, the bf16 wire of
    ``-e cfg/env/wire-bf16.yaml`` and ``--wire-format u8``."""
    data = tmp / "wire-data"
    _write_training_tree(
        data, TRAIN_SHAPE, WIRE_STEPS * TRAIN_BATCH,
        _strategy("s1-things", TRAIN_BATCH, "true", 0.000125, gamma=0.8))
    frame = data / "frames" / "frame_0000.png"
    frame.write_bytes(frame.read_bytes()[:1000])
    model_cfg = ROOT / "cfg" / "model" / "raft-baseline.yaml"
    pixels = TRAIN_BATCH * TRAIN_SHAPE[0] * TRAIN_SHAPE[1]

    problems, readings, paths, losses = [], {}, {}, {}
    for wire, extra in (("f32", ("--wire-format", "f32")),
                        ("bf16", ("-e", str(ENV_DIR / "wire-bf16.yaml"))),
                        ("u8", ("--wire-format", "u8"))):
        tctx, wall_s, peak, counts = _run_train(
            data / "strategy.yaml", model_cfg, tmp / f"wire-{wire}",
            WIRE_STEPS, "-s", str(SEEDS), "--reproduce", *extra)
        run, p = _run_readings(tctx, TRAIN_BATCH, WIRE_STEPS, wall_s)
        problems += [f"train {wire}: {x}" for x in p]
        if tctx.wire is None or tctx.wire.images != wire:
            problems.append(f"train {wire}: ran the wire {tctx.wire}")
        nbytes = [h["wire_bytes"] for h in tctx.history]
        if nbytes != [WIRE_BYTES_PER_PX[wire] * pixels] * WIRE_STEPS:
            problems.append(f"train {wire}: {nbytes} bytes a batch, "
                            f"expected {WIRE_BYTES_PER_PX[wire] * pixels}")
        expected = _expect(convex_combine_8x=WIRE_STEPS,
                           convex_combine_8x_bwd=WIRE_STEPS)
        if counts != expected:
            problems.append(f"train {wire}: launches {counts}")
        healed = _heal_lines(tctx)
        if healed != 1 or tctx.data.bad_samples != 1:
            problems.append(f"train {wire}: {healed} substitutions logged, "
                            f"{tctx.data.bad_samples} counted, expected 1")
        losses[wire] = run["losses"][0]
        readings[f"train_{wire}"] = dict(
            wire=tctx.wire.describe(), bytes_per_batch=nbytes[0],
            bytes_per_px=nbytes[0] / pixels, losses=run["losses"],
            step_ms=run["step_ms"], median_step_ms=run["median_step_ms"],
            substitutions_logged=healed, max_memory_allocated=peak)
        paths[f"wire_train_{wire}"] = {k: v for k, v in counts.items() if v}
    for wire, rel in WIRE_LOSS_REL.items():
        diff = abs(losses[wire] - losses["f32"]) / abs(losses["f32"])
        readings[f"train_{wire}"]["first_loss_rel_to_f32"] = diff
        if not diff <= rel:
            problems.append(f"train {wire}: first loss {losses[wire]} is "
                            f"{diff} from the f32 wire's {losses['f32']} "
                            f"(bound {rel})")
    readings["phase8_median_step_ms"] = SHARED.get("train_median_step_ms")
    return readings, problems, paths


def _wire_evaluate(tmp):
    """``main evaluate --wire-format u8`` over the shipped Sintel source at
    phase 23's tree: each sample's EPE and loss against this process's
    recomputation through the same wire."""
    from raft_meets_dicl_tpu_torch import models
    from raft_meets_dicl_tpu_torch import main as port_main
    from raft_meets_dicl_tpu_torch.models.wire import WireFormat
    from raft_meets_dicl_tpu_torch.strategy import checkpoint
    from raft_meets_dicl_tpu_torch.utils import config

    model_cfg = ROOT / "cfg" / "model" / "raft-baseline.yaml"
    _write_sintel_tree(tmp / "sintel")
    sources = _eval_sources(tmp)
    spec = models.load(config.load(model_cfg))
    spec.model.init(torch.Generator().manual_seed(0), "cuda")
    ckpt = tmp / "raft-baseline-init.ckpt"
    checkpoint.Checkpoint(
        model=spec.id, iteration=checkpoint.Iteration(0, None, 0),
        metrics=None, state=checkpoint.State(
            spec.model.module.state_dict(), {}, {}, [], []),
        metadata={"source": "seeded init"}).save(ckpt)

    _zero_counts()
    report = port_main.main([
        "evaluate", "-d", str(sources["sintel"]), "-m", str(model_cfg),
        "-c", str(ckpt), "-b", str(EVAL_BATCH), "--wire-format", "u8",
        "-o", str(tmp / "eval-u8" / "report.json")])
    torch.cuda.synchronize()
    counts = _counts()
    stats = report["stats"]
    wire = WireFormat.from_config("u8", clip=spec.input.clip,
                                  range=spec.input.range)
    expected = _eval_recompute(spec, sources["sintel"], None, EVAL_BATCH,
                               wire=wire)
    problems, epe_diff = [], []
    for s in report["samples"]:
        epe, loss = expected.get(s["id"], (math.nan,) * 2)
        m = s["metrics"]
        epe_diff.append(abs(m["EndPointError/mean"] - epe))
        if not (epe_diff[-1] <= EVAL_EPE_ATOL + EVAL_EPE_REL * abs(epe)
                and abs(m["Loss"] - loss) <= EVAL_LOSS_REL * abs(loss)):
            problems.append(f"evaluate u8: {s['id']} EPE "
                            f"{m['EndPointError/mean']} loss {m['Loss']}, "
                            f"recomputed {epe}, {loss}")
    pairs = EVAL_SINTEL_SCENES * (EVAL_SINTEL_FRAMES - 1)
    if len(report["samples"]) != pairs or len(expected) != pairs:
        problems.append(f"evaluate u8: {len(report['samples'])} samples")
    batches = -(-pairs // EVAL_BATCH)
    if counts != _expect(convex_combine_8x=batches):
        problems.append(f"evaluate u8: launches {counts}")
    readings = dict(
        samples=stats.samples, batches=stats.batches,
        samples_per_sec=stats.samples_per_sec(),
        dispatch_ms_per_batch=1e3 * stats.phases["dispatch"] / stats.batches,
        drain_ms_per_batch=1e3 * stats.phases["drain"] / stats.batches,
        f32_dispatch_ms_per_batch_phase23=SHARED.get(
            "evaluate_sintel_dispatch_ms_per_batch"),
        max_epe_diff=max(epe_diff), summary=report["summary"]["mean"])
    return readings, problems, {"wire_evaluate_u8": {
        "convex_combine_8x": counts["convex_combine_8x"]}}


_RERUN = (
    "import json, sys\n"
    "from raft_meets_dicl_tpu_torch import main\n"
    "tctx = main.main(sys.argv[1:])\n"
    "print(json.dumps([h['loss'] for h in tctx.history]))\n")


def _rerun(config_json, out, env):
    """``main train -c config.json --reproduce -e env`` in a process of
    its own (the deterministic switches are process-wide), started now;
    its last line of output is the losses."""
    return subprocess.Popen(
        [sys.executable, "-c", _RERUN, "train", "-c", str(config_json),
         "--reproduce", "-e", str(env), "-o", str(out), "--limit-steps",
         str(DET_STEPS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wire_rerun(tmp):
    """A run of the shipped s1-things data graph (phase 22's) from fixed
    seeds, then two reruns from its own config.json with ``-c ...
    --reproduce -e cfg/env/deterministic.yaml``, side by side in
    processes of their own: their losses equal bit for bit."""
    model_cfg = ROOT / "cfg" / "model" / "raft-baseline.yaml"
    _write_things_tree(tmp / "things", AUG_PAIRS)
    _write_training_tree(tmp / "val", LIFE_VAL_SHAPE, AUG_VAL_PAIRS, "")
    strategy = _s1_things(tmp)
    tctx, wall_s, _, _ = _run_train(strategy, model_cfg, tmp / "first",
                                    DET_STEPS, "-s", str(SEEDS),
                                    "--reproduce")
    config_json = tctx.path / "config.json"
    environment = json.loads(config_json.read_text())["environment"]
    first = [h["loss"] for h in tctx.history]

    t0 = time.perf_counter()
    procs = [_rerun(config_json, tmp / f"det-{k}",
                    ENV_DIR / "deterministic.yaml") for k in (0, 1)]
    outs = [p.communicate(timeout=600) for p in procs]
    rerun_s = time.perf_counter() - t0
    problems, losses = [], []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            problems.append(f"deterministic rerun exited {p.returncode}: "
                            f"{err[-2000:]}")
            losses.append(None)
            continue
        losses.append(json.loads(out.strip().splitlines()[-1]))
        if "deterministic algorithms: on" not in err:
            problems.append("a rerun did not turn deterministic "
                            "algorithms on")
    if not problems and (losses[0] != losses[1]
                         or len(losses[0]) != DET_STEPS):
        problems.append(f"deterministic reruns' losses differ: {losses}")
    return dict(first_losses=first, rerun_losses=losses,
                reruns_equal=losses[0] == losses[1] and losses[0] is not None,
                equal_to_first=losses[0] == first,
                environment=environment, rerun_wall_s=round(rerun_s, 3),
                first_wall_s=round(wall_s, 3)), problems


def phase_wire_env(card):
    """Environments and wire formats on the card (shipped bf16-policy
    raft/baseline, 12 iterations): ``main serve -c cfg/serve/example.yaml``
    as it ships (u8 wire) and with ``--wire-format f32``; ``main train``
    on the f32, bf16 (``-e cfg/env/wire-bf16.yaml``) and u8 wires over a
    tree with one truncated PNG, healed once a run; ``main evaluate
    --wire-format u8`` over phase 23's Sintel tree; phase 22's run rerun
    twice from its config.json under ``-e cfg/env/deterministic.yaml``."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    problems, readings, paths = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, part in (("serve", lambda: _wire_serve(card)),
                           ("train", lambda: _wire_train(tmp)),
                           ("evaluate", lambda: _wire_evaluate(tmp))):
            t0 = time.perf_counter()
            r, p, launches = part()
            readings[name] = r | {"seconds": round(time.perf_counter() - t0,
                                                   3)}
            problems += p
            paths.update(launches)
        t0 = time.perf_counter()
        readings["rerun"], p = _wire_rerun(tmp)
        readings["rerun"]["seconds"] = round(time.perf_counter() - t0, 3)
        problems += p
    emit(phase="wire-env", model="raft/baseline (bf16 policy, 12 "
         "iterations)", serve_config=str(SERVE_EXAMPLE.relative_to(ROOT)),
         train_shape=[TRAIN_BATCH, *TRAIN_SHAPE], card=card, **readings)
    if problems:
        raise AssertionError("wire-env phase: " + "; ".join(problems))
    return paths


def kernels_line(results):
    """The nine kernels with their checks, times and launches.
    ``launches`` is the count of the main path of the slice that ported
    the kernel (ctf-l3's ``main train`` for the convex and sampler kernels,
    raft/fs's for the windowed correlation, the probe's bf16 run for the
    lookup kernels); ``launches_by_path`` has every path's count."""
    raft_train = results["phase_train"]
    paths = {
        "raft_model": {"convex_combine_8x": results["phase_model"]},
        "raft_serve": {"convex_combine_8x": results["phase_serve"]},
        "raft_train_step": dict(zip(
            ("convex_combine_8x", "convex_combine_8x_bwd"),
            results["phase_train_step"])),
        "raft_train": dict(zip(
            ("convex_combine_8x", "convex_combine_8x_bwd"), raft_train)),
        "ctf_model": results["phase_ctf_model"],
        "ctf_serve": results["phase_ctf_serve"],
        "ctf_train_step": results["phase_ctf_train_step"],
        "ctf_train": results["phase_ctf_train"],
        "fs_model": results["phase_fs_model"],
        "fs_serve": results["phase_fs_serve"],
        "fs_train_step": results["phase_fs_train_step"],
        "fs_train": results["phase_fs_train"],
        "fs_train_all_levels": results["phase_fs_train_all_levels"],
        **results["phase_lookup_kernels"]["paths"],
        **{f"quant {run}": counts
           for run, counts in results["phase_quant"].items()},
        **{f"lifecycle_{path}": counts
           for path, counts in results["phase_lifecycle"].items()},
        **{f"augmented_{path}": counts
           for path, counts in results["phase_augmented_train"].items()},
        **results["phase_evaluate"],
        **results["phase_wire_env"],
    }

    def launches(name):
        return {path: counts[name] for path, counts in paths.items()
                if counts.get(name)}

    cases = results["phase_kernels"]
    bwd_cases = results["phase_kernels_bwd"]
    # the convex entries quote ctf-l3 training's case (f32 logits), the
    # path whose launches they report, and raft/baseline training's beside
    def case_at(cases, dtype, rows):
        case = next(c for c in cases
                    if c["dtype"] == dtype and c["rows"] == rows)
        return {k: case[k] for k in ("dtype", "rows", "ms", "plain_ms",
                                     "bound_ms", "bound_by")}

    fwd_case = case_at(cases, "float32", CTF_TRAIN_M)
    bwd_case = case_at(bwd_cases, "float32", CTF_TRAIN_M)
    raft_shape = (f"bf16 logits, M={TRAIN_M} (raft/baseline training, "
                  "batch 6 at 400x720, 12 iterations)")
    raft_fwd = {**case_at(cases, "bfloat16", TRAIN_M), "shape": raft_shape}
    raft_bwd = {**case_at(bwd_cases, "bfloat16", TRAIN_M), "shape": raft_shape}
    convex_src = "raft_meets_dicl_tpu_torch/csrc/convex_combine_8x.cu"
    convex_shape = (f"f32 logits, M={CTF_TRAIN_M} (ctf-l3 training, batch "
                    "10 at 384x512, the finest level's 3 iterations)")
    sw_cases = results["phase_sw_kernels"]
    sw = sw_cases[SW_MAIN_CASE]
    sw_src = "raft_meets_dicl_tpu_torch/csrc/sample_window.cu"
    sw_shape = (f"{sw['dtype']} f2 {sw['f2']}, coords {sw['coords']}, "
                f"radius {sw['radius']} (ctf-l3 training, level 3 of batch "
                "10 at 384x512)")
    ctf_train = results["phase_ctf_train"]
    return [{
        "name": "convex_combine_8x",
        "route": "cuda",
        "source": convex_src,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:110",
        "launches": ctf_train["convex_combine_8x"],
        "launches_by_path": launches("convex_combine_8x"),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": fwd_case["ms"],
        "plain_ms": fwd_case["plain_ms"],
        "bound_ms": fwd_case["bound_ms"],
        "bound_by": fwd_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the neighbour "
                        "softmax + convex combine",
        "tolerance": "max |diff| <= 1e-5",
        "shape": convex_shape,
        "raft_train": raft_fwd,
        "cases": cases,
    }, {
        "name": "convex_combine_8x_bwd",
        "route": "cuda",
        "source": convex_src,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:136",
        "launches": ctf_train["convex_combine_8x_bwd"],
        "launches_by_path": launches("convex_combine_8x_bwd"),
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
        "shape": convex_shape,
        "raft_train": raft_bwd,
        "cases": bwd_cases,
    }, {
        "name": "sample_window",
        "route": "cuda",
        "source": sw_src,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:1004",
        "launches": ctf_train["sample_window"],
        "launches_by_path": launches("sample_window"),
        "max_abs_err": max(c["max_abs_err"] for c in sw_cases),
        "max_err_over_bound": max(c["err_over_bound"] for c in sw_cases),
        "ms": sw["ms"],
        "plain_ms": sw["plain_ms"],
        "bound_ms": sw["bound_ms"],
        "bound_by": sw["bound_by"],
        "library_ms": sw["library_ms"],
        "library_note": "F.grid_sample (bilinear, zeros, align_corners) "
                        "over the (B, K*K*H, W) grid of window positions",
        "tolerance": "float32 |diff| <= 1e-5; bf16 |diff| <= 1e-5 + one "
                     "bf16 ulp of the larger value",
        "shape": sw_shape,
        "cases": sw_cases,
    }, {
        "name": "sample_window_bwd",
        "route": "cuda",
        "source": sw_src,
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:1039",
        "launches": ctf_train["sample_window_bwd"],
        "launches_by_path": launches("sample_window_bwd"),
        "max_abs_err": max(c["bwd_max_abs_err"] for c in sw_cases),
        "max_err_over_bound": max(c["bwd_err_over_bound"] for c in sw_cases),
        "ms": sw["bwd_ms"],
        "plain_ms": sw["plain_bwd_ms"],
        "bound_ms": sw["bwd_bound_ms"],
        "bound_by": sw["bwd_bound_by"],
        "library_ms": sw["library_bwd_ms"],
        "library_note": "backward of F.grid_sample over the same grid "
                        "(input gradient only)",
        "tolerance": "|diff| <= 1e-5 + 2^-13 * S, S = the plain backward of "
                     "|dout| (float32 summation order); bf16 adds one bf16 "
                     "ulp of the larger value",
        "shape": sw_shape,
        "cases": sw_cases,
    }] + _wcp_entries(results, launches) + _lookup_entries(results, launches)


def _wcp_entries(results, launches):
    """The three windowed-correlation kernels, quoting the 2560x1072
    training case (bf16, level 0: the path whose launches they report)."""
    cases = results["phase_wcp_kernels"]
    main = cases[WCP_MAIN_CASE]
    fs_train = results["phase_fs_train"]
    src = "raft_meets_dicl_tpu_torch/csrc/windowed_corr.cu"
    shape = (f"{main['dtype']} f1 {main['f1']}, levels {main['levels']}, "
             f"radius {main['radius']} (raft/fs training, batch 1 at "
             "2560x1072: level 0 windowed)")
    note = ("no single PyTorch call computes the windowed correlation "
            "(the plain version is a gather, two lerps and a batched dot)")
    tolerance = ("|diff| <= 1e-5 max|plain| + 2^-13 S, S the plain function "
                 "of |f1|, |f2_l| (and |dout|); gradients of bf16 inputs "
                 "add one bf16 ulp")
    common = dict(route="cuda", source=src, library_ms=None,
                  library_note=note, tolerance=tolerance, shape=shape,
                  cases=cases)
    return [{
        "name": "windowed_corr_pyramid",
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:688",
        "launches": fs_train["windowed_corr_pyramid"],
        "launches_by_path": launches("windowed_corr_pyramid"),
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_err_over_bound": max(c["err_over_bound"] for c in cases),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        **common,
    }, {
        "name": "windowed_corr_pyramid_df1",
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:769",
        "launches": fs_train["windowed_corr_pyramid_df1"],
        "launches_by_path": launches("windowed_corr_pyramid_df1"),
        "max_abs_err": max(c["df1_max_abs_err"] for c in cases),
        "max_err_over_bound": max(c["df1_err_over_bound"] for c in cases),
        "ms": main["df1_ms"], "plain_ms": main["plain_bwd_ms"],
        "plain_note": "the plain backward computes df1 and df2 together",
        "bound_ms": main["df1_bound_ms"], "bound_by": main["df1_bound_by"],
        **common,
    }, {
        "name": "windowed_corr_pyramid_df2",
        "replaces": "raft_meets_dicl_tpu/ops/pallas.py:793",
        "launches": fs_train["windowed_corr_pyramid_df2"],
        "launches_by_path": launches("windowed_corr_pyramid_df2"),
        "max_abs_err": max(c["df2_max_abs_err"] for c in cases),
        "max_err_over_bound": max(c["df2_err_over_bound"] for c in cases),
        "ms": main["df2_ms"][0], "plain_ms": main["plain_bwd_ms"],
        "plain_note": "the plain backward computes df1 and df2 together",
        "bound_ms": main["df2_bound_ms"][0],
        "bound_by": main["df2_bound_by"][0],
        **common,
    }]


def _lookup_entries(results, launches):
    """The two lookup kernels, quoting the probe's bf16 bench case (the
    path whose launches they report: the probe's bf16 run)."""
    phase = results["phase_lookup_kernels"]
    cases = phase["cases"]
    main = cases[LOOKUP_MAIN_CASE]
    probe = phase["probe"]["bf16"]["launches"]
    shape = (f"{main['dtype']} wy (B, NI, NJ, 9, H2), corr (B, NI, NJ, H2, "
             f"W2), wx (B, NI, NJ, 9, W2) at {main['shape']} (the probe's "
             "bench case: level 0 of batch 6 at 400x720, hat inputs)")
    common = dict(route="cuda",
                  source="raft_meets_dicl_tpu_torch/csrc/fused_lookup.cu",
                  shape=shape, cases=cases)
    return [{
        "name": "lookup_stage1",
        "replaces": "scripts/probe_fused_lookup.py:93",
        "launches": probe["lookup_stage1"],
        "launches_by_path": launches("lookup_stage1"),
        "max_abs_err": max(c["stage1_max_abs_err"] for c in cases),
        "max_err_over_bound": max(c["stage1_err_over_bound"]
                                  for c in cases),
        "ms": main["stage1_ms"], "plain_ms": main["stage1_plain_ms"],
        "bound_ms": main["stage1_bound_ms"],
        "bound_by": main["stage1_bound_by"],
        "library_ms": main["stage1_library_ms"],
        "library_note": "torch.matmul(wy, corr) in the inputs' dtype (arm "
                        "A's first matmul; bf16 output for bf16 inputs)",
        "tolerance": "|diff| <= 2^-13 S elementwise, S = the plain stage 1 "
                     "of |wy|, |corr| (float32 summation order)",
        **common,
    }, {
        "name": "lookup_fused",
        "replaces": "scripts/probe_fused_lookup.py:112",
        "launches": probe["lookup_fused"],
        "launches_by_path": launches("lookup_fused"),
        "max_abs_err": max(c["fused_max_abs_err"] for c in cases),
        "max_err_over_bound": max(c["fused_err_over_bound"] for c in cases),
        "ms": main["fused_ms"], "plain_ms": main["fused_plain_ms"],
        "bound_ms": main["fused_bound_ms"],
        "bound_by": main["fused_bound_by"],
        "library_ms": main["fused_library_ms"],
        "library_note": "arm A: torch.matmul(wy, corr), then "
                        "torch.matmul(t.float(), wx.float().mT)",
        "tolerance": "|diff| <= 2^-13 S + sum_w ulp_bf16(t) |wx| "
                     "elementwise (bf16 inputs; float32: 2^-13 S), S = the "
                     "plain fused function of |wy|, |corr|, |wx|",
        **common,
    }]

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

    # every phase runs even after another failed, so one run reads them
    # all; any failure still ends the run without a result line
    failed = []
    results = {}

    def run(phase):
        t0 = time.perf_counter()
        try:
            results[phase.__name__] = phase(card)
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
        emit(phase="timing", of=phase.__name__.removeprefix("phase_"),
             seconds=round(time.perf_counter() - t0, 3))

    phases = (phase_kernels, phase_model, phase_serve, phase_kernels_bwd,
              phase_train_step, phase_train, phase_sw_kernels,
              phase_ctf_model, phase_ctf_serve, phase_ctf_train_step,
              phase_ctf_train, phase_wcp_kernels, phase_fs_model,
              phase_fs_serve, phase_fs_train_step, phase_fs_train,
              phase_fs_train_all_levels, phase_lookup_kernels, phase_quant,
              phase_lifecycle, phase_augmented_train, phase_evaluate,
              phase_wire_env)
    for phase in phases:
        run(phase)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernels_line(results)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
