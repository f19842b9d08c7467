#!/usr/bin/env python3
"""The sampler backward's device time at ``chip_smoke.py``'s phase-9 cases,
for the port in this checkout or in another tree (say a ``git archive`` of
an earlier commit), on one GPU.

    python3 scripts/time_sample_window_bwd.py [--package-root DIR]
                                              [--label NAME] [--profile]
                                              [--set CONST=VALUE ...]

Draws every ``SW_CASES`` case's f2, centres and window gradient as phase 9
draws them (one generator seeded 4, the cases in order) and times
``ops.sample._launch_bwd`` with the cast to f2's dtype, as phase 9 times it
(``gpu_timer_ms``). With ``--package-root`` the package imported is
``DIR/raft_meets_dicl_tpu_torch``, its kernels built from DIR's sources.
With ``--set`` the package is first copied to ``build/variants/NAME/`` and
each named ``constexpr`` of its ``csrc/sample_window.cu`` given the value
(say ``--set kTileQX=4``): a variant of the kernel, timed as it stands.
With ``--profile`` each case also traces 20 backward calls with
``torch.profiler`` and gives each device operation's mean time a call.
Prints the card's name and power limit, then one JSON line per case. Fails
without CUDA.
"""

import argparse
import importlib.util
import json
import re
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _profile(fn, calls=20):
    """Each device operation's mean time a call of ``fn`` (microseconds),
    from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def _variant(root, label, sets):
    """A copy of ``root``'s package under ``build/variants/label`` with the
    constants of ``sets`` (``NAME=VALUE``) replaced in its sampler source;
    returns the copy's root."""
    dst = ROOT / "build" / "variants" / label
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "raft_meets_dicl_tpu_torch",
                    dst / "raft_meets_dicl_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / "raft_meets_dicl_tpu_torch" / "csrc" / "sample_window.cu"
    text = src.read_text()
    for item in sets:
        name, value = item.split("=", 1)
        text, n = re.subn(rf"(constexpr [\w ]+ {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"no constexpr {name} in {src}")
    src.write_text(text)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package-root", type=Path, default=ROOT)
    parser.add_argument("--label", default="checkout")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--set", action="append", default=[],
                        metavar="CONST=VALUE")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sample_window_bwd: needs a CUDA GPU", file=sys.stderr)
        return 1

    root = args.package_root.resolve()
    if args.set:
        root = _variant(root, args.label, args.set)
    sys.path.insert(0, str(root))
    from raft_meets_dicl_tpu_torch.ops import sample

    if not Path(sample.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {sample.__file__}, not from {root}")
    # the cases and their inputs come from this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = smoke.phase_environment()
    from raft_meets_dicl_tpu_torch.ops import cuda_build

    _, _, log = cuda_build.build("sample_window")
    smoke.emit(phase="sample-window-build", label=args.label, sets=args.set,
               ptxas=[line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line])
    gen = torch.Generator(device="cuda").manual_seed(4)
    k = 2 * smoke.CTF_RADIUS + 1
    for case in smoke.SW_CASES:
        dtype = getattr(torch, case["dtype"])
        f2, coords = smoke._sw_inputs(case, gen)
        b, h2, w2, c, h, w = case["shape"]
        dout = torch.randn((b, k, k, h, w, c), device="cuda",
                           generator=gen).to(dtype)
        def bwd():
            return sample._launch_bwd(dout, coords, tuple(f2.shape),
                                      smoke.CTF_RADIUS).to(dtype)

        ms = smoke.gpu_timer_ms(bwd)
        record = dict(case=case["name"], dtype=case["dtype"],
                      centres=case.get("centres", "scattered"), bwd_ms=ms)
        if args.profile:
            record["device_us_per_call"] = _profile(bwd)
        smoke.emit(phase="sample-window-bwd", label=args.label, card=card,
                   **record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
