#!/usr/bin/env python3
"""Times the port's hand-written kernels at the shapes the models' main paths
give them, one GPU, for comparing two checkouts of the port on one card.

    python3 kernel_times.py [--root DIR] [--json PATH]

``--root`` is the checkout whose ``vdpp_tpu_torch`` is imported (default:
this file's); run it for two checkouts in turns (A, B, B, A) on one card,
one after the other. For each shape it prints two numbers:

* ``wall_ms``: CUDA events around CALLS back-to-back calls of the wrapper,
  over CALLS, as ``chip_smoke.py`` times its kernels. Where a kernel takes
  less time than the wrapper's host work (Python, the tensor maps, the
  launch), this is the host's rate, which the models' host-bound paths pay
  too;
* ``device_ms``: the device time of the wrapper's kernels a call, from
  ``torch.profiler`` (CUPTI) over CALLS calls: the kernel alone.

Inputs are N(0, 1) from a seed, contiguous, bf16 unless named fp32. It
imports nothing of JAX and needs the CUDA toolkit to build the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

# (name, kind, shape, dtype): flash (B, L, H, D), GroupNorm+SiLU (N, S, C)
# with 32 groups, frame attention (B, F, L, H, D).
SHAPES = (
    ("B1 d=64 14 frames L=9216 B*H=70", "flash", (14, 9216, 5, 64), "bf16"),
    ("B1 d=64 14 frames L=2304 B*H=140", "flash", (14, 2304, 10, 64), "bf16"),
    ("B1 d=64 14 frames L=576 B*H=280", "flash", (14, 576, 20, 64), "bf16"),
    ("B1 d=64 25 frames L=576 B*H=500", "flash", (25, 576, 20, 64), "bf16"),
    ("B1 d=72 joint3d L=5120 H=16", "flash", (1, 5120, 16, 72), "bf16"),
    ("B1 d=72 factorized L=640 B*H=128", "flash", (8, 640, 16, 72), "bf16"),
    ("B1 d=512 fp32 B=4 L=9216", "flash", (4, 9216, 1, 512), "fp32"),
    ("B1 d=512 fp32 B=1 L=9216", "flash", (1, 9216, 1, 512), "fp32"),
    ("B1 d=512 bf16 B=4 L=9216", "flash", (4, 9216, 1, 512), "bf16"),
    ("B2 level 0 temporal N=1 S=230400 C=320", "gn", (1, 230400, 320), "bf16"),
    ("B2 level 0 spatial N=25 S=9216 C=320", "gn", (25, 9216, 320), "bf16"),
    ("B2 level 3 skip concat N=25 S=144 C=2560", "gn", (25, 144, 2560), "bf16"),
    ("B2 level 3 temporal N=1 S=3600 C=1280", "gn", (1, 3600, 1280), "bf16"),
    *((f"B1 generic d={d} {dt} L=2304 H=8", "flash", (1, 2304, 8, d), dt)
      for dt in ("bf16", "fp32") for d in (16, 40, 80, 128, 256)),
    *((f"B1 wide d={d} {dt} L=2304 H=2", "flash", (1, 2304, 2, d), dt)
      for dt in ("bf16", "fp32") for d in (640, 768, 1024)),
    ("B3 d=64 F=25 L=9216 H=5", "frame", (1, 25, 9216, 5, 64), "bf16"),
    ("B3 d=64 F=25 L=2304 H=10", "frame", (1, 25, 2304, 10, 64), "bf16"),
    ("B3 d=64 F=25 L=576 H=20", "frame", (1, 25, 576, 20, 64), "bf16"),
    ("B3 d=64 F=25 L=144 H=20", "frame", (1, 25, 144, 20, 64), "bf16"),
    ("B3 d=64 F=14 L=9216 H=5", "frame", (1, 14, 9216, 5, 64), "bf16"),
    ("B3 d=72 F=8 L=640 H=16", "frame", (1, 8, 640, 16, 72), "bf16"),
)
# Words in the names of each wrapper's kernels, as the profiler reports them.
KERNEL_NAMES = {"flash": ("flash_fwd", "flash_scale_q"), "gn": ("gn_stats", "gn_apply"),
                "frame": ("frame_attn",)}
CALLS = 50  # calls timed a shape, each way


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose vdpp_tpu_torch is timed")
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import normalization
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"kernel_times: {fa.__file__}; {smi}", flush=True)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32}
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, kind, shape, dt in SHAPES:
        dtype = dtypes[dt]
        if kind == "gn":
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            norm = normalization.Norm(shape[-1], device="cuda", dtype=torch.bfloat16)
            norm.weight.fill_(1.0)
            norm.bias.zero_()

            def fn(x=x, norm=norm):
                return nk.group_norm_silu_fused(x, norm, 32, 1e-6)
        else:
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            call = fa.flash_attention if kind == "flash" else ta.frame_attention

            def fn(q=q, k=k, v=v, call=call):
                return call(q, k, v)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end) / CALLS
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.device_time_total for e in prof.key_averages()
                        if any(k in e.key for k in KERNEL_NAMES[kind]))
        device = device_us / 1e3 / CALLS
        rows.append({"name": name, "wall_ms": wall, "device_ms": device if device else math.nan})
        print(f"{name}: wall_ms {wall:.4f}, device_ms {device:.4f}", flush=True)
        del fn
        torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"root": os.path.abspath(args.root), "device": smi, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
