#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vdpp_tpu_torch``), one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: every kernel under ``vdpp_tpu_torch/csrc/`` compiled by nvcc for
   sm_90a (one nvcc per source, all at once), with ptxas' report;
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, with times for the kernel, the plain
   version, a one-call PyTorch yardstick, and the bound;
4. agreement: a small UNet (head dim 64, so the flash kernel runs) and one
   CFG Euler step, on the card against the same weights on the CPU;
5. main path: full-width SVD-XT (random weights from a seed), 25 frames at
   72x128, CFG ramp to 3 in sequential mode, Euler steps through
   ``vdpp_tpu_torch.bench.measure_config``; launch counts are set to 0 just
   before and read just after, and must show the kernel on every site.

The last two lines are the ``nvidia-smi`` name/power-limit line and the
contract line ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
comes before them.
"""

from __future__ import annotations

import json
import math
import sys
import time

STEPS = 2  # Euler steps of the full-width run
VIDEOS = 1  # timed videos of the full-width run, after one warm-up video
# Flash kernel against its plain version: fail when max|kernel - plain| exceeds
# TOL * max|plain| for the shape and mode. Relative, because the outputs are
# small: each is a softmax-weighted mean of N(0, 1) values, std about
# sqrt(e / L), so max|plain| is about 0.1 at L = 9216. A bf16 ulp is 2^-8 to
# 2^-7 of the value it rounds, so 2e-2 is 2.5 to 5 ulps of the largest output:
# room for the 1-2 ulp flips where the two sides' fp32 sums, taken in other
# orders, round q', P or o the other way; a kernel off by a few percent fails.
TOL = {"bf16": 2e-2, "fp32": 1e-5}
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM, 700 W)
H100_HBM_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash(torch, fa, F) -> dict:
    """The flash kernel against its plain version at the UNet's three
    self-attention shapes (d = 64, bf16, full B*H: the plain version chunks
    its queries, so no reduction is needed), both softmax modes, plus a
    ragged length and fp32."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, l, h, dtype):
        return [torch.randn(b, l, h, 64, generator=g, device="cuda").to(dtype) for _ in range(3)]

    def compare(what, q, k, v, static, tol):
        got = fa.flash_attention(q, k, v, static_max=static)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        mode = "static" if static else "running"
        print(f"flash {what} {mode}: max|diff| {err:.3g}, max|plain| {ref_max:.3g}, "
              f"limit {tol} x max|plain| = {tol * ref_max:.3g}", flush=True)
        if not math.isfinite(err) or err > tol * ref_max:
            fail(f"flash {what} {mode}: max|diff| {err} > {tol} x {ref_max}")
        return err, ref_max

    print(f"flash tolerance: max|kernel - plain| <= {TOL['bf16']} x max|plain| in bf16 (2.5 "
          f"to 5 bf16 ulps of the largest output; the sums run in other orders), "
          f"{TOL['fp32']} x max|plain| in fp32")
    max_err = 0.0
    shapes = []
    # (frames*batch, L, heads): UNet levels 0, 1, 2 at 25 frames, 72x128.
    for b, l, h in ((25, 9216, 5), (25, 2304, 10), (25, 576, 20)):
        q, k, v = inputs(b, l, h, torch.bfloat16)
        row = {"L": l, "BH": b * h}
        for static in (True, False):
            err, ref_max = compare(f"bf16 L={l} B*H={b * h}", q, k, v, static, TOL["bf16"])
            max_err = max(max_err, err)
            row["err_static" if static else "err_running"] = err
            row["ref_max"] = ref_max
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's (B, H, L, D)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * l * l * 64
        nbytes = 4 * b * h * l * 64 * 2
        row["bound_ms"] = max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES) * 1e3
        row["bound_by"] = "operations" if flops / H100_BF16_FLOPS > nbytes / H100_HBM_BYTES \
            else "bytes"
        row["tflops"] = flops / row["ms"] / 1e9
        print(f"flash bf16 L={l} B*H={b * h}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}), "
              f"{row['tflops']:.1f} TFLOP/s", flush=True)
        shapes.append(row)
    for dtype, tol in ((torch.bfloat16, TOL["bf16"]), (torch.float32, TOL["fp32"])):
        q, k, v = inputs(2, 600, 3, dtype)  # 600 keys: a ragged last tile
        for static in (True, False):
            err, _ = compare(f"{dtype} L=600", q, k, v, static, tol)
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_agreement(torch) -> None:
    """A small UNet with head dim 64 (level 0 has 512 tokens, so the flash
    kernel runs) in fp32: the card's forward and CFG Euler step against the
    same weights and inputs on the CPU (plain versions)."""
    import dataclasses

    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    cfg = SVDUNetConfig(block_out_channels=(128, 256), num_attention_heads=(2, 4),
                        layers_per_block=1, cross_attention_dim=64,
                        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
                        norm_num_groups=8, dtype=torch.float32)
    params = {"cpu": StableVideoUNet(cfg, device="cpu").init(torch.Generator().manual_seed(0))}
    params["cuda"] = SVDUNet(cfg, device="cuda")
    params["cuda"].load_state_dict(params["cpu"].state_dict())
    cond = make_dummy_conditioning(torch.Generator().manual_seed(1), 1, 3, 16, 32,
                                   cross_dim=64, guidance_scale=3.0)
    x = torch.randn(1, 1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(2))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = StableVideoUNet(cfg, num_steps=4, device=dev)
        c = dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(dev)
                                         for f in dataclasses.fields(cond)})
        xd = (x * model.init_noise_sigma).to(dev)
        with torch.inference_mode():
            lat = torch.cat([xd[0], c.image_latents], dim=-1)
            fwd = params[dev](lat, 0.5, c.image_embeddings, c.added_time_ids)
            step = run_reference_single_device(model.pipeline_step_fn(), (params[dev], c), xd, 1)
        outs[dev] = (fwd.cpu(), step.cpu())
    for name, i in (("UNet forward", 0), ("CFG Euler step", 1)):
        ref = outs["cpu"][i]
        rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
        print(f"agreement card vs CPU, small fp32 UNet ({name}): max|diff|/max|ref| {rel:.3g} "
              f"(tolerance 1e-4: fp32 sums in other orders, no TF32)")
        if not math.isfinite(rel) or rel > 1e-4:
            fail(f"card and CPU disagree on the small UNet ({name}): {rel}")


def main() -> int:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from vdpp_tpu_torch import bench
        from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
        from vdpp_tpu_torch.ops import flash_attention as fa
        from vdpp_tpu_torch.utils import kernels
        from vdpp_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the vdpp_tpu_torch package is not beside this script: {e}")

    resolve_device("cuda")  # full-fp32 matmuls and convolutions, no TF32
    name = torch.cuda.get_device_name(0)
    smi = bench.nvidia_smi_line()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    for src, info in built.items():
        print(f"  {src}: {info['path']} ({info['seconds']:.1f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")

    flash = check_flash(torch, fa, F)
    check_agreement(torch)

    fa.launches = 0
    res = bench.measure_config(
        config=SVDUNetConfig.svd_xt(), frames=25, lat_h=72, lat_w=128, steps=STEPS,
        guidance=3.0, cfg_mode="sequential", videos=VIDEOS, warmup=1, device="cuda",
    )
    launches = fa.launches
    forwards = 2 * STEPS * (VIDEOS + 1)
    print(f"full width: SVD-XT bf16, 25 frames at 72x128, CFG 3 sequential, {STEPS} Euler "
          f"steps: {res['sec_per_step']:.3f} s/step ({res['sec_per_video']:.3f} s/video of "
          f"{STEPS} steps), peak allocated {res['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"output {res['shape']}, finite {res['finite']}, on {res['device']} ({smi})")
    print(f"flash launches on the main path: {launches} for {forwards} UNet forwards")
    if not res["finite"]:
        fail("the full-width run gave non-finite values")
    if res["shape"] != (1, 25, 72, 128, 4):
        fail(f"unexpected output shape {res['shape']}")
    if launches != 15 * forwards:
        fail(f"flash kernel launched {launches} times, expected 15 x {forwards}")

    level0 = flash["shapes"][0]
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "vdpp_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vdpp_tpu/ops/flash_attention.py:233",
        "launches": launches,
        "max_abs_err": flash["max_abs_err"],
        "ms": level0["ms"],
        "plain_ms": level0["plain_ms"],
        "bound_ms": level0["bound_ms"],
        "bound_by": level0["bound_by"],
        "library_ms": level0["library_ms"],
        "shapes": flash["shapes"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
