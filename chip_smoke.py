#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vdpp_tpu_torch``), one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: every kernel under ``vdpp_tpu_torch/csrc/`` compiled by nvcc for
   sm_90a (one nvcc per source, all at once), with ptxas' report (registers,
   spills, shared memory per CTA of each kernel of the three sources);
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, with times for the kernel, the plain
   version, a one-call PyTorch yardstick and the bound, the share of the
   bound and the ratio to the yardstick (and for flash the TFLOP/s): flash
   attention at d = 64 bf16 (UNet; the wgmma + TMA kernel, plus the fp32
   SIMT kernel timed at a ragged length), d = 512 fp32 (the register-tiled
   SIMT kernel)
   and bf16 (the wgmma + TMA kernel) at the VAE mid-block's shapes (B = 4
   and 1 at L = 9216, B = 4 at L = 2560, ragged 600 and 201), and d = 72
   bf16 (DiT-XL's joint3d and factorized sites, plus ragged bf16 lengths and
   fp32), fused GroupNorm+SiLU (two launches, bf16 weights as the UNet
   stores them), and frame attention at d = 64 (the UNet's sites) and d = 72
   (the factorized DiT's; bf16 on the TMA + mma.sync kernel);
4. agreement: a small UNet (head dim 64, so the flash kernel runs) and one
   CFG Euler step, on the card against the same weights on the CPU, first
   as it is, then with both kernel switches on (VDPP_GN_FUSED=1,
   VDPP_TEMPORAL_ATTN=pallas); then a small VAE decoder whose mid-block
   attention takes the flash kernel at d = 512; then a small fp32 DiT with
   head dim 72, joint3d and then factorized with VDPP_TEMPORAL_ATTN=pallas
   (forward and one CFG Euler step), whose flash and frame-attention
   launches are counted;
5. main paths: full-width SVD-XT (random weights from a seed), 25 frames at
   72x128, CFG ramp to 3 in sequential mode, Euler steps through
   ``vdpp_tpu_torch.bench.measure_config``, first as it is, then with both
   kernel switches on; then ``bench.measure_decode`` decodes the switched
   run's latent with the full-width temporal VAE decoder (fp32, chunks of 4
   frames) to (1, 25, 576, 1024, 3), and again with the bf16 decoder
   (``VAEConfig.svd(torch.bfloat16)``, 7 flash launches at d = 512 in bf16).
   Then the text->video path at full
   width (random weights from a seed): T5-v1.1-XXL encodes the app's default
   prompt and is freed, DiT-XL denoises 8 frames at 40x64 (512x320) for 2
   Euler steps with a CFG ramp to 6 through ``bench.measure_dit_config``,
   joint3d and then factorized with VDPP_TEMPORAL_ATTN=pallas, and the fp32
   decoder turns the factorized run's latent into (1, 8, 320, 512, 3). For
   each run the launch counts are set to 0 just before and read just after,
   and must show the kernels on every site.

The last two lines are the ``nvidia-smi`` name/power-limit line and the
contract line ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
comes before them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (the same data sheet)
H100_HBM_BYTES = 3.35e12
# Launches per UNet forward at SVD-XT (4 levels, 2 ResNets a level down, 3 up):
# 15 spatial self-attention sites at L >= 512 (levels 0-2: 6 down + 9 up);
# 16 temporal transformer blocks (levels 0-2 down: 6, mid: 1, up: 9); and
# 4 GroupNorm+SiLU pairs in each of the 22 spatio-temporal ResBlocks (8 down,
# 2 mid, 12 up) plus conv_norm_out, all of whose row counts have an 8-aligned
# chunking (the reference's rule for fusing a site).
FLASH_PER_FORWARD = 15
FRAME_ATTN_PER_FORWARD = 16
GN_SILU_PER_FORWARD = 4 * 22 + 1
# 25 frames decoded in chunks of 4: 7 mid-block attentions at d = 512.
FLASH_PER_DECODE = 7
SWITCHES = {"VDPP_GN_FUSED": "1", "VDPP_TEMPORAL_ATTN": "pallas"}
TEMPORAL_SWITCH = {"VDPP_TEMPORAL_ATTN": "pallas"}  # the only one the DiT reads
# DiT-XL (28 blocks) at 8 frames of a 40x64 latent: 640 patch tokens a frame.
# joint3d: all 28 blocks self-attend over 8 * 640 = 5120 tokens (flash);
# factorized: 14 spatial blocks over 640 tokens (flash) and 14 temporal
# blocks over the 8 frames (frame attention under VDPP_TEMPORAL_ATTN=pallas).
DIT_FRAMES, DIT_LAT = 8, (40, 64)
FLASH_PER_JOINT3D_FORWARD = 28
FLASH_PER_FACTORIZED_FORWARD = 14
FRAME_ATTN_PER_FACTORIZED_FORWARD = 14
# 8 frames decoded in chunks of 4: 2 mid-block attentions at d = 512.
FLASH_PER_DIT_DECODE = 2


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
        add_rates(row, flops)
        print(f"flash bf16 L={l} B*H={b * h}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{rates_text(row)}", flush=True)
        shapes.append(row)
    for dtype, tol, l in ((torch.bfloat16, TOL["bf16"], 600), (torch.bfloat16, TOL["bf16"], 201),
                          (torch.float32, TOL["fp32"], 600)):
        q, k, v = inputs(2, l, 3, dtype)  # ragged: the last query and key tiles part-filled
        for static in (True, False):
            err, _ = compare(f"{dtype} L={l}", q, k, v, static, tol)
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
        if dtype == torch.float32:
            fp32_row = time_flash_fp32(torch, fa, F, q, k, v, "d=64 ragged")
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_row}


def time_flash_fp32(torch, fa, F, q, k, v, what: str) -> dict:
    """The fp32 SIMT kernel at d = 64/72 (off the models' paths; the small
    agreement configs use it) timed beside its plain version and SDPA in
    fp32, with its bound: fp32 FMA at 67 TFLOP/s or the bytes."""
    b, l, h, d = q.shape
    row = {"site": what, "B": b, "L": l, "H": h, "D": d}
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
    row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
    row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True), iters=3,
                              warmup=1)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops = 4 * b * h * l * l * d
    row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * d * 4, H100_FP32_FLOPS)
    add_rates(row, flops)
    print(f"flash fp32 {what} B={b} L={l} H={h}: kernel_ms {row['ms']:.4f} (running "
          f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA fp32) "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} ({row['bound_by']}, 67 "
          f"TFLOP/s fp32); {row['tflops']:.2f} TFLOP/s, {row['bound_share']:.3f} of the bound, "
          f"{row['vs_library']:.3f}x SDPA's time", flush=True)
    return row


def add_rates(row: dict, flops: float) -> None:
    """TFLOP/s, the share of the bound and the ratio to the library call,
    from the row's times."""
    row["tflops"] = flops / row["ms"] / 1e9
    add_shares(row)


def add_shares(row: dict) -> None:
    """The share of the bound and the ratio to the library call."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"]


def shares_text(row: dict, library: str) -> str:
    return (f"{row['bound_share']:.3f} of the bound, {row['vs_library']:.3f}x {library}'s "
            f"time")


def rates_text(row: dict) -> str:
    return f"{row['tflops']:.1f} TFLOP/s, {shares_text(row, 'SDPA')}"


# Kernel templates of each source, as ptxas names them, and the words for
# their bool arguments.
KERNEL_NAMES = {"flash_attention": (r"flash_fwd_\w+?", ("running", "static")),
                "frame_attention": (r"frame_attn\w*?", ("false", "true")),
                "group_norm_silu": (r"gn_\w+?", ("false", "true"))}


def template_args(mangled: str, flags: tuple[str, str]) -> str:
    """``Li64ELb1E`` -> ``64, static``: the template arguments of a mangled
    kernel name (ints, bools, ``float`` and ``__nv_bfloat16``)."""
    out = []
    for m in re.finditer(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f", mangled):
        if m.group(1):
            out.append(m.group(1))
        elif m.group(2):
            out.append(flags[int(m.group(2))])
        else:
            out.append("f32" if m.group(0) == "f" else "bf16")
    return ", ".join(out)


def ptxas_report(log: str, source: str = "flash_attention") -> dict[str, dict]:
    """Registers, spills and static shared memory of each kernel of
    ``csrc/<source>.cu`` in ptxas' ``-v`` log, by a readable name such as
    ``flash_fwd_bf16<64, static>``."""
    names, flags = KERNEL_NAMES[source]
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*?\d+({names})I(\w+?)EEv", line)
        if m:
            name = f"{m.group(1)}<{template_args(m.group(2), flags)}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "spill_stores" not in out[name]:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
            name = None
    return out


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def check_flash_512(torch, fa, F, dtype) -> dict:
    """The flash kernel at the VAE mid-block's shapes: d = 512, one head,
    B = 4 frames of a decode chunk at L = 9216 (72 x 128 latent positions),
    the last chunk of 25 frames (B = 1) and the DiT decode's L = 2560 (40 x
    64), both softmax modes, plus ragged lengths (600, 201) whose last query
    and key tiles are part-filled. fp32 is the decoder's default and runs on
    the register-tiled SIMT kernel; bf16 is ``VAEConfig.svd(torch.bfloat16)``
    and runs on the wgmma + TMA kernel. The three path shapes are timed."""
    g = torch.Generator(device="cuda").manual_seed(1 if dtype == torch.float32 else 9)
    name = "fp32" if dtype == torch.float32 else "bf16"

    def inputs(b, l):
        return [torch.randn(b, l, 1, 512, generator=g, device="cuda").to(dtype) for _ in range(3)]

    tol = TOL[name]
    print(f"flash d=512 {name} tolerance: max|kernel - plain| <= {tol} x max|plain| "
          + ("(fp32 both sides, sums in other orders, no TF32)" if name == "fp32"
             else "(as at d = 64: q', P and o rounded to bf16 on both sides)"))
    max_err = 0.0
    shapes = []
    for b, l in ((4, 9216), (1, 9216), (4, 2560), (2, 600), (2, 201)):
        q, k, v = inputs(b, l)
        for static in (True, False):
            got = fa.flash_attention(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            mode = "static" if static else "running"
            print(f"flash {name} d=512 B={b} L={l} {mode}: max|diff| {err:.3g}, max|plain| "
                  f"{ref_max:.3g}, limit {tol * ref_max:.3g}", flush=True)
            if not math.isfinite(err) or err > tol * ref_max:
                fail(f"flash {name} d=512 B={b} L={l} {mode}: max|diff| {err} > {tol} x {ref_max}")
            max_err = max(max_err, err)
        if l not in (9216, 2560):
            continue
        row = {"L": l, "B": b, "dtype": name, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True),
                            iters=5, warmup=1)
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, False),
                                    iters=5, warmup=1)
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                    iters=5, warmup=1)
        flops = 4 * b * l * l * 512
        # fp32: the SIMT rate (the tensor cores would round to TF32); bf16:
        # the tensor cores' bf16 rate, the card's peak for the inputs' type.
        peak = H100_FP32_FLOPS if name == "fp32" else H100_BF16_FLOPS
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * l * 512 * q.element_size(), peak)
        add_rates(row, flops)
        print(f"flash {name} d=512 B={b} L={l}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA "
              f"{name}) {row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {peak / 1e12:.0f} TFLOP/s); {rates_text(row)}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_group_norm(torch, nk, F) -> dict:
    """Fused GroupNorm+SiLU against its plain version at the UNet's sites,
    bf16, G = 32: level 0 spatial (N = 25 frames, S = 72 x 128) and temporal
    (N = 1, S = 25 x 72 x 128), the 2560-channel skip concatenation at level
    3, level 3 temporal; plus fp32, and an fp32 shape whose chunks are ragged
    and whose rows are not 16-byte aligned."""
    from vdpp_tpu_torch.ops.normalization import Norm

    g = torch.Generator(device="cuda").manual_seed(2)
    print("GroupNorm+SiLU tolerance: bf16 max|kernel - plain| <= one bf16 ulp at max|plain| "
          "(fp32 statistics merged in another order flip an output rounding at most once); "
          f"fp32 {TOL['fp32']} x max|plain|")
    max_err = 0.0
    shapes = []
    cases = (("level 0 temporal", 1, 25 * 9216, 320, torch.bfloat16),
             ("level 0 spatial", 25, 9216, 320, torch.bfloat16),
             ("level 3 skip concat", 25, 144, 2560, torch.bfloat16),
             ("level 3 temporal", 1, 25 * 144, 1280, torch.bfloat16),
             ("fp32", 3, 512, 128, torch.float32),
             ("fp32 ragged", 2, 200, 90, torch.float32))
    for what, n, rows, c, dtype in cases:
        groups = 6 if c == 90 else 32
        norm = Norm(c, device="cuda", dtype=dtype)
        norm.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g, device="cuda"))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g, device="cuda"))
        x = (3.0 * torch.randn(n, rows, c, generator=g, device="cuda")).to(dtype)
        before = nk.launches
        got = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
        torch.cuda.synchronize()
        if nk.launches != before + 1:
            fail("the GroupNorm+SiLU wrapper did not count its launch")
        ref = nk.group_norm_silu_fused_plain(x, norm, groups, 1e-6)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"gn_silu {what} (N={n}, S={rows}, C={c}, {dtype}): max|diff| {err:.3g}, "
              f"max|plain| {ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"gn_silu {what}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            continue
        max_err = max(max_err, err)
        row = {"site": what, "N": n, "S": rows, "C": c, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused(x, norm, groups, 1e-6))
        row["plain_ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused_plain(x, norm, groups,
                                                                                 1e-6),
                                  iters=3, warmup=1)
        xc = x.transpose(1, 2).contiguous()  # channels-first copy, not timed
        w, b = norm.weight.to(dtype), norm.bias.to(dtype)
        row["library_ms"] = time_ms(torch, lambda: F.silu(F.group_norm(xc, groups, w, b, 1e-6)))
        elems = n * rows * c
        row["bound_ms"], row["bound_by"] = bound(8 * elems, 2 * elems * 2, H100_FP32_FLOPS)
        add_shares(row)
        print(f"gn_silu {what}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (two calls: F.group_norm + F.silu, channels-first) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'the library')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_frame_attention(torch, ta, F) -> dict:
    """Frame attention against its plain version at the UNet's four temporal
    attention shapes (B = 1, F = 25, d = 64, bf16), plus fp32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    print("frame attention tolerance: bf16 max|kernel - plain| <= one bf16 ulp at max|plain| "
          "(fp32 softmax on both sides, sums in other orders); "
          f"fp32 {TOL['fp32']} x max|plain|")
    max_err = 0.0
    shapes = []
    cases = [(9216, 5, torch.bfloat16), (2304, 10, torch.bfloat16), (576, 20, torch.bfloat16),
             (144, 20, torch.bfloat16), (512, 4, torch.float32)]
    for l, h, dtype in cases:
        f = 25 if dtype == torch.bfloat16 else 3
        q, k, v = (torch.randn(1, f, l, h, 64, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        before = ta.launches
        got = ta.frame_attention(q, k, v)
        torch.cuda.synchronize()
        if ta.launches != before + 1:
            fail("the frame-attention wrapper did not count its launch")
        ref = ta.frame_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"frame_attention L={l} H={h} F={f} {dtype}: max|diff| {err:.3g}, max|plain| "
              f"{ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"frame_attention L={l} H={h}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            continue
        max_err = max(max_err, err)
        row = {"L": l, "H": h, "F": f, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
        row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        # SDPA over (B*L, H, F, D) copies (not timed): frames as the sequence axis.
        qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(l, h, f, 64).contiguous()
                      for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = bound(l * h * 4 * f * f * 64, 4 * f * l * h * 64 * 2,
                                                 H100_FP32_FLOPS)
        add_shares(row)
        print(f"frame_attention L={l} H={h}: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'SDPA')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_flash_72(torch, fa, F) -> dict:
    """The flash kernel at DiT-XL's head dim 72, bf16: the joint3d site
    (B = 1, L = 8 x 640 = 5120, 16 heads) and the factorized spatial site
    (B = 8 frames, L = 640, 16 heads), both softmax modes; plus fp32 at a
    ragged L = 600 (the small-config agreement runs fp32)."""
    g = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, l, h, dtype):
        return [torch.randn(b, l, h, 72, generator=g, device="cuda").to(dtype) for _ in range(3)]

    print(f"flash d=72 tolerance: max|kernel - plain| <= {TOL['bf16']} x max|plain| in bf16, "
          f"{TOL['fp32']} x max|plain| in fp32 (as at d = 64)")
    max_err = 0.0
    shapes = []
    for site, b, l, h, dtype in (("joint3d", 1, 5120, 16, torch.bfloat16),
                                 ("factorized spatial", 8, 640, 16, torch.bfloat16),
                                 ("bf16 ragged", 2, 600, 3, torch.bfloat16),
                                 ("bf16 ragged, under two tiles", 2, 201, 3, torch.bfloat16),
                                 ("fp32 ragged", 2, 600, 3, torch.float32)):
        q, k, v = inputs(b, l, h, dtype)
        tol = TOL["bf16"] if dtype == torch.bfloat16 else TOL["fp32"]
        row = {"site": site, "B": b, "L": l, "H": h}
        for static in (True, False):
            got = fa.flash_attention(q, k, v, static_max=static)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            mode = "static" if static else "running"
            print(f"flash d=72 {site} {dtype} B={b} L={l} H={h} {mode}: max|diff| {err:.3g}, "
                  f"max|plain| {ref_max:.3g}, limit {tol * ref_max:.3g}", flush=True)
            if not math.isfinite(err) or err > tol * ref_max:
                fail(f"flash d=72 {site} {mode}: max|diff| {err} > {tol} x {ref_max}")
            row["err_static" if static else "err_running"] = err
            row["ref_max"] = ref_max
        if dtype != torch.bfloat16:
            fp32_row = time_flash_fp32(torch, fa, F, q, k, v, "d=72 ragged")
            continue
        max_err = max(max_err, row["err_static"], row["err_running"])
        if "ragged" in site:
            continue
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's (B, H, L, D)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * l * l * 72
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * 72 * 2, H100_BF16_FLOPS)
        add_rates(row, flops)
        print(f"flash d=72 {site} bf16 B={b} L={l} H={h}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{rates_text(row)}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_row}


def check_frame_attention_72(torch, ta, F) -> dict:
    """Frame attention at the factorized DiT-XL's temporal sites: B = 1,
    F = 8, L = 640, 16 heads, d = 72, bf16 and fp32."""
    g = torch.Generator(device="cuda").manual_seed(7)
    print("frame attention d=72 tolerance: bf16 one bf16 ulp at max|plain|, "
          f"fp32 {TOL['fp32']} x max|plain| (as at d = 64)")
    max_err = 0.0
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(1, 8, 640, 16, 72, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        before = ta.launches
        got = ta.frame_attention(q, k, v)
        torch.cuda.synchronize()
        if ta.launches != before + 1:
            fail("the frame-attention wrapper did not count its launch")
        ref = ta.frame_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"frame_attention d=72 F=8 L=640 H=16 {dtype}: max|diff| {err:.3g}, max|plain| "
              f"{ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"frame_attention d=72 {dtype}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            continue
        max_err = err
        row = {"L": 640, "H": 16, "F": 8, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
        row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(640, 16, 8, 72).contiguous()
                      for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = bound(640 * 16 * 4 * 8 * 8 * 72,
                                                 4 * 8 * 640 * 16 * 72 * 2, H100_FP32_FLOPS)
        add_shares(row)
        print(f"frame_attention d=72 F=8 L=640 H=16: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'SDPA')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


@contextlib.contextmanager
def kernel_switches(switches: dict[str, str] = SWITCHES):
    """Opt-in kernel switches on, by default both (VDPP_GN_FUSED=1 is read
    when a wrapper is built, VDPP_TEMPORAL_ATTN=pallas at every call)."""
    saved = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_agreement(torch, switches: bool) -> None:
    """A small UNet with head dim 64 (level 0 has 512 tokens, so the flash
    kernel runs) in fp32: the card's forward and CFG Euler step against the
    same weights and inputs on the CPU (plain versions). With ``switches``
    its GroupNorm+SiLU pairs and temporal attention take the fused kernels
    on the card, which must launch."""
    import dataclasses

    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    cfg = SVDUNetConfig(block_out_channels=(128, 256), num_attention_heads=(2, 4),
                        layers_per_block=1, cross_attention_dim=64,
                        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
                        norm_num_groups=8, dtype=torch.float32, fused_groupnorm=switches)
    params = {"cpu": StableVideoUNet(cfg, device="cpu").init(torch.Generator().manual_seed(0))}
    params["cuda"] = SVDUNet(cfg, device="cuda")
    params["cuda"].load_state_dict(params["cpu"].state_dict())
    cond = make_dummy_conditioning(torch.Generator().manual_seed(1), 1, 3, 16, 32,
                                   cross_dim=64, guidance_scale=3.0)
    x = torch.randn(1, 1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(2))
    outs = {}
    with kernel_switches() if switches else contextlib.nullcontext():
        for dev in ("cpu", "cuda"):
            nk.launches = ta.launches = 0
            model = StableVideoUNet(cfg, num_steps=4, device=dev)
            c = dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(dev)
                                             for f in dataclasses.fields(cond)})
            xd = (x * model.init_noise_sigma).to(dev)
            with torch.inference_mode():
                lat = torch.cat([xd[0], c.image_latents], dim=-1)
                fwd = params[dev](lat, 0.5, c.image_embeddings, c.added_time_ids)
                step = run_reference_single_device(model.pipeline_step_fn(), (params[dev], c),
                                                   xd, 1)
            outs[dev] = (fwd.cpu(), step.cpu())
    what = "with both kernel switches" if switches else "as it is"
    if switches and not (nk.launches and ta.launches):
        fail(f"the small UNet {what} launched GroupNorm+SiLU {nk.launches} and frame "
             f"attention {ta.launches} times on the card")
    for name, i in (("UNet forward", 0), ("CFG Euler step", 1)):
        ref = outs["cpu"][i]
        rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
        print(f"agreement card vs CPU, small fp32 UNet {what} ({name}): max|diff|/max|ref| "
              f"{rel:.3g} (tolerance 1e-4: fp32 sums in other orders, no TF32)")
        if not math.isfinite(rel) or rel > 1e-4:
            fail(f"card and CPU disagree on the small UNet {what} ({name}): {rel}")


def check_vae_agreement(torch, fa) -> None:
    """A small fp32 temporal VAE decoder with 512 top channels (its mid-block
    attention is one head at d = 512 over 16 x 32 = 512 latent positions, so
    it takes the flash kernel on the card): ``decode_chunked`` of 3 frames in
    chunks of 2 on the card against the same weights on the CPU."""
    from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig

    cfg = VAEConfig(block_out_channels=(64, 512), layers_per_block=1)
    cpu = TemporalVAEDecoder(cfg, device="cpu").init_weights(torch.Generator().manual_seed(4))
    card = TemporalVAEDecoder(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    lat = torch.randn(1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(5))
    ref = cpu.decode_chunked(lat, chunk_frames=2)
    fa.launches = 0
    got = card.decode_chunked(lat.cuda(), chunk_frames=2).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"agreement card vs CPU, small fp32 VAE decoder (d = 512 attention, 2 chunks): "
          f"max|diff|/max|ref| {rel:.3g} (tolerance 1e-4: fp32 sums in other orders, no TF32); "
          f"flash launches {fa.launches}")
    if fa.launches != 2:
        fail(f"the small VAE decoder launched the flash kernel {fa.launches} times, expected 2")
    if got.shape != (1, 3, 32, 64, 3) or not math.isfinite(rel) or rel > 1e-4:
        fail(f"card and CPU disagree on the small VAE decoder: {rel}, shape {tuple(got.shape)}")


def check_dit_agreement(torch, fa, ta) -> None:
    """A small fp32 DiT with DiT-XL's head dim (hidden 144 over 2 heads),
    depth 2, 4 frames of a 32 x 64 latent (512 patch tokens a frame): its
    forward and one CFG Euler step on the card against the same weights on
    the CPU, joint3d (2 flash launches a forward, L = 2048) and then
    factorized with VDPP_TEMPORAL_ATTN=pallas (1 flash launch, L = 512, and 1
    frame-attention launch a forward)."""
    from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig, DiTVideoWrapper
    from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    g = torch.Generator().manual_seed(8)
    lat = torch.randn(1, 4, 32, 64, 4, generator=g)
    ctx = torch.randn(1, 7, 32, generator=g)
    for mode, want in (("joint3d", (2, 0)), ("factorized", (1, 1))):
        cfg = DiTVideoConfig(hidden_size=144, depth=2, num_heads=2, cross_attention_dim=32,
                             attention_mode=mode, dtype=torch.float32)
        models = {"cpu": DiTVideo(cfg, device="cpu").init_weights(torch.Generator().manual_seed(9))}
        models["cuda"] = DiTVideo(cfg, device="cuda")
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        outs, counts = {}, {}
        with kernel_switches(TEMPORAL_SWITCH) if mode == "factorized" else \
                contextlib.nullcontext():
            for dev, model in models.items():
                wrapper = DiTVideoWrapper(cfg, num_steps=4, device=dev)
                bundle = (model, ctx.to(dev), make_guidance_ramp(6.0, 4, device=dev))
                fa.launches = ta.launches = 0
                with torch.inference_mode():
                    fwd = model(lat.to(dev), 0.3, ctx.to(dev))
                    step = run_reference_single_device(
                        wrapper.pipeline_step_fn(), bundle,
                        (lat * wrapper.init_noise_sigma).to(dev)[None], 1)
                outs[dev] = (fwd.cpu(), step.cpu())
                counts[dev] = (fa.launches, ta.launches)
        what = "joint3d" if mode == "joint3d" else "factorized with VDPP_TEMPORAL_ATTN=pallas"
        forwards = 3  # the forward, then the step's two CFG forwards
        expect(f"flash in the small DiT {what} on the card", counts["cuda"][0],
               want[0] * forwards)
        expect(f"frame attention in the small DiT {what} on the card", counts["cuda"][1],
               want[1] * forwards)
        for name, i in (("forward", 0), ("CFG Euler step", 1)):
            ref = outs["cpu"][i]
            rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
            print(f"agreement card vs CPU, small fp32 DiT d=72 {what} ({name}): "
                  f"max|diff|/max|ref| {rel:.3g} (tolerance 1e-4: fp32 sums in other orders, "
                  f"no TF32)")
            if not math.isfinite(rel) or rel > 1e-4:
                fail(f"card and CPU disagree on the small DiT {what} ({name}): {rel}")


def run_dit_path(torch, bench, config, context, smi: str, what: str) -> dict:
    """The full-width text->video denoise through ``bench.measure_dit_config``,
    checked."""
    res = bench.measure_dit_config(
        config=config, context=context, frames=DIT_FRAMES, lat_h=DIT_LAT[0], lat_w=DIT_LAT[1],
        steps=STEPS, guidance=6.0, videos=VIDEOS, warmup=1, device="cuda",
    )
    print(f"full width {what}: DiT-XL bf16, {DIT_FRAMES} frames at {DIT_LAT[0]}x{DIT_LAT[1]}, "
          f"CFG ramp to 6, {STEPS} Euler steps: {res['sec_per_step']:.3f} s/step "
          f"({res['sec_per_video']:.3f} s/video of {STEPS} steps), peak allocated "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, output {res['shape']}, finite "
          f"{res['finite']}, on {res['device']} ({smi})")
    if not res["finite"]:
        fail(f"the full-width DiT run {what} gave non-finite values")
    if res["shape"] != (1, DIT_FRAMES, *DIT_LAT, 4):
        fail(f"unexpected DiT output shape {res['shape']}")
    return res


def run_main_path(torch, bench, config, smi: str, what: str) -> dict:
    """The full-width denoise through ``bench.measure_config``, checked."""
    res = bench.measure_config(
        config=config, frames=25, lat_h=72, lat_w=128, steps=STEPS, guidance=3.0,
        cfg_mode="sequential", videos=VIDEOS, warmup=1, device="cuda",
    )
    print(f"full width {what}: SVD-XT bf16, 25 frames at 72x128, CFG 3 sequential, {STEPS} "
          f"Euler steps: {res['sec_per_step']:.3f} s/step ({res['sec_per_video']:.3f} s/video of "
          f"{STEPS} steps), peak allocated {res['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"output {res['shape']}, finite {res['finite']}, on {res['device']} ({smi})")
    if not res["finite"]:
        fail(f"the full-width run {what} gave non-finite values")
    if res["shape"] != (1, 25, 72, 128, 4):
        fail(f"unexpected output shape {res['shape']}")
    return res


def expect(what: str, got: int, want: int) -> None:
    print(f"{what}: {got} launches (expected {want})")
    if got != want:
        fail(f"{what}: {got} launches, expected {want}")


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
        from vdpp_tpu_torch.models.dit import DiTVideoConfig
        from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
        from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig
        from vdpp_tpu_torch.models.vae import VAEConfig
        from vdpp_tpu_torch.ops import flash_attention as fa
        from vdpp_tpu_torch.ops import norm_kernel as nk
        from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
        from vdpp_tpu_torch.utils import kernels
        from vdpp_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the vdpp_tpu_torch package is not beside this script: {e}")

    t_start = time.perf_counter()
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
    ptxas = ptxas_report(built["flash_attention"]["log"])
    lib = fa._kernel_lib()
    for kname, r in ptxas.items():
        d = re.match(r"flash_fwd_bf16<(\d+)", kname)
        dims = {"flash_fwd_d512_bf16": (512, 1), "flash_fwd_d512_f32": (512, 0)}
        d_bf16 = (int(d.group(1)), 1) if d else dims.get(kname.split("<")[0])
        r["dynamic_smem"] = lib.vdpp_flash_attention_smem(*d_bf16) if d_bf16 else None
        print(f"ptxas {kname}: {r.get('registers')} registers"
              + (" at launch (setmaxnreg: consumer warpgroups 240, producer 24)" if d else "")
              + f", {r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads, "
              f"{r.get('static_smem')} B static shared memory"
              + (f", {r['dynamic_smem']} B dynamic shared memory per CTA" if d_bf16 else ""))
    for new in ("flash_fwd_d512_bf16", "flash_fwd_d512_f32"):
        if built["flash_attention"]["seconds"] and not any(k.startswith(new) for k in ptxas):
            fail(f"no ptxas report for {new}")
    if not ptxas:
        print("ptxas: no report (the flash library was built before this run)")
    frame_lib = ta._kernel_lib()
    other_ptxas = {src: ptxas_report(built[src]["log"], src)
                   for src in ("frame_attention", "group_norm_silu")}
    for src, report in other_ptxas.items():
        for kname, r in report.items():
            d = re.match(r"frame_attn_tma<(\d+)", kname)
            r["dynamic_smem"] = frame_lib.vdpp_frame_attention_smem(int(d.group(1))) if d else None
            print(f"ptxas {kname}: {r.get('registers')} registers, {r.get('spill_stores')} B "
                  f"spill stores, {r.get('spill_loads')} B spill loads, {r.get('static_smem')} B "
                  f"static shared memory"
                  + (f", {r['dynamic_smem']} B dynamic shared memory per CTA" if d else ""))
        if built[src]["seconds"] and not report:
            fail(f"no ptxas report for {src}.cu")

    flash = check_flash(torch, fa, F)
    flash512 = check_flash_512(torch, fa, F, torch.float32)
    flash512_bf16 = check_flash_512(torch, fa, F, torch.bfloat16)
    gn = check_group_norm(torch, nk, F)
    frame = check_frame_attention(torch, ta, F)
    flash72 = check_flash_72(torch, fa, F)
    frame72 = check_frame_attention_72(torch, ta, F)
    check_agreement(torch, switches=False)
    check_agreement(torch, switches=True)
    check_vae_agreement(torch, fa)
    check_dit_agreement(torch, fa, ta)

    forwards = 2 * STEPS * (VIDEOS + 1)
    fa.launches = nk.launches = ta.launches = 0
    run_main_path(torch, bench, SVDUNetConfig.svd_xt(), smi, "as it is")
    flash_launches = fa.launches
    expect(f"flash on the main path ({forwards} UNet forwards)", flash_launches,
           FLASH_PER_FORWARD * forwards)
    expect("GroupNorm+SiLU on the main path as it is", nk.launches, 0)
    expect("frame attention on the main path as it is", ta.launches, 0)

    with kernel_switches():
        fa.launches = nk.launches = ta.launches = 0
        res = run_main_path(torch, bench, SVDUNetConfig.svd_xt(), smi,
                            "with VDPP_GN_FUSED=1 VDPP_TEMPORAL_ATTN=pallas")
        switched = {"flash": fa.launches, "gn": nk.launches, "frame": ta.launches}
    expect(f"flash on the switched path ({forwards} UNet forwards)", switched["flash"],
           FLASH_PER_FORWARD * forwards)
    expect("GroupNorm+SiLU on the switched path", switched["gn"], GN_SILU_PER_FORWARD * forwards)
    expect("frame attention on the switched path", switched["frame"],
           FRAME_ATTN_PER_FORWARD * forwards)

    fa.launches = nk.launches = ta.launches = 0
    dec = bench.measure_decode(res["latent"])
    decode_flash = fa.launches
    print(f"decode: temporal VAE decoder fp32, 25 frames in chunks of 4: {dec['sec']:.3f} s, "
          f"video {dec['shape']}, finite {dec['finite']}, peak allocated "
          f"{dec['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in the decode", decode_flash, FLASH_PER_DECODE)
    expect("GroupNorm+SiLU in the decode", nk.launches, 0)
    if dec["shape"] != (1, 25, 576, 1024, 3) or not dec["finite"]:
        fail(f"decode gave shape {dec['shape']}, finite {dec['finite']}")

    # The same latent through the bf16 decoder (VAEConfig.svd(torch.bfloat16),
    # the JAX scripts' --vae-dtype bfloat16): its mid-block attention takes the
    # flash kernel at d = 512 in bf16.
    fa.launches = nk.launches = ta.launches = 0
    dec16 = bench.measure_decode(res["latent"], config=VAEConfig.svd(torch.bfloat16))
    decode16_flash = fa.launches
    print(f"decode: temporal VAE decoder bf16, 25 frames in chunks of 4: {dec16['sec']:.3f} s, "
          f"video {dec16['shape']}, finite {dec16['finite']}, peak allocated "
          f"{dec16['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in bf16 in the bf16 decode", decode16_flash, FLASH_PER_DECODE)
    if dec16["shape"] != (1, 25, 576, 1024, 3) or not dec16["finite"]:
        fail(f"the bf16 decode gave shape {dec16['shape']}, finite {dec16['finite']}")

    # The text->video path: T5-XXL encode (then freed), DiT-XL joint3d, then
    # factorized with frame attention switched on, then the decode.
    t5_cfg = T5EncoderConfig.xxl()
    enc = bench.encode_prompt(t5_cfg, device="cuda")
    ctx = enc["context"]
    print(f"encode: T5-v1.1-XXL bf16, {enc['tokens']} tokens: {enc['sec']:.3f} s, context "
          f"{tuple(ctx.shape)}, finite {bool(torch.isfinite(ctx).all())} ({smi})")
    if tuple(ctx.shape) != (1, enc["tokens"], t5_cfg.d_model) or not torch.isfinite(ctx).all():
        fail(f"the T5-XXL encode gave shape {tuple(ctx.shape)} or non-finite values")
    dit_xl = dataclasses.replace(DiTVideoConfig.latte_xl(), cross_attention_dim=t5_cfg.d_model)
    fa.launches = nk.launches = ta.launches = 0
    run_dit_path(torch, bench, dataclasses.replace(dit_xl, attention_mode="joint3d"), ctx, smi,
                 "joint3d")
    joint = {"flash": fa.launches, "frame": ta.launches}
    expect(f"flash at d = 72 on the joint3d path ({forwards} DiT forwards)", joint["flash"],
           FLASH_PER_JOINT3D_FORWARD * forwards)
    expect("frame attention on the joint3d path", joint["frame"], 0)
    with kernel_switches(TEMPORAL_SWITCH):
        fa.launches = nk.launches = ta.launches = 0
        dit_res = run_dit_path(torch, bench, dataclasses.replace(dit_xl,
                                                                 attention_mode="factorized"),
                               ctx, smi, "factorized with VDPP_TEMPORAL_ATTN=pallas")
        fact = {"flash": fa.launches, "frame": ta.launches}
    expect(f"flash at d = 72 on the factorized path ({forwards} DiT forwards)", fact["flash"],
           FLASH_PER_FACTORIZED_FORWARD * forwards)
    expect("frame attention at d = 72 on the factorized path", fact["frame"],
           FRAME_ATTN_PER_FACTORIZED_FORWARD * forwards)
    expect("GroupNorm+SiLU on the DiT paths", nk.launches, 0)
    fa.launches = 0
    dit_dec = bench.measure_decode(dit_res["latent"])
    dit_decode_flash = fa.launches
    print(f"decode: temporal VAE decoder fp32, {DIT_FRAMES} frames in chunks of 4: "
          f"{dit_dec['sec']:.3f} s, video {dit_dec['shape']}, finite {dit_dec['finite']}, peak "
          f"allocated {dit_dec['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in the text->video decode", dit_decode_flash, FLASH_PER_DIT_DECODE)
    if dit_dec["shape"] != (1, DIT_FRAMES, 320, 512, 3) or not dit_dec["finite"]:
        fail(f"the text->video decode gave shape {dit_dec['shape']}, finite "
             f"{dit_dec['finite']}")

    def entry(name, source, replaces, launches, check, row, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": check["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shapes": check["shapes"], **extra}

    print(f"chip_smoke phases done in {time.perf_counter() - t_start:.1f} s")
    flash_src, flash_tpu = ("vdpp_tpu_torch/csrc/flash_attention.cu",
                            "vdpp_tpu/ops/flash_attention.py:233")
    frame_src, frame_tpu = ("vdpp_tpu_torch/csrc/frame_attention.cu",
                            "vdpp_tpu/ops/temporal_attention_kernel.py:80")
    print(json.dumps({"kernels": [
        entry("flash_attention", flash_src, flash_tpu, flash_launches, flash,
              flash["shapes"][0], ptxas=ptxas,
              fp32_d64_d72=[flash["fp32"], flash72["fp32"]]),
        entry("flash_attention_d512", flash_src, flash_tpu, decode_flash + dit_decode_flash,
              flash512, flash512["shapes"][0]),
        entry("flash_attention_d512_bf16", flash_src, flash_tpu, decode16_flash, flash512_bf16,
              flash512_bf16["shapes"][0]),
        entry("group_norm_silu", "vdpp_tpu_torch/csrc/group_norm_silu.cu",
              "vdpp_tpu/ops/norm_kernel.py:165", switched["gn"], gn, gn["shapes"][0],
              ptxas=other_ptxas["group_norm_silu"]),
        entry("frame_attention", frame_src, frame_tpu, switched["frame"], frame,
              frame["shapes"][0], ptxas=other_ptxas["frame_attention"]),
        entry("flash_attention_d72", flash_src, flash_tpu, joint["flash"] + fact["flash"],
              flash72, flash72["shapes"][0]),
        entry("frame_attention_d72", frame_src, frame_tpu, fact["frame"], frame72,
              frame72["shapes"][0]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
