#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vdpp_tpu_torch``), one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: every kernel under ``vdpp_tpu_torch/csrc/`` compiled by nvcc for
   sm_90a (one nvcc per source, all at once), with ptxas' report;
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, with times for the kernel, the plain
   version, a one-call PyTorch yardstick, and the bound: flash attention at
   d = 64 bf16 (UNet) and d = 512 fp32 (VAE mid-block), fused GroupNorm+SiLU
   and frame attention (bf16, the UNet's sites);
4. agreement: a small UNet (head dim 64, so the flash kernel runs) and one
   CFG Euler step, on the card against the same weights on the CPU, first
   as it is, then with both kernel switches on (VDPP_GN_FUSED=1,
   VDPP_TEMPORAL_ATTN=pallas); then a small VAE decoder whose mid-block
   attention takes the flash kernel at d = 512;
5. main path: full-width SVD-XT (random weights from a seed), 25 frames at
   72x128, CFG ramp to 3 in sequential mode, Euler steps through
   ``vdpp_tpu_torch.bench.measure_config``, first as it is, then with both
   kernel switches on; then ``bench.measure_decode`` decodes the switched
   run's latent with the full-width temporal VAE decoder (fp32, chunks of 4
   frames) to (1, 25, 576, 1024, 3). For each of the three runs the launch
   counts are set to 0 just before and read just after, and must show the
   kernels on every site.

The last two lines are the ``nvidia-smi`` name/power-limit line and the
contract line ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
comes before them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def check_flash_512(torch, fa, F) -> dict:
    """The flash kernel at the VAE mid-block's shape: d = 512, fp32, one head,
    L = 9216 (72 x 128 latent positions), B = 4 frames of a decode chunk;
    both softmax modes, plus a ragged length."""
    g = torch.Generator(device="cuda").manual_seed(1)

    def inputs(b, l):
        return [torch.randn(b, l, 1, 512, generator=g, device="cuda") for _ in range(3)]

    tol = TOL["fp32"]
    print(f"flash d=512 tolerance: max|kernel - plain| <= {tol} x max|plain| (fp32 both sides, "
          f"sums in other orders, no TF32)")
    max_err = 0.0
    row = {}
    for b, l in ((4, 9216), (2, 600)):
        q, k, v = inputs(b, l)
        for static in (True, False):
            got = fa.flash_attention(q, k, v, static_max=static)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, static_max=static)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            mode = "static" if static else "running"
            print(f"flash fp32 d=512 B={b} L={l} {mode}: max|diff| {err:.3g}, max|plain| "
                  f"{ref_max:.3g}, limit {tol * ref_max:.3g}", flush=True)
            if not math.isfinite(err) or err > tol * ref_max:
                fail(f"flash d=512 B={b} L={l} {mode}: max|diff| {err} > {tol} x {ref_max}")
            max_err = max(max_err, err)
        if l == 9216:
            row = {"L": l, "B": b, "ref_max": ref_max}
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
            row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * l * 512 * 4, H100_FP32_FLOPS)
            row["tflops"] = flops / row["ms"] / 1e9
            print(f"flash fp32 d=512 B={b} L={l}: kernel_ms {row['ms']:.3f} (running "
                  f"{row['running_ms']:.3f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA "
                  f"fp32) {row['library_ms']:.3f}, bound_ms {row['bound_ms']:.3f} "
                  f"({row['bound_by']}, fp32 67 TFLOP/s), {row['tflops']:.1f} TFLOP/s",
                  flush=True)
    return {"max_abs_err": max_err, "shapes": [row]}


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
        print(f"gn_silu {what}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (two calls: F.group_norm + F.silu, channels-first) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
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
        print(f"frame_attention L={l} H={h}: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']})",
              flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


@contextlib.contextmanager
def kernel_switches():
    """Both opt-in kernel switches on (VDPP_GN_FUSED=1 is read when a
    wrapper is built, VDPP_TEMPORAL_ATTN=pallas at every call)."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update(SWITCHES)
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
        from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
        from vdpp_tpu_torch.ops import flash_attention as fa
        from vdpp_tpu_torch.ops import norm_kernel as nk
        from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
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
    flash512 = check_flash_512(torch, fa, F)
    gn = check_group_norm(torch, nk, F)
    frame = check_frame_attention(torch, ta, F)
    check_agreement(torch, switches=False)
    check_agreement(torch, switches=True)
    check_vae_agreement(torch, fa)

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

    def entry(name, source, replaces, launches, check, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": check["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shapes": check["shapes"]}

    flash_src, flash_tpu = ("vdpp_tpu_torch/csrc/flash_attention.cu",
                            "vdpp_tpu/ops/flash_attention.py:233")
    print(json.dumps({"kernels": [
        entry("flash_attention", flash_src, flash_tpu, flash_launches, flash,
              flash["shapes"][0]),
        entry("flash_attention_d512", flash_src, flash_tpu, decode_flash, flash512,
              flash512["shapes"][0]),
        entry("group_norm_silu", "vdpp_tpu_torch/csrc/group_norm_silu.cu",
              "vdpp_tpu/ops/norm_kernel.py:165", switched["gn"], gn, gn["shapes"][0]),
        entry("frame_attention", "vdpp_tpu_torch/csrc/frame_attention.cu",
              "vdpp_tpu/ops/temporal_attention_kernel.py:80", switched["frame"], frame,
              frame["shapes"][0]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
