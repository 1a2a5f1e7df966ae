"""Flagship SVD denoise benchmark of the port on one CUDA device.

    python -m vdpp_tpu_torch.bench [--preset full|tiny] [--steps N] [--frames F]
                                   [--latent-hw H W] [--device cuda|cpu] [--decode]

The counterpart of the root ``bench.py::measure_config``: random-init SVD-XT
(weights made from a seed), ``make_dummy_conditioning`` and the Euler loop
through ``run_reference_single_device``, with the same defaults (25 frames,
72x128 latent, 30 steps, CFG ramp to 3, sequential CFG). Prints one JSON line
on stdout, ``{"metric", "value", "unit", "vs_baseline"}``, whose metric names
the device it ran on and the kernel switches that were set
(``VDPP_GN_FUSED=1``, ``VDPP_TEMPORAL_ATTN=pallas``); progress goes to stderr.
``--decode`` then decodes the last video's latent with the temporal VAE
decoder (random weights from the seed, fp32, chunks of 4 frames, as the
image->video app decodes) and reports its time on stderr.

``vs_baseline`` is the root bench's yardstick: the reference system's
measured single-GPU 14-frame/25-step diffusion time (47.65 s, RTX A5000)
scaled by frames x steps, over the measured time (0 for the tiny preset).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.device import resolve_device

SECONDARY_BASELINE_SEC = 47.65


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Kernel-name patterns of the layers a step's device time is split into;
# the first match wins, unmatched kernels count as "other".
KERNEL_GROUPS = (
    ("flash attention (csrc/flash_attention.cu)", "flash_fwd"),
    ("GroupNorm+SiLU (csrc/group_norm_silu.cu)", "gn_partials|gn_merge|gn_apply"),
    ("frame attention (csrc/frame_attention.cu)", "frame_attn"),
    ("convolution (cuDNN)", "fprop|cudnn|conv"),
    ("matmul (cuBLAS)", "nvjet|gemm|cublas|cutlass"),
    ("elementwise, reduction, copy (PyTorch native)", "at::native"),
)


def profile_step(fn, device: torch.device, top: int = 25) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device time of
    every CUDA kernel it launched, by kernel name and by ``KERNEL_GROUPS``.

    Returns ``{"wall_ms", "kernel_ms", "busy_share", "groups", "kernels"}``:
    the host wall time of the call (ending in a synchronise), the summed
    kernel time, their ratio (one stream, so kernels do not overlap and the
    ratio is the device's busy share), ``{group: [launches, ms]}``, and the
    ``top`` kernels as ``[name, launches, ms]``.
    """
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        raise ValueError("profile_step measures a CUDA device")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        row = by_name.setdefault(evt.name, [evt.name, 0, 0.0])
        row[1] += 1
        row[2] += evt.time_range.elapsed_us() / 1e3
    kernels = sorted(by_name.values(), key=lambda r: -r[2])
    groups = {label: [0, 0.0] for label, _ in KERNEL_GROUPS}
    groups["other"] = [0, 0.0]
    for name, n, ms in kernels:
        label = next((lb for lb, pat in KERNEL_GROUPS if re.search(pat, name)), "other")
        groups[label][0] += n
        groups[label][1] += ms
    kernel_ms = sum(r[2] for r in kernels)
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
            "groups": groups, "kernels": kernels[:top]}


def measure_config(
    *,
    config: SVDUNetConfig,
    frames: int,
    lat_h: int,
    lat_w: int,
    steps: int,
    guidance: float,
    cfg_mode: str = "sequential",
    videos: int = 2,
    warmup: int = 1,
    seed: int = 0,
    device: str | torch.device | None = None,
    profile: bool = False,
) -> dict:
    """Generate ``warmup + videos`` videos and time the last ``videos``.

    Returns ``{"sec_per_video", "sec_per_step", "times", "peak_mem_bytes",
    "finite", "shape", "device", "profile", "latent"}``; ``peak_mem_bytes`` is
    the CUDA allocator's peak over the timed videos (None on the CPU) and
    ``latent`` the last video's final latent. Every video ends in a device
    synchronise inside its timed region. ``profile=True`` then traces one
    more denoise step (:func:`profile_step`).
    """
    dev = resolve_device(device)
    model = StableVideoUNet(config, num_steps=steps, cfg_mode=cfg_mode, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    cond = make_dummy_conditioning(
        torch.Generator(device=dev).manual_seed(seed + 1), 1, frames, lat_h, lat_w,
        cross_dim=config.cross_attention_dim, guidance_scale=guidance,
    )
    _sync(dev)
    log(f"init: {time.perf_counter() - t0:.2f} s")
    step_fn = model.pipeline_step_fn()

    def initial(i: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        noise = torch.randn(1, frames, lat_h, lat_w, 4, generator=g, device=dev)
        return model.pack_initial(noise * model.init_noise_sigma)[None]

    def generate(i: int) -> torch.Tensor:
        out = run_reference_single_device(step_fn, (params, cond), initial(i), steps)[0]
        return model.unpack_final(out)

    finite = True
    for i in range(warmup):
        t0 = time.perf_counter()
        out = generate(i)
        finite &= bool(torch.isfinite(out).all())
        log(f"warm-up video {i}: {time.perf_counter() - t0:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(videos):
        t0 = time.perf_counter()
        out = generate(warmup + i)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(out).all())
        log(f"video {i}: {times[-1]:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    prof = None
    if profile:
        x = initial(warmup + videos)
        prof = profile_step(
            lambda: run_reference_single_device(step_fn, (params, cond), x, 1), dev)
    sec = sum(times) / len(times)
    return {
        "sec_per_video": sec,
        "sec_per_step": sec / steps,
        "times": times,
        "peak_mem_bytes": peak,
        "finite": finite,
        "shape": tuple(out.shape),
        "device": device_name(dev),
        "profile": prof,
        "latent": out,
    }


def measure_decode(latent: torch.Tensor, *, warmup: int = 0, seed: int = 0,
                   config: VAEConfig | None = None) -> dict:
    """Decode ``latent / scaling_factor`` with a random-init temporal VAE
    decoder (weights from ``seed``) on the latent's device through
    ``decode_chunked`` (chunks of 4 frames); ``warmup`` untimed decodes
    first.

    Returns ``{"sec", "shape", "finite", "peak_mem_bytes"}``; the timed
    decode ends in a device synchronise.
    """
    dev = latent.device
    vae = TemporalVAEDecoder(config or VAEConfig.svd(), device=dev)
    vae.init_weights(torch.Generator(device=dev).manual_seed(seed + 2))
    lat = latent / vae.config.scaling_factor
    for _ in range(warmup):
        vae.decode_chunked(lat)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    video = vae.decode_chunked(lat)
    _sync(dev)
    sec = time.perf_counter() - t0
    return {
        "sec": sec,
        "shape": tuple(video.shape),
        "finite": bool(torch.isfinite(video).all()),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def kernel_switches() -> str:
    """The opt-in kernel switches that are set, as ``NAME=value`` words."""
    on = [f"{k}={os.environ[k]}" for k in ("VDPP_GN_FUSED", "VDPP_TEMPORAL_ATTN")
          if os.environ.get(k, "") not in ("", "0", "vpu")]
    return " ".join(on)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--frames", type=int)
    ap.add_argument("--latent-hw", type=int, nargs=2, metavar=("H", "W"))
    ap.add_argument("--guidance", type=float, default=3.0)
    ap.add_argument("--cfg-mode", choices=["sequential", "batched"], default="sequential")
    ap.add_argument("--videos", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed videos, trace one denoise step and print its "
                         "kernels by device time (stderr)")
    ap.add_argument("--decode", action="store_true",
                    help="decode the last video's latent with the temporal VAE decoder "
                         "(fp32, chunks of 4 frames, one warm-up decode) and print its "
                         "time (stderr)")
    args = ap.parse_args(argv)

    tiny = args.preset == "tiny"
    config = SVDUNetConfig.tiny() if tiny else SVDUNetConfig.svd_xt()
    frames = args.frames or (3 if tiny else 25)
    lat_h, lat_w = args.latent_hw or ((16, 16) if tiny else (72, 128))
    steps = args.steps or (4 if tiny else 30)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"card: {nvidia_smi_line()}")
    switches = kernel_switches()
    log(f"{args.preset}: {frames}f latent {lat_h}x{lat_w}, {steps} steps, guidance "
        f"{args.guidance}, cfg_mode {args.cfg_mode}, device {device_name(dev)}, "
        f"kernel switches: {switches or 'none'}")
    res = measure_config(
        config=config, frames=frames, lat_h=lat_h, lat_w=lat_w, steps=steps,
        guidance=args.guidance, cfg_mode=args.cfg_mode, videos=args.videos,
        warmup=args.warmup, seed=args.seed, device=dev, profile=args.profile,
    )
    if not res["finite"]:
        log("non-finite output")
        return 1
    if res["peak_mem_bytes"] is not None:
        log(f"peak allocated: {res['peak_mem_bytes'] / 2**30:.2f} GiB")
    if res["profile"] is not None:
        p = res["profile"]
        log(f"profiled step: wall {p['wall_ms']:.3f} ms, kernels {p['kernel_ms']:.3f} ms, "
            f"device busy share {p['busy_share']:.4f}")
        for label, (n, ms) in p["groups"].items():
            log(f"  {ms:10.3f} ms {n:6d}x  {label} ({ms / p['kernel_ms']:.4f} of kernel time)")
        log("top kernels:")
        for name, n, ms in p["kernels"]:
            log(f"  {ms:10.3f} ms {n:6d}x  {name[:150]}")
    if args.decode:
        vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.svd()
        dec = measure_decode(res["latent"], warmup=1, seed=args.seed, config=vae_cfg)
        if not dec["finite"]:
            log("non-finite decoded video")
            return 1
        mem = "" if dec["peak_mem_bytes"] is None else \
            f", peak allocated {dec['peak_mem_bytes'] / 2**30:.2f} GiB"
        log(f"decode: {dec['sec']:.3f} s for video {dec['shape']} (fp32, chunks of 4 "
            f"frames){mem}")
    baseline = 0.0 if tiny else SECONDARY_BASELINE_SEC * frames * steps / (14 * 25)
    print(json.dumps({
        "metric": (f"sec/video single {res['device']} SVD {frames}f {lat_h}x{lat_w} latent, "
                   f"{steps} steps, CFG {args.guidance}" + (f", {switches}" if switches else "")),
        "value": round(res["sec_per_video"], 3),
        "unit": "s/video",
        "vs_baseline": round(baseline / res["sec_per_video"], 3) if baseline else 0.0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
