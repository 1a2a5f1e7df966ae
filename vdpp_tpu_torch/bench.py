"""Denoise benchmarks of the port on one CUDA device: SVD image->video (the
flagship) and the DiT text->video family.

    python -m vdpp_tpu_torch.bench [--preset full|tiny] [--steps N] [--frames F]
                                   [--latent-hw H W] [--device cuda|cpu] [--decode]
    python -m vdpp_tpu_torch.bench --model dit3d_xl|dit_xl|dit3d_tiny [--profile]

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

``--model dit3d_xl`` (DiT-XL, joint3d attention), ``dit_xl`` (factorized)
and ``dit3d_tiny`` time the denoise of one text->video sample at the
defaults of ``vdpp_tpu_torch.apps.generate_video_text``: T5-v1.1-XXL encodes
the app's default prompt (random weights from the seed) and is freed, then
8 frames of a 40x64 latent (512x320), 24 Euler steps, CFG ramp to 6 (two DiT
forwards a step), bf16, through ``measure_dit_config``; the encode and the
fp32 temporal VAE decode of the last latent are timed on stderr. Its JSON
line has the same keys, ``vs_baseline`` 0 (the yardstick is SVD's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import torch

from vdpp_tpu_torch.models.dit import DiTVideoConfig, DiTVideoWrapper
from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import (
    StableVideoUNet,
    make_dummy_conditioning,
    make_guidance_ramp,
)
from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig, T5TextEncoder, hash_tokenize
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.device import resolve_device

SECONDARY_BASELINE_SEC = 47.65
# --model: (preset, attention mode) of the DiT text->video configurations.
DIT_MODELS = {"dit3d_xl": ("xl", "joint3d"), "dit_xl": ("xl", "factorized"),
              "dit3d_tiny": ("tiny", "joint3d")}


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
    ("GroupNorm+SiLU (csrc/group_norm_silu.cu)", "gn_stats|gn_apply"),
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


def _time_videos(generate, steps: int, videos: int, warmup: int, dev: torch.device,
                 profile_one_step=None) -> dict:
    """Run ``generate(i)`` for ``warmup`` untimed and ``videos`` timed videos,
    each timed one ending in a device synchronise; the allocator's peak is
    taken over the timed videos (None on the CPU). ``profile_one_step`` then
    runs under :func:`profile_step`."""
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
    prof = profile_step(profile_one_step, dev) if profile_one_step is not None else None
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

    one_step = None
    if profile:
        x = initial(warmup + videos)
        one_step = lambda: run_reference_single_device(step_fn, (params, cond), x, 1)  # noqa: E731
    return _time_videos(generate, steps, videos, warmup, dev, one_step)


def encode_prompt(config: T5EncoderConfig, prompt: str = "a video", max_tokens: int = 64,
                  seed: int = 0, device: str | torch.device | None = None) -> dict:
    """Encode ``prompt`` (hash-tokenized, as the app does with random weights)
    with a T5 encoder whose random weights come from ``seed``, then free the
    encoder. Returns ``{"context", "sec", "tokens"}``: the fp32 ``(1, M,
    d_model)`` tokens and the encode's time, ending in a device synchronise."""
    dev = resolve_device(device)
    t5 = T5TextEncoder(config, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    ids = torch.tensor([hash_tokenize(prompt, config.vocab_size, max_tokens)], device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    ctx = t5(ids).float()
    _sync(dev)
    sec = time.perf_counter() - t0
    del t5
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"context": ctx, "sec": sec, "tokens": ids.shape[1]}


def measure_dit_config(
    *,
    config: DiTVideoConfig,
    context: torch.Tensor,
    frames: int,
    lat_h: int,
    lat_w: int,
    steps: int,
    guidance: float,
    solver: str = "euler",
    videos: int = 2,
    warmup: int = 1,
    seed: int = 0,
    device: str | torch.device | None = None,
    profile: bool = False,
) -> dict:
    """The text->video counterpart of :func:`measure_config`: a random-init
    DiT (weights from ``seed``) denoises ``warmup + videos`` latents of
    ``frames x lat_h x lat_w`` conditioned on ``context`` (from
    :func:`encode_prompt`), CFG ramp to ``guidance``; returns the same keys."""
    dev = resolve_device(device)
    wrapper = DiTVideoWrapper(config, num_steps=steps, solver=solver, device=dev)
    t0 = time.perf_counter()
    dit = wrapper.init(torch.Generator(device=dev).manual_seed(seed + 1))
    bundle = (dit, context.to(dev), make_guidance_ramp(guidance, frames, device=dev))
    _sync(dev)
    log(f"init: {time.perf_counter() - t0:.2f} s")
    step_fn = wrapper.pipeline_step_fn()

    def initial(i: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        noise = torch.randn(1, frames, lat_h, lat_w, config.in_channels, generator=g, device=dev)
        return wrapper.pack_initial(noise * wrapper.init_noise_sigma)[None]

    def generate(i: int) -> torch.Tensor:
        return wrapper.unpack_final(
            run_reference_single_device(step_fn, bundle, initial(i), steps)[0])

    one_step = None
    if profile:
        x = initial(warmup + videos)
        one_step = lambda: run_reference_single_device(step_fn, bundle, x, 1)  # noqa: E731
    return _time_videos(generate, steps, videos, warmup, dev, one_step)


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


def _log_profile(p: dict) -> None:
    log(f"profiled step: wall {p['wall_ms']:.3f} ms, kernels {p['kernel_ms']:.3f} ms, "
        f"device busy share {p['busy_share']:.4f}")
    for label, (n, ms) in p["groups"].items():
        log(f"  {ms:10.3f} ms {n:6d}x  {label} ({ms / p['kernel_ms']:.4f} of kernel time)")
    log("top kernels:")
    for name, n, ms in p["kernels"]:
        log(f"  {ms:10.3f} ms {n:6d}x  {name[:150]}")


def _decode(latent: torch.Tensor, seed: int, config: VAEConfig) -> bool:
    """Time the decode of ``latent`` on stderr; False if it is not finite."""
    dec = measure_decode(latent, warmup=1, seed=seed, config=config)
    if not dec["finite"]:
        log("non-finite decoded video")
        return False
    mem = "" if dec["peak_mem_bytes"] is None else \
        f", peak allocated {dec['peak_mem_bytes'] / 2**30:.2f} GiB"
    log(f"decode: {dec['sec']:.3f} s for video {dec['shape']} (fp32, chunks of 4 "
        f"frames){mem}")
    return True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["svd", *DIT_MODELS], default="svd",
                    help="svd (image->video, the flagship) or a DiT text->video config")
    ap.add_argument("--preset", choices=["full", "tiny"], default="full",
                    help="svd only: svd_xt (full) or tiny")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--frames", type=int)
    ap.add_argument("--latent-hw", type=int, nargs=2, metavar=("H", "W"))
    ap.add_argument("--guidance", type=float, help="CFG scale (default 3 for svd, 6 for DiT)")
    ap.add_argument("--cfg-mode", choices=["sequential", "batched"], default="sequential")
    ap.add_argument("--videos", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed videos, trace one denoise step and print its "
                         "kernels by device time (stderr)")
    ap.add_argument("--decode", action="store_true",
                    help="svd: decode the last video's latent with the temporal VAE decoder "
                         "(fp32, chunks of 4 frames, one warm-up decode) and print its "
                         "time (stderr); DiT configs always decode")
    args = ap.parse_args(argv)

    dit = args.model in DIT_MODELS
    tiny = DIT_MODELS[args.model][0] == "tiny" if dit else args.preset == "tiny"
    if dit:
        frames = args.frames or (4 if tiny else 8)
        lat_h, lat_w = args.latent_hw or ((16, 16) if tiny else (40, 64))
        steps = args.steps or (4 if tiny else 24)
        guidance = 6.0 if args.guidance is None else args.guidance
    else:
        config = SVDUNetConfig.tiny() if tiny else SVDUNetConfig.svd_xt()
        frames = args.frames or (3 if tiny else 25)
        lat_h, lat_w = args.latent_hw or ((16, 16) if tiny else (72, 128))
        steps = args.steps or (4 if tiny else 30)
        guidance = 3.0 if args.guidance is None else args.guidance
    vae_cfg = VAEConfig.tiny() if tiny else VAEConfig.svd()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"card: {nvidia_smi_line()}")
    switches = kernel_switches()
    log(f"{args.model} {'tiny' if tiny else 'full'}: {frames}f latent {lat_h}x{lat_w}, {steps} "
        f"steps, guidance {guidance}, cfg_mode {args.cfg_mode}, device {device_name(dev)}, "
        f"kernel switches: {switches or 'none'}")
    if dit:
        mode = DIT_MODELS[args.model][1]
        t5_cfg = T5EncoderConfig.tiny() if tiny else T5EncoderConfig.xxl()
        enc = encode_prompt(t5_cfg, seed=args.seed, device=dev)
        log(f"encode: {enc['sec']:.3f} s for {enc['tokens']} tokens "
            f"(T5 {'tiny' if tiny else 'v1.1-XXL'}, then freed)")
        base = DiTVideoConfig.tiny() if tiny else DiTVideoConfig.latte_xl()
        config = dataclasses.replace(base, cross_attention_dim=t5_cfg.d_model,
                                     attention_mode=mode)
        res = measure_dit_config(
            config=config, context=enc["context"], frames=frames, lat_h=lat_h, lat_w=lat_w,
            steps=steps, guidance=guidance, videos=args.videos, warmup=args.warmup,
            seed=args.seed, device=dev, profile=args.profile,
        )
        what = f"DiT-{'tiny' if tiny else 'XL'} {mode} text->video"
    else:
        res = measure_config(
            config=config, frames=frames, lat_h=lat_h, lat_w=lat_w, steps=steps,
            guidance=guidance, cfg_mode=args.cfg_mode, videos=args.videos,
            warmup=args.warmup, seed=args.seed, device=dev, profile=args.profile,
        )
        what = "SVD"
    if not res["finite"]:
        log("non-finite output")
        return 1
    if res["peak_mem_bytes"] is not None:
        log(f"peak allocated: {res['peak_mem_bytes'] / 2**30:.2f} GiB")
    if res["profile"] is not None:
        _log_profile(res["profile"])
    if (dit or args.decode) and not _decode(res["latent"], args.seed, vae_cfg):
        return 1
    baseline = 0.0 if tiny or dit else SECONDARY_BASELINE_SEC * frames * steps / (14 * 25)
    print(json.dumps({
        "metric": (f"sec/video single {res['device']} {what} {frames}f {lat_h}x{lat_w} latent, "
                   f"{steps} steps, CFG {guidance}" + (f", {switches}" if switches else "")),
        "value": round(res["sec_per_video"], 3),
        "unit": "s/video",
        "vs_baseline": round(baseline / res["sec_per_video"], 3) if baseline else 0.0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
