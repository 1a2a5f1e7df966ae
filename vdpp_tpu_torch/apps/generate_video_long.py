"""Long image -> video generation by chaining segments, on CUDA devices.

    python -m vdpp_tpu_torch.apps.generate_video_long --random-weights --segments 2
    python -m vdpp_tpu_torch.apps.generate_video_long --random-weights --preset tiny \\
        --device cpu --num-frames 4 --steps 2 --num-stages 2 --segments 3

The port's counterpart of ``scripts/generate_video_long.py``: K segments of
F frames each, every continuation conditioned on the previous segment's last
decoded frame (which it replays as its own first frame, so it adds frames
``[1:]``), for ``F + (K - 1)(F - 1)`` frames in one MP4 and GIF. Each
segment is the image->video app's run (CLIP and VAE encode with noise
augmentation from ``seed + 100 + k``, latent noise from ``seed + k``, the
step pipeline, the chunked decode), built from that app's pieces, and takes
its ``--solver``, ``--deepcache`` and ``--num-stages``. Across stages rank 0
encodes each segment and the last rank decodes it and sends the last frame
back to rank 0. Without a CUDA device the app fails unless ``--device cpu``
is asked for.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from vdpp_tpu_torch.apps.generate_video import (
    _configs,
    _decode,
    _encode,
    _load_models,
    _log_timing,
    _logging,
    _save,
    _share,
    _sync,
    add_solver_args,
    load_and_preprocess_image,
    make_wrapper,
    seeded_normal,
)
from vdpp_tpu_torch.models.clip_encoder import preprocess_image
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline

LOGGER = logging.getLogger("vdpp_torch.generate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", default=None,
                   help="input image path (needs Pillow); a synthetic gradient if omitted")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--preset", default="svd_xt", choices=["svd_xt", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="as the image->video app's: npz files or a diffusers SVD checkpoint")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--num-frames", type=int, default=14,
                   help="frames a segment (the model's trained window)")
    p.add_argument("--segments", type=int, default=2,
                   help="segments to chain; total frames = F + (segments - 1)(F - 1)")
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--num-stages", type=int, default=None,
                   help="pipeline stages, one process each (default: every card; 1 on the CPU)")
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--cfg-mode", default="sequential", choices=["sequential", "batched"])
    add_solver_args(p)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--decode-chunk-frames", type=int, default=4)
    p.add_argument("--vae-dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log-level", default="INFO")
    return p


def default_draw(args: argparse.Namespace):
    """The app's noise for segment k: the augmentation from ``seed + 100 +
    k``, the latent's from ``seed + k``, each from a generator on the device."""
    return lambda name, k, shape, dev: seeded_normal(
        args.seed + (100 + k if name == "aug" else k), shape, dev)


@torch.inference_mode()
def long_video(stage: Stage, models: dict, wrapper: StableVideoUNet, image: np.ndarray | None,
               args: argparse.Namespace, lat_hw, draw=None, times: dict | None = None):
    """Every segment on one rank of ``stage``'s pipeline. Rank 0 holds
    ``clip`` and ``vae_encoder`` and the first frame ``image`` ((H, W, 3) in
    [-1, 1]) and encodes each segment; every rank holds ``unet``; the last
    holds ``vae_decoder``, decodes each segment and shares its last frame.
    ``draw(name, k, shape, device)`` gives segment k's ``"aug"`` and
    ``"latent"`` standard normals (default: the app's seeds). Returns the
    stitched ``(F + (K-1)(F-1), H, W, 3)`` video in [-1, 1] on the last rank,
    else None; adds ``encode``, ``diffusion`` and ``decode`` seconds to
    ``times``."""
    draw = draw or default_draw(args)
    times = {} if times is None else times
    times.update(encode=0.0, diffusion=0.0, decode=0.0)
    dev, f = stage.device, args.num_frames
    pipe = StepPipeline(stage, wrapper.pipeline_step_fn(),
                        PipelineConfig(wrapper.num_steps, stage.num_stages))
    pieces = []
    for k in range(args.segments):
        sent = None
        if stage.rank == 0:
            t0 = time.perf_counter()
            clip_px = preprocess_image(((image + 1.0) * 127.5).astype(np.uint8),
                                       size=models["clip"].config.image_size)
            cond = _encode(models, dev, image, clip_px, draw("aug", k, image.shape, dev), {},
                           num_frames=f, fps=args.fps, motion_bucket_id=args.motion_bucket_id,
                           noise_aug_strength=args.noise_aug_strength,
                           guidance_scale=args.guidance_scale, keep=True)
            noise = draw("latent", k, (1, 1, f, *lat_hw, 4), dev) * wrapper.init_noise_sigma
            _sync(dev)
            sent = (cond, noise, time.perf_counter() - t0)
        cond, noise, t_encode = _share(stage, sent)
        times["encode"] += t_encode
        t0 = time.perf_counter()
        latents = pipe.run((models["unet"], cond), wrapper.pack_initial(noise))
        _sync(dev)
        times["diffusion"] += time.perf_counter() - t0
        last = None
        if stage.is_last:
            t0 = time.perf_counter()
            video = _decode(models["vae_decoder"], wrapper.unpack_final(latents),
                            args.decode_chunk_frames)[0][0].float().cpu().numpy()
            times["decode"] += time.perf_counter() - t0
            pieces.append(video if k == 0 else video[1:])
            last = np.clip(video[-1], -1.0, 1.0)
            LOGGER.info("segment %d/%d done (%d new frames)", k + 1, args.segments,
                        pieces[-1].shape[0])
        if k + 1 < args.segments:  # the next segment starts from the last decoded frame
            image = stage.broadcast_object(last, src=stage.num_stages - 1)
    return np.concatenate(pieces) if stage.is_last else None


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _logging(args.log_level)
    t_start = time.perf_counter()
    if args.segments < 1:
        LOGGER.error("--segments must be >= 1")
        return 1
    if not args.checkpoint and not args.random_weights:
        LOGGER.error("provide --checkpoint or --random-weights")
        return 1
    mesh = make_pipeline_mesh(args.num_stages, device=args.device)
    PipelineConfig(args.steps, mesh.num_stages)  # a bad split fails before any rank starts
    if mesh.num_stages == 1:
        _stage_main(Stage(mesh, 0), args, t_start)
    else:
        run_stages(mesh, _stage_main, args, t_start)
    return 0


def _stage_main(stage: Stage, args: argparse.Namespace, t_start: float) -> list[str] | None:
    """One stage of the run (see :func:`long_video`); the last rank writes the
    files and returns their paths."""
    if stage.num_stages > 1:  # a spawned rank starts with no logging set up
        _logging(args.log_level, f"rank {stage.rank}/{stage.num_stages} ")
    dev = stage.device
    unet_cfg, vae_cfg, clip_cfg, lat_hw = _configs(args)
    total = args.num_frames + (args.segments - 1) * (args.num_frames - 1)
    if stage.rank == 0:
        LOGGER.info("generate long: %dx%d, %d segments of %d frames (%d in all), %d steps on "
                    "%s, %d stage(s)", args.width, args.height, args.segments, args.num_frames,
                    total, args.steps, dev, stage.num_stages)
    t0 = time.perf_counter()
    wrapper = make_wrapper(args, unet_cfg, dev)
    names = (["clip", "vae_encoder"] if stage.rank == 0 else []) + ["unet"] + (
        ["vae_decoder"] if stage.is_last else [])
    models = _load_models(args, wrapper, vae_cfg, clip_cfg, names)
    _sync(dev)
    t_load = time.perf_counter() - t0
    image = (load_and_preprocess_image(args.image, args.width, args.height)
             if stage.rank == 0 else None)
    times: dict = {}
    video = long_video(stage, models, wrapper, image, args, lat_hw, times=times)
    if video is None:
        return None
    if video.shape[0] != total:
        raise RuntimeError(f"stitched {video.shape[0]} frames, expected {total}")
    t0 = time.perf_counter()
    outputs = _save(args, [video[None]], stage.num_stages, prefix=f"svd_long{args.segments}x")
    _log_timing(t_load, times["encode"], times["diffusion"],
                times["decode"] + time.perf_counter() - t0, time.perf_counter() - t_start, outputs)
    return outputs


if __name__ == "__main__":
    sys.exit(main())
