"""Video -> video refinement (SDEdit-style partial denoising) on CUDA devices.

    python -m vdpp_tpu_torch.apps.restyle_video --input in.y4m --strength 0.4 --random-weights
    python -m vdpp_tpu_torch.apps.restyle_video --input in.y4m --strength 0.5 --random-weights \\
        --preset tiny --device cpu --steps 4 --num-stages 2

The port's counterpart of ``scripts/restyle_video.py``: read a ``.y4m``
(``utils/video_io.read_y4m``), VAE-encode every frame in chunks of
``--decode-chunk-frames`` (``.mode()`` times the scaling factor), condition
on the first frame as the image->video app conditions on its image (CLIP
embedding, noise-augmented unscaled VAE latent), re-noise the clean latents
to the sigma at ``1 - --strength`` of the schedule (``x0 + sigma_start *
noise``) and run only the tail of the schedule (``denoise_from``) through
the step pipeline, then decode and write MP4 and GIF. A tail that does not
divide over the stages is padded with identity steps (``pad_steps_to``),
which change nothing. ``--solver``, ``--deepcache`` and ``--num-stages``
are the image->video app's, whose encode, denoise and decode pieces this
app shares. ``--seq-parallel`` and ``--frame-parallel`` make each stage a
block of ranks that split each UNet forward over the latent's W axis and its
frames; with DeepCache over more than one stage the stages must take the
cache's full and cache steps together (``StepPipeline`` refuses a padded
tail or a stage slice off the cadence, as the reference does; one stage is
exempt). Without a CUDA device the app fails unless ``--device cpu`` is
asked for.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np
import torch

from vdpp_tpu_torch.apps.generate_video import (
    _decode,
    _encode,
    _free,
    _load_models,
    _log_timing,
    _logging,
    _save,
    _share,
    _sync,
    add_solver_args,
    make_wrapper,
    model_configs,
    seeded_normal,
)
from vdpp_tpu_torch.models.clip_encoder import preprocess_image
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet
from vdpp_tpu_torch.parallel.mesh import Stage, make_axes_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.utils.video_io import read_y4m

LOGGER = logging.getLogger("vdpp_torch.generate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="input video (.y4m)")
    p.add_argument("--strength", type=float, default=0.5,
                   help="fraction of the schedule to re-run, in (0, 1]: the latents are "
                        "re-noised to the sigma at (1 - strength) of the schedule and denoised "
                        "from there (SDEdit); 1.0 = full generation")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--preset", default="svd_xt", choices=["svd_xt", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="as the image->video app's: npz files or a diffusers SVD checkpoint")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--num-frames", type=int, default=None,
                   help="use only the first N input frames (default: all)")
    p.add_argument("--steps", type=int, default=25,
                   help="length of the full schedule the truncation slices")
    p.add_argument("--num-stages", type=int, default=None,
                   help="pipeline stages, one process each (default: every card; 1 on the CPU)")
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--cfg-mode", default="sequential", choices=["sequential", "batched"])
    add_solver_args(p)
    p.add_argument("--seq-parallel", type=int, default=1)
    p.add_argument("--frame-parallel", type=int, default=1)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--decode-chunk-frames", type=int, default=4,
                   help="frames a VAE encode and decode call takes at once")
    p.add_argument("--vae-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="VAE compute dtype (bfloat16 halves encode and decode memory)")
    p.add_argument("--fps", type=int, default=None, help="output fps (default: the input's)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="an explicit device per rank, in rank order; a card named more than "
                        "once is shared by its ranks over gloo")
    p.add_argument("--log-level", default="INFO")
    return p


def denoise_from(strength: float, steps: int) -> int:
    """The SDEdit truncation: the first step of the schedule that runs."""
    return min(round((1.0 - strength) * steps), steps - 1)


def wrapper_for(args: argparse.Namespace, unet_cfg, stages: int, dev) -> StableVideoUNet:
    """The wrapper over the schedule's tail, identity-padded to a multiple of
    ``stages`` where the tail does not divide."""
    k = denoise_from(args.strength, args.steps)
    return make_wrapper(args, unet_cfg, dev, denoise_from=k,
                        pad_steps_to=stages if (args.steps - k) % stages else None)


def default_draw(args: argparse.Namespace):
    """The app's noise: the augmentation from ``seed + 4``, the latent's from
    ``seed``, each from a generator on the device."""
    return lambda name, shape, dev: seeded_normal(args.seed + (4 if name == "aug" else 0),
                                                  shape, dev)


@torch.inference_mode()
def restyle(stage: Stage, models: dict, wrapper: StableVideoUNet, frames_u8: np.ndarray,
            args: argparse.Namespace, fps: int, draw=None, times: dict | None = None):
    """The app's device work on one rank of ``stage``'s pipeline: rank 0
    encodes the conditioning (frame 0) and every frame's clean latent,
    re-noises them to ``wrapper.sigma_start`` and shares both; every rank
    denoises its slice; the last rank decodes. ``draw(name, shape, device)``
    gives the ``"aug"`` and ``"latent"`` standard normals (default: the
    app's seeds). ``models`` holds what the rank runs (``clip``,
    ``vae_encoder`` on rank 0, ``unet`` on all, ``vae_decoder`` on the
    last); the encoders and the UNet are taken out of it and freed after
    their use. Returns the ``(1, F, H, W, 3)`` video on the last rank, else
    None; adds ``encode``, ``diffusion`` and ``decode`` seconds to ``times``.
    """
    draw = draw or default_draw(args)
    times = {} if times is None else times
    dev = stage.device
    f = frames_u8.shape[0]
    sent = None
    if stage.rank == 0:
        t0 = time.perf_counter()
        frames = frames_u8.astype(np.float32) / 127.5 - 1.0
        clip_px = preprocess_image(frames_u8[0], size=models["clip"].config.image_size)
        cond = _encode(models, dev, frames[0], clip_px, draw("aug", frames[0].shape, dev), {},
                       num_frames=f, fps=fps, motion_bucket_id=args.motion_bucket_id,
                       noise_aug_strength=args.noise_aug_strength,
                       guidance_scale=args.guidance_scale, keep=True)
        # Clean diffusion-space latents of every frame: .mode() x scaling factor.
        models.pop("clip")
        vae_enc = models.pop("vae_encoder")
        step = max(args.decode_chunk_frames, 1)
        x0 = torch.cat([
            vae_enc.mode(vae_enc.apply(torch.as_tensor(frames[i:i + step], device=dev)))
            * vae_enc.config.scaling_factor for i in range(0, f, step)])[None]
        del vae_enc
        _free(dev)
        latent0 = x0[None] + wrapper.sigma_start * draw("latent", (1, 1, *x0.shape[1:]), dev)
        _sync(dev)
        times["encode"] = time.perf_counter() - t0
        sent = (cond, latent0, times["encode"])
    cond, latent0, times["encode"] = _share(stage, sent)

    t0 = time.perf_counter()
    pipe = StepPipeline(stage, wrapper.pipeline_step_fn(**stage.axes),
                        PipelineConfig(wrapper.num_steps, stage.num_stages))
    latents = pipe.run((models.pop("unet"), cond), wrapper.pack_initial(latent0))
    _free(dev)
    _sync(dev)
    times["diffusion"] = time.perf_counter() - t0
    if not stage.is_last_rank:
        return None
    t0 = time.perf_counter()
    video = _decode(models["vae_decoder"], wrapper.unpack_final(latents),
                    args.decode_chunk_frames)[0]
    _sync(dev)
    times["decode"] = time.perf_counter() - t0
    return video


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _logging(args.log_level)
    t_start = time.perf_counter()
    if not args.checkpoint and not args.random_weights:
        LOGGER.error("provide --checkpoint or --random-weights")
        return 1
    if not 0.0 < args.strength <= 1.0:
        LOGGER.error("--strength must be in (0, 1], got %s", args.strength)
        return 1
    frames_u8, in_fps = read_y4m(args.input)
    if args.num_frames:
        frames_u8 = frames_u8[: args.num_frames]
    unet_cfg, vae_cfg, _ = model_configs(args)
    down = 2 ** (len(vae_cfg.block_out_channels) - 1)
    if frames_u8.shape[1] % down or frames_u8.shape[2] % down:
        LOGGER.error("input %dx%d not divisible by the VAE factor %d", frames_u8.shape[2],
                     frames_u8.shape[1], down)
        return 1
    sp, fp = args.seq_parallel, args.frame_parallel
    lat_w, f = frames_u8.shape[2] // down, frames_u8.shape[0]
    if sp > 1 and lat_w % unet_cfg.seq_min_divisor(sp) != 0:
        LOGGER.error("--seq-parallel %d: latent width %d must divide by %d", sp, lat_w,
                     unet_cfg.seq_min_divisor(sp))
        return 1
    if fp > 1 and f % fp != 0:
        LOGGER.error("--frame-parallel %d: %d input frames must divide by it", fp, f)
        return 1
    mesh = make_axes_mesh(args.num_stages, seq=sp, frame=fp, device=args.device,
                          devices=args.devices)
    if mesh.world_size == 1:
        _stage_main(Stage(mesh, 0), args, t_start, frames_u8, in_fps)
    else:
        run_stages(mesh, _stage_main, args, t_start, frames_u8, in_fps)
    return 0


def _stage_main(stage: Stage, args: argparse.Namespace, t_start: float, frames_u8: np.ndarray,
                in_fps: int) -> list[str] | None:
    """One stage of the run (see :func:`restyle`); the last rank writes the
    files and returns their paths."""
    if stage.mesh.world_size > 1:  # a spawned rank starts with no logging set up
        _logging(args.log_level, f"rank {stage.rank}/{stage.mesh.world_size} ")
    dev = stage.device
    unet_cfg, vae_cfg, clip_cfg = model_configs(args)
    fps = args.fps or in_fps
    t0 = time.perf_counter()
    wrapper = wrapper_for(args, unet_cfg, stage.num_stages, dev)
    if stage.rank == 0:
        LOGGER.info("restyle: %dx%d, %d frames, strength %.2f -> %d of %d steps (sigma_start "
                    "%.3f) over %d stage(s) on %s", frames_u8.shape[2], frames_u8.shape[1],
                    frames_u8.shape[0], args.strength, wrapper.num_steps, args.steps,
                    wrapper.sigma_start, stage.num_stages, dev)
    names = (["clip", "vae_encoder"] if stage.rank == 0 else []) + ["unet"] + (
        ["vae_decoder"] if stage.is_last_rank else [])
    models = _load_models(args, wrapper, vae_cfg, clip_cfg, names)
    _sync(dev)
    t_load = time.perf_counter() - t0
    times: dict = {}
    video = restyle(stage, models, wrapper, frames_u8, args, fps, times=times)
    if video is None:
        return None
    t0 = time.perf_counter()
    outputs = _save(args, [video], stage.num_stages, prefix="restyle", steps=wrapper.num_steps,
                    fps=fps)
    LOGGER.info("diffusion [%d stage(s)]: %.3fs (%d steps); decoded in %.3fs", stage.num_stages,
                times["diffusion"], wrapper.num_steps, times["decode"])
    _log_timing(t_load, times["encode"], times["diffusion"],
                times["decode"] + time.perf_counter() - t0, time.perf_counter() - t_start,
                outputs)
    return outputs


if __name__ == "__main__":
    sys.exit(main())
