"""Image -> video generation (Stable Video Diffusion) on one CUDA device.

    python -m vdpp_tpu_torch.apps.generate_video --random-weights
    python -m vdpp_tpu_torch.apps.generate_video --random-weights --preset tiny --device cpu \\
        --width 64 --height 64 --num-frames 4 --steps 2

The port's counterpart of ``scripts/generate_video.py``, the flagship app:
centre-crop preprocessing, CLIP ViT-H/14 image encode, VAE encode with
pixel-space noise augmentation, ``.mode()`` latents and no scaling factor,
conditioning with a per-frame CFG ramp, the Euler denoise loop, the chunked
temporal VAE decode, MP4 and GIF output, and a ``TIMING`` line. CLIP and the
VAE encoder are freed after the encode and the UNet before the decode. The
``svd_xt`` preset is SVD-XT (bf16), ViT-H/14 (fp32) and the SVD VAE
(``--vae-dtype``, fp32 by default) at 14 frames of 1024x576 and 25 steps.

``--checkpoint`` is a directory of the JAX package's own ``save_params``
files (``unet.npz``, ``clip.npz``, ``vae_encoder.npz``, ``vae_decoder.npz``)
or, where it holds no ``unet.npz``, a diffusers SVD checkpoint (``unet/``,
``vae/``, ``image_encoder/`` of ``*.safetensors`` shards), read by name
with ``load_svd_checkpoint`` and no ``safetensors`` package: the one way to
real weights on a machine without JAX. Without ``--image`` a synthetic gradient card
at the target size is the input, and no image library is needed; ``--image
FILE`` needs Pillow to decode the file and for the LANCZOS resize, as the
reference app does. CLIP's resize runs on PyTorch alone.

The denoise runs every step on one device (``run_reference_single_device``).
Options of parts not yet ported raise and name their ROADMAP item:
``--solver`` other than euler and ``--deepcache`` (A12), ``--num-stages``
above 1 (A6), ``--seq-parallel``, ``--frame-parallel`` and
``--decode-devices`` (A13). Without a CUDA device the app fails unless
``--device cpu`` is asked for. The ``tiny`` preset is a CPU preset: its
UNet's head dim 16 (and its VAE's 32) at L >= 512 has no flash kernel, so
on the card it raises there.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import logging
import os
import sys
import time

import numpy as np
import torch

from vdpp_tpu_torch.models.clip_encoder import (
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_image,
)
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig, VAEEncoder
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.device import resolve_device
from vdpp_tpu_torch.utils.video_io import (
    build_output_name,
    frames_to_uint8,
    save_video_gif,
    save_video_mp4,
)
from vdpp_tpu_torch.utils.weights import (
    from_jax_clip_params,
    from_jax_params,
    from_jax_vae_decoder_params,
    from_jax_vae_encoder_params,
    load_jax_npz,
    load_svd_checkpoint,
)

LOGGER = logging.getLogger("vdpp_torch.generate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image", required=False, default=None,
                   help="input image path (needs Pillow); a synthetic gradient is used if "
                        "omitted")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--preset", default="svd_xt", choices=["svd_xt", "tiny"])
    p.add_argument("--checkpoint", default=None,
                   help="directory of the JAX package's weight files (unet.npz, clip.npz, "
                        "vae_encoder.npz, vae_decoder.npz), or of a diffusers SVD checkpoint "
                        "(unet/, vae/, image_encoder/ of *.safetensors)")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--num-frames", type=int, default=14)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--num-stages", type=int, default=None)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--cfg-mode", default="sequential", choices=["sequential", "batched"])
    p.add_argument("--solver", default="euler", choices=["euler", "euler_a", "heun", "dpmpp2m"],
                   help="euler (the reference semantics); the others are not ported yet")
    p.add_argument("--deepcache", type=int, default=0, metavar="N",
                   help="cached inference every N steps (not ported yet; 0 = off)")
    p.add_argument("--deepcache-split", type=int, default=1)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--decode-chunk-frames", type=int, default=4)
    p.add_argument("--seq-parallel", type=int, default=1)
    p.add_argument("--frame-parallel", type=int, default=1)
    p.add_argument("--decode-devices", type=int, default=0)
    p.add_argument("--vae-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="VAE compute dtype (bfloat16 halves decode memory)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler-seed", type=int, default=0, help="euler_a only (not ported yet)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log-level", default="INFO")
    return p


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("--image needs Pillow to decode the file and for the LANCZOS "
                           "resize, as the reference app does; Pillow is not installed") from e
    return Image


def load_and_preprocess_image(path: str | None, width: int, height: int) -> np.ndarray:
    """Centre-crop to the target aspect, then resize (LANCZOS, through
    Pillow) to ``width`` x ``height``; float32 ``(H, W, 3)`` in [-1, 1]. The
    synthetic card (no ``path``) is already at the target size: no resize,
    as Pillow returns a copy there, and no Pillow."""
    if path:
        img = np.asarray(_pillow().open(path).convert("RGB"))
    else:  # synthetic gradient test card
        x = np.linspace(0, 1, width, dtype=np.float32)
        y = np.linspace(0, 1, height, dtype=np.float32)
        g = np.stack(np.meshgrid(x, y), -1)
        img = (np.concatenate([g, g[..., :1] * g[..., 1:]], -1) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    target_ratio = width / height
    if w / h > target_ratio:
        new_w = int(h * target_ratio)
        left = (w - new_w) // 2
        img = img[:, left:left + new_w]
    else:
        new_h = int(w / target_ratio)
        top = (h - new_h) // 2
        img = img[top:top + new_h]
    if img.shape[:2] != (height, width):
        image = _pillow()
        img = np.asarray(image.fromarray(img).resize((width, height),
                                                     image.Resampling.LANCZOS))
    return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


@torch.inference_mode()
def image_to_video(models: dict, wrapper: StableVideoUNet, image, clip_pixels, aug_noise,
                   latent_noise, *, num_frames: int, fps: int = 7, motion_bucket_id: int = 127,
                   noise_aug_strength: float = 0.02, guidance_scale: float = 3.0,
                   decode_chunk_frames: int = 4) -> tuple[list[torch.Tensor], dict]:
    """The app's device work on preprocessed inputs, on ``wrapper.device``.

    ``models`` holds ``clip``, ``vae_encoder``, ``unet`` and ``vae_decoder``;
    CLIP and the VAE encoder are taken out of it after the encode and the
    UNet before the decode, so that they are freed when the caller holds no
    other reference. ``image`` is ``(H, W, 3)`` in [-1, 1], ``clip_pixels``
    CLIP's ``(S, S, 3)``; ``aug_noise`` (like ``image``) and ``latent_noise``
    ``(samples, 1, F, h, w, 4)`` are standard-normal draws, scaled here by
    ``noise_aug_strength`` and the schedule's initial sigma.

    Returns the decoded videos, ``(1, F, H, W, 3)`` each, and the seconds of
    ``clip``, ``vae_encode``, ``encode`` (both and the conditioning),
    ``diffusion`` and ``decode``, each ending in a device synchronise.
    """
    dev = wrapper.device
    times = {}

    def lap(name: str, t0: float) -> float:
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = t_enc = time.perf_counter()
    clip = models.pop("clip")
    clip_embeds = clip.apply(torch.as_tensor(clip_pixels, device=dev)[None])  # (1, D)
    del clip
    _free(dev)
    t0 = lap("clip", t0)

    # VAE encode with pixel-space noise augmentation; .mode(), no scaling factor.
    vae_enc = models.pop("vae_encoder")
    noise_aug = noise_aug_strength * torch.as_tensor(aug_noise, dtype=torch.float32, device=dev)
    pixels = torch.as_tensor(image, dtype=torch.float32, device=dev)[None] + noise_aug
    image_latent = vae_enc.mode(vae_enc.apply(pixels))  # (1, h, w, 4)
    image_latents = image_latent[:, None].repeat(1, num_frames, 1, 1, 1)
    del vae_enc
    _free(dev)
    lap("vae_encode", t0)
    cond = make_conditioning(
        image_embeddings=clip_embeds, image_latents=image_latents, num_frames=num_frames,
        fps=fps, motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
        guidance_scale=guidance_scale,
    )
    t0 = lap("encode", t_enc)

    noise = torch.as_tensor(latent_noise, dtype=torch.float32, device=dev)
    noise = wrapper.pack_initial(noise * wrapper.init_noise_sigma)
    unet = models.pop("unet")
    latents = run_reference_single_device(wrapper.pipeline_step_fn(), (unet, cond), noise,
                                          wrapper.num_steps)
    latents = wrapper.unpack_final(latents)
    del unet
    _free(dev)
    t0 = lap("diffusion", t0)

    vae_dec = models["vae_decoder"]
    videos = [vae_dec.decode_chunked(lat / vae_dec.config.scaling_factor,
                                     chunk_frames=decode_chunk_frames) for lat in latents]
    lap("decode", t0)
    return videos, times


def _check_ported(args: argparse.Namespace) -> None:
    if args.solver != "euler" or args.deepcache:
        raise NotImplementedError("--solver other than euler and --deepcache come with a later "
                                  "slice of the port (ROADMAP A12)")
    if (args.num_stages or 1) != 1:
        raise NotImplementedError("--num-stages above 1 comes with the multi-GPU step pipeline "
                                  "(ROADMAP A6)")
    if args.seq_parallel != 1 or args.frame_parallel != 1 or args.decode_devices:
        raise NotImplementedError("--seq-parallel, --frame-parallel and --decode-devices come "
                                  "with intra-sample parallelism (ROADMAP A13)")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    t_start = time.perf_counter()
    if not args.checkpoint and not args.random_weights:
        LOGGER.error("provide --checkpoint or --random-weights")
        return 1
    _check_ported(args)
    dev = resolve_device(args.device)

    vae_dtype = torch.bfloat16 if args.vae_dtype == "bfloat16" else torch.float32
    if args.preset == "tiny":
        unet_cfg = SVDUNetConfig.tiny()
        vae_cfg = VAEConfig.tiny(vae_dtype)
        # CLIP's projection must match the UNet's cross-attention width.
        clip_cfg = dataclasses.replace(CLIPVisionConfig.tiny(),
                                       projection_dim=unet_cfg.cross_attention_dim)
        args.width, args.height = max(args.width, 64), max(args.height, 64)
    else:
        unet_cfg = SVDUNetConfig.svd_xt()
        vae_cfg = VAEConfig.svd(vae_dtype)
        clip_cfg = CLIPVisionConfig.vit_h_14()
    spatial_down = 2 ** (len(vae_cfg.block_out_channels) - 1)
    lat_h, lat_w = args.height // spatial_down, args.width // spatial_down
    LOGGER.info("generate: %dx%d, %d frames, %d steps on %s, CFG %.1f", args.width, args.height,
                args.num_frames, args.steps, dev, args.guidance_scale)

    # ---- models ----
    t0 = time.perf_counter()
    wrapper = StableVideoUNet(unet_cfg, num_steps=args.steps, cfg_mode=args.cfg_mode,
                              device=dev)
    if args.checkpoint and not os.path.exists(os.path.join(args.checkpoint, "unet.npz")):
        models = load_svd_checkpoint(args.checkpoint, unet_config=wrapper.config,
                                     vae_config=vae_cfg, clip_config=clip_cfg, device=dev)
        missing = {"unet", "clip", "vae_encoder", "vae_decoder"} - set(models)
        if missing:
            raise FileNotFoundError(f"{args.checkpoint}: neither unet.npz nor a diffusers "
                                    f"checkpoint with every part (missing {sorted(missing)})")
    else:
        models = {"clip": CLIPVisionEncoder(clip_cfg, device=dev),
                  "vae_encoder": VAEEncoder(vae_cfg, device=dev),
                  "vae_decoder": TemporalVAEDecoder(vae_cfg, device=dev)}
        if args.checkpoint:
            models["unet"] = SVDUNet(wrapper.config, device=dev)
            for name, carry in (("unet", from_jax_params), ("clip", from_jax_clip_params),
                                ("vae_encoder", from_jax_vae_encoder_params),
                                ("vae_decoder", from_jax_vae_decoder_params)):
                path = os.path.join(args.checkpoint, f"{name}.npz")
                models[name].load_state_dict(carry(load_jax_npz(path)))
        else:
            models["unet"] = wrapper.init(torch.Generator(device=dev).manual_seed(args.seed))
            for i, name in enumerate(("clip", "vae_encoder", "vae_decoder"), start=1):
                models[name].init_weights(torch.Generator(device=dev).manual_seed(args.seed + i))
    _sync(dev)
    t_load = time.perf_counter() - t0
    LOGGER.info("models ready in %.3fs", t_load)

    # ---- inputs: the preprocessed image and the noise draws ----
    t0 = time.perf_counter()
    image = load_and_preprocess_image(args.image, args.width, args.height)
    clip_px = preprocess_image(((image + 1.0) * 127.5).astype(np.uint8), size=clip_cfg.image_size)
    aug_noise = torch.randn(image.shape, generator=torch.Generator(device=dev).manual_seed(
        args.seed + 4), device=dev)
    latent_noise = torch.randn(args.num_samples, 1, args.num_frames, lat_h, lat_w, 4,
                               generator=torch.Generator(device=dev).manual_seed(args.seed),
                               device=dev)
    t_prep = time.perf_counter() - t0

    videos, times = image_to_video(
        models, wrapper, image, clip_px, aug_noise, latent_noise, num_frames=args.num_frames,
        fps=args.fps, motion_bucket_id=args.motion_bucket_id,
        noise_aug_strength=args.noise_aug_strength, guidance_scale=args.guidance_scale,
        decode_chunk_frames=args.decode_chunk_frames,
    )
    t_encode = t_prep + times["encode"]
    LOGGER.info("conditioning encoded in %.3fs (preprocess %.3fs, CLIP %.3fs, VAE encode %.3fs)",
                t_encode, t_prep, times["clip"], times["vae_encode"])
    LOGGER.info("diffusion [single]: %.3fs (%d samples)", times["diffusion"], args.num_samples)

    # ---- save ----
    t0 = time.perf_counter()
    os.makedirs(args.output_dir, exist_ok=True)
    outputs = []
    for i, video in enumerate(videos):
        frames = frames_to_uint8(video[0].float().cpu().numpy())
        name = build_output_name("svd", num_frames=args.num_frames, steps=args.steps, stages=1,
                                 fps=args.fps, seed=args.seed + i, ext="mp4")
        path = save_video_mp4(frames, os.path.join(args.output_dir, name), args.fps)
        save_video_gif(frames, os.path.splitext(path)[0] + ".gif", args.fps)
        outputs.append(path)
    t_save = time.perf_counter() - t0
    t_decode = times["decode"] + t_save
    LOGGER.info("decoded in %.3fs, saved in %.3fs", times["decode"], t_save)

    total = time.perf_counter() - t_start
    LOGGER.info("=" * 60)
    LOGGER.info("TIMING  load %.3fs | encode %.3fs | diffusion %.3fs | decode+save %.3fs | "
                "total %.3fs", t_load, t_encode, times["diffusion"], t_decode, total)
    for p in outputs:
        LOGGER.info("output: %s", p)
    LOGGER.info("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
