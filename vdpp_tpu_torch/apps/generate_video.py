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

``--solver`` is euler, euler_a (its noise seeded by ``--sampler-seed``),
heun or dpmpp2m; ``--deepcache N`` runs the whole UNet every N steps and its
shallow ``--deepcache-split`` levels between, on a cached deep feature that
rides the pipeline payload (not with heun). ``--num-stages`` defaults to every
card (1 on the CPU), as the reference's does. The denoise is the step
pipeline: one stage runs in this process, S stages one process each
(``parallel/mesh.py``: NCCL with a card per stage, gloo on the CPU). Rank 0
builds CLIP and the VAE encoder, encodes and broadcasts the conditioning;
every rank builds the UNet from the same checkpoint or seed and runs its
slice of the steps; every rank frees its UNet and builds the decoder, and
the ranks decode the finished samples chunk-parallel
(``TemporalVAEDecoder.decode_data_parallel``: chunk j on rank j mod R),
gathered to the last rank, which writes the files.
``--seq-parallel N`` and ``--frame-parallel N`` make each stage a block of
ranks that split each UNet forward over the latent's W axis and its frames
(``make_axes_mesh``). ``--decode-devices D`` reserves D decode ranks after
the stage ranks (``make_pipeline_and_decode_mesh``): the ticked pipeline
hands each sample, the moment it finishes, from the first rank of the last
stage to the decode ranks, which decode it chunk-parallel while later
samples denoise; decode rank 0 writes the files. The files are the same
byte for byte for any stage count, axis and decode layout (each chunk is
decoded alone, at the same shape, whatever rank takes it). The encode,
denoise and decode pieces here are shared with ``apps.restyle_video`` and
``apps.generate_video_long``.
Without a CUDA device the app fails unless ``--device cpu`` is asked for.
The ``tiny`` preset is a CPU preset: its UNet's head dim 16 (and its VAE's
32) at L >= 512 has no flash kernel, so on the card it raises there.
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
from vdpp_tpu_torch.models.svd_wrapper import (
    StableVideoUNet,
    SVDConditioning,
    make_conditioning,
)
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig, VAEEncoder
from vdpp_tpu_torch.parallel.collectives import broadcast
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_and_decode_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    StepPipeline,
    run_reference_single_device,
)
from vdpp_tpu_torch.utils.kernels import launch_counts, launches_since
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
    p.add_argument("--num-stages", type=int, default=None,
                   help="pipeline stages, one process each (default: every card; 1 on the CPU)")
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--cfg-mode", default="sequential", choices=["sequential", "batched"])
    add_solver_args(p)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--motion-bucket-id", type=int, default=127)
    p.add_argument("--noise-aug-strength", type=float, default=0.02)
    p.add_argument("--decode-chunk-frames", type=int, default=4)
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="halo-exchange W sharding width per stage (latent W must divide by "
                        "sp x 2^(levels-1))")
    p.add_argument("--frame-parallel", type=int, default=1,
                   help="frame sharding width per stage (--num-frames must divide by it)")
    p.add_argument("--decode-devices", type=int, default=0,
                   help="reserve this many ranks (after the stage ranks) for the VAE decode, "
                        "and decode each sample while the later ones denoise; 0 = decode after "
                        "the diffusion on every rank")
    p.add_argument("--vae-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="VAE compute dtype (bfloat16 halves decode memory)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="an explicit device per rank, in rank order; a card named more than "
                        "once is shared by its ranks over gloo")
    p.add_argument("--log-level", default="INFO")
    return p


def add_solver_args(p: argparse.ArgumentParser) -> None:
    """``--solver``, ``--sampler-seed``, ``--deepcache``, ``--deepcache-split``."""
    p.add_argument("--solver", default="euler", choices=["euler", "euler_a", "heun", "dpmpp2m"],
                   help="euler (the reference semantics), euler_a (ancestral), heun (2 UNet "
                        "evals a step) or dpmpp2m (DPM-Solver++ 2M, 1 eval a step)")
    p.add_argument("--sampler-seed", type=int, default=0,
                   help="euler_a only: seed of the per-step injected noise")
    p.add_argument("--deepcache", type=int, default=0, metavar="N",
                   help="DeepCache: the whole UNet every N steps, its shallow levels between "
                        "(0 = off; changes the output)")
    p.add_argument("--deepcache-split", type=int, default=1,
                   help="shallow levels a cache step still computes")


def make_wrapper(args: argparse.Namespace, unet_cfg: SVDUNetConfig, dev: torch.device,
                 **kw) -> StableVideoUNet:
    """The SVD wrapper from the app's solver and cache flags."""
    return StableVideoUNet(unet_cfg, num_steps=args.steps, cfg_mode=args.cfg_mode,
                           solver=args.solver, sampler_seed=args.sampler_seed,
                           deepcache_interval=args.deepcache,
                           deepcache_split=args.deepcache_split, device=dev, **kw)


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


def _encode(models: dict, dev: torch.device, image, clip_pixels, aug_noise, times: dict, *,
            num_frames: int, fps: int, motion_bucket_id: int, noise_aug_strength: float,
            guidance_scale: float, keep: bool = False):
    """CLIP and the VAE encode into the conditioning; both encoders are taken
    out of ``models`` and freed, unless ``keep``. Adds ``clip``,
    ``vae_encode`` and ``encode`` seconds to ``times``."""
    take = models.get if keep else models.pop

    def lap(name: str, t0: float) -> float:
        _sync(dev)
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = t_enc = time.perf_counter()
    clip = take("clip")
    clip_embeds = clip.apply(torch.as_tensor(clip_pixels, device=dev)[None])  # (1, D)
    del clip
    if not keep:
        _free(dev)
    t0 = lap("clip", t0)

    # VAE encode with pixel-space noise augmentation; .mode(), no scaling factor.
    vae_enc = take("vae_encoder")
    noise_aug = noise_aug_strength * torch.as_tensor(aug_noise, dtype=torch.float32, device=dev)
    pixels = torch.as_tensor(image, dtype=torch.float32, device=dev)[None] + noise_aug
    image_latent = vae_enc.mode(vae_enc.apply(pixels))  # (1, h, w, 4)
    image_latents = image_latent[:, None].repeat(1, num_frames, 1, 1, 1)
    del vae_enc
    if not keep:
        _free(dev)
    lap("vae_encode", t0)
    cond = make_conditioning(
        image_embeddings=clip_embeds, image_latents=image_latents, num_frames=num_frames,
        fps=fps, motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
        guidance_scale=guidance_scale,
    )
    lap("encode", t_enc)
    return cond


def _decode(vae_dec: TemporalVAEDecoder, latents: torch.Tensor,
            chunk_frames: int) -> list[torch.Tensor]:
    return [vae_dec.decode_chunked(lat / vae_dec.config.scaling_factor, chunk_frames=chunk_frames)
            for lat in latents]


@torch.inference_mode()
def image_to_video(models: dict, wrapper: StableVideoUNet, image, clip_pixels, aug_noise,
                   latent_noise, *, num_frames: int, fps: int = 7, motion_bucket_id: int = 127,
                   noise_aug_strength: float = 0.02, guidance_scale: float = 3.0,
                   decode_chunk_frames: int = 4) -> tuple[list[torch.Tensor], dict]:
    """The app's device work on preprocessed inputs, on ``wrapper.device``,
    every step in this process (the composition the app's stages split).

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
    times: dict = {}
    cond = _encode(models, dev, image, clip_pixels, aug_noise, times, num_frames=num_frames,
                   fps=fps, motion_bucket_id=motion_bucket_id,
                   noise_aug_strength=noise_aug_strength, guidance_scale=guidance_scale)

    t0 = time.perf_counter()
    noise = torch.as_tensor(latent_noise, dtype=torch.float32, device=dev)
    noise = wrapper.pack_initial(noise * wrapper.init_noise_sigma)
    unet = models.pop("unet")
    latents = run_reference_single_device(wrapper.pipeline_step_fn(), (unet, cond), noise,
                                          wrapper.num_steps)
    latents = wrapper.unpack_final(latents)
    del unet
    _free(dev)
    _sync(dev)
    times["diffusion"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    videos = _decode(models["vae_decoder"], latents, decode_chunk_frames)
    _sync(dev)
    times["decode"] = time.perf_counter() - t0
    return videos, times


def check_axes(args: argparse.Namespace, unet_cfg: SVDUNetConfig, lat_w: int) -> bool:
    """The reference's checks of the intra-sample flags (each logs an error
    and the app returns 1)."""
    sp, fp = args.seq_parallel, args.frame_parallel
    if sp > 1 and lat_w % unet_cfg.seq_min_divisor(sp) != 0:
        LOGGER.error("--seq-parallel %d: latent width %d must divide by sp x 2^(levels-1) = %d",
                     sp, lat_w, unet_cfg.seq_min_divisor(sp))
        return False
    if fp > 1 and args.num_frames % fp != 0:
        LOGGER.error("--frame-parallel %d: --num-frames %d must divide by it", fp,
                     args.num_frames)
        return False
    return True


def model_configs(args: argparse.Namespace):
    """The preset's UNet, VAE and CLIP configs."""
    vae_dtype = torch.bfloat16 if args.vae_dtype == "bfloat16" else torch.float32
    if args.preset == "tiny":
        unet_cfg, vae_cfg = SVDUNetConfig.tiny(), VAEConfig.tiny(vae_dtype)
        # CLIP's projection must match the UNet's cross-attention width.
        clip_cfg = dataclasses.replace(CLIPVisionConfig.tiny(),
                                       projection_dim=unet_cfg.cross_attention_dim)
    else:
        unet_cfg, vae_cfg = SVDUNetConfig.svd_xt(), VAEConfig.svd(vae_dtype)
        clip_cfg = CLIPVisionConfig.vit_h_14()
    return unet_cfg, vae_cfg, clip_cfg


def _configs(args: argparse.Namespace):
    """:func:`model_configs` and the latent's (h, w) (the tiny preset widens
    the frame to at least 64x64 in ``args``)."""
    unet_cfg, vae_cfg, clip_cfg = model_configs(args)
    if args.preset == "tiny":
        args.width, args.height = max(args.width, 64), max(args.height, 64)
    spatial_down = 2 ** (len(vae_cfg.block_out_channels) - 1)
    return unet_cfg, vae_cfg, clip_cfg, (args.height // spatial_down, args.width // spatial_down)


_SEED_OFFSET = {"unet": 0, "clip": 1, "vae_encoder": 2, "vae_decoder": 3}


def _load_models(args: argparse.Namespace, wrapper: StableVideoUNet, vae_cfg: VAEConfig,
                 clip_cfg: CLIPVisionConfig, names) -> dict:
    """The modules ``names`` (of ``unet``, ``clip``, ``vae_encoder``,
    ``vae_decoder``) on ``wrapper.device``: from ``--checkpoint`` (the JAX
    package's npz files, or a diffusers directory), or drawn each from its
    own seed, so that any subset is the same as in the whole."""
    dev = wrapper.device
    if args.checkpoint and not os.path.exists(os.path.join(args.checkpoint, "unet.npz")):
        models = load_svd_checkpoint(args.checkpoint, unet_config=wrapper.config,
                                     vae_config=vae_cfg, clip_config=clip_cfg, device=dev,
                                     parts=names)
        missing = set(names) - set(models)
        if missing:
            raise FileNotFoundError(f"{args.checkpoint}: neither unet.npz nor a diffusers "
                                    f"checkpoint with every part (missing {sorted(missing)})")
        return models
    build = {"unet": lambda: SVDUNet(wrapper.config, device=dev),
             "clip": lambda: CLIPVisionEncoder(clip_cfg, device=dev),
             "vae_encoder": lambda: VAEEncoder(vae_cfg, device=dev),
             "vae_decoder": lambda: TemporalVAEDecoder(vae_cfg, device=dev)}
    carry = {"unet": from_jax_params, "clip": from_jax_clip_params,
             "vae_encoder": from_jax_vae_encoder_params, "vae_decoder": from_jax_vae_decoder_params}
    models = {}
    for name in names:
        models[name] = build[name]()
        if args.checkpoint:
            path = os.path.join(args.checkpoint, f"{name}.npz")
            models[name].load_state_dict(carry[name](load_jax_npz(path)))
        else:
            models[name].init_weights(torch.Generator(device=dev).manual_seed(
                args.seed + _SEED_OFFSET[name]))
    return models


def _prepare(args: argparse.Namespace, clip_cfg: CLIPVisionConfig, dev: torch.device):
    """The preprocessed image, CLIP's pixels and the augmentation noise."""
    image = load_and_preprocess_image(args.image, args.width, args.height)
    clip_px = preprocess_image(((image + 1.0) * 127.5).astype(np.uint8), size=clip_cfg.image_size)
    aug_noise = seeded_normal(args.seed + 4, image.shape, dev)
    return image, clip_px, aug_noise


def seeded_normal(seed: int, shape, dev: torch.device) -> torch.Tensor:
    """A standard-normal draw of ``shape`` from a generator on ``dev``."""
    return torch.randn(tuple(shape), generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def _latent_noise(args: argparse.Namespace, lat_hw, dev: torch.device):
    return seeded_normal(args.seed, (args.num_samples, 1, args.num_frames, *lat_hw, 4), dev)


def _save(args: argparse.Namespace, videos, stages: int, prefix: str = "svd",
          steps: int | None = None, fps: int | None = None, index: int = 0) -> list[str]:
    """Each ``(1, F, H, W, 3)`` video in [-1, 1] as MP4 (or its stand-in)
    and GIF under ``--output-dir``, the first as sample ``index`` (its
    seed's offset); returns the MP4 paths."""
    os.makedirs(args.output_dir, exist_ok=True)
    fps = args.fps if fps is None else fps
    outputs = []
    for i, video in enumerate(videos, start=index):
        video = video[0]
        frames = frames_to_uint8(video.float().cpu().numpy() if torch.is_tensor(video) else video)
        name = build_output_name(prefix, num_frames=frames.shape[0],
                                 steps=args.steps if steps is None else steps, stages=stages,
                                 fps=fps, seed=args.seed + i, ext="mp4")
        path = save_video_mp4(frames, os.path.join(args.output_dir, name), fps)
        save_video_gif(frames, os.path.splitext(path)[0] + ".gif", fps)
        outputs.append(path)
    return outputs


def _share(stage: Stage, obj, src: int = 0):
    """A tuple of tensors (or None, or a conditioning) from rank ``src`` on
    every rank, moved to each rank's device."""
    def to(v, dev):
        if isinstance(v, SVDConditioning):
            return SVDConditioning(**{k: to(x, dev) for k, x in vars(v).items()})
        return v.to(dev) if torch.is_tensor(v) else v

    sent = None if obj is None else tuple(to(v, "cpu") for v in obj)
    return tuple(to(v, stage.device) for v in stage.broadcast_object(sent, src=src))


def _log_timing(t_load: float, t_encode: float, t_diffusion: float, t_decode: float,
                total: float, outputs: list[str]) -> dict:
    """Log the TIMING line and the outputs; returns the line's seconds."""
    LOGGER.info("=" * 60)
    LOGGER.info("TIMING  load %.3fs | encode %.3fs | diffusion %.3fs | decode+save %.3fs | "
                "total %.3fs", t_load, t_encode, t_diffusion, t_decode, total)
    for p in outputs:
        LOGGER.info("output: %s", p)
    LOGGER.info("=" * 60)
    return {"load": t_load, "encode": t_encode, "diffusion": t_diffusion,
            "decode_save": t_decode, "total": total}


def _logging(level: str, prefix: str = "") -> None:
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        format=f"%(asctime)s %(levelname)s {prefix}%(name)s: %(message)s")


def main(argv: list[str] | None = None) -> int:
    return 1 if run(argv) is None else 0


def run(argv: list[str] | None = None) -> list[dict] | None:
    """What ``main`` runs: each rank's result in rank order (``outputs``, the
    paths of the files on the rank that wrote them, else None; ``launches``,
    the kernels it launched from the denoise on; ``timing``, the writer's
    TIMING seconds), each rank's launches logged; None when the flags are
    refused (logged)."""
    args = build_parser().parse_args(argv)
    _logging(args.log_level)
    t_start = time.perf_counter()
    if not args.checkpoint and not args.random_weights:
        LOGGER.error("provide --checkpoint or --random-weights")
        return None
    unet_cfg, _, _, lat_hw = _configs(args)
    if not check_axes(args, unet_cfg, lat_hw[1]):
        return None
    mesh = make_pipeline_and_decode_mesh(args.num_stages, args.decode_devices,
                                         device=args.device, devices=args.devices,
                                         seq=args.seq_parallel, frame=args.frame_parallel)
    PipelineConfig(args.steps, mesh.num_stages)  # a bad split fails before any rank starts
    if mesh.world_size == 1:
        ranks = [_stage_main(Stage(mesh, 0), args, t_start)]
    else:
        ranks = run_stages(mesh, _stage_main, args, t_start)
    for r, res in enumerate(ranks):
        LOGGER.info("rank %d (%s%s) launched from the denoise on: %s", r, mesh.devices[r],
                    ", decode" if r >= mesh.stage_ranks else "", res["launches"])
    return ranks


def _stage_main(stage: Stage, args: argparse.Namespace, t_start: float) -> dict:
    """One rank of the run, in this process when there is one rank, else in
    its own: rank 0 encodes and broadcasts the conditioning, every stage rank
    denoises its slice of the steps and frees its UNet. Without decode ranks
    every rank then decodes its chunks of each finished sample and the last
    rank writes the files; a decode rank decodes each sample as it arrives
    and decode rank 0 writes them. Returns ``{"outputs", "launches",
    "timing"}`` (see :func:`run`); the launches are counted after the
    encode."""
    before = None

    def result(outputs: list[str] | None = None, timing: dict | None = None) -> dict:
        return {"outputs": outputs, "launches": launches_since(before), "timing": timing}

    if stage.mesh.world_size > 1:  # a spawned rank starts with no logging set up
        _logging(args.log_level, f"rank {stage.rank}/{stage.mesh.world_size} ")
    dev = stage.device
    if dev.type == "cuda":
        # The same bits in every process: the files are byte-equal for any
        # layout of the ranks.
        torch.backends.cudnn.deterministic = True
    unet_cfg, vae_cfg, clip_cfg, lat_hw = _configs(args)
    mesh = stage.mesh
    if stage.rank == 0:
        LOGGER.info("generate: %dx%d, %d frames, %d steps on %s, CFG %.1f, %d stage(s)%s",
                    args.width, args.height, args.num_frames, args.steps, dev,
                    args.guidance_scale, stage.num_stages,
                    f", {mesh.decode} decode rank(s)" if mesh.decode else "")
    t0 = time.perf_counter()
    wrapper = make_wrapper(args, unet_cfg, dev)
    names = (["vae_decoder"] if stage.is_decode else
             ["unet", "clip", "vae_encoder"] if stage.rank == 0 else ["unet"])
    models = _load_models(args, wrapper, vae_cfg, clip_cfg, names)
    _sync(dev)
    t_load = time.perf_counter() - t0
    LOGGER.info("models ready in %.3fs", t_load)

    sent = None
    if stage.rank == 0:
        t0 = time.perf_counter()
        image, clip_px, aug_noise = _prepare(args, clip_cfg, dev)
        t_prep = time.perf_counter() - t0
        times: dict = {}
        with torch.inference_mode():
            cond = _encode(models, dev, image, clip_px, aug_noise, times,
                           num_frames=args.num_frames, fps=args.fps,
                           motion_bucket_id=args.motion_bucket_id,
                           noise_aug_strength=args.noise_aug_strength,
                           guidance_scale=args.guidance_scale)
        t_encode = t_prep + times["encode"]
        LOGGER.info("conditioning encoded in %.3fs (preprocess %.3fs, CLIP %.3fs, VAE encode "
                    "%.3fs)", t_encode, t_prep, times["clip"], times["vae_encode"])
        sent = (cond, t_encode)
    cond, t_encode = _share(stage, sent)
    noise = wrapper.pack_initial(_latent_noise(args, lat_hw, dev) * wrapper.init_noise_sigma)
    before = launch_counts()
    if stage.is_decode:
        return result(*_decode_rank(stage, args, wrapper, models.pop("vae_decoder"), noise,
                                    (t_load, t_encode, t_start)))

    t0 = time.perf_counter()
    pipe = StepPipeline(stage, wrapper.pipeline_step_fn(**stage.axes),
                        PipelineConfig(wrapper.num_steps, stage.num_stages))
    params = (models.pop("unet"), cond)
    if mesh.decode:
        # The overlapped decode: each sample goes to the decode ranks the
        # moment it finishes; the sends are waited on after the last tick.
        pending: list = []

        def on_sample(i: int, latent: torch.Tensor) -> None:
            if stage.is_decode_sender:
                pending.extend(stage.send_to_decode(latent))

        pipe.run_ticked(params, noise, on_sample=on_sample)
        for work, _ in pending:
            work.wait()
        del params
        _free(dev)
        _sync(dev)
        if stage.is_last_rank:
            LOGGER.info("diffusion [%d stage(s)]: %.3fs (%d samples, decoded on %d rank(s))",
                        stage.num_stages, time.perf_counter() - t0, args.num_samples,
                        mesh.decode)
        return result()
    latents = pipe.run(params, noise)
    del params
    _free(dev)
    _sync(dev)
    t_diffusion = time.perf_counter() - t0
    if stage.is_last_rank:
        LOGGER.info("diffusion [%d stage(s)]: %.3fs (%d samples)", stage.num_stages,
                    t_diffusion, args.num_samples)

    # The decode over every rank the diffusion used (chunk j on rank j mod R),
    # gathered to the last rank, which writes the files.
    t0 = time.perf_counter()
    vae_dec = _load_models(args, wrapper, vae_cfg, clip_cfg, ["vae_decoder"])["vae_decoder"]
    _sync(dev)
    t_load += time.perf_counter() - t0
    t0 = time.perf_counter()
    axis = stage.ranks_axis() if mesh.world_size > 1 else None
    root = mesh.world_size - 1
    if axis is not None:  # the latents from the last rank, which holds them
        latents = broadcast(latents if stage.is_last_rank else noise, axis, root)
    with torch.inference_mode():
        videos = [vae_dec.decode_data_parallel(lat / vae_dec.config.scaling_factor, axis,
                                               args.decode_chunk_frames, root)
                  for lat in wrapper.unpack_final(latents)]
    _sync(dev)
    if not stage.is_last_rank:
        return result()
    t_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    outputs = _save(args, videos, stage.num_stages)
    t_save = time.perf_counter() - t0
    LOGGER.info("decoded in %.3fs on %d rank(s), saved in %.3fs", t_decode, mesh.world_size,
                t_save)
    timing = _log_timing(t_load, t_encode, t_diffusion, t_decode + t_save,
                         time.perf_counter() - t_start, outputs)
    return result(outputs, timing)


def _decode_rank(stage: Stage, args: argparse.Namespace, wrapper: StableVideoUNet,
                 vae_dec: TemporalVAEDecoder, noise: torch.Tensor,
                 times: tuple[float, float, float]) -> tuple[list[str] | None, dict | None]:
    """A reserved decode rank: receive each finished sample from the stage
    ranks, decode it chunk-parallel over the decode ranks and, on decode rank
    0, write its files. The TIMING line's diffusion is the wait for the last
    sample (the earlier samples' decodes overlap it), its decode+save what
    follows. Returns the files' paths and the TIMING seconds, with
    ``overlapped``, the decode and save seconds spent while the stage ranks
    denoised, on decode rank 0; (None, None) on the others."""
    t_load, t_encode, t_start = times
    axis = stage.decode_axis
    writer = axis.index == 0
    t0 = time.perf_counter()
    busy, outputs = 0.0, []
    for i in range(args.num_samples):
        latent = stage.receive_sample(noise[i])
        t_got = time.perf_counter()
        with torch.inference_mode():
            lat = wrapper.unpack_final(latent)
            video = vae_dec.decode_data_parallel(lat / vae_dec.config.scaling_factor, axis,
                                                 args.decode_chunk_frames)
        _sync(stage.device)
        if writer:
            outputs += _save(args, [video], stage.num_stages, index=i)
        busy += time.perf_counter() - t_got
        if i == args.num_samples - 1:
            t_diffusion = t_got - t0
            t_tail = time.perf_counter() - t_got
    if not writer:
        return None, None
    LOGGER.info("decode ranks: %d sample(s) decoded and saved in %.3fs on %d rank(s), %.3fs of "
                "it while the stage ranks denoised", args.num_samples, busy, axis.size,
                busy - t_tail)
    timing = _log_timing(t_load, t_encode, t_diffusion, t_tail, time.perf_counter() - t_start,
                         outputs)
    return outputs, {**timing, "overlapped": busy - t_tail}


if __name__ == "__main__":
    sys.exit(main())
