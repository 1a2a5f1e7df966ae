"""Text -> video generation (T5-conditioned video DiT) on one CUDA device.

    python -m vdpp_tpu_torch.apps.generate_video_text --prompt "a red panda" --random-weights
    python -m vdpp_tpu_torch.apps.generate_video_text --random-weights --preset tiny --device cpu

The port's counterpart of ``scripts/generate_video_text.py``: T5 text encoder
-> cross-attended video DiT (``--attention-mode joint3d``, the default, or
``factorized``) -> chunked temporal VAE decode -> video files. The T5 weights
are freed after the encode. The ``xl`` preset is T5-v1.1-XXL, DiT-XL with
4096-wide cross-attention, and the SVD temporal VAE decoder in fp32, at 8
frames of 512x320 (a 40x64 latent) and 24 Euler steps with a per-frame CFG
ramp to 6.

Tokenization: real T5 tokenization needs the sentencepiece vocabulary that
ships with a checkpoint. With ``--checkpoint`` pass ``--token-ids`` or
``--token-ids-file``; otherwise a deterministic hash of the prompt's words
stands in. ``--checkpoint`` is a directory of the JAX package's own
``save_params`` files (``t5.npz``, ``dit.npz``, ``vae_decoder.npz``).

``--solver`` is euler, euler_a (its noise seeded by ``--sampler-seed``), heun,
dpmpp2m or flowmatch. ``--num-stages`` defaults to every card (1 on the CPU),
as the reference's does. The denoise is the step pipeline: one stage runs in
this process, S stages one process each (``parallel/mesh.py``). Rank 0 runs
T5 and broadcasts the context, every rank builds the DiT from the same
checkpoint or seed, and the last rank builds the decoder, decodes and writes
the files, the same byte for byte for any stage count. ``--seq-parallel N``
splits each DiT forward's tokens over N ranks (``DiTVideo.forward(
seq_axis=)``): with ``--num-stages`` above 1 each stage is a block of N seq
ranks of the step pipeline, otherwise ``SequenceParallelRunner`` runs each
sample's whole schedule on the N ranks. ``--devices`` names a device a rank
(a card named twice is shared over gloo). Without a CUDA device the app
fails unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import numpy as np
import torch

from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig, DiTVideoWrapper
from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig, T5TextEncoder, hash_tokenize
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.parallel.mesh import Stage, make_axes_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.parallel.sequence_parallel import SequenceParallelRunner
from vdpp_tpu_torch.utils.video_io import (
    build_output_name,
    frames_to_uint8,
    save_video_gif,
    save_video_mp4,
)
from vdpp_tpu_torch.utils.weights import (
    from_jax_dit_params,
    from_jax_t5_params,
    from_jax_vae_decoder_params,
    load_jax_npz,
)

LOGGER = logging.getLogger("vdpp_torch.generate_text")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--prompt", default="a video")
    p.add_argument("--negative-prompt", default=None,
                   help="condition the uncond CFG branch on this prompt's encoding instead "
                        "of zeros (needs --guidance-scale > 1)")
    p.add_argument("--negative-token-ids", default=None,
                   help="comma-separated token ids for the negative prompt")
    p.add_argument("--token-ids", default=None,
                   help="comma-separated token ids (overrides --prompt hashing)")
    p.add_argument("--token-ids-file", default=None, help=".npy int array of token ids")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--preset", default="xl", choices=["xl", "tiny"])
    p.add_argument("--attention-mode", default="joint3d", choices=["factorized", "joint3d"])
    p.add_argument("--checkpoint", default=None,
                   help="directory of the JAX package's weight files (t5.npz, dit.npz, "
                        "vae_decoder.npz)")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--num-frames", type=int, default=8)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--solver", default="euler",
                   choices=["euler", "euler_a", "heun", "dpmpp2m", "flowmatch"],
                   help="euler, euler_a, heun or dpmpp2m (v-prediction over Karras sigmas) "
                        "or flowmatch (rectified flow, shifted-linear schedule)")
    p.add_argument("--flow-shift", type=float, default=3.0,
                   help="flowmatch only: resolution shift of the sigma schedule")
    p.add_argument("--num-stages", type=int, default=None,
                   help="pipeline stages, one process each (default: every card; 1 on the CPU)")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="token sharding width per stage: each DiT forward's tokens split over "
                        "this many ranks")
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--guidance-scale", type=float, default=6.0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--decode-chunk-frames", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler-seed", type=int, default=0,
                   help="euler_a only: seed of the per-step injected noise")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--devices", nargs="+", default=None, metavar="DEV",
                   help="an explicit device per rank, in rank order; a card named more than "
                        "once is shared by its ranks over gloo")
    p.add_argument("--log-level", default="INFO")
    return p


def _ids(text: str) -> np.ndarray:
    return np.asarray([int(t) for t in text.split(",")], np.int64).reshape(1, -1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _configs(args: argparse.Namespace):
    """The preset's T5, DiT and VAE configs (the tiny preset shrinks the
    frame to at most 64x64 in ``args``)."""
    if args.preset == "tiny":
        t5_cfg, dit_base, vae_cfg = (T5EncoderConfig.tiny(), DiTVideoConfig.tiny(),
                                     VAEConfig.tiny())
        args.width, args.height = min(args.width, 64), min(args.height, 64)
    else:
        t5_cfg, dit_base, vae_cfg = (T5EncoderConfig.xxl(), DiTVideoConfig.latte_xl(),
                                     VAEConfig.svd(torch.float32))
    dit_cfg = dataclasses.replace(dit_base, cross_attention_dim=t5_cfg.d_model,
                                  attention_mode=args.attention_mode)
    spatial_down = 2 ** (len(vae_cfg.block_out_channels) - 1)
    return t5_cfg, dit_cfg, vae_cfg, (args.height // spatial_down, args.width // spatial_down)


def _token_ids(args: argparse.Namespace, t5_cfg: T5EncoderConfig):
    """The prompt's token ids and the negative prompt's (or None)."""
    if args.token_ids_file:
        ids = np.load(args.token_ids_file).astype(np.int64).reshape(1, -1)
    elif args.token_ids:
        ids = _ids(args.token_ids)
    else:
        ids = np.asarray(hash_tokenize(args.prompt, t5_cfg.vocab_size, args.max_tokens),
                         np.int64).reshape(1, -1)
        if args.checkpoint:
            LOGGER.warning("hash tokenizer with real weights: pass --token-ids for meaningful "
                           "conditioning")
    neg_ids = None
    if args.negative_token_ids:
        neg_ids = _ids(args.negative_token_ids)
    elif args.negative_prompt is not None:
        neg_ids = np.asarray(hash_tokenize(args.negative_prompt, t5_cfg.vocab_size,
                                           args.max_tokens), np.int64).reshape(1, -1)
    if neg_ids is not None:
        # Equal token counts, as the reference pads them: right-pad the
        # shorter list with the hash tokenizer's EOS (vocab_size - 1).
        eos = t5_cfg.vocab_size - 1
        want = max(ids.shape[1], neg_ids.shape[1])
        ids = np.pad(ids, ((0, 0), (0, want - ids.shape[1])), constant_values=eos)
        neg_ids = np.pad(neg_ids, ((0, 0), (0, want - neg_ids.shape[1])), constant_values=eos)
    return ids, neg_ids


def _load(args: argparse.Namespace, name: str, module: torch.nn.Module, seed: int):
    """``module`` with its weights from ``--checkpoint`` (``<name>.npz``) or
    drawn from ``seed``."""
    carry = {"t5": from_jax_t5_params, "dit": from_jax_dit_params,
             "vae_decoder": from_jax_vae_decoder_params}[name]
    if args.checkpoint:
        module.load_state_dict(carry(load_jax_npz(os.path.join(args.checkpoint, f"{name}.npz"))))
    else:
        module.init_weights(torch.Generator(device=next(module.parameters()).device)
                            .manual_seed(seed))
    return module


def _encode(t5: T5TextEncoder, ids, neg_ids, dev: torch.device):
    """The T5 context, or ``(negative, positive)`` for negative-prompt CFG."""
    ctx = t5(torch.as_tensor(ids, device=dev)).float()  # (1, M, D)
    if neg_ids is not None:
        ctx = (t5(torch.as_tensor(neg_ids, device=dev)).float(), ctx)
    return ctx


def _noise(args: argparse.Namespace, wrapper: DiTVideoWrapper, lat_hw, dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(args.seed + 3)
    noise = torch.randn(args.num_samples, 1, args.num_frames, *lat_hw,
                        wrapper.config.in_channels, generator=g, device=dev)
    return wrapper.pack_initial(noise * wrapper.init_noise_sigma)


def _decode_and_save(args: argparse.Namespace, vae: TemporalVAEDecoder, latents: torch.Tensor,
                     stages: int) -> list[str]:
    os.makedirs(args.output_dir, exist_ok=True)
    outputs = []
    for i in range(args.num_samples):
        video = vae.decode_chunked(latents[i] / vae.config.scaling_factor,
                                   chunk_frames=args.decode_chunk_frames)
        frames = frames_to_uint8(video[0].float().cpu().numpy())
        name = build_output_name("dit_text", num_frames=args.num_frames, steps=args.steps,
                                 stages=stages, fps=args.fps, seed=args.seed + i, ext="mp4")
        path = save_video_mp4(frames, os.path.join(args.output_dir, name), args.fps)
        save_video_gif(frames, os.path.splitext(path)[0] + ".gif", args.fps)
        outputs.append(path)
    return outputs


def _log_timing(t_load, t_encode, t_diffusion, t_decode, total, outputs) -> None:
    LOGGER.info("=" * 60)
    LOGGER.info("TIMING  load %.1fs | encode %.1fs | diffusion %.1fs | decode+save %.1fs | "
                "total %.1fs", t_load, t_encode, t_diffusion, t_decode, total)
    for p in outputs:
        LOGGER.info("output: %s", p)
    LOGGER.info("=" * 60)


def _logging(level: str, prefix: str = "") -> None:
    logging.basicConfig(level=getattr(logging, level.upper(), logging.INFO),
                        format=f"%(asctime)s %(levelname)s {prefix}%(name)s: %(message)s")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _logging(args.log_level)
    t_start = time.perf_counter()
    if not args.checkpoint and not args.random_weights:
        LOGGER.error("provide --checkpoint or --random-weights")
        return 1
    if (args.negative_prompt is not None or args.negative_token_ids) and (
            args.guidance_scale is None or args.guidance_scale <= 1.0):
        LOGGER.error("--negative-prompt needs CFG: set --guidance-scale > 1.0 (got %s)",
                     args.guidance_scale)
        return 1
    t5_cfg, dit_cfg, vae_cfg, lat_hw = _configs(args)
    if lat_hw[0] % dit_cfg.patch_size or lat_hw[1] % dit_cfg.patch_size:
        LOGGER.error("latent %dx%d not divisible by patch size", *lat_hw)
        return 1
    # With --seq-parallel and neither --num-stages nor --devices one stage of
    # seq ranks runs, as in the reference.
    stages = args.num_stages
    if stages is None and args.seq_parallel > 1 and args.devices is None:
        stages = 1
    mesh = make_axes_mesh(stages, seq=args.seq_parallel, device=args.device, devices=args.devices)
    PipelineConfig(args.steps, mesh.num_stages)  # a bad split fails before any rank starts
    if mesh.world_size == 1:
        _stage_main(Stage(mesh, 0), args, t_start)
    else:
        run_stages(mesh, _stage_main, args, t_start)
    return 0


def _stage_main(stage: Stage, args: argparse.Namespace, t_start: float) -> list[str] | None:
    """One rank of the run, in this process when there is one rank, else in
    its own: rank 0 runs T5 and broadcasts the context, every rank denoises
    (its stage's slice of the steps, its share of the tokens), and the last
    rank builds the decoder, decodes and writes the files (whose paths it
    returns)."""
    if stage.mesh.world_size > 1:  # a spawned rank starts with no logging set up
        _logging(args.log_level, f"rank {stage.rank}/{stage.mesh.world_size} ")
    dev = stage.device
    t5_cfg, dit_cfg, vae_cfg, lat_hw = _configs(args)
    t0 = time.perf_counter()
    wrapper = DiTVideoWrapper(dit_cfg, num_steps=args.steps, solver=args.solver,
                              flow_shift=args.flow_shift, sampler_seed=args.sampler_seed,
                              device=dev)
    dit = _load(args, "dit", DiTVideo(dit_cfg, device=dev), args.seed + 1)
    _sync(dev)
    t_load = time.perf_counter() - t0
    LOGGER.info("DiT ready in %.1fs", t_load)

    sent = None
    if stage.rank == 0:
        t0 = time.perf_counter()
        ids, neg_ids = _token_ids(args, t5_cfg)
        t5 = _load(args, "t5", T5TextEncoder(t5_cfg, device=dev), args.seed)
        ctx = _encode(t5, ids, neg_ids, dev)
        del t5
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_encode = time.perf_counter() - t0
        LOGGER.info("T5 built and text encoded in %.1fs (%d tokens)", t_encode, ids.shape[1])
        sent = (tuple(c.cpu() for c in ctx) if isinstance(ctx, tuple) else ctx.cpu(), t_encode)
    ctx, t_encode = stage.broadcast_object(sent)
    ctx = tuple(c.to(dev) for c in ctx) if isinstance(ctx, tuple) else ctx.to(dev)
    guidance = make_guidance_ramp(args.guidance_scale, args.num_frames, device=dev)

    t0 = time.perf_counter()
    noise = _noise(args, wrapper, lat_hw, dev)
    sp = args.seq_parallel
    if sp > 1 and stage.num_stages == 1:
        runner = SequenceParallelRunner(stage, wrapper)
        latents = torch.stack([runner.run(dit, x, ctx, guidance) for x in noise])
        mode = f"sp{sp}"
    else:
        pipe = StepPipeline(stage, wrapper.pipeline_step_fn(**stage.axes),
                            PipelineConfig(args.steps, stage.num_stages))
        latents = pipe.run((dit, ctx, guidance), noise)
        mode = f"pp{stage.num_stages}" + (f" x sp{sp}" if sp > 1 else "")
    del dit
    _sync(dev)
    if not stage.is_last_rank:
        return None
    t_diffusion = time.perf_counter() - t0
    LOGGER.info("diffusion [%s]: %.1fs (%d samples)", mode, t_diffusion, args.num_samples)

    t0 = time.perf_counter()
    vae = _load(args, "vae_decoder", TemporalVAEDecoder(vae_cfg, device=dev), args.seed + 2)
    outputs = _decode_and_save(args, vae, wrapper.unpack_final(latents), stage.num_stages)
    _log_timing(t_load, t_encode, t_diffusion, time.perf_counter() - t0,
                time.perf_counter() - t_start, outputs)
    return outputs


if __name__ == "__main__":
    sys.exit(main())
