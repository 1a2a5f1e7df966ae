"""Stable Video Diffusion denoise-step wrapper (port of
``vdpp_tpu/models/svd_wrapper.py`` for the euler, heun and dpmpp2m solvers).

Owns the Euler/Karras schedule, the conditioning (CLIP image embedding,
frame-repeated image latents, added time ids, per-frame guidance ramp),
classifier-free guidance in ``sequential`` or ``batched`` mode, and the
per-step math

    scale -> UNet (uncond, cond) -> per-frame guidance blend -> fp32 update

(Euler; Heun, which calls the UNet twice a step; or DPM-Solver++ (2M), whose
previous ``x0_hat`` rides the pipeline payload along the channel axis).

Latents are channels-last ``(B, F, H, W, 4)``. The UNet's weights travel as
the ``params`` argument (an initialised :class:`SVDUNet`), as the reference's
parameter tree does, so ``pipeline_step_fn`` keeps the
``step_fn(bundle, latent, step)`` contract.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch

from vdpp_tpu_torch.diffusion.scheduler import (
    EulerKarrasSchedule,
    dpmpp2m_step_v_prediction,
    euler_step_v_prediction,
    heun_step_v_prediction,
)
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SVDConditioning:
    """Conditioning for one generation request.

    Attributes:
        image_embeddings: (B, 1, cross_dim) CLIP image embedding.
        image_latents: (B, F, H, W, 4) VAE-encoded conditioning image, per frame.
        added_time_ids: (B, 3) [fps-1, motion_bucket_id, noise_aug_strength].
        guidance: (1, F, 1, 1, 1) per-frame CFG scale, or None for no CFG.
    """

    image_embeddings: torch.Tensor
    image_latents: torch.Tensor
    added_time_ids: torch.Tensor
    guidance: torch.Tensor | None


def make_added_time_ids(batch_size: int, fps: int = 6, motion_bucket_id: int = 127,
                        noise_aug_strength: float = 0.02, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """[fps-1, motion_bucket_id, noise_aug_strength] per batch element."""
    row = torch.tensor([fps - 1, motion_bucket_id, noise_aug_strength], dtype=dtype,
                       device=device)
    return row[None, :].repeat(batch_size, 1)


def make_guidance_ramp(guidance_scale: float | None, num_frames: int, dtype=torch.float32,
                       device=None) -> torch.Tensor | None:
    """Linear per-frame guidance 1.0 -> guidance_scale over F frames; None
    (no CFG) when guidance_scale is None or <= 1."""
    if guidance_scale is None or guidance_scale <= 1.0:
        return None
    ramp = torch.linspace(1.0, guidance_scale, num_frames, dtype=dtype, device=device)
    return ramp.reshape(1, num_frames, 1, 1, 1)


def make_conditioning(
    image_embeddings: torch.Tensor,
    image_latents: torch.Tensor,
    num_frames: int,
    fps: int = 6,
    motion_bucket_id: int = 127,
    noise_aug_strength: float = 0.02,
    guidance_scale: float | None = None,
    dtype=torch.float32,
) -> SVDConditioning:
    if image_embeddings.ndim == 2:
        image_embeddings = image_embeddings[:, None, :]
    b = image_embeddings.shape[0]
    dev = image_embeddings.device
    return SVDConditioning(
        image_embeddings=image_embeddings.to(dtype),
        image_latents=image_latents.to(dtype),
        added_time_ids=make_added_time_ids(b, fps, motion_bucket_id, noise_aug_strength,
                                           dtype, dev),
        guidance=make_guidance_ramp(guidance_scale, num_frames, dtype, dev),
    )


def make_dummy_conditioning(
    generator: torch.Generator,
    batch_size: int,
    num_frames: int,
    height: int,
    width: int,
    cross_dim: int = 1024,
    guidance_scale: float | None = None,
    dtype=torch.float32,
    **kwargs,
) -> SVDConditioning:
    """Random conditioning for benchmarks (no CLIP/VAE), drawn from
    ``generator`` on its device."""
    dev = generator.device
    return make_conditioning(
        image_embeddings=torch.randn(batch_size, 1, cross_dim, generator=generator, device=dev),
        image_latents=torch.randn(batch_size, num_frames, height, width, 4,
                                  generator=generator, device=dev),
        num_frames=num_frames,
        guidance_scale=guidance_scale,
        dtype=dtype,
        **kwargs,
    )


class StableVideoUNet:
    """SVD denoiser with embedded schedule; ``pipeline_step_fn`` gives the
    pipeline's ``step_fn(bundle, latent, step)`` contract. The euler_a solver
    and deepcache are not ported yet."""

    def __init__(
        self,
        config: SVDUNetConfig | None = None,
        num_steps: int = 25,
        sigma_min: float = 0.002,
        sigma_max: float = 700.0,
        cfg_mode: str = "sequential",
        pad_steps_to: int | None = None,
        solver: str = "euler",
        deepcache_interval: int = 0,
        denoise_from: int = 0,
        device: str | torch.device | None = None,
    ):
        if cfg_mode not in ("sequential", "batched"):
            raise ValueError("cfg_mode must be 'sequential' or 'batched'")
        if solver not in ("euler", "euler_a", "heun", "dpmpp2m"):
            raise ValueError("solver must be 'euler', 'euler_a', 'heun' or 'dpmpp2m'")
        if solver == "euler_a":
            raise NotImplementedError("solver 'euler_a' is not ported yet (ROADMAP A12)")
        if deepcache_interval:
            raise NotImplementedError("deepcache is not ported yet (ROADMAP A12)")
        self.config = config or SVDUNetConfig.svd_xt()
        # VDPP_GN_FUSED=1 routes GroupNorm->SiLU pairs through the fused
        # kernel; read at construction, as the reference reads it.
        if os.environ.get("VDPP_GN_FUSED") == "1":
            self.config = dataclasses.replace(self.config, fused_groupnorm=True)
        self.device = resolve_device(device)
        self.schedule = EulerKarrasSchedule.create(
            num_steps, sigma_min, sigma_max, pad_to_multiple_of=pad_steps_to,
            denoise_from=denoise_from,
        )
        self.cfg_mode = cfg_mode
        self.solver = solver

    @property
    def latent_channel_multiplier(self) -> int:
        """How many latent-sized channel slots the pipeline payload carries
        (2 for dpmpp2m: [x | previous x0_hat])."""
        return 2 if self.solver == "dpmpp2m" else 1

    def pack_initial(self, latent: torch.Tensor) -> torch.Tensor:
        """Attach the solver's cross-step state to a fresh latent. dpmpp2m's
        x0_hat slot starts at zero; its first step is first order
        (``sigma_prev == sigma``), so the zeros are never read."""
        if self.latent_channel_multiplier == 1:
            return latent
        return torch.cat([latent, torch.zeros_like(latent)], dim=-1)

    def unpack_final(self, latent: torch.Tensor) -> torch.Tensor:
        """Strip the solver's state from the pipeline's final payload."""
        if self.latent_channel_multiplier == 1:
            return latent
        return latent[..., : latent.shape[-1] // 2]

    @property
    def num_steps(self) -> int:
        """Total schedule length including any identity padding."""
        return self.schedule.num_steps

    @property
    def init_noise_sigma(self) -> float:
        return self.schedule.init_noise_sigma

    def init(self, generator: torch.Generator) -> SVDUNet:
        """A randomly initialised UNet on this wrapper's device, built from
        this wrapper's config (so ``VDPP_GN_FUSED`` reaches it)."""
        return SVDUNet(self.config, device=self.device).init_weights(generator)

    def noise_pred(self, params: SVDUNet, latent_scaled: torch.Tensor, timestep,
                   cond: SVDConditioning) -> torch.Tensor:
        """UNet eval(s) incl. CFG on the pre-scaled latent; the guided blend
        is fp32."""
        md = self.config.dtype
        if params.config.fused_groupnorm != self.config.fused_groupnorm:
            raise ValueError(
                "the UNet was built with fused_groupnorm="
                f"{params.config.fused_groupnorm} but this wrapper's config (VDPP_GN_FUSED is "
                f"read when the wrapper is built) says {self.config.fused_groupnorm}: build "
                "the UNet from the wrapper's config (init() or SVDUNet(wrapper.config))"
            )

        def unet_call(lat, image_latents, ctx, added_time_ids):
            x = torch.cat([lat.to(md), image_latents.to(md)], dim=-1)
            return params(x, timestep, ctx, added_time_ids)

        atids = cond.added_time_ids
        if cond.guidance is None:
            return unet_call(latent_scaled, cond.image_latents, cond.image_embeddings, atids)
        zeros_lat = torch.zeros_like(cond.image_latents)
        zeros_ctx = torch.zeros_like(cond.image_embeddings)
        if self.cfg_mode == "sequential":
            # Two passes: half the activation memory of the batched form.
            uncond = unet_call(latent_scaled, zeros_lat, zeros_ctx, atids)
            cond_p = unet_call(latent_scaled, cond.image_latents, cond.image_embeddings, atids)
        else:
            both = unet_call(
                torch.cat([latent_scaled, latent_scaled]),
                torch.cat([zeros_lat, cond.image_latents]),
                torch.cat([zeros_ctx, cond.image_embeddings]),
                torch.cat([atids, atids]),
            )
            uncond, cond_p = both.chunk(2)
        uncond = uncond.float()
        return uncond + cond.guidance.float() * (cond_p.float() - uncond)

    def step(self, params: SVDUNet, latent: torch.Tensor, step_idx: int,
             cond: SVDConditioning) -> torch.Tensor:
        """One denoising step: scale, UNet (+CFG), fp32 solver update. With
        dpmpp2m ``latent`` is the payload ``[x | previous x0_hat]`` and so is
        the result."""
        sigmas = self.schedule.sigmas
        sigma, sigma_next = sigmas[step_idx], sigmas[step_idx + 1]
        lat32 = latent.float()
        if self.solver == "heun":
            return heun_step_v_prediction(
                lat32, lambda scaled, t: self.noise_pred(params, scaled, t, cond), sigma,
                sigma_next, latent.dtype)
        if self.solver == "dpmpp2m":
            lat32, old_den = lat32.chunk(2, dim=-1)
        s = torch.as_tensor(sigma, dtype=torch.float32, device=latent.device)
        timestep = 0.25 * torch.log(s)
        scaled = lat32 * torch.rsqrt(s * s + 1.0)
        eps = self.noise_pred(params, scaled, timestep, cond)
        if self.solver == "dpmpp2m":
            # sigma_prev == sigma at step 0 and after identity padding: first order.
            x_next, denoised = dpmpp2m_step_v_prediction(
                lat32, eps, old_den, sigmas[max(step_idx - 1, 0)], sigma, sigma_next,
                latent.dtype)
            return torch.cat([x_next, denoised], dim=-1)
        return euler_step_v_prediction(lat32, eps, sigma, sigma_next, latent.dtype)

    def pipeline_step_fn(self):
        """``step_fn(bundle, latent, step)`` with ``bundle = (unet, cond)``."""

        def step_fn(bundle, latent: torch.Tensor, step_idx: int) -> torch.Tensor:
            params, cond = bundle
            return self.step(params, latent, step_idx, cond)

        return step_fn
