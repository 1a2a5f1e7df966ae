"""Stable Video Diffusion denoise-step wrapper (port of
``vdpp_tpu/models/svd_wrapper.py``: the euler, euler_a, heun and dpmpp2m
solvers, DeepCache, and the intra-sample axes).

Owns the Euler/Karras schedule, the conditioning (CLIP image embedding,
frame-repeated image latents, added time ids, per-frame guidance ramp),
classifier-free guidance in ``sequential`` or ``batched`` mode, and the
per-step math

    scale -> UNet (uncond, cond) -> per-frame guidance blend -> fp32 update

(Euler; ancestral Euler, whose noise is a pure function of the sampler seed
and the step; Heun, which calls the UNet twice a step; or DPM-Solver++ (2M),
whose previous ``x0_hat`` rides the pipeline payload along the channel
axis). With DeepCache every ``interval``-th real step runs the whole UNet
and the others only its shallow levels, on a deep feature cached per CFG
branch that rides the payload too: ``[x | (old x0_hat) | cache_u | cache_c]``.

The intra-sample axes (``parallel/mesh.py``'s ``Stage.axes``): ``seq_axis``
and ``frame_axis`` split each UNet forward (``SVDUNet.forward``); on
``cfg_axis``, a size-2 axis, rank 0 runs the uncond branch and rank 1 the
cond one, and one swap gives both ranks both outputs (and under DeepCache
both caches), so the payload stays the same on every rank of a stage.

Latents are channels-last ``(B, F, H, W, 4)``. The UNet's weights travel as
the ``params`` argument (an initialised :class:`SVDUNet`), as the reference's
parameter tree does, so ``pipeline_step_fn`` keeps the
``step_fn(bundle, latent, step)`` contract.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable
from dataclasses import dataclass

import torch

from vdpp_tpu_torch.diffusion.scheduler import (
    EulerKarrasSchedule,
    ancestral_noise,
    dpmpp2m_step_v_prediction,
    euler_ancestral_step_v_prediction,
    euler_step_v_prediction,
    heun_step_v_prediction,
)
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig, cache_feature_shape
from vdpp_tpu_torch.parallel.collectives import Axis, swap
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


NoiseSource = Callable[[int, tuple], torch.Tensor]


class StableVideoUNet:
    """SVD denoiser with embedded schedule; ``pipeline_step_fn`` gives the
    pipeline's ``step_fn(bundle, latent, step)`` contract.

    ``sampler_seed`` seeds euler_a's per-step noise, which is drawn on the
    real step (identity-padded leading steps count as real step 0), so a
    padded schedule draws the unpadded one's noise. ``noise_source(step,
    shape)``, when given, replaces the generator (tests inject another
    package's draws through it). ``deepcache_interval`` (0 = off) and
    ``deepcache_split`` set DeepCache; ``denoise_from`` keeps the tail of
    the schedule (SDEdit), entered at :attr:`sigma_start`.
    """

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
        deepcache_split: int = 1,
        sampler_seed: int = 0,
        denoise_from: int = 0,
        device: str | torch.device | None = None,
        noise_source: NoiseSource | None = None,
    ):
        if cfg_mode not in ("sequential", "batched"):
            raise ValueError("cfg_mode must be 'sequential' or 'batched'")
        if solver not in ("euler", "euler_a", "heun", "dpmpp2m"):
            raise ValueError("solver must be 'euler', 'euler_a', 'heun' or 'dpmpp2m'")
        if deepcache_interval < 0:
            raise ValueError("deepcache_interval must be >= 0 (0 = off)")
        if deepcache_interval and solver == "heun":
            # The cadence counts model calls, and heun makes two a step.
            raise ValueError("deepcache composes with solver euler/euler_a/dpmpp2m only (heun "
                             "runs two evals per step)")
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
        self.sampler_seed = int(sampler_seed)
        self.noise_source = noise_source
        self.deepcache_interval = int(deepcache_interval)
        self.deepcache_split = int(deepcache_split)
        if self.deepcache_interval:
            self._deepcache_packed_channels()  # validates the split against the architecture
        self._n_pad = self.schedule.num_steps - (num_steps - denoise_from)

    @property
    def latent_channel_multiplier(self) -> int:
        """How many latent-sized channel slots the pipeline payload carries
        (2 for dpmpp2m: [x | previous x0_hat])."""
        return 2 if self.solver == "dpmpp2m" else 1

    def _deepcache_packed_channels(self) -> int:
        """fp32 payload channels one CFG branch's cache packs into: the
        (B, F, H/r, W/r, C') cache laid onto the latent's (H, W) grid, C'/r^2
        values a pixel, two bf16 values to an fp32 word when the model is
        bf16."""
        r = 2 ** (self.deepcache_split - 1)
        shape = cache_feature_shape(self.config, 1, 1, r, r, self.deepcache_split)
        per_pixel, rem = divmod(shape[-1], r * r)
        kf, rem2 = divmod(per_pixel, 2 if self.config.dtype == torch.bfloat16 else 1)
        if rem or rem2:
            raise ValueError(f"deepcache split {self.deepcache_split}: cache channels "
                             f"{shape[-1]} not packable onto the latent grid (r={r})")
        return kf

    @property
    def payload_extra_channels(self) -> int:
        """Channels the payload carries beyond the latent's slots (the two
        branches' caches under DeepCache, else 0)."""
        return 2 * self._deepcache_packed_channels() if self.deepcache_interval else 0

    def pack_initial(self, latent: torch.Tensor) -> torch.Tensor:
        """Attach the solver's and the cache's cross-step state to a fresh
        latent: ``[x | (dpmpp2m's x0_hat) | cache_u | cache_c]``, all zeros.
        The zeros are never read: dpmpp2m's first step is first order
        (``sigma_prev == sigma``) and the first real step is a full one."""
        parts = [latent]
        if self.latent_channel_multiplier > 1:
            parts.append(torch.zeros_like(latent))
        extra = self.payload_extra_channels
        if extra:
            if latent.dtype != torch.float32:
                raise ValueError("deepcache requires an fp32 latent payload")
            parts.append(latent.new_zeros((*latent.shape[:-1], extra)))
        return torch.cat(parts, dim=-1) if len(parts) > 1 else latent

    def unpack_final(self, latent: torch.Tensor) -> torch.Tensor:
        """Strip the solver's and the cache's state from the final payload."""
        extra = self.payload_extra_channels
        if extra:
            latent = latent[..., :-extra]
        if self.latent_channel_multiplier > 1:
            latent = latent[..., : latent.shape[-1] // 2]
        return latent

    def _pack_cache(self, cache: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(B, F, H/r, W/r, C') model dtype -> (B, F, H, W, Kf) fp32; a bf16
        pair becomes one fp32 word, its first value in the low 16 bits."""
        b, f = cache.shape[:2]
        kf = self._deepcache_packed_channels()
        if cache.dtype == torch.bfloat16:
            return cache.reshape(b, f, h, w, kf * 2).contiguous().view(torch.float32)
        return cache.reshape(b, f, h, w, kf).float()

    def _unpack_cache(self, packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """(B, F, H, W, Kf) fp32 -> (B, F, H/r, W/r, C') model dtype."""
        b, f = packed.shape[:2]
        shape = cache_feature_shape(self.config, b, f, h, w, self.deepcache_split)
        if self.config.dtype == torch.bfloat16:
            return packed.contiguous().view(torch.bfloat16).reshape(shape)
        return packed.reshape(shape).to(self.config.dtype)

    @property
    def num_steps(self) -> int:
        """Total schedule length including any identity padding."""
        return self.schedule.num_steps

    @property
    def init_noise_sigma(self) -> float:
        return self.schedule.init_noise_sigma

    @property
    def sigma_start(self) -> float:
        """The first sigma: where ``x0 + sigma_start * noise`` enters a
        ``denoise_from`` run (the SDEdit start)."""
        return float(self.schedule.sigmas[0])

    def init(self, generator: torch.Generator) -> SVDUNet:
        """A randomly initialised UNet on this wrapper's device, built from
        this wrapper's config (so ``VDPP_GN_FUSED`` reaches it)."""
        return SVDUNet(self.config, device=self.device).init_weights(generator)

    def _check_unet(self, params: SVDUNet) -> None:
        if params.config.fused_groupnorm != self.config.fused_groupnorm:
            raise ValueError(
                "the UNet was built with fused_groupnorm="
                f"{params.config.fused_groupnorm} but this wrapper's config (VDPP_GN_FUSED is "
                f"read when the wrapper is built) says {self.config.fused_groupnorm}: build "
                "the UNet from the wrapper's config (init() or SVDUNet(wrapper.config))"
            )

    def _cfg_calls(self, call, latent_scaled: torch.Tensor, cond: SVDConditioning, *caches,
                   cfg_axis: Axis | None = None):
        """Run ``call(lat, image_latents, ctx, added_time_ids, *caches)`` for
        the CFG branches and blend in fp32. Returns ``(eps, outputs)``, where
        ``outputs`` holds the call's further outputs for (uncond, cond) each
        (for the cond branch alone without guidance).

        ``cfg_axis``: this rank runs its own branch (rank 0 the uncond one,
        with zeroed conditioning and ``caches[0]``; rank 1 the cond one), and
        one swap a output gives it the other's, so both ranks blend the same
        values. It overrides ``cfg_mode``."""
        atids = cond.added_time_ids
        if cond.guidance is None:
            eps, *rest = call(latent_scaled, cond.image_latents, cond.image_embeddings, atids,
                              *caches[1:])
            return eps.float(), (None, rest)
        zeros_lat = torch.zeros_like(cond.image_latents)
        zeros_ctx = torch.zeros_like(cond.image_embeddings)
        if cfg_axis is not None:
            is_cond = cfg_axis.index == 1
            local, *rest = call(latent_scaled,
                                cond.image_latents if is_cond else zeros_lat,
                                cond.image_embeddings if is_cond else zeros_ctx, atids,
                                *caches[1:] if is_cond else caches[:1])
            # Every rank swaps the outputs in the same order.
            other, *rest_other = (swap(t, cfg_axis) for t in (local, *rest))
            uncond, cond_p = (other, local) if is_cond else (local, other)
            rest_u, rest_c = (rest_other, rest) if is_cond else (rest, rest_other)
        elif self.cfg_mode == "sequential":
            # Two passes: half the activation memory of the batched form.
            uncond, *rest_u = call(latent_scaled, zeros_lat, zeros_ctx, atids, *caches[:1])
            cond_p, *rest_c = call(latent_scaled, cond.image_latents, cond.image_embeddings,
                                   atids, *caches[1:])
        else:
            both, *rest = call(
                torch.cat([latent_scaled, latent_scaled]),
                torch.cat([zeros_lat, cond.image_latents]),
                torch.cat([zeros_ctx, cond.image_embeddings]),
                torch.cat([atids, atids]),
                *([torch.cat(caches)] if caches else []),
            )
            uncond, cond_p = both.chunk(2)
            rest_u, rest_c = [r.chunk(2)[0] for r in rest], [r.chunk(2)[1] for r in rest]
        uncond = uncond.float()
        return uncond + cond.guidance.float() * (cond_p.float() - uncond), (rest_u, rest_c)

    def noise_pred(self, params: SVDUNet, latent_scaled: torch.Tensor, timestep,
                   cond: SVDConditioning, cfg_axis: Axis | None = None,
                   seq_axis: Axis | None = None, frame_axis: Axis | None = None
                   ) -> torch.Tensor:
        """UNet eval(s) incl. CFG on the pre-scaled latent; the guided blend
        is fp32. ``seq_axis``/``frame_axis`` split each forward, ``cfg_axis``
        runs the two branches on its two ranks."""
        self._check_unet(params)
        md = self.config.dtype

        def unet_call(lat, image_latents, ctx, added_time_ids):
            x = torch.cat([lat.to(md), image_latents.to(md)], dim=-1)
            return (params(x, timestep, ctx, added_time_ids, seq_axis=seq_axis,
                           frame_axis=frame_axis),)

        if cond.guidance is None:  # the model's dtype, as the reference returns it
            return unet_call(latent_scaled, cond.image_latents, cond.image_embeddings,
                             cond.added_time_ids)[0]
        return self._cfg_calls(unet_call, latent_scaled, cond, cfg_axis=cfg_axis)[0]

    def _noise_pred_cached(self, params: SVDUNet, latent_scaled: torch.Tensor, timestep,
                           cond: SVDConditioning, cache_u: torch.Tensor, cache_c: torch.Tensor,
                           use_full: bool, cfg_axis: Axis | None = None,
                           seq_axis: Axis | None = None, frame_axis: Axis | None = None):
        """:meth:`noise_pred` through ``apply_cached``, a cache per CFG
        branch. Returns ``(eps, cache_u, cache_c)`` (fp32 eps); without
        guidance only the cond cache is live. Under ``cfg_axis`` the
        refreshed cache is swapped with the output, so both branches' caches
        stay on both ranks."""
        self._check_unet(params)
        md = self.config.dtype

        def call(lat, image_latents, ctx, added_time_ids, cache):
            x = torch.cat([lat.to(md), image_latents.to(md)], dim=-1)
            return params.apply_cached(x, timestep, ctx, added_time_ids, cache, use_full,
                                       split=self.deepcache_split, seq_axis=seq_axis,
                                       frame_axis=frame_axis)

        eps, (rest_u, rest_c) = self._cfg_calls(call, latent_scaled, cond, cache_u, cache_c,
                                                cfg_axis=cfg_axis)
        return eps, (cache_u if rest_u is None else rest_u[0]), rest_c[0]

    def _ancestral_noise(self, step_idx: int, shape) -> torch.Tensor:
        """euler_a's noise, drawn on the real step (padded leading steps clamp
        to real step 0, which they ignore)."""
        real = max(step_idx - self._n_pad, 0)
        if self.noise_source is not None:
            return self.noise_source(real, tuple(shape)).to(self.device, torch.float32)
        return ancestral_noise(self.sampler_seed, real, shape, self.device)

    def _update(self, x32: torch.Tensor, eps: torch.Tensor, old_den, step_idx: int,
                out_dtype: torch.dtype) -> torch.Tensor:
        """The one-call solvers' fp32 update; dpmpp2m returns ``[x | x0_hat]``."""
        sigmas = self.schedule.sigmas
        sigma, sigma_next = sigmas[step_idx], sigmas[step_idx + 1]
        if self.solver == "dpmpp2m":
            # sigma_prev == sigma at step 0 and after identity padding: first order.
            x_next, denoised = dpmpp2m_step_v_prediction(
                x32, eps, old_den, sigmas[max(step_idx - 1, 0)], sigma, sigma_next, out_dtype)
            return torch.cat([x_next, denoised], dim=-1)
        if self.solver == "euler_a":
            return euler_ancestral_step_v_prediction(
                x32, eps, self._ancestral_noise(step_idx, x32.shape), sigma, sigma_next,
                out_dtype)
        return euler_step_v_prediction(x32, eps, sigma, sigma_next, out_dtype)

    def step(self, params: SVDUNet, latent: torch.Tensor, step_idx: int,
             cond: SVDConditioning, cfg_axis: Axis | None = None,
             seq_axis: Axis | None = None, frame_axis: Axis | None = None) -> torch.Tensor:
        """One denoising step: scale, UNet (+CFG), fp32 solver update, on the
        payload (``[x | (old x0_hat) | (cache_u | cache_c)]``); returns the
        next payload. The axes go to every UNet call (heun's two included)."""
        axes = dict(cfg_axis=cfg_axis, seq_axis=seq_axis, frame_axis=frame_axis)
        sigmas = self.schedule.sigmas
        sigma, sigma_next = sigmas[step_idx], sigmas[step_idx + 1]
        lat32 = latent.float()
        if self.solver == "heun":
            return heun_step_v_prediction(
                lat32, lambda scaled, t: self.noise_pred(params, scaled, t, cond, **axes), sigma,
                sigma_next, latent.dtype)
        co = self.config.out_channels
        s0 = co * self.latent_channel_multiplier
        x32, old_den = lat32[..., :co], lat32[..., co:s0]
        s = torch.as_tensor(sigma, dtype=torch.float32, device=latent.device)
        timestep = 0.25 * torch.log(s)
        scaled = x32 * torch.rsqrt(s * s + 1.0)
        if not self.deepcache_interval:
            eps = self.noise_pred(params, scaled, timestep, cond, **axes)
            return self._update(x32, eps, old_den, step_idx, latent.dtype)
        h, w = latent.shape[-3:-1]
        kf = self._deepcache_packed_channels()
        cache_u = self._unpack_cache(latent[..., s0:s0 + kf], h, w)
        cache_c = self._unpack_cache(latent[..., s0 + kf:], h, w)
        # The cadence counts real steps: padded leading steps clamp to real
        # step 0 (a full step), so padded and unpadded runs agree bit for bit.
        use_full = max(step_idx - self._n_pad, 0) % self.deepcache_interval == 0
        eps, cache_u, cache_c = self._noise_pred_cached(params, scaled, timestep, cond,
                                                        cache_u, cache_c, use_full, **axes)
        return torch.cat([self._update(x32, eps, old_den, step_idx, latent.dtype),
                          self._pack_cache(cache_u, h, w), self._pack_cache(cache_c, h, w)],
                         dim=-1)

    def pipeline_step_fn(self, cfg_axis: Axis | None = None, seq_axis: Axis | None = None,
                         frame_axis: Axis | None = None, expert_axis: Axis | None = None):
        """``step_fn(bundle, latent, step)`` with ``bundle = (unet, cond)``,
        over the given intra-sample axes (``Stage.axes``: a rank's axes on a
        (stage, seq, frame, cfg) mesh).

        With DeepCache and a seq or frame axis, the full and the cache step
        make different collectives; the step function then carries the
        cadence and the schedule's padding (``collective_uniform_interval``,
        ``collective_uniform_pad``), and ``StepPipeline`` refuses, as the
        reference does, a split where the stages would not take the same
        branch at the same tick. The UNet has no experts: an expert axis is
        refused."""
        if expert_axis is not None:
            raise ValueError("the SVD UNet has no experts (--expert-parallel needs an MoE "
                             "model)")

        def step_fn(bundle, latent: torch.Tensor, step_idx: int) -> torch.Tensor:
            params, cond = bundle
            return self.step(params, latent, step_idx, cond, cfg_axis=cfg_axis,
                             seq_axis=seq_axis, frame_axis=frame_axis)

        if self.deepcache_interval and (seq_axis is not None or frame_axis is not None):
            step_fn.collective_uniform_interval = self.deepcache_interval
            step_fn.collective_uniform_pad = self._n_pad
        return step_fn
