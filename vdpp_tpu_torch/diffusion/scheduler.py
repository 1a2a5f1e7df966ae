"""Diffusion schedules and their fp32 updates, in numpy and PyTorch.

Port of ``vdpp_tpu/diffusion/scheduler.py``: the EulerDiscrete/Karras
v-prediction schedule (SVD and the DiT's ``euler`` solver) and the
flow-matching schedule (the DiT's ``flowmatch`` solver). The tables (Karras
rho=7 sigmas with a trailing 0, continuous timesteps ``0.25 * ln(sigma)``;
shifted-linear flow-matching sigmas, timesteps ``sigma * 1000``) are built in
numpy exactly as the reference builds them, so they match it bit for bit.
The per-step updates run in fp32 on tensors:

    x0_hat = eps * (-sigma / sqrt(sigma^2+1)) + x / (sigma^2 + 1)
    x     <- x + (x - x0_hat) / sigma * (sigma_next - sigma)      (Euler)
    x     <- x + (sigma_next - sigma) * v                          (flow match)

the second-order v-prediction solvers, Heun (two model calls a step) and
DPM-Solver++ (2M) (one call, and the previous ``x0_hat`` carried as state),
and the ancestral (stochastic) Euler step, whose noise the caller draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


def karras_sigmas(
    num_steps: int,
    sigma_min: float = 0.002,
    sigma_max: float = 700.0,
    rho: float = 7.0,
) -> np.ndarray:
    """Karras rho-ramp sigma table, descending, with the trailing 0:
    float32 of shape ``(num_steps + 1,)``."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if num_steps == 1:
        ramp = np.zeros(1, dtype=np.float64)
    else:
        ramp = np.linspace(0.0, 1.0, num_steps, dtype=np.float64)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sig = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def continuous_timesteps(sigmas: np.ndarray) -> np.ndarray:
    """EDM c_noise timesteps ``0.25 * ln(sigma)`` for the active steps."""
    return (0.25 * np.log(sigmas[:-1])).astype(np.float32)


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    """``x / sqrt(sigma^2 + 1)`` in fp32, returned in the sample's dtype."""
    s = _f32(sigma, sample)
    return (sample.float() * torch.rsqrt(s * s + 1.0)).to(sample.dtype)


def euler_step_v_prediction(
    latent: torch.Tensor,
    noise_pred: torch.Tensor,
    sigma,
    sigma_next,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """fp32 v-prediction Euler update. ``sigma_next == sigma`` (an
    identity-padded step) returns the latent bit for bit."""
    out_dtype = out_dtype or latent.dtype
    x = latent.float()
    eps = noise_pred.float()
    s = _f32(sigma, x)
    s_next = _f32(sigma_next, x)
    denom = s * s + 1.0
    pred_original = eps * (-s * torch.rsqrt(denom)) + x / denom
    derivative = (x - pred_original) / s
    prev = x + derivative * (s_next - s)
    return prev.to(out_dtype)


def _pred_original(x: torch.Tensor, eps: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """v-prediction ``x0_hat`` (the EulerDiscrete denoiser output form)."""
    denom = s * s + 1.0
    return eps * (-s * torch.rsqrt(denom)) + x / denom


def heun_step_v_prediction(
    latent: torch.Tensor,
    eps_fn,
    sigma,
    sigma_next,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One Heun update (2nd-order EDM, Karras et al. 2022 Alg. 1) in fp32,
    in the parameterization of :func:`euler_step_v_prediction`.

    ``eps_fn(scaled_latent, c_noise_timestep)`` is the full model call (CFG
    included), evaluated at ``sigma`` (predictor) and at ``sigma_next``
    (corrector). An identity-padded step (``sigma_next == sigma``) returns
    the latent bit for bit; at the final ``sigma_next == 0`` the corrector is
    undefined and the step is the plain Euler one, which is returned without
    the second model call.
    """
    out_dtype = out_dtype or latent.dtype
    x = latent.float()
    s = _f32(sigma, x)
    s_next = _f32(sigma_next, x)
    dt = s_next - s
    d1 = (x - _pred_original(x, eps_fn(x * torch.rsqrt(s * s + 1.0), 0.25 * torch.log(s))
                            .float(), s)) / s
    x_euler = x + d1 * dt
    if not float(sigma_next) > 0.0:
        return x_euler.to(out_dtype)
    eps2 = eps_fn(x_euler * torch.rsqrt(s_next * s_next + 1.0), 0.25 * torch.log(s_next)).float()
    d2 = (x_euler - _pred_original(x_euler, eps2, s_next)) / s_next
    return (x + 0.5 * (d1 + d2) * dt).to(out_dtype)


def dpmpp2m_step_v_prediction(
    latent: torch.Tensor,
    noise_pred: torch.Tensor,
    old_denoised: torch.Tensor,
    sigma_prev,
    sigma,
    sigma_next,
    out_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++ (2M) update in fp32: one model call a step, the
    second-order term from the previous step's ``x0_hat``. Over
    ``t = -ln(sigma)``:

        h      = t_next - t,   h_last = t - t_prev,   r = h_last / h
        x_next = (sigma_next / sigma) * x - expm1(-h) * D
        D      = x0_hat                                 (first order)
        D      = (1 + 1/2r) x0_hat - (1/2r) old_x0_hat  (second order)

    Returns ``(x_next, x0_hat)``; callers carry ``x0_hat`` to the next step.
    First order exactly where the second-order term is undefined: the first
    step and a step after identity padding (``h_last == 0``), the final step
    (``sigma_next == 0``: ``x_next = x0_hat``) and a padded step itself
    (``h == 0``: a bitwise no-op for a finite ``noise_pred``).
    """
    out_dtype = out_dtype or latent.dtype
    x = latent.float()
    s_prev = _f32(sigma_prev, x)
    s = _f32(sigma, x)
    s_next = _f32(sigma_next, x)
    denoised = _pred_original(x, noise_pred.float(), s)

    h = torch.log(s) - torch.log(s_next)
    h_last = torch.log(s_prev) - torch.log(s)
    first_order = (h_last == 0.0) | (s_next <= 0.0) | (h == 0.0)
    # The guarded divisions feed only the second-order expression.
    r = h_last / torch.where(h > 0.0, h, 1.0)
    inv_2r = 0.5 / torch.where(r > 0.0, r, 1.0)
    d_used = torch.where(first_order, denoised,
                         (1.0 + inv_2r) * denoised - inv_2r * old_denoised.float())
    x_next = s_next / s * x - torch.expm1(-h) * d_used
    return x_next.to(out_dtype), denoised.to(out_dtype)


def euler_ancestral_step_v_prediction(
    latent: torch.Tensor,
    noise_pred: torch.Tensor,
    noise: torch.Tensor,
    sigma,
    sigma_next,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One fp32 ancestral Euler update in the parameterization of
    :func:`euler_step_v_prediction`: an Euler step to ``sigma_down`` plus
    ``sigma_up * noise``, where

        sigma_up^2   = sigma_next^2 (sigma^2 - sigma_next^2) / sigma^2
        sigma_down^2 = sigma_next^2 - sigma_up^2

    ``noise`` is standard normal, drawn by the caller. An identity-padded
    step (``sigma_next == sigma``) returns the latent bit for bit for finite
    noise, and the final step (``sigma_next == 0``) ignores the noise.
    """
    out_dtype = out_dtype or latent.dtype
    x = latent.float()
    eps = noise_pred.float()
    z = noise.float()
    s = _f32(sigma, x)
    s_next = _f32(sigma_next, x)
    up2 = s_next * s_next * (s * s - s_next * s_next) / (s * s)
    up = torch.sqrt(torch.clamp(up2, min=0.0))
    down = torch.sqrt(torch.clamp(s_next * s_next - up2, min=0.0))
    # sqrt(s_next^2 - 0) may land an ulp off s on a padded step: force the no-op.
    same = s_next == s
    up = torch.where(same, 0.0, up)
    dt = torch.where(same, 0.0, down - s)
    d = (x - _pred_original(x, eps, s)) / s
    return (x + d * dt + up * z).to(out_dtype)


def ancestral_noise(seed: int, step: int, shape, device) -> torch.Tensor:
    """The ancestral step's standard-normal draw for ``step``: a generator on
    ``device`` seeded from ``(seed, step)`` alone, so that every rank of a
    pipeline and the single-device run draw the same noise."""
    # A hash of the pair: the CPU generator reads only the low 32 bits.
    lo, hi = np.random.SeedSequence([int(seed) & 0xFFFFFFFF,
                                     int(step) & 0xFFFFFFFF]).generate_state(2)
    g = torch.Generator(device=device).manual_seed(int(lo) | int(hi) << 32)
    return torch.randn(tuple(shape), generator=g, device=device, dtype=torch.float32)


@dataclass(frozen=True)
class EulerKarrasSchedule:
    """Precomputed schedule: sigma table + continuous timesteps.

    Attributes:
        sigmas: ``(T+1,)`` fp32, descending with trailing 0.
        timesteps: ``(T,)`` fp32 continuous c_noise values fed to the UNet.
        init_noise_sigma: initial-noise scale ``sqrt(sigmas[0]^2 + 1)``.
    """

    sigmas: np.ndarray
    timesteps: np.ndarray
    init_noise_sigma: float
    num_steps: int = field(default=0)

    @classmethod
    def create(
        cls,
        num_steps: int,
        sigma_min: float = 0.002,
        sigma_max: float = 700.0,
        rho: float = 7.0,
        pad_to_multiple_of: int | None = None,
        denoise_from: int = 0,
    ) -> EulerKarrasSchedule:
        """Build the schedule; optionally pad it to a stage-count multiple.

        ``pad_to_multiple_of`` prepends copies of the first sigma: a step with
        ``sigma_next == sigma`` is an exact identity, so the padded schedule
        gives the unpadded one's output bit for bit. ``denoise_from=k`` keeps
        the last ``num_steps - k`` steps of the table (SDEdit truncation),
        before any padding.
        """
        if not 0 <= denoise_from < num_steps:
            raise ValueError(
                f"denoise_from must be in [0, num_steps), got "
                f"{denoise_from} of {num_steps}"
            )
        sig = karras_sigmas(num_steps, sigma_min, sigma_max, rho)
        if denoise_from:
            sig = sig[denoise_from:]
            num_steps -= denoise_from
        if pad_to_multiple_of:
            pad = (-num_steps) % pad_to_multiple_of
            if pad:
                sig = np.concatenate([np.full(pad, sig[0], np.float32), sig])
                num_steps += pad
        return cls(
            sigmas=sig,
            timesteps=continuous_timesteps(sig),
            init_noise_sigma=float(math.sqrt(float(sig[0]) ** 2 + 1.0)),
            num_steps=num_steps,
        )

    def sigma_at(self, step: int) -> float:
        return float(self.sigmas[step])

    def timestep_at(self, step: int) -> float:
        return float(self.timesteps[step])

    def step(self, latent: torch.Tensor, noise_pred: torch.Tensor, step_idx: int) -> torch.Tensor:
        """One Euler update using table sigmas at ``step_idx``/``step_idx+1``."""
        return euler_step_v_prediction(
            latent, noise_pred, self.sigmas[step_idx], self.sigmas[step_idx + 1]
        )


def flowmatch_sigmas(num_steps: int, shift: float = 3.0) -> np.ndarray:
    """Shifted-linear flow-matching sigma table, descending, trailing 0:
    ``t = 1, (N-1)/N, ..., 1/N`` warped by ``shift * t / (1 + (shift - 1) t)``,
    float32 of shape ``(num_steps + 1,)``."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if shift <= 0.0:
        raise ValueError("shift must be > 0")
    t = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    sig = shift * t / (1.0 + (shift - 1.0) * t)
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def flowmatch_step(
    latent: torch.Tensor,
    velocity_pred: torch.Tensor,
    sigma,
    sigma_next,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """fp32 flow-matching Euler update ``x + (sigma_next - sigma) * v``;
    ``sigma_next == sigma`` (an identity-padded step) returns the latent bit
    for bit."""
    out_dtype = out_dtype or latent.dtype
    x = latent.float()
    v = velocity_pred.float()
    return (x + (_f32(sigma_next, x) - _f32(sigma, x)) * v).to(out_dtype)


@dataclass(frozen=True)
class FlowMatchSchedule:
    """Precomputed flow-matching schedule with :class:`EulerKarrasSchedule`'s
    surface: ``timesteps`` are ``sigma * 1000``, ``init_noise_sigma`` is 1,
    and ``pad_to_multiple_of`` prepends copies of the first sigma (bitwise
    no-op steps)."""

    sigmas: np.ndarray
    timesteps: np.ndarray
    init_noise_sigma: float
    num_steps: int = field(default=0)

    @classmethod
    def create(
        cls,
        num_steps: int,
        shift: float = 3.0,
        pad_to_multiple_of: int | None = None,
    ) -> FlowMatchSchedule:
        sig = flowmatch_sigmas(num_steps, shift)
        if pad_to_multiple_of:
            pad = (-num_steps) % pad_to_multiple_of
            if pad:
                sig = np.concatenate([np.full(pad, sig[0], np.float32), sig])
                num_steps += pad
        return cls(
            sigmas=sig,
            timesteps=(sig[:-1] * 1000.0).astype(np.float32),
            init_noise_sigma=1.0,
            num_steps=num_steps,
        )

    def sigma_at(self, step: int) -> float:
        return float(self.sigmas[step])

    def timestep_at(self, step: int) -> float:
        return float(self.timesteps[step])

    def step(self, latent: torch.Tensor, velocity_pred: torch.Tensor,
             step_idx: int) -> torch.Tensor:
        """One flow-match update using table sigmas at ``step_idx``/``step_idx+1``."""
        return flowmatch_step(
            latent, velocity_pred, self.sigmas[step_idx], self.sigmas[step_idx + 1]
        )
