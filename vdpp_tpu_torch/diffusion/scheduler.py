"""EulerDiscrete/Karras v-prediction schedule for SVD, in numpy and PyTorch.

Port of ``vdpp_tpu/diffusion/scheduler.py``. The tables (Karras rho=7 sigmas
with a trailing 0, continuous timesteps ``0.25 * ln(sigma)``) are built in
numpy exactly as the reference builds them, so they match it bit for bit.
The per-step update runs in fp32 on tensors:

    x0_hat = eps * (-sigma / sqrt(sigma^2+1)) + x / (sigma^2 + 1)
    x     <- x + (x - x0_hat) / sigma * (sigma_next - sigma)
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
