"""Lightweight denoiser stand-in for the simulator (port of
``vdpp_tpu/models/dummy_unet.py``).

Two 3-D convolutions with a SiLU between them, a residual scaled by
``tanh(step / 10)`` so that the order of the steps shows in the output, and
a LayerNorm over the channel axis of the residual added on top. It exists to
check the pipeline's schedule: the final latent must be the same for any
stage count. Latents are ``(B, C, F, H, W)``, the pipeline-wide layout of
the original system.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.utils.device import resolve_device


class DummyUNet(nn.Module):
    """``forward(latent, step)``; parameters are allocated on ``device``
    (``None`` means CUDA, which must exist) and left unset: load a state dict
    (``utils/weights.py::from_jax_dummy_params``) or call
    :meth:`init_weights`."""

    def __init__(self, channels: int = 8, hidden_channels: int = 16, use_layernorm: bool = True,
                 dtype: torch.dtype = torch.float32, device: str | torch.device | None = None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(kernel_size=3, padding=1, device=dev, dtype=dtype)
        self.conv1 = nn.Conv3d(channels, hidden_channels, **kw)
        self.conv2 = nn.Conv3d(hidden_channels, channels, **kw)
        self.ln = (nn.LayerNorm(channels, eps=1e-5, device=dev, dtype=dtype) if use_layernorm
                   else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> DummyUNet:
        """Uniform over +-1/sqrt(fan_in) for the convolutions (the JAX
        ``init``'s family), unit scale and zero bias for the LayerNorm."""
        for conv in (self.conv1, self.conv2):
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            for p in (conv.weight, conv.bias):
                p.copy_(torch.rand(p.shape, generator=generator, device=generator.device)
                        .mul_(2 * bound).sub_(bound))
        if self.ln is not None:
            self.ln.reset_parameters()
        return self

    def forward(self, latent: torch.Tensor, step) -> torch.Tensor:
        out = self.conv2(F.silu(self.conv1(latent)))
        scale = torch.tanh(torch.as_tensor(step, dtype=torch.float32, device=latent.device) / 10.0)
        out = latent + scale.to(latent.dtype) * out
        if self.ln is not None:
            # LayerNorm over channels of the residual, in fp32, added on.
            x = latent.movedim(1, -1).float()
            normed = F.layer_norm(x, x.shape[-1:], self.ln.weight.float(), self.ln.bias.float(),
                                  self.ln.eps)
            out = out + normed.to(latent.dtype).movedim(-1, 1)
        return out
