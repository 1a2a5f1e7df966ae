"""Timestep / positional embeddings (port of ``vdpp_tpu/ops/embeddings.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.linear import Linear


def sinusoidal_embedding(
    t: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """diffusers ``Timesteps`` embedding of scalar or ``(B,)`` continuous
    timesteps: ``(B, dim)`` fp32, cos half first when flipped."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32))
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    args = scale * t[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """diffusers ``TimestepEmbedding``: ``linear_1`` -> SiLU -> ``linear_2``."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int | None = None, **kw):
        super().__init__()
        self.linear_1 = Linear(in_dim, hidden_dim, **kw)
        self.linear_2 = Linear(hidden_dim, out_dim or hidden_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return timestep_mlp(x, self)


def timestep_mlp(x: torch.Tensor, mlp: TimestepEmbedding) -> torch.Tensor:
    h = mlp.linear_1(x)
    h = F.silu(h.float()).to(h.dtype)
    return mlp.linear_2(h)
