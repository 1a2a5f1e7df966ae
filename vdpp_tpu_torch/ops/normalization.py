"""Normalization over channels-last tensors with fp32 statistics
(port of ``vdpp_tpu/ops/normalization.py``).

Statistics are two-pass (mean, then the mean of squared deviations), as in
the reference: the one-pass E[x^2] - mean^2 form was measured there at about
2e-4 of CFG-amplified error. Results are cast back to the input dtype.
``group_norm_silu(fused=True)`` takes the fused GroupNorm+SiLU kernel
(:mod:`vdpp_tpu_torch.ops.norm_kernel`) where the reference does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.norm_kernel import _row_chunk, group_norm_silu_fused


class Norm(nn.Module):
    """``weight`` (scale) and ``bias`` of a GroupNorm or LayerNorm."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(channels, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(channels, **kw), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


def group_norm(x: torch.Tensor, norm: Norm, num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of ``(N, ..., C)``; statistics
    per (N, group) over every other axis."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    xc = xf - xf.mean(dim=(1, 3), keepdim=True)
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    xn = (xc * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * norm.weight.float() + norm.bias.float()).to(x.dtype)


def group_norm_silu(
    x: torch.Tensor, norm: Norm, num_groups: int = 32, eps: float = 1e-6, fused: bool = False
) -> torch.Tensor:
    """``silu(group_norm(x))``, the norm rounded to ``x.dtype`` before the
    fp32 SiLU as in the reference's unfused form.

    ``fused=True`` takes :func:`~vdpp_tpu_torch.ops.norm_kernel.group_norm_silu_fused`
    under the reference's own shape rule: ``C % G == 0`` and a row extent
    with an 8-aligned chunking (``_row_chunk``). Every other shape takes the
    composition, as in the reference, so the two choose the same sites."""
    if fused:
        c = x.shape[-1]
        if c % num_groups == 0 and _row_chunk(math.prod(x.shape[1:-1]), c):
            return group_norm_silu_fused(x, norm, num_groups, eps, silu=True)
    h = group_norm(x, norm, num_groups, eps)
    return F.silu(h.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, norm: Norm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 two-pass statistics."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    xn = xc * torch.rsqrt(var + eps)
    return (xn * norm.weight.float() + norm.bias.float()).to(x.dtype)
