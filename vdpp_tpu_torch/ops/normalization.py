"""Normalization over channels-last tensors with fp32 statistics
(port of ``vdpp_tpu/ops/normalization.py``).

Statistics are two-pass (mean, then the mean of squared deviations), as in
the reference: the one-pass E[x^2] - mean^2 form was measured there at about
2e-4 of CFG-amplified error. Results are cast back to the input dtype.
``group_norm_silu(fused=True)`` takes the fused GroupNorm+SiLU kernel
(:mod:`vdpp_tpu_torch.ops.norm_kernel`) where the reference does.
``VDPP_ABLATE_GROUPNORM=1`` (profiling only, as in the reference) keeps
only ``group_norm``'s affine.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.norm_kernel import _row_chunk, group_norm_silu_fused
from vdpp_tpu_torch.parallel.collectives import Axis, pmean


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


def group_norm(x: torch.Tensor, norm: Norm, num_groups: int = 32, eps: float = 1e-6,
               psum_axis: Axis | tuple[Axis, ...] | None = None) -> torch.Tensor:
    """GroupNorm over the trailing channel axis of ``(N, ..., C)``; statistics
    per (N, group) over every other axis.

    ``psum_axis``: the axis (or axes, such as seq and frame together) over
    which the non-batch axes of ``x`` are split in equal shards. The mean is
    then averaged across them, and the variance about that mean too, so the
    statistics are the unsharded ones (two passes, as in the reference)."""
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if os.environ.get("VDPP_ABLATE_GROUPNORM") == "1":  # profiling only
        return (x.float() * norm.weight.float() + norm.bias.float()).to(x.dtype)
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    if psum_axis is not None:
        mean = pmean(mean, psum_axis)
    xc = xf - mean
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    if psum_axis is not None:
        var = pmean(var, psum_axis)
    xn = (xc * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * norm.weight.float() + norm.bias.float()).to(x.dtype)


def group_norm_silu(
    x: torch.Tensor, norm: Norm, num_groups: int = 32, eps: float = 1e-6, fused: bool = False,
    psum_axis: Axis | tuple[Axis, ...] | None = None,
) -> torch.Tensor:
    """``silu(group_norm(x))``, the norm rounded to ``x.dtype`` before the
    fp32 SiLU as in the reference's unfused form.

    ``fused=True`` takes :func:`~vdpp_tpu_torch.ops.norm_kernel.group_norm_silu_fused`
    under the reference's own shape rule: unsharded statistics (``psum_axis
    is None``: the kernel reduces locally only), ``C % G == 0`` and a row
    extent with an 8-aligned chunking (``_row_chunk``). Every other case
    takes the composition, as in the reference, so the two choose the same
    sites."""
    if fused and psum_axis is None:
        c = x.shape[-1]
        if c % num_groups == 0 and _row_chunk(math.prod(x.shape[1:-1]), c):
            return group_norm_silu_fused(x, norm, num_groups, eps, silu=True)
    h = group_norm(x, norm, num_groups, eps, psum_axis=psum_axis)
    return F.silu(h.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, norm: Norm, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 two-pass statistics."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    xn = xc * torch.rsqrt(var + eps)
    return (xn * norm.weight.float() + norm.bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """``weight`` (scale) of an RMSNorm (HF T5's ``T5LayerNorm``)."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device, dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)


def rms_norm(x: torch.Tensor, norm: RMSNorm, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing axis (no mean subtraction, no bias), fp32
    statistics: ``x * rsqrt(mean(x^2) + eps) * scale``, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * norm.weight.float()).to(x.dtype)
