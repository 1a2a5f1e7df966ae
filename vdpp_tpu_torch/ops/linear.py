"""Dense layers and the GEGLU feed-forward (port of ``vdpp_tpu/ops/linear.py``).

Weights keep PyTorch's ``(out, in)`` layout under diffusers names; the
result is in the input's dtype, with fp32 accumulation. A weight held in int8
(``ops/quant.py``) is dequantized as it is read; a W8A8-marked one quantizes
the activation per row and runs the int8 product (``int8_dot``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.quant import int8_dot, int8_tensor, is_a8, weight_for


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T + bias``, result in ``x.dtype``."""
    return F.linear(x, weight, bias)


class Linear(nn.Module):
    """``weight (out, in)`` and optional ``bias (out,)``; LeCun-normal init."""

    int8_weights = ("weight",)

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw), requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_dim, **kw), requires_grad=False) if bias else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        out_dim, in_dim = self.weight.shape
        w = torch.randn(out_dim, in_dim, generator=generator, device=self.weight.device)
        self.weight.copy_(w / math.sqrt(in_dim))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_a8(self):
            y = int8_dot(x, int8_tensor(self), self.weight_scale)
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(x.dtype)
        return linear(x, weight_for(self, x.dtype), self.bias)


class GEGLUProj(nn.Module):
    """diffusers ``GEGLU``: holds ``proj`` (dim -> 2 * inner)."""

    def __init__(self, dim: int, inner: int, **kw):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, **kw)


class FeedForward(nn.Module):
    """diffusers ``FeedForward`` with GEGLU: ``net.0.proj`` and ``net.2``
    (``net.1`` is the parameterless dropout slot)."""

    def __init__(self, dim: int, inner_dim: int | None = None, out_dim: int | None = None, **kw):
        super().__init__()
        inner_dim = inner_dim or 4 * dim
        self.net = nn.ModuleList(
            [GEGLUProj(dim, inner_dim, **kw), nn.Identity(), Linear(inner_dim, out_dim or dim, **kw)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu_ff(x, self)


def geglu_ff(x: torch.Tensor, ff: FeedForward) -> torch.Tensor:
    """``proj_out(val * gelu(gate))`` with exact-erf gelu taken in fp32."""
    h = ff.net[0].proj(x)
    val, gate = h.chunk(2, dim=-1)
    h = val * F.gelu(gate.float()).to(val.dtype)
    return ff.net[2](h)
