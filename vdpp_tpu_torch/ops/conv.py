"""Convolutions over channels-last tensors (port of ``vdpp_tpu/ops/conv.py``).

Spatial convs run per frame on ``(N, H, W, C)``; temporal convs run a
``(k, 1, 1)`` kernel over the frame axis of ``(B, F, H, W, C)``. Weights keep
PyTorch's layouts (``(O, I, kh, kw)`` and ``(O, I, k, 1, 1)``). The
channels-last tensor is handed to ``torch.nn.functional.conv2d`` as the NCHW
view it already is in ``channels_last`` memory format, so no copy is made.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv(nn.Module):
    """``weight`` of shape ``(O, I, *kernel)`` and ``bias (O,)``; LeCun-normal."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, ...], *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_ch, **kw), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        w = torch.randn(self.weight.shape, generator=generator, device=self.weight.device)
        self.weight.copy_(w / math.sqrt(fan_in))
        self.bias.zero_()


class Conv2d(Conv):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, **kw):
        super().__init__(in_ch, out_ch, (kernel, kernel), **kw)


class ConvTemporal(Conv):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, **kw):
        super().__init__(in_ch, out_ch, (kernel, 1, 1), **kw)


def conv2d(x: torch.Tensor, conv: Conv, stride: int = 1) -> torch.Tensor:
    """2-D conv of ``(N, H, W, C)`` with SAME-style padding ``k // 2`` on
    each side (the reference's SAME at stride 1 and its explicit
    ``((1, 1), (1, 1))`` at the stride-2 downsample)."""
    pad = conv.weight.shape[-1] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_temporal(x: torch.Tensor, conv: ConvTemporal) -> torch.Tensor:
    """``(k, 1, 1)`` conv over the frame axis of ``(B, F, H, W, C)`` with SAME
    padding, as a ``(k, 1)`` conv2d over ``(B, C, F, H*W)``."""
    b, f, h, w, c = x.shape
    k = conv.weight.shape[2]
    weight = conv.weight.reshape(*conv.weight.shape[:3], 1)
    xv = x.reshape(b, f, h * w, c).permute(0, 3, 1, 2)
    y = F.conv2d(xv, weight, conv.bias, padding=((k - 1) // 2, 0))
    return y.permute(0, 2, 3, 1).reshape(b, f, h, w, -1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of ``(N, H, W, C)``."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
