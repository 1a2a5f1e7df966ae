"""Convolutions over channels-last tensors (port of ``vdpp_tpu/ops/conv.py``).

Spatial convs run per frame on ``(N, H, W, C)``; temporal convs run a
``(k, 1, 1)`` kernel over the frame axis of ``(B, F, H, W, C)``. Their halo
forms (``conv2d_halo``, ``conv_temporal_halo``) run on a shard of the W or
the frame axis and exchange the edge a kernel needs with the neighbouring
shards (``parallel/collectives.py``). Weights keep
PyTorch's layouts (``(O, I, kh, kw)`` and ``(O, I, k, 1, 1)``). The
channels-last tensor is handed to ``torch.nn.functional.conv2d`` as the NCHW
view it already is in ``channels_last`` memory format, so no copy is made.

int8 weights (``ops/quant.py``): a weight-only one is dequantized as it is
read. A W8A8-marked spatial conv quantizes its input with one scale for the
whole tensor (the max taken over ``amax_axes``, the axes that split it, so
every shard has the unsplit tensor's scale), pads the int8 tensor, gathers
its im2col patches in (row, column, channel) order and runs the int8 product
(``int_mm``) against the kernel laid out to match; under ``conv2d_halo``
the halo exchanged is the int8 one. Given the same input bits a split conv
then gives the unsplit one's int32 products. A temporal conv refuses the
W8A8 mark, as the reference does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.quant import (
    int8_tensor,
    int_mm,
    is_a8,
    quantize_activation,
    weight_for,
    weight_shape,
)
from vdpp_tpu_torch.parallel.collectives import Axis, halo_exchange


class Conv(nn.Module):
    """``weight`` of shape ``(O, I, *kernel)`` and ``bias (O,)``; LeCun-normal."""

    int8_weights = ("weight",)

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


Padding = str | tuple[tuple[int, int], tuple[int, int]]


def _pads(h: int, w: int, k: tuple[int, int], stride: int, padding: Padding
          ) -> tuple[tuple[int, int], tuple[int, int]]:
    """``((top, bottom), (left, right))`` for ``padding`` as ``lax.conv`` reads
    it: ``"SAME"`` (output ``ceil(size / stride)``, the odd pixel of padding
    at the bottom/right) or explicit pairs."""
    if padding == "SAME":
        out = []
        for size, kk in ((h, k[0]), (w, k[1])):
            total = max((-(-size // stride) - 1) * stride + kk - size, 0)
            out.append((total // 2, total - total // 2))
        return out[0], out[1]
    (top, bottom), (left, right) = padding
    return (top, bottom), (left, right)


def _int8_conv(q: torch.Tensor, scale: torch.Tensor, conv: Conv, stride: int,
               pads: tuple[tuple[int, int], tuple[int, int]], dtype: torch.dtype
               ) -> torch.Tensor:
    """The W8A8 conv of an int8 ``(N, H, W, C)`` tensor ``q`` (its scale
    ``scale``) padded by ``pads``: im2col patches in (row, column, channel)
    order, the int8 product against the OIHW kernel laid out to match, then
    ``y * activation scale * channel scale + bias`` in fp32, cast to
    ``dtype``."""
    wq = int8_tensor(conv)
    cout, cin, kh, kw = wq.shape
    (top, bottom), (left, right) = pads
    qp = F.pad(q, (0, 0, left, right, top, bottom))
    n, h, w, _ = qp.shape
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    patches = torch.cat([qp[:, i:i + (ho - 1) * stride + 1:stride,
                            j:j + (wo - 1) * stride + 1:stride] for i in range(kh)
                         for j in range(kw)], dim=-1)
    y = int_mm(patches.reshape(-1, kh * kw * cin), wq.permute(0, 2, 3, 1).reshape(cout, -1))
    y = y.reshape(n, ho, wo, cout).float() * scale * conv.weight_scale.reshape(-1)
    return (y + conv.bias.float()).to(dtype)


def conv2d(x: torch.Tensor, conv: Conv, stride: int = 1, padding: Padding = "SAME",
           amax_axes: tuple[Axis, ...] = ()) -> torch.Tensor:
    """2-D conv of ``(N, H, W, C)``. ``padding`` takes the reference's forms
    (``vdpp_tpu/ops/conv.py::conv2d``): ``"SAME"`` (the default) or
    ``((top, bottom), (left, right))``, such as the UNet downsample's
    ``((1, 1), (1, 1))`` and the KL encoder's right/bottom-only
    ``((0, 1), (0, 1))``. Equal pads go to the convolution itself; unequal
    ones are padded first. ``amax_axes``: the axes that split ``x``'s
    elements (read by a W8A8 conv only)."""
    pads = _pads(x.shape[1], x.shape[2], weight_shape(conv)[-2:], stride, padding)
    if is_a8(conv):
        q, scale = quantize_activation(x, per_row=False, pmax_axes=amax_axes)
        return _int8_conv(q, scale, conv, stride, pads, x.dtype)
    (top, bottom), (left, right) = pads
    xc = x.permute(0, 3, 1, 2)
    weight = weight_for(conv, x.dtype)
    if top == bottom and left == right:
        y = F.conv2d(xc, weight, conv.bias, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), weight, conv.bias, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def _temporal_weight(conv: ConvTemporal, dtype: torch.dtype) -> torch.Tensor:
    """The ``(O, I, k, 1)`` kernel of a temporal conv; a W8A8 mark is
    refused rather than quietly dequantized."""
    if is_a8(conv):
        raise NotImplementedError("a8 (W8A8) temporal convs are not implemented; use "
                                  "weight-only int8 for temporal kernels")
    w = weight_for(conv, dtype)
    return w.reshape(*w.shape[:3], 1)


def conv_temporal(x: torch.Tensor, conv: ConvTemporal) -> torch.Tensor:
    """``(k, 1, 1)`` conv over the frame axis of ``(B, F, H, W, C)`` with SAME
    padding, as a ``(k, 1)`` conv2d over ``(B, C, F, H*W)``."""
    b, f, h, w, c = x.shape
    weight = _temporal_weight(conv, x.dtype)
    k = weight.shape[2]
    xv = x.reshape(b, f, h * w, c).permute(0, 3, 1, 2)
    y = F.conv2d(xv, weight, conv.bias, padding=((k - 1) // 2, 0))
    return y.permute(0, 2, 3, 1).reshape(b, f, h, w, -1)


def conv2d_halo(x: torch.Tensor, conv: Conv, axis: Axis, stride: int = 1,
                amax_axes: tuple[Axis, ...] = ()) -> torch.Tensor:
    """3x3 conv of the local ``(N, H, W_local, C)`` shard of an input whose W
    axis is split over ``axis`` in contiguous blocks: one edge column
    exchanged with each neighbour (zeros at the chain's ends, the unsharded
    conv's SAME padding), then the conv with one pixel of padding in H and
    none in W. Equal to the unsharded ``conv2d`` where that pads one pixel
    on each side: the 3x3 sites at stride 1 and the downsample's ``((1, 1),
    (1, 1))`` at stride 2, whose windows stay on the global grid while every
    shard's width is even (``SVDUNetConfig.seq_min_divisor``).

    W8A8: the shard is quantized with the scale of the whole tensor (the max
    over ``axis`` and ``amax_axes``) and the int8 shard exchanges its halo,
    so the int32 products are the unsplit conv's."""
    if is_a8(conv):
        axes = (axis, *(a for a in amax_axes if a.name != axis.name))
        q, scale = quantize_activation(x, per_row=False, pmax_axes=axes)
        return _int8_conv(halo_exchange(q, axis, dim=2, halo=1), scale, conv, stride,
                          ((1, 1), (0, 0)), x.dtype)
    xh = halo_exchange(x, axis, dim=2, halo=1)
    y = F.conv2d(xh.permute(0, 3, 1, 2), weight_for(conv, x.dtype), conv.bias, stride=stride,
                 padding=(1, 0))
    return y.permute(0, 2, 3, 1).contiguous()


def conv_temporal_halo(x: torch.Tensor, conv: ConvTemporal, axis: Axis) -> torch.Tensor:
    """Temporal conv of the local ``(B, F_local, H, W, C)`` shard of an input
    whose frame axis is split over ``axis`` in contiguous blocks: ``(k - 1)
    // 2`` edge frames exchanged with each neighbour (zeros at the chain's
    ends, the unsharded conv's SAME padding), then the conv with no frame
    padding. An even kernel (whose SAME output the halo form cannot give)
    and a shard shorter than the halo (a one-hop exchange reaches only the
    next shard) raise, as in the reference."""
    weight = _temporal_weight(conv, x.dtype)
    k = weight.shape[2]
    if k % 2 == 0:
        raise ValueError(f"conv_temporal_halo requires odd kernel, got {k}")
    halo = (k - 1) // 2
    if halo == 0:
        return conv_temporal(x, conv)
    if x.shape[1] < halo:
        raise ValueError(f"local frame shard {x.shape[1]} smaller than the kernel halo {halo}")
    xh = halo_exchange(x, axis, dim=1, halo=halo)
    b, f, h, w, c = xh.shape
    y = F.conv2d(xh.reshape(b, f, h * w, c).permute(0, 3, 1, 2), weight, conv.bias)
    return y.permute(0, 2, 3, 1).reshape(b, f - 2 * halo, h, w, -1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of ``(N, H, W, C)``."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
