"""Fused GroupNorm(+SiLU) over channels-last tensors: the port of the JAX
package's Pallas kernel ``vdpp_tpu/ops/norm_kernel.py::_gn_silu_kernel``.

The composed form (``normalization.group_norm`` then SiLU) makes several
fp32 passes over the activation; the fused form reads it twice (statistics,
then normalize) and writes it once, and reads ``weight`` and ``bias`` in the
dtype they are stored in (bf16 in the SVD-XT UNet), with no cast. Same
arithmetic as the reference: fp32 statistics per (batch row, group) over all
middle axes, merged from chunks with the parallel (Chan) formula -- never the
one-pass E[x^2] - mean^2 form --, the affine folded into ``y = x * a + b``,
and SiLU applied to the fp32 ``y`` before the one rounding to the output
dtype. It may differ from the composed form by one ulp of the output dtype,
which rounds the norm before the SiLU.

Two implementations of that arithmetic live here:

* the CUDA kernel ``vdpp_tpu_torch/csrc/group_norm_silu.cu`` (bf16 and fp32,
  two launches a call, any C, G and N: channels past 4096 in tiles), which
  :func:`group_norm_silu_fused` launches for a CUDA tensor;
* :func:`group_norm_silu_fused_plain`, plain PyTorch, which
  :func:`group_norm_silu_fused` runs for a CPU tensor and which the tests and
  ``chip_smoke.py`` hold the kernel against.

A CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vdpp_tpu_torch.utils import kernels

# Wrapper calls that launched the kernel since the count was last set to 0
# (chip_smoke.py reads it to show that the UNet's norms went through it).
launches = 0
# Launches past the kernel's earlier limits (C > 4096: channel tiles; G > 256;
# N > 65,535), which no model of either package reaches. Never set to 0 here,
# so that chip_smoke.py can read it over every model phase of a run.
wide_launches = 0

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("group_norm_silu")
        lib.vdpp_gn_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.vdpp_gn_scratch_floats.restype = ctypes.c_long
        fn = lib.vdpp_group_norm_silu_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _scratch_floats(device: int, n: int, rows: int, c: int, groups: int) -> int:
    """fp32 scratch the kernel needs for this shape on ``device`` (its plan
    depends on the device's SM count)."""
    with torch.cuda.device(device):
        return int(_kernel_lib().vdpp_gn_scratch_floats(n, rows, c, groups))


def _weight(t: torch.Tensor, what: str, x: torch.Tensor) -> torch.Tensor:
    """``norm.weight`` or ``norm.bias`` as the kernel reads it: as stored."""
    t = t.detach()
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA GroupNorm kernel reads a bf16 or fp32 {what}, got {t.dtype}")
    if t.device != x.device or not t.is_contiguous():
        raise ValueError(f"the CUDA GroupNorm kernel reads a contiguous {what} on {x.device}")
    return t


@functools.lru_cache(maxsize=None)
def _row_chunk(s: int, c: int, budget_bytes: int = 2 << 20) -> int | None:
    """Largest divisor of ``s`` that is a multiple of 8 and keeps a
    ``(chunk, c)`` fp32 block under ``budget_bytes``; None if there is none.

    The port's copy of the reference's chunk picker. The CUDA kernel chunks
    its rows its own way; this rule decides, as in the reference, which
    shapes take the fused form at all (``normalization.group_norm_silu``).
    Cached: the scan is s / 8 steps of Python (28,800 at the UNet's level-0
    temporal sites), and every call of the fused route asks it twice."""
    best = None
    for chunk in range(8, s + 1, 8):
        if s % chunk == 0 and chunk * c * 4 <= budget_bytes:
            best = chunk
    return best


def _check(x: torch.Tensor, num_groups: int) -> int:
    """Raise on what the reference refuses; returns the row count."""
    c = x.shape[-1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    rows = math.prod(x.shape[1:-1])
    if _row_chunk(rows, c) is None:
        raise ValueError(
            f"rows {rows} have no 8-aligned divisor fitting the chunk budget; "
            "pad the spatial extent or use normalization.group_norm"
        )
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_silu_fused takes bf16 or fp32, got {x.dtype}")
    return rows


def group_norm_silu_fused(
    x: torch.Tensor, norm, num_groups: int = 32, eps: float = 1e-6, silu: bool = True
) -> torch.Tensor:
    """``silu(group_norm(x))`` (bare GroupNorm with ``silu=False``) over the
    trailing channel axis of ``(N, ..., C)``, statistics per (N, group) over
    every other axis. ``norm`` holds ``weight`` and ``bias`` (C,)."""
    rows = _check(x, num_groups)
    if x.device.type == "cpu":
        return group_norm_silu_fused_plain(x, norm, num_groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu_fused runs on cuda or cpu tensors, not {x.device}")
    n, c = x.shape[0], x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("the CUDA GroupNorm kernel takes a contiguous tensor")
    weight = _weight(norm.weight, "weight", x)
    bias = _weight(norm.bias, "bias", x)
    if weight.dtype != bias.dtype or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"the CUDA GroupNorm kernel takes weight and bias of shape ({c},) and "
                         f"one dtype, got {weight.dtype}{tuple(weight.shape)}, "
                         f"{bias.dtype}{tuple(bias.shape)}")
    lib = _kernel_lib()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    out = torch.empty_like(x)
    scratch = torch.empty(_scratch_floats(dev, n, rows, c, num_groups), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vdpp_group_norm_silu_fwd(
            x.data_ptr(), out.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            int(weight.dtype == torch.bfloat16), scratch.data_ptr(),
            int(x.dtype == torch.bfloat16), n, rows, c, num_groups, eps, int(silu), stream,
        )
    if rc != 0:
        raise RuntimeError(f"GroupNorm+SiLU kernel launch failed: CUDA error {rc}")
    global launches, wide_launches
    launches += 1
    if c > 4096 or num_groups > 256 or n > 65535:
        wide_launches += 1
    return out


def group_norm_silu_fused_plain(
    x: torch.Tensor, norm, num_groups: int = 32, eps: float = 1e-6, silu: bool = True
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device: fp32 mean and
    sum of squared deviations per (N, group) (one exact two-pass over all
    rows where the kernel merges chunks, so the two differ only by fp32
    rounding), ``a = rstd * weight``, ``b = bias - mean * a``,
    ``y = x * a + b``, ``y * sigmoid(y)``, one rounding."""
    n, c = x.shape[0], x.shape[-1]
    gsize = c // num_groups
    xf = x.float().reshape(n, -1, c)
    xg = xf.reshape(n, -1, num_groups, gsize)
    mean = xg.mean(dim=(1, 3))  # (N, G)
    m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    rstd = torch.rsqrt(m2 / (xg.shape[1] * gsize) + eps)
    a = rstd.repeat_interleave(gsize, dim=1) * norm.weight.float()  # (N, C)
    b = norm.bias.float() - mean.repeat_interleave(gsize, dim=1) * a
    y = xf * a[:, None, :] + b[:, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)
