"""Attention over the frame axis of ``(B, F, L, H, D)`` tensors: the port of
the JAX package's Pallas kernel
``vdpp_tpu/ops/temporal_attention_kernel.py::_frame_attn_kernel``.

Video UNets attend over FRAMES at every spatial location: F is small (25 for
SVD-XT) and B * L * H large. Same arithmetic as the reference kernel, in fp32
whatever the input dtype: q scaled by 1/sqrt(d) before the dot products, the
max over key frames, ``exp(s - max)`` summed into the denominator and,
weighted, into the output, ``out / denom``, one rounding to the dtype.

Two implementations of that arithmetic live here:

* the CUDA kernels of ``vdpp_tpu_torch/csrc/frame_attention.cu`` (head dims
  64 (SVD UNet) and 72 (DiT-XL) with F <= 32: bf16 on the tensor cores, fed
  by TMA through a ring of shared-memory tiles, fp32 on the SIMT cores; any
  other head dim or frame count, such as the tiny configs' d = 16, on a
  simple SIMT kernel), which :func:`frame_attention` launches for a CUDA
  tensor; they read q, k and v in the layout the projections produce, with
  no transpose or padding copy -- the fused QKV projection's strided chunks
  too (``utils.kernels.operand_strides``; an operand that breaks that rule is
  copied to contiguous and counted in :data:`copies`);
* :func:`frame_attention_plain`, plain PyTorch, which :func:`frame_attention`
  runs for a CPU tensor and which the tests and ``chip_smoke.py`` hold the
  kernel against.

A CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vdpp_tpu_torch.utils import kernels

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it to
# show that the models' temporal attention went through the kernel).
launches = 0
# Operands copied to contiguous before a launch (their layout broke the
# kernels' input rule); 0 on the models' routes, fused QKV or not.
copies = 0

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("frame_attention")
        fn = lib.vdpp_frame_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.vdpp_frame_attention_max_frames.argtypes = []
        lib.vdpp_frame_attention_max_frames.restype = ctypes.c_int
        _lib = lib
    return _lib


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the frame axis: ``q, k, v`` of shape ``(B, F, L, H, D)``
    -> ``(B, F, L, H, D)`` in ``q.dtype``."""
    if q.ndim != 5 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"frame_attention takes three (B, F, L, H, D) tensors of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q, k, v must all be bf16 or all fp32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu":
        return frame_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"frame_attention runs on cuda or cpu tensors, not {q.device}")
    b, f, l, h, d = q.shape
    lib = _kernel_lib()
    max_frames = lib.vdpp_frame_attention_max_frames()
    if f > max_frames:
        raise ValueError(f"the CUDA frame-attention kernels take at most {max_frames} frames "
                         f"(their scores live in shared memory), got {f}")
    global copies, launches
    (q, k, v), strides, copied = kernels.kernel_operands(q, k, v)
    copies += copied
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vdpp_frame_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            int(q.dtype == torch.bfloat16), b, f, l, h, d, 1.0 / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"frame-attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device, as batched
    fp32 matmuls over ``(B, L, H)`` (sums in another order than the kernel's
    key-frame loop, so the two differ only by fp32 rounding)."""
    d = q.shape[-1]
    qf = q.float() * (1.0 / math.sqrt(d))
    s = torch.matmul(qf.permute(0, 2, 3, 1, 4), k.float().permute(0, 2, 3, 4, 1))  # (B,L,H,F,G)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float().permute(0, 2, 3, 1, 4)) / p.sum(dim=-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype).contiguous()
