"""Flash attention over (B, L, H, D) tensors: the port of the JAX package's
Pallas kernel ``vdpp_tpu/ops/flash_attention.py::_flash_kernel``.

Non-causal, unmasked multi-head attention that never holds the L x L score
matrix (at the SVD-XT level-0 site it would be 125 * 9216^2 * 4 B = 42 GB).
Same arithmetic as the reference: q pre-scaled by log2(e)/sqrt(d) and rounded
back to its dtype, base-2 softmax, static-max mode (log2-logits clipped to
[-100, 100], no running max) by default or the classic running max, P rounded
to the input dtype before P.V, l summed from those rounded values, fp32
accumulation and ``l == 0 -> 1``.

Two implementations of that arithmetic live here:

* the CUDA kernel ``vdpp_tpu_torch/csrc/flash_attention.cu`` (head dim 64:
  bf16 on the tensor cores, fp32 on the SIMT cores; head dim 512, the VAE
  decoder's mid-block: fp32 on the SIMT cores), which :func:`flash_attention`
  launches for a CUDA tensor;
* :func:`flash_attention_plain`, plain PyTorch that processes the queries in
  chunks, which :func:`flash_attention` runs for a CPU tensor and which the
  tests and ``chip_smoke.py`` hold the kernel against.

A CUDA tensor never reaches the plain version: the wrapper launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from vdpp_tpu_torch.utils import kernels

LOG2E = math.log2(math.e)
S_CLAMP = 100.0
S_CLAMP_LO = -100.0
# Head dims the CUDA kernel takes, with the dtypes it takes them in.
KERNEL_HEAD_DIMS = {64: (torch.bfloat16, torch.float32), 512: (torch.float32,)}
# fp32 scores the plain version holds at once (query chunk x all keys x B*H).
_PLAIN_SCORE_ELEMS = 1 << 26

# Kernel launches since the count was last set to 0 (chip_smoke.py reads it to
# show that the UNet's attention went through the kernel).
launches = 0

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("flash_attention")
        fn = lib.vdpp_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def default_static_max() -> bool:
    """``VDPP_FLASH_SOFTMAX=running`` selects the running-max kernel, as in
    the reference; anything else keeps static max."""
    return os.environ.get("VDPP_FLASH_SOFTMAX", "static") == "static"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, L, H, D) tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q, k, v must all be bf16 or all fp32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if os.environ.get("VDPP_FLASH_EXP") == "bf16":
        raise NotImplementedError("VDPP_FLASH_EXP=bf16 (the bf16-exponent experiment) "
                                  "is not ported")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, static_max: bool | None = None
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, L, H, D) tensors, non-causal.

    ``static_max=None`` reads ``VDPP_FLASH_SOFTMAX`` (default static). Its
    precondition is the reference's: log2-logits within +-100
    (|q.k/sqrt(d)| <= ~69); beyond it the static form saturates and only
    finiteness is guaranteed.
    """
    _check(q, k, v)
    if static_max is None:
        static_max = default_static_max()
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, static_max)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, lq, h, d = q.shape
    if q.dtype not in KERNEL_HEAD_DIMS.get(d, ()):
        raise NotImplementedError(
            f"the CUDA flash kernel takes head dim 64 (bf16, fp32) and 512 (fp32); d={d} "
            f"in {q.dtype} is not ported (d=72 comes with the DiT slice of the port)"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA flash kernel takes contiguous (B, L, H, D) tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the CUDA flash kernel takes 16-byte aligned tensors")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid's 65535")
    lib = _kernel_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vdpp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, lq, k.shape[1], d, int(static_max),
            LOG2E / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, static_max: bool = True
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, any head dim, on any device.

    Processes the queries in chunks so that at most ``_PLAIN_SCORE_ELEMS`` fp32
    scores exist at once. Sums run over all keys in one product, where the
    kernel sums tile by tile, so the two differ only by fp32 rounding.
    """
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qs = (q.float() * (LOG2E / math.sqrt(d))).to(q.dtype)
    qt = qs.permute(0, 2, 1, 3).float()  # (B, H, Lq, D)
    kt = k.permute(0, 2, 3, 1).float()  # (B, H, D, Lk)
    vt = v.permute(0, 2, 1, 3).float()  # (B, H, Lk, D)
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    rows = max(1, _PLAIN_SCORE_ELEMS // (b * h * lk))
    for i in range(0, lq, rows):
        s = torch.matmul(qt[:, :, i:i + rows], kt)  # log2-domain logits
        if static_max:
            p = torch.exp2(s.clamp_(S_CLAMP_LO, S_CLAMP))
        else:
            p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
        p = p.to(v.dtype).float()
        l = p.sum(dim=-1, keepdim=True)
        l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
        out[:, :, i:i + rows] = (torch.matmul(p, vt) * l_inv).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()
