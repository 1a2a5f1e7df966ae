"""Flash attention over (B, L, H, D) tensors: the port of the JAX package's
Pallas kernel ``vdpp_tpu/ops/flash_attention.py::_flash_kernel``.

Non-causal, unmasked multi-head attention that never holds the L x L score
matrix (at the SVD-XT level-0 site it would be 125 * 9216^2 * 4 B = 42 GB).
Same arithmetic as the reference: q pre-scaled by log2(e)/sqrt(d) and rounded
back to its dtype, base-2 softmax, static-max mode (log2-logits clipped to
[-100, 100], no running max) by default or the classic running max, P rounded
to the input dtype before P.V, l summed from those rounded values, fp32
accumulation and ``l == 0 -> 1``. ``VDPP_FLASH_EXP=bf16`` (running max only,
as in the reference) rounds s - m to bf16 before exp2 and the exponential to
bf16 after it.

Two implementations of that arithmetic live here:

* the CUDA kernels of ``vdpp_tpu_torch/csrc/flash_attention.cu``, which
  :func:`flash_attention` launches for a CUDA tensor. bf16 runs on the
  tensor cores (wgmma, TMA loads) at every head dim: 64 (the SVD UNet's) and
  72 (DiT-XL's) and 512 (the VAE decoder's mid-block) on kernels of their
  own, every other one up to 512 (such as the tiny configs' 16) on
  ``flash_fwd_any``, templated on d rounded up to 16, and above 512 on
  ``flash_fwd_wide``, which cuts O into slabs of 512 columns. fp32 runs
  exact on the SIMT cores: static max at 64 and 72 on a kernel of its own,
  512 and every other head dim (and running max at 64 and 72) on
  register-tiled kernels in the SGEMM layout. They read q, k and v in place
  wherever ``utils.kernels.operand_strides`` admits them (the fused QKV
  projection's chunks among them) and copy the rest, counted in
  :data:`copies`; a head dim that is no whole number of 16-byte words (bf16
  d % 8, fp32 d % 4) is copied into rows padded with zeros to one, as TMA
  and the 16-byte copies need (``utils.kernels.padded_operands``);
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
from collections import Counter

import torch

from vdpp_tpu_torch.utils import kernels

LOG2E = math.log2(math.e)
S_CLAMP = 100.0
S_CLAMP_LO = -100.0
# fp32 scores the plain version holds at once (query chunk x all keys x B*H).
_PLAIN_SCORE_ELEMS = 1 << 26

# Kernel launches by head dim since the count was last cleared (chip_smoke.py
# reads it to show that the models' attention went through the kernel; a path
# such as the image->video app runs several head dims); ``launches.total()``
# is the count over all of them. ``exp_bf16_launches`` counts, by head dim
# too, the launches among them that ran the VDPP_FLASH_EXP=bf16 form.
launches: Counter[int] = Counter()
exp_bf16_launches: Counter[int] = Counter()
# Operands copied to contiguous before a launch because their layout broke
# the kernels' input rule (``utils.kernels.operand_strides``); 0 on the
# models' routes, fused QKV or not.
copies = 0
# Launches past the limits the kernels had before they took every shape, which
# no model of either package reaches: ``"wide"`` at d > 512, ``"many_heads"``
# at B * H > 65,535. Never set to 0 here, so that chip_smoke.py can read them
# over every model phase of a run.
variant_launches: Counter[str] = Counter()

_lib: ctypes.CDLL | None = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kernels.load("flash_attention")
        fn = lib.vdpp_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.vdpp_flash_attention_scratch.argtypes = [ctypes.c_int] * 5
        lib.vdpp_flash_attention_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def default_static_max() -> bool:
    """``VDPP_FLASH_SOFTMAX=running`` selects the running-max kernel, as in
    the reference; anything else keeps static max."""
    return os.environ.get("VDPP_FLASH_SOFTMAX", "static") == "static"


def default_exp_bf16() -> bool:
    """``VDPP_FLASH_EXP=bf16`` selects the bf16 exponent in running-max mode,
    as in the reference."""
    return os.environ.get("VDPP_FLASH_EXP") == "bf16"


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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, static_max: bool | None = None,
    exp_bf16: bool | None = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, L, H, D) tensors, non-causal.

    ``static_max=None`` reads ``VDPP_FLASH_SOFTMAX`` (default static), and
    ``exp_bf16=None`` reads ``VDPP_FLASH_EXP``, which only the running-max
    form honours. The static form's precondition is the reference's:
    log2-logits within +-100 (|q.k/sqrt(d)| <= ~69); beyond it the static
    form saturates and only finiteness is guaranteed.

    On the card every head dim and every B * H is taken (the kernels' one
    grid axis holds 2^31 - 1 CTAs of at least 48 query rows: more rows than
    80 GB hold in q and the output at any d); the output is contiguous.
    """
    _check(q, k, v)
    if static_max is None:
        static_max = default_static_max()
    if exp_bf16 is None:
        exp_bf16 = default_exp_bf16()
    exp_bf16 = exp_bf16 and not static_max
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, static_max, exp_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, lq, h, d = q.shape
    global copies
    if d * q.element_size() % 16:
        (q, k, v), strides, copied = kernels.padded_operands(q, k, v)
    else:
        (q, k, v), strides, copied = kernels.kernel_operands(q, k, v)
    copies += copied
    lib = _kernel_lib()
    bf16 = int(q.dtype == torch.bfloat16)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        scratch = None  # q' for the kernels above d = 512
        if d > 512:
            scratch = torch.empty(lib.vdpp_flash_attention_scratch(d, bf16, b, h, lq),
                                  dtype=torch.uint8, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.vdpp_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), strides, bf16, b, h, lq,
            k.shape[1], d, int(static_max), int(exp_bf16), LOG2E / math.sqrt(d), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    launches[d] += 1
    if exp_bf16:
        exp_bf16_launches[d] += 1
    if d > 512:
        variant_launches["wide"] += 1
    if b * h > 65535:  # the grid's y axis once held B * H
        variant_launches["many_heads"] += 1
    return out


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, static_max: bool = True,
    exp_bf16: bool = False,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, any head dim, on any device;
    ``exp_bf16`` applies to the running-max form only.

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
            x = s - s.amax(dim=-1, keepdim=True)
            if exp_bf16:  # the reference's exp2 of a bf16 array: bf16 in and out
                p = torch.exp2(x.to(torch.bfloat16).float()).to(torch.bfloat16).float()
            else:
                p = torch.exp2(x)
        p = p.to(v.dtype).float()
        l = p.sum(dim=-1, keepdim=True)
        l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
        out[:, :, i:i + rows] = (torch.matmul(p, vt) * l_inv).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()
