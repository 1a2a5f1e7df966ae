"""Multi-head attention for the spatio-temporal transformer blocks
(port of ``vdpp_tpu/ops/attention.py``).

Three regimes, chosen on shapes as in the reference:

* one key (SVD's CLIP-image cross-attention): softmax over one key is 1, so
  the output is ``to_out(to_v(ctx))`` broadcast over the queries -- exact;
* self-attention with L >= 512: the flash kernel
  (:mod:`vdpp_tpu_torch.ops.flash_attention`), unless the caller passes
  ``use_flash=False``;
* otherwise plain dot-product attention with an fp32 softmax.

``temporal_self_attention`` attends over the frame axis; with
``VDPP_TEMPORAL_ATTN=pallas`` it takes the frame-attention kernel
(:mod:`vdpp_tpu_torch.ops.temporal_attention_kernel`).

Layouts follow the reference: ``(B, L, C)`` activations, ``(B, L, H, D)``
heads.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

from vdpp_tpu_torch.ops.flash_attention import flash_attention
from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.ops.temporal_attention_kernel import frame_attention

FLASH_MIN_Q_LEN = 512


def _check_attn_impl() -> None:
    """``VDPP_ATTN_IMPL``: "pallas" (default) and "splash" both take the
    port's flash kernel; nothing else is ported."""
    impl = os.environ.get("VDPP_ATTN_IMPL", "pallas")
    if impl not in ("pallas", "splash"):
        raise NotImplementedError(f"VDPP_ATTN_IMPL={impl!r} is not ported")


class Attention(nn.Module):
    """diffusers ``Attention`` parameters: ``to_q``, ``to_k``, ``to_v`` (no
    bias unless ``qkv_bias``) and ``to_out.0``."""

    def __init__(self, query_dim: int, cross_dim: int | None = None, qkv_bias: bool = False,
                 **kw):
        super().__init__()
        kv_dim = cross_dim or query_dim
        self.to_q = Linear(query_dim, query_dim, bias=qkv_bias, **kw)
        self.to_k = Linear(kv_dim, query_dim, bias=qkv_bias, **kw)
        self.to_v = Linear(kv_dim, query_dim, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim, **kw)])


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(B, L, H, D)`` dot-product attention: fp32 logits and softmax, the
    weights rounded to ``v.dtype`` before the fp32-accumulated product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.permute(0, 2, 1, 3).float(), k.permute(0, 2, 3, 1).float()) * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights.float(), v.permute(0, 2, 1, 3).float())  # (B, H, L, D)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention(
    x: torch.Tensor,
    p: Attention,
    heads: int,
    context: torch.Tensor | None = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Multi-head attention over ``(B, L, C)``; ``context (B, M, Ckv)`` makes
    it cross-attention. ``use_flash=False`` keeps self-attention on the plain
    path at any length (the CLIP tower's, as in the reference)."""
    b, l, c = x.shape
    ctx = x if context is None else context
    m = ctx.shape[1]
    d = c // heads
    if m == 1:
        # Softmax over one key is 1: the output is v for every query. to_out
        # runs on the single row before the broadcast (linear commutes with
        # broadcasting identical rows).
        out = p.to_out[0](p.to_v(ctx))  # (B, 1, C)
        return out.expand(b, l, c)
    q = p.to_q(x).reshape(b, l, heads, d)
    k = p.to_k(ctx).reshape(b, m, heads, d)
    v = p.to_v(ctx).reshape(b, m, heads, d)
    if use_flash and context is None and l >= FLASH_MIN_Q_LEN:
        _check_attn_impl()
        out = flash_attention(q, k, v)
    else:
        out = sdpa_plain(q, k, v)
    return p.to_out[0](out.reshape(b, l, c))


def temporal_self_attention(
    p: Attention, x: torch.Tensor, heads: int, batch: int, frames: int
) -> torch.Tensor:
    """Self-attention over the FRAME axis of ``(B*F, L, C)``.

    ``VDPP_TEMPORAL_ATTN`` is read at call time, as in the reference:

    * ``vpu`` (default): fp32 logits over (frame, key-frame) pairs at each
      location and head, fp32 softmax over the key frames, fp32 weighted sum
      of fp32 values, cast back at the end. The reference writes the
      contraction as a broadcast-multiply-reduce that XLA fuses; written
      literally in eager PyTorch it would build a ``(B, F, F, L, H, D)`` fp32
      tensor (7.4 GB at the SVD-XT level-0 site), so here it is the same fp32
      contraction as batched matmuls over ``(B, L, H)``;
    * ``pallas``: the frame-attention kernel on the ``(B, F, L, H, D)``
      projections as they are.
    """
    impl = os.environ.get("VDPP_TEMPORAL_ATTN", "vpu")
    if impl not in ("vpu", "pallas"):
        raise NotImplementedError(f"VDPP_TEMPORAL_ATTN={impl!r} is not ported")
    bf, l, c = x.shape
    d = c // heads
    if impl == "pallas":
        q, k, v = (proj(x).reshape(batch, frames, l, heads, d) for proj in (p.to_q, p.to_k, p.to_v))
        return p.to_out[0](frame_attention(q, k, v).reshape(bf, l, c))

    def frames_last(t: torch.Tensor) -> torch.Tensor:  # -> (B, L, H, F, D) fp32
        return t.reshape(batch, frames, l, heads, d).permute(0, 2, 3, 1, 4).float()

    q = frames_last(p.to_q(x))
    k = frames_last(p.to_k(x))
    v = frames_last(p.to_v(x))
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))  # (B, L, H, F, G)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w, v)  # (B, L, H, F, D)
    out = out.permute(0, 3, 1, 2, 4).to(x.dtype).reshape(bf, l, c)
    return p.to_out[0](out)
