"""Multi-head attention for the spatio-temporal transformer blocks
(port of ``vdpp_tpu/ops/attention.py``).

Three regimes, chosen on shapes as in the reference:

* one key (SVD's CLIP-image cross-attention): softmax over one key is 1, so
  the output is ``to_out(to_v(ctx))`` broadcast over the queries -- exact;
* self-attention with L >= ``VDPP_FLASH_MIN_L`` (default 512): the flash
  kernel (:mod:`vdpp_tpu_torch.ops.flash_attention`), unless the caller
  passes ``use_flash=False``;
* otherwise plain dot-product attention with an fp32 softmax.

``temporal_self_attention`` attends over the frame axis; with
``VDPP_TEMPORAL_ATTN=pallas`` it takes the frame-attention kernel
(:mod:`vdpp_tpu_torch.ops.temporal_attention_kernel`).

Under intra-sample parallelism the queries stay local and the keys and
values are gathered (``parallel/collectives.py``): ``attention(seq_axis=)``
over the token shards of self-attention, ``temporal_self_attention(
frame_axis=)`` over the frame shards. The routes are chosen on the local
query length, as in the reference; under a frame axis the frame-attention
kernel (square frame attention) gives way to the default form, as there,
and ``frame_axis_fallbacks`` counts those calls.

The reference's routing switches, each read at call time as there:

* ``VDPP_ATTN_IMPL`` for the long self-attention sites: ``pallas`` (default)
  and ``splash`` take the flash kernel (the reference's splash is JAX's
  library kernel, which the port maps onto its own); ``xla`` and ``naive``
  are plain attention in the reference (XLA's attention, the materialized
  scores), so :func:`sdpa_plain` on every device here; ``identity`` skips the
  attention core (profiling only);
* ``VDPP_FLASH_MIN_L``: the length from which self-attention takes that route;
* ``VDPP_FUSE_QKV=1``: self-attention's three projections as one product
  with the concatenated weight (the same contractions), unless one of them
  is held in int8 (each keeps its own scales), as in the reference;
* ``VDPP_TEMPORAL_ATTN``: ``vpu`` (default), ``pallas``, ``transpose`` or
  ``einsum``, the reference's four forms of frame attention;
* ``VDPP_ABLATE_TEMPORAL_ATTN=1``: the temporal block's attention core
  skipped (``to_out(v)``; profiling only).

Layouts follow the reference: ``(B, L, C)`` activations, ``(B, L, H, D)``
heads.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

from vdpp_tpu_torch.ops.flash_attention import flash_attention
from vdpp_tpu_torch.ops.linear import Linear, linear
from vdpp_tpu_torch.ops.quant import is_quantized
from vdpp_tpu_torch.ops.temporal_attention_kernel import frame_attention
from vdpp_tpu_torch.parallel.collectives import Axis, all_gather

FLASH_MIN_Q_LEN = 512  # unless VDPP_FLASH_MIN_L says otherwise

# Calls of temporal_self_attention under a frame axis that asked for the
# frame-attention kernel (VDPP_TEMPORAL_ATTN=pallas) and took the default
# form, as the reference routes them.
frame_axis_fallbacks = 0


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


def _self_qkv(x: torch.Tensor, p: Attention) -> tuple[torch.Tensor, ...]:
    """``(q, k, v)`` of self-attention over ``x``: under ``VDPP_FUSE_QKV=1``
    from one product with the three weights (and biases) concatenated, as
    the reference's ``_qkv_fused``, when all three have a bias or none has
    and none is held in int8."""
    projs = (p.to_q, p.to_k, p.to_v)
    biases = {proj.bias is None for proj in projs}
    if (os.environ.get("VDPP_FUSE_QKV", "0") == "1" and len(biases) == 1
            and not any(is_quantized(proj) for proj in projs)):
        w = torch.cat([p.to_q.weight, p.to_k.weight, p.to_v.weight])
        b = None if p.to_q.bias is None else torch.cat([p.to_q.bias, p.to_k.bias, p.to_v.bias])
        return linear(x, w, b).chunk(3, dim=-1)
    return p.to_q(x), p.to_k(x), p.to_v(x)


def attention(
    x: torch.Tensor,
    p: Attention,
    heads: int,
    context: torch.Tensor | None = None,
    use_flash: bool = True,
    seq_axis: Axis | None = None,
) -> torch.Tensor:
    """Multi-head attention over ``(B, L, C)``; ``context (B, M, Ckv)`` makes
    it cross-attention. ``use_flash=False`` keeps self-attention on the plain
    path at any length (the CLIP tower's, as in the reference).

    ``seq_axis``: L is split over that axis; self-attention gathers K and V
    over it, so the local queries attend over every key (the keys in shard
    order: softmax does not depend on their order). Cross-attention needs
    nothing (the context is whole on every rank)."""
    b, l, c = x.shape
    ctx = x if context is None else context
    m = ctx.shape[1]
    d = c // heads
    if m == 1 and (context is not None or seq_axis is None):
        # Softmax over one key is 1: the output is v for every query. to_out
        # runs on the single row before the broadcast (linear commutes with
        # broadcasting identical rows). Not for a one-token shard of
        # self-attention, which still attends over the gathered keys.
        out = p.to_out[0](p.to_v(ctx))  # (B, 1, C)
        return out.expand(b, l, c)
    if context is None:
        q, k, v = (t.reshape(b, l, heads, d) for t in _self_qkv(x, p))
        if seq_axis is not None:
            k, v = all_gather(k, seq_axis, 1), all_gather(v, seq_axis, 1)
    else:
        q = p.to_q(x).reshape(b, l, heads, d)
        k = p.to_k(ctx).reshape(b, m, heads, d)
        v = p.to_v(ctx).reshape(b, m, heads, d)
    impl = os.environ.get("VDPP_ATTN_IMPL", "pallas")
    min_l = int(os.environ.get("VDPP_FLASH_MIN_L", FLASH_MIN_Q_LEN))
    if use_flash and context is None and l >= min_l and impl != "naive":
        if impl == "identity":  # profiling only: the projections without the core
            out = v
        elif impl == "xla":
            out = sdpa_plain(q, k, v)
        else:
            out = flash_attention(q, k, v)
    else:
        out = sdpa_plain(q, k, v)
    return p.to_out[0](out.reshape(b, l, c))


def temporal_self_attention(
    p: Attention, x: torch.Tensor, heads: int, batch: int, frames: int,
    frame_axis: Axis | None = None,
) -> torch.Tensor:
    """Self-attention over the FRAME axis of ``(B*F, L, C)``.

    ``frame_axis``: the frames are split over that axis (``frames`` is the
    local count); K and V are gathered over it, so the local frames attend
    over every frame.

    ``VDPP_TEMPORAL_ATTN`` is read at call time, as in the reference:

    * ``vpu`` (default, and any value the reference does not name): fp32
      logits over (frame, key-frame) pairs at each location and head, fp32
      softmax over the key frames, fp32 weighted sum of fp32 values, cast
      back at the end. The reference writes the contraction as a
      broadcast-multiply-reduce that XLA fuses; written literally in eager
      PyTorch it would build a ``(B, F, F, L, H, D)`` fp32 tensor (7.4 GB at
      the SVD-XT level-0 site), so here it is the same fp32 contraction as
      batched matmuls over ``(B, L, H)``;
    * ``pallas``: the frame-attention kernel on the ``(B, F, L, H, D)``
      projections as they are; under a frame axis the ``vpu`` form instead
      (the kernel attends square), counted in ``frame_axis_fallbacks``;
    * ``transpose`` and ``einsum``: fp32 logits and softmax, the weights
      rounded to the values' dtype before the fp32-accumulated product. The
      reference lays the same arithmetic out two ways (a copy to
      ``(B*L, H, F, D)``, or batched products in place) for XLA's sake; here
      it is one form, as batched matmuls over ``(B, L, H)``.
    """
    global frame_axis_fallbacks
    bf, l, c = x.shape
    d = c // heads
    q, k, v = (t.reshape(batch, frames, l, heads, d) for t in _self_qkv(x, p))
    if os.environ.get("VDPP_ABLATE_TEMPORAL_ATTN") == "1":  # profiling only
        return p.to_out[0](v.reshape(bf, l, c))
    if frame_axis is not None:
        k, v = all_gather(k, frame_axis, 1), all_gather(v, frame_axis, 1)
    impl = os.environ.get("VDPP_TEMPORAL_ATTN", "vpu")
    if impl == "pallas" and frame_axis is not None:
        impl = "vpu"
        frame_axis_fallbacks += 1
    scale = 1.0 / math.sqrt(d)
    if impl == "pallas":
        out = frame_attention(q, k, v)
    else:
        # (B, L, H, F, D) views; the products batch over (B, L, H).
        qf, kf, vf = (t.permute(0, 2, 3, 1, 4).float() for t in (q, k, v))
        w = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
        if impl in ("transpose", "einsum"):
            w = w.to(v.dtype).float()
        out = torch.matmul(w, vf).to(x.dtype).permute(0, 3, 1, 2, 4)  # (B, F, L, H, D)
    return p.to_out[0](out.reshape(bf, l, c))
