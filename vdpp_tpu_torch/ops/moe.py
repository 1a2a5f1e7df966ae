"""Mixture-of-Experts feed-forward with expert parallelism: top-1, dropless
(port of ``vdpp_tpu/ops/moe.py``).

* **Routing**: an fp32 gate and softmax; every token goes to its argmax
  expert (ties to the first, as in both libraries) with that probability as
  its weight.
* **Dense dispatch** (:func:`moe_ff`, the default): each expert runs over
  every token and a one-hot combine keeps each token's own expert, so
  nothing drops and the result does not depend on how the experts are
  split. **Gather dispatch** (:func:`moe_ff_gather`, ``VDPP_MOE_DISPATCH=
  gather``): tokens sorted by expert, each expert runs over a window of
  ``capacity`` tokens, and tokens past it drop (their output is 0); at a
  capacity factor of at least the expert count nothing drops and it equals
  the dense form. The window reproduces the reference's
  ``dynamic_slice_in_dim``, whose start is clamped to ``T - capacity``, so
  the same tokens drop.
* **Expert parallelism**: the stacks ``w_in (E, D, I)``, ``b_in (E, I)``,
  ``w_out (E, I, D)`` and ``b_out (E, D)`` keep the reference's layout with
  the expert axis first; :func:`shard_experts` leaves a rank of an
  ``expert`` axis only its ``E / k`` experts (their int8 tensors and scales
  too) and frees the rest. The gate stays whole. Each rank computes its
  experts' part and one sum over the axis (``collectives.psum``, in shard
  order) combines them: a token's output comes from one expert, so the sum
  adds zeros to it and every split gives the same bits.

The expert products take operands in the weights' dtype and give fp32, as
the reference's ``preferred_element_type=float32`` does, so each product
meets its bias, GELU and combine unrounded (:func:`_mm_f32`); there is no
Pallas kernel here to port (the reference computes them with ``einsum``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.ops.quant import weight_for
from vdpp_tpu_torch.parallel.collectives import Axis, psum


class MoEFF(nn.Module):
    """The gate (``gate.weight (E, D)``, fp32, no bias) and the expert stacks.
    ``num_experts`` is the global count; a rank of an expert axis holds
    ``E / k`` of them after :func:`shard_experts`."""

    int8_weights = ("w_in", "w_out")

    def __init__(self, dim: int, num_experts: int, inner_dim: int | None = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        inner = inner_dim or 4 * dim
        self.num_experts = num_experts
        self.gate = Linear(dim, num_experts, bias=False, device=device, dtype=torch.float32)
        kw = dict(device=device, dtype=dtype)
        for name, shape in (("w_in", (num_experts, dim, inner)), ("b_in", (num_experts, inner)),
                            ("w_out", (num_experts, inner, dim)), ("b_out", (num_experts, dim))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape, **kw),
                                                       requires_grad=False))
        self.expert_shard: tuple[int, int] | None = None  # (index, size) once sharded

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) stacks over the square root of their fan-in, zero biases
        (the gate is a Linear and resets itself)."""
        for name in ("w_in", "w_out"):
            p = getattr(self, name)
            w = torch.randn(p.shape, generator=generator, device=p.device)
            p.copy_(w / math.sqrt(p.shape[1]))
        self.b_in.zero_()
        self.b_out.zero_()


def shard_experts(params, axis: Axis | None):
    """Leave each MoE module of ``params`` (a module or a bundle) only the
    experts of this rank of ``axis``: every tensor of its stacks, the int8
    ones and their scales too, cut to ``[index * E / k, (index + 1) * E / k)``
    along its first axis and copied, so the whole stack is freed. Done once;
    None (no axis) leaves everything. Returns ``params``."""
    from vdpp_tpu_torch.utils.memory import bundle_modules

    if axis is None:
        return params
    for module in bundle_modules(params):
        for m in module.modules():
            if not isinstance(m, MoEFF):
                continue
            if m.expert_shard == (axis.index, axis.size):
                continue
            if m.expert_shard is not None:
                raise ValueError(f"experts already split {m.expert_shard}, asked for "
                                 f"{(axis.index, axis.size)}")
            if m.num_experts % axis.size:
                raise ValueError(f"{m.num_experts} experts do not split over an expert axis "
                                 f"of {axis.size}")
            n = m.num_experts // axis.size
            for name, p in list(m._parameters.items()):
                part = p.detach()[axis.index * n:(axis.index + 1) * n].clone()
                m._parameters[name] = nn.Parameter(part, requires_grad=False)
            m.expert_shard = (axis.index, axis.size)
    return params


def expert_layout(params, stage):
    """``StepPipeline``'s ``param_spec`` for an expert-parallel bundle: the
    experts of ``stage``'s place on its expert axis (:func:`shard_experts`)."""
    return shard_experts(params, stage.expert)


def _route(moe: MoEFF, x: torch.Tensor, expert_axis: Axis | None):
    """What both dispatch forms share: the fp32 gate softmax, the local stacks
    in the activation dtype, their count and the first one's global index."""
    logits = F.linear(x.float(), weight_for(moe.gate, torch.float32))  # (B, L, E)
    probs = torch.softmax(logits, dim=-1)
    w_in = weight_for(moe, x.dtype, "w_in")
    w_out = weight_for(moe, x.dtype, "w_out")
    e_local = w_in.shape[0]
    if expert_axis is None and e_local != moe.num_experts:
        raise ValueError(f"single-device call needs all {moe.num_experts} experts, got "
                         f"{e_local}")
    off = expert_axis.index * e_local if expert_axis is not None else 0
    return probs, w_in, moe.b_in, w_out, moe.b_out, e_local, off


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or 3-D batched) with an fp32 result and no rounding of
    the product to the operands' dtype: on the card cuBLAS writes fp32 from
    bf16 operands (``out_dtype``); on the CPU, which has no ``out_dtype``, the
    operands are widened first, which is exact."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        mm = torch.bmm if a.ndim == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def moe_ff(moe: MoEFF, x: torch.Tensor, expert_axis: Axis | None = None) -> torch.Tensor:
    """``(B, L, D) -> (B, L, D)`` top-1 MoE feed-forward, dense one-hot
    dispatch. ``expert_axis``: the stacks are this rank's share of that
    axis; the partial outputs are summed over it."""
    b, l, d = x.shape
    t = b * l
    probs, w_in, b_in, w_out, b_out, e_local, off = _route(moe, x, expert_axis)
    combine = (F.one_hot(probs.argmax(dim=-1), moe.num_experts).float()
               * probs.amax(dim=-1, keepdim=True)).reshape(t, -1)[:, off:off + e_local]
    xd = x.to(w_in.dtype).reshape(1, t, d).expand(e_local, t, d)
    h = _mm_f32(xd, w_in) + b_in[:, None, :].float()  # (E_local, T, I)
    h = F.gelu(h, approximate="tanh").to(xd.dtype)
    o = _mm_f32(h, w_out) + b_out[:, None, :].float()  # (E_local, T, D)
    out = torch.einsum("etd,te->td", o, combine)
    if expert_axis is not None:
        out = psum(out, expert_axis)
    return out.reshape(b, l, d).to(x.dtype)


def moe_ff_gather(moe: MoEFF, x: torch.Tensor, expert_axis: Axis | None = None,
                  capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-based token-gather dispatch: tokens sorted expert-major
    (token-minor), each local expert runs over a window of ``capacity =
    min(ceil(T * capacity_factor / E), T)`` tokens from its segment's start
    (clamped to ``T - capacity``; tokens of other experts in the window are
    masked), and tokens past the capacity drop. Same parameters and expert
    axis as :func:`moe_ff`."""
    b, l, d = x.shape
    t = b * l
    num_experts = moe.num_experts
    probs, w_in, b_in, w_out, b_out, e_local, off = _route(moe, x, expert_axis)
    assign = probs.argmax(dim=-1).reshape(t)
    gatev = probs.amax(dim=-1).reshape(t)
    cap = int(-(-t * capacity_factor // num_experts))  # ceil, as the reference writes it
    cap = min(cap, t)
    order = torch.argsort(assign * t + torch.arange(t, device=x.device))
    sorted_assign = assign[order]
    # a count per expert without bincount, whose output size waits on the card
    counts = torch.zeros(num_experts, dtype=assign.dtype, device=x.device).index_add_(
        0, assign, torch.ones_like(assign))
    starts = torch.cumsum(counts, 0) - counts
    flat = x.reshape(t, d)
    out = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    window = torch.arange(cap, device=x.device)
    for j in range(e_local):
        e = off + j
        idx = starts[e].clamp(0, t - cap) + window
        tok, seg = order[idx], sorted_assign[idx]
        xt = flat[tok].to(w_in.dtype)
        h = F.gelu(_mm_f32(xt, w_in[j]) + b_in[j].float(), approximate="tanh")
        o = _mm_f32(h.to(xt.dtype), w_out[j]) + b_out[j].float()
        o = o * ((seg == e).float() * gatev[tok])[:, None]
        out.index_add_(0, tok, o)
    if expert_axis is not None:
        out = psum(out, expert_axis)
    return out.reshape(b, l, d).to(x.dtype)
