"""int8 weights: weight-only (per-output-channel scales) and W8A8 (port of
``vdpp_tpu/ops/quant.py``).

Weight-only int8 halves the parameter bytes of a bf16 model at rest; the
compute sites dequantize a weight to the activation dtype when they read it
and compute as before. W8A8 (``quantize_model(act_int8=True)``) also marks
the big linear and spatial-conv weights ``q8``: at those sites the
activation is quantized on the fly (per row for a linear, per tensor for a
conv) and the product runs int8 x int8 -> int32 (``torch._int_mm``, cuBLASLt
on the card), then is rescaled by both scales.

The arithmetic is the reference's, so the int8 tensors and scales are the
same bits: symmetric, ``scale = amax / 127`` (1 where ``amax`` is 0),
``q = clip(round_half_even(w / scale), -127, 127)``, one scale per output
channel. The output channel is axis 0 of the port's ``(out, in)``, OIHW and
OIDHW layouts, where the JAX package's is the last axis of ``(in, out)``,
HWIO and DHWIO; a scale keeps its tensor's rank (``(out, 1, ...)``) so it
broadcasts. An MoE expert stack keeps the reference's ``(E, in, out)``
layout and gets one scale per (expert, output channel), ``(E, 1, out)``.

A quantized module drops its float tensor ``<name>`` for two parameters,
``<name>_q`` (or ``<name>_q8``, the W8A8 mark, as the reference marks it with
the key name) and ``<name>_scale``, and records the form in an ``int8`` dict
on the module (absent: nothing quantized). Parameters, not buffers, so that
FSDP (``parallel/data_parallel.py``) shards and gathers them by its one rule,
and an expert rank keeps only its experts' (``ops/moe.py``).
:func:`load_int8_forms` gives a module built on the meta device the forms a
saved state dict holds.

``torch._int_mm`` on the card takes more than 16 rows and an inner and an
outer extent divisible by 8: :func:`int_mm` pads with zeros where a shape
falls short (zeros add nothing to an integer product), never falling back to
a float product.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.parallel.collectives import Axis, pmax

# torch._int_mm calls since the count was last set to 0 (by tests and
# chip_smoke.py): every W8A8 site's product, on any device.
int_mm_calls = 0

_MIN_ROWS = 17  # torch._int_mm on the card wants more than 16 rows


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127``, 1 where ``amax`` is 0. The divisor is a tensor on
    ``amax``'s device: on the card PyTorch multiplies by the reciprocal of a
    Python scalar divisor, which is not the same bits as the division the
    reference and the CPU make."""
    return torch.where(amax == 0.0, 1.0, amax / amax.new_full((), 127.0))


def quantize_weight(w: torch.Tensor, expert_stacked: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """float ``w`` -> ``(q int8, scale fp32)``: one scale per output channel
    (axis 0: ``(out, 1, ...)``), or for an expert stack ``(E, in, out)`` one
    per (expert, output channel), ``(E, 1, out)``."""
    wf = w.float()
    if expert_stacked and wf.ndim >= 3:
        amax = wf.abs().amax(dim=tuple(range(1, wf.ndim - 1)), keepdim=True)
    else:
        amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)), keepdim=True)
    scale = _scale(amax)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_forms(module: nn.Module) -> Mapping[str, str]:
    """``{name: "q" | "q8"}`` of the module's quantized tensors."""
    return module.__dict__.get("int8", {})


def is_quantized(module: nn.Module, name: str = "weight") -> bool:
    return name in int8_forms(module)


def is_a8(module: nn.Module, name: str = "weight") -> bool:
    """The tensor carries the W8A8 mark: its site quantizes the activation
    too and runs the int8 product."""
    return int8_forms(module).get(name) == "q8"


def int8_tensor(module: nn.Module, name: str = "weight") -> torch.Tensor:
    return getattr(module, f"{name}_{int8_forms(module)[name]}")


def weight_for(module: nn.Module, dtype: torch.dtype, name: str = "weight") -> torch.Tensor:
    """The module's ``name`` tensor in ``dtype``, dequantized when it is held
    in int8: the one place the quantized form is read as floats (linears,
    convs and MoE stacks all go through it)."""
    if is_quantized(module, name):
        return (int8_tensor(module, name).float() * getattr(module, name + "_scale")).to(dtype)
    return getattr(module, name).to(dtype)


def weight_shape(module: nn.Module, name: str = "weight") -> torch.Size:
    t = int8_tensor(module, name) if is_quantized(module, name) else getattr(module, name)
    return t.shape


def set_int8(module: nn.Module, name: str, q: torch.Tensor, scale: torch.Tensor,
             form: str) -> None:
    """Hold ``name`` as ``<name>_<form>`` and ``<name>_scale``; the float
    tensor, if any, is dropped."""
    module._parameters.pop(name, None)
    module.register_parameter(f"{name}_{form}", nn.Parameter(q, requires_grad=False))
    module.register_parameter(f"{name}_scale", nn.Parameter(scale, requires_grad=False))
    module.int8 = {**int8_forms(module), name: form}


def _a8_eligible(w: torch.Tensor, a8_convs: bool) -> bool:
    """A linear ``(out, in)`` or, with ``a8_convs``, a spatial conv ``(out,
    in, kh, kw)`` with at least 64 channels on both sides."""
    if w.ndim == 2 or (w.ndim == 4 and a8_convs):
        return min(w.shape[0], w.shape[1]) >= 64
    return False


def quantize_model(module: nn.Module, min_ndim: int = 2, min_size: int = 4096,
                   act_int8: bool = False, a8_convs: bool = True) -> nn.Module:
    """Quantize, in place, every float weight of at least ``min_ndim`` dims
    and ``min_size`` elements that a module names in its ``int8_weights``
    (linears' and convs' ``weight``, MoE stacks' ``w_in`` and ``w_out``):
    the tensors the reference's ``quantize_tree`` picks (its ``w``, ``w_in``
    and ``w_out`` leaves). Biases, norms and smaller weights stay float.

    ``act_int8=True`` (W8A8) marks ``q8`` the linears and (with
    ``a8_convs``) spatial convs with at least 64 input and output channels;
    temporal convs and MoE stacks stay weight-only, as there."""
    for m in module.modules():
        for name in getattr(type(m), "int8_weights", ()):
            w = m._parameters.get(name)
            if (w is None or not w.is_floating_point() or w.ndim < min_ndim
                    or w.numel() < min_size):
                continue
            stacked = name != "weight"
            a8 = act_int8 and not stacked and _a8_eligible(w, a8_convs)
            q, scale = quantize_weight(w.detach(), expert_stacked=stacked)
            set_int8(m, name, q, scale, "q8" if a8 else "q")
    return module


def load_int8_forms(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Give ``module`` (built float, e.g. on the meta device) the int8 form of
    every tensor that ``state`` holds quantized, so that ``load_state_dict(
    state)`` finds its names. A state without int8 tensors changes
    nothing."""
    for prefix, m in module.named_modules():
        for name in getattr(type(m), "int8_weights", ()):
            key = f"{prefix}.{name}" if prefix else name
            for form in ("q", "q8"):
                if f"{key}_{form}" in state:
                    set_int8(m, name, state[f"{key}_{form}"], state[f"{key}_scale"], form)
    return module


def quantize_activation(x: torch.Tensor, per_row: bool = True,
                        pmax_axes: Sequence[Axis] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization: ``(q int8, scale fp32)``.

    ``per_row=True``: a scale per row of the last axis, ``(..., 1)``, for a
    product's left operand; ``per_row=False``: one scalar for the tensor (a
    conv quantizes before its im2col), its ``amax`` taken over every rank of
    ``pmax_axes``, the axes that split the tensor's elements, so that each
    shard derives the scale the unsplit tensor has."""
    xf = x.float()
    if per_row:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    else:
        amax = xf.abs().amax()
        if pmax_axes:
            amax = pmax(amax, pmax_axes)
    scale = _scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w (N, K)^T`` in int8 -> int32 by ``torch._int_mm``. On the
    card a shape it refuses (M <= 16, K or N not divisible by 8) is padded
    with zero rows and columns, whose products add nothing, and the result
    is cut back to ``(M, N)``."""
    global int_mm_calls
    int_mm_calls += 1
    if a.device.type != "cuda":
        return torch._int_mm(a, w.t())
    m, k = a.shape
    n = w.shape[0]
    pk, pn = -k % 8, -n % 8
    if pk:
        a, w = F.pad(a, (0, pk)), F.pad(w, (0, pk))
    if pn:
        w = F.pad(w, (0, 0, 0, pn))
    if m < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:m, :n]


def int8_dot(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w^T`` for an a8-marked weight ``q8 (N, K)`` with its
    ``scale (N, 1)``: ``x`` quantized per row, the int32 product, then
    ``y * row scale * channel scale`` in fp32, in that order. Returns fp32
    ``(..., N)``; the caller adds the bias and casts."""
    q, s = quantize_activation(x, per_row=True)
    y = int_mm(q.reshape(-1, q.shape[-1]), q8).reshape(*x.shape[:-1], q8.shape[0])
    return y.float() * s * scale.reshape(-1)
