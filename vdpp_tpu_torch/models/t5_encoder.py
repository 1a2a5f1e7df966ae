"""T5 text encoder (encoder only, relative-position attention) in PyTorch.

Port of ``vdpp_tpu/models/t5_encoder.py``, the conditioning tower of the
text->video DiT path; the default preset is the T5-v1.1-XXL shape (4.76 B
parameters). Same semantics as the reference:

* pre-RMSNorm blocks, every linear bias-free;
* self-attention WITHOUT the 1/sqrt(d) logit scale, plus a learned bucketed
  relative-position bias held by block 0 and shared by every layer;
* an attention mask adds -1e9 to the logits of masked keys;
* gated-GELU (tanh, v1.1) or ReLU feed-forward;
* fp32 norm statistics, logits and softmax; model-dtype (bf16) weights.

Modules carry the names of transformers' ``T5EncoderModel``
(``encoder.block.{i}.layer.0.SelfAttention.q.weight``, ...), so
``vdpp_tpu/utils/weights.py::convert_t5_encoder_state_dict`` reads the
port's ``state_dict()`` and :func:`vdpp_tpu_torch.utils.weights.
from_jax_t5_params` is its inverse. The sequence is short (64 tokens at the
app's default), so attention is plain PyTorch: no flash site.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.ops.normalization import RMSNorm, rms_norm
from vdpp_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_buckets: int = 32
    relative_max_distance: int = 128
    feed_forward_proj: str = "gated-gelu"  # "relu" | "gated-gelu"
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.feed_forward_proj not in ("relu", "gated-gelu"):
            raise ValueError(f"unknown feed_forward_proj {self.feed_forward_proj!r}")

    @classmethod
    def xxl(cls, dtype: torch.dtype = torch.bfloat16) -> T5EncoderConfig:
        """google/t5-v1_1-xxl, the CogVideoX text encoder (4.76 B parameters)."""
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> T5EncoderConfig:
        return cls(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                   relative_buckets=8, relative_max_distance=16, dtype=dtype)

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def hash_tokenize(prompt: str, vocab_size: int, max_tokens: int = 64) -> list[int]:
    """Deterministic placeholder tokenizer for random-weight runs: one token
    per whitespace word, hashed into the vocab (id 0 reserved), terminated by
    the top id as an EOS stand-in. Real T5 tokenization needs the
    sentencepiece vocab that ships with a checkpoint."""
    ids = [
        int(hashlib.sha256(w.encode()).hexdigest(), 16) % (vocab_size - 2) + 1
        for w in prompt.split()[: max_tokens - 1]
    ]
    return ids + [vocab_size - 1]


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 relative-position buckets, ``(q_len, k_len)`` int64.

    Half the buckets encode the sign; within each half, small offsets get
    exact buckets and larger ones log-spaced buckets up to ``max_distance``.
    The log is taken in fp32, as in the reference, so the integer buckets
    are the same.
    """
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    rel = mem - ctx  # key - query
    half = num_buckets // 2
    buckets = torch.where(rel > 0, half, 0)
    rel_abs = rel.abs()
    max_exact = half // 2
    scale = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    rel_large = max_exact + (
        torch.log(rel_abs.float() / max_exact) / scale.to(rel_abs.device) * (half - max_exact)
    ).to(torch.int64)
    rel_large = rel_large.clamp(max=half - 1)
    return buckets + torch.where(rel_abs < max_exact, rel_abs, rel_large)


class _Embedding(nn.Module):
    """``weight (num, dim)``, N(0, 1) at init times ``init_std``."""

    def __init__(self, num: int, dim: int, init_std: float = 1.0, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(num, dim, device=device, dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = torch.randn(self.weight.shape, generator=generator, device=self.weight.device)
        self.weight.copy_(w * self.init_std)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        d, inner = cfg.d_model, cfg.inner_dim
        self.q = Linear(d, inner, bias=False, **kw)
        self.k = Linear(d, inner, bias=False, **kw)
        self.v = Linear(d, inner, bias=False, **kw)
        self.o = Linear(inner, d, bias=False, **kw)
        if has_bias:
            self.relative_attention_bias = _Embedding(cfg.relative_buckets, cfg.num_heads,
                                                      0.1, **kw)


class _LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool, **kw):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, has_bias, **kw)
        self.layer_norm = RMSNorm(cfg.d_model, **kw)


class _DenseReluDense(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        if cfg.feed_forward_proj == "gated-gelu":
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False, **kw)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, **kw)


class _LayerFF(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(cfg, **kw)
        self.layer_norm = RMSNorm(cfg.d_model, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, first: bool, **kw):
        super().__init__()
        self.layer = nn.ModuleList([_LayerSelfAttention(cfg, first, **kw), _LayerFF(cfg, **kw)])


class _Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, **kw):
        super().__init__()
        self.block = nn.ModuleList([_Block(cfg, i == 0, **kw) for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, **kw)


class T5TextEncoder(nn.Module):
    """``forward(input_ids, attention_mask)`` -> the final-norm hidden states
    ``(B, L, d_model)``, the tokens a text->video DiT cross-attends.
    Parameters are allocated on ``device`` (``None`` means CUDA, which must
    exist) and left unset: load a state dict or call :meth:`init_weights`."""

    def __init__(self, config: T5EncoderConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = cfg = config or T5EncoderConfig.xxl()
        kw = dict(device=resolve_device(device), dtype=cfg.dtype)
        self.shared = _Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = _Stack(cfg, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> T5TextEncoder:
        """Random init as the reference's ``init``: N(0, 1) embeddings, a
        0.1 x N(0, 1) position bias, LeCun-normal linears, unit norm scales."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def _attention(self, attn: _SelfAttention, h: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, l, _ = h.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, L, inner) -> (B, H, L, dk) fp32
            return t.reshape(b, l, cfg.num_heads, cfg.d_kv).permute(0, 2, 1, 3).float()

        q, k, v = heads(attn.q(h)), heads(attn.k(h)), attn.v(h)
        logits = torch.matmul(q, k.transpose(-1, -2)) + bias  # no 1/sqrt(d) in T5
        w = torch.softmax(logits, dim=-1).to(v.dtype).float()
        out = torch.matmul(w, heads(v)).permute(0, 2, 1, 3).reshape(b, l, cfg.inner_dim)
        return attn.o(out.to(h.dtype))

    @torch.inference_mode()
    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids ``(B, L)`` integers; attention_mask ``(B, L)``, 1 = attend."""
        cfg = self.config
        l = input_ids.shape[1]
        dev = self.shared.weight.device
        x = self.shared.weight[input_ids.to(dev)]  # (B, L, D)
        buckets = relative_position_buckets(l, l, cfg.relative_buckets,
                                            cfg.relative_max_distance, device=dev)
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        bias = rel[buckets].float().permute(2, 0, 1)[None]  # (1, H, L, L)
        if attention_mask is not None:
            keep = attention_mask.to(dev).bool()[:, None, None, :]
            bias = bias + torch.where(keep, 0.0, -1e9)
        for blk in self.encoder.block:
            sa, ff = blk.layer
            x = x + self._attention(sa.SelfAttention, rms_norm(x, sa.layer_norm,
                                                               cfg.layer_norm_eps), bias)
            hh = rms_norm(x, ff.layer_norm, cfg.layer_norm_eps)
            dense = ff.DenseReluDense
            if cfg.feed_forward_proj == "gated-gelu":
                gate = F.gelu(dense.wi_0(hh).float(), approximate="tanh").to(x.dtype)
                hh = gate * dense.wi_1(hh)
            else:
                hh = F.relu(dense.wi(hh))
            x = x + dense.wo(hh)
        return rms_norm(x, self.encoder.final_layer_norm, cfg.layer_norm_eps)

