"""CLIP vision tower (ViT + projection) for SVD's image conditioning: the port
of ``vdpp_tpu/models/clip_encoder.py`` (``CLIPVisionConfig``,
``CLIPVisionEncoder.apply`` and ``preprocess_image``).

A pre-norm ViT: a stride-p patch convolution, a class token and learned
position embeddings, ``pre_layrnorm``, layers of self-attention and an
exact-GELU MLP, then the class token through ``post_layernorm`` and a linear
projection without bias. Modules carry the transformers
``CLIPVisionModelWithProjection`` names, so ``state_dict()`` has the keys of
the checkpoint's ``image_encoder``. SVD's tower is laion ViT-H/14: width
1280, 32 layers, 16 heads (head dim 80), patch 14, 257 tokens at 224x224,
projection 1024, fp32 as in the reference.

Its attention runs at L = 257 with ``use_flash=False``, as the reference's
does: the plain path, never the flash kernel (which has no head dim 80).

``preprocess_image`` is host-side preprocessing with PyTorch alone (no
Pillow): a shortest-edge bicubic resize, a centre crop, and the CLIP
mean/std normalization.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.attention import attention
from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.ops.normalization import Norm, layer_norm
from vdpp_tpu_torch.utils.device import resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """``vit_h_14()`` is SVD's image encoder; ``tiny()`` a 2-layer model for
    tests."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @classmethod
    def vit_h_14(cls, dtype: torch.dtype = torch.float32) -> CLIPVisionConfig:
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> CLIPVisionConfig:
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                   projection_dim=16, dtype=dtype)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Weight(nn.Module):
    """A module holding one ``weight`` (the patch convolution, which has no
    bias, and the position-embedding table)."""

    def __init__(self, *shape: int, std: float | None = None, device=None, dtype=torch.float32):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(*shape, device=device, dtype=dtype),
                                   requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.std or 1.0 / math.sqrt(self.weight[0].numel())  # LeCun over the fan-in
        w = torch.randn(self.weight.shape, generator=generator, device=self.weight.device)
        self.weight.copy_(w * std)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.patch_embedding = _Weight(d, 3, p, p, **kw)
        self.position_embedding = _Weight(cfg.num_patches + 1, d, std=0.02, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = torch.randn(self.class_embedding.shape, generator=generator,
                        device=self.class_embedding.device)
        self.class_embedding.copy_(w * 0.02)


class _SelfAttention(nn.Module):
    """``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` with biases, seen
    by :func:`~vdpp_tpu_torch.ops.attention.attention` under the names it
    reads."""

    def __init__(self, d: int, **kw):
        super().__init__()
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)

    to_q = property(lambda self: self.q_proj)
    to_k = property(lambda self: self.k_proj)
    to_v = property(lambda self: self.v_proj)
    to_out = property(lambda self: (self.out_proj,))


class _MLP(nn.Module):
    def __init__(self, d: int, hidden: int, **kw):
        super().__init__()
        self.fc1 = Linear(d, hidden, **kw)
        self.fc2 = Linear(hidden, d, **kw)


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = Norm(d, **kw)
        self.self_attn = _SelfAttention(d, **kw)
        self.layer_norm2 = Norm(d, **kw)
        self.mlp = _MLP(d, int(d * cfg.mlp_ratio), **kw)

    def forward(self, x: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
        eps = cfg.layer_norm_eps
        h = layer_norm(x, self.layer_norm1, eps)
        x = x + attention(h, self.self_attn, cfg.num_heads, use_flash=False)
        h = self.mlp.fc1(layer_norm(x, self.layer_norm2, eps))
        h = F.gelu(h.float()).to(x.dtype)  # exact (erf) GELU in fp32
        return x + self.mlp.fc2(h)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg, **kw) for _ in range(cfg.num_layers)])


class _VisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **kw):
        super().__init__()
        self.embeddings = _Embeddings(cfg, **kw)
        self.pre_layrnorm = Norm(cfg.hidden_size, **kw)  # (sic) transformers' name
        self.encoder = _Encoder(cfg, **kw)
        self.post_layernorm = Norm(cfg.hidden_size, **kw)


class CLIPVisionEncoder(nn.Module):
    """The vision tower; :meth:`apply` gives the projected image embedding.
    Parameters are allocated on ``device`` (``None`` means CUDA, which must
    exist) and left unset: load a state dict or call :meth:`init_weights`."""

    def __init__(self, config: CLIPVisionConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = cfg = config or CLIPVisionConfig.vit_h_14()
        kw = dict(device=resolve_device(device), dtype=cfg.dtype)
        self.vision_model = _VisionModel(cfg, **kw)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim, bias=False, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> CLIPVisionEncoder:
        """Random init as the reference's ``init``: LeCun-normal matrices,
        N(0, 0.02) class and position embeddings, zero biases, unit norm
        scales."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    @torch.inference_mode()
    def apply(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3), preprocessed -> image embeds (B, projection_dim)."""
        cfg = self.config
        vm = self.vision_model
        emb = vm.embeddings
        x = pixels.to(cfg.dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, emb.patch_embedding.weight, stride=cfg.patch_size)  # (B, D, H/p, W/p)
        x = x.flatten(2).transpose(1, 2)  # (B, N, D), patches in row-major order
        cls_tok = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls_tok, x], dim=1) + emb.position_embedding.weight
        x = layer_norm(x, vm.pre_layrnorm, cfg.layer_norm_eps)
        for layer in vm.encoder.layers:
            x = layer(x, cfg)
        pooled = layer_norm(x[:, 0], vm.post_layernorm, cfg.layer_norm_eps)
        return self.visual_projection(pooled)


def preprocess_image(image, size: int = 224) -> torch.Tensor:
    """CLIP preprocessing of an ``(H, W, 3)`` uint8 image (an array or a
    tensor): shortest-edge bicubic resize (no side below ``size``), centre
    crop to ``size`` x ``size``, rescale to [0, 1], normalize with the CLIP
    mean and std. Returns ``(size, size, 3)`` fp32 on the CPU.

    The resize is ``F.interpolate(mode="bicubic", antialias=True)`` on the
    uint8 tensor in channels-last memory, PyTorch's port of Pillow's
    resampling (a = -0.5, fixed-point weights): within one uint8 level of the
    reference's ``Image.resize(BICUBIC)``. On float tensors the same call
    differs by more, so the dtype stays uint8 through the resize.
    """
    img = torch.as_tensor(np.asarray(image)).to(torch.uint8)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    new_w, new_h = max(size, round(w * scale)), max(size, round(h * scale))
    x = img.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x, size=(new_h, new_w), mode="bicubic", antialias=True,
                          align_corners=False)
    left, top = (new_w - size) // 2, (new_h - size) // 2
    x = x[0, :, top:top + size, left:left + size].permute(1, 2, 0)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float64)
    std = torch.tensor(CLIP_STD, dtype=torch.float64)
    return ((x.to(torch.float32) / 255.0).double() - mean).div(std).float()
