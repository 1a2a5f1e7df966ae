"""Temporal VAE decoder of the SVD family in PyTorch: the port of
``vdpp_tpu/models/vae.py`` (``VAEConfig``, the decoder's blocks,
``TemporalVAEDecoder.apply`` and ``.decode_chunked``).

The decoder turns denoised latents ``(B, F, h, w, 4)`` into frames
``(B, F, 8h, 8w, 3)``: conv_in, a mid block (spatio-temporal ResNet,
single-head spatial self-attention, spatio-temporal ResNet), up blocks of
spatio-temporal ResNets with nearest-2x upsamples, a GroupNorm+SiLU head,
conv_out and a final (3, 1, 1) temporal conv over the frames. Modules carry
the diffusers ``AutoencoderKLTemporalDecoder`` names under ``decoder.``, so
``state_dict()`` has the keys of the checkpoint's decoder subtree.
Activations stay channels-last as in the reference; GroupNorm statistics are
fp32 and the default dtype is fp32.

The mid-block attention runs over all h * w latent positions with one head
of d = 512 (at SVD, 72 * 128 = 9216 positions): the port's ``attention``
sends it to the flash kernel at head dim 512, with the static-max softmax,
as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from vdpp_tpu_torch.models.svd_unet import AlphaBlender, _Block, _Resample
from vdpp_tpu_torch.ops.attention import Attention, attention
from vdpp_tpu_torch.ops.conv import Conv2d, ConvTemporal, conv2d, conv_temporal, upsample_nearest_2x
from vdpp_tpu_torch.ops.normalization import Norm, group_norm, group_norm_silu
from vdpp_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class VAEConfig:
    """``svd()`` is stable-video-diffusion's temporal-decoder VAE; ``tiny()``
    is a structurally identical 2-level model for tests."""

    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    eps: float = 1e-6
    temporal_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @classmethod
    def svd(cls, dtype: torch.dtype = torch.float32) -> VAEConfig:
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> VAEConfig:
        return cls(block_out_channels=(16, 32), norm_num_groups=8, layers_per_block=1,
                   dtype=dtype)


class _SpatialResnet(nn.Module):
    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(in_ch, **kw)
        self.conv1 = Conv2d(in_ch, out_ch, 3, **kw)
        self.norm2 = Norm(out_ch, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C)."""
        g, eps = self.cfg.norm_num_groups, self.cfg.eps
        h = conv2d(group_norm_silu(x, self.norm1, g, eps), self.conv1)
        h = conv2d(group_norm_silu(h, self.norm2, g, eps), self.conv2)
        shortcut = x if self.conv_shortcut is None else conv2d(x, self.conv_shortcut)
        return shortcut + h


class _TemporalResnet(nn.Module):
    """No time embedding in the VAE decoder."""

    def __init__(self, cfg: VAEConfig, ch: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(ch, **kw)
        self.conv1 = ConvTemporal(ch, ch, 3, **kw)
        self.norm2 = Norm(ch, **kw)
        self.conv2 = ConvTemporal(ch, ch, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, F, H, W, C)."""
        g, eps = self.cfg.norm_num_groups, self.cfg.temporal_eps
        h = conv_temporal(group_norm_silu(x, self.norm1, g, eps), self.conv1)
        h = conv_temporal(group_norm_silu(h, self.norm2, g, eps), self.conv2)
        return x + h


class _LearnedMix(AlphaBlender):
    """diffusers ``AlphaBlender`` ("learned", switch_spatial_to_temporal_mix):
    ``alpha = sigmoid(mix_factor)`` weights the TEMPORAL path; init 0."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mix_factor.zero_()

    def blend(self, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float()).to(spatial.dtype)
        return (1.0 - alpha) * spatial + alpha * temporal


class _STResBlock(nn.Module):
    """diffusers ``SpatioTemporalResBlock`` of the temporal decoder."""

    def __init__(self, cfg: VAEConfig, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.spatial_res_block = _SpatialResnet(cfg, in_ch, out_ch, **kw)
        self.temporal_res_block = _TemporalResnet(cfg, out_ch, **kw)
        self.time_mixer = _LearnedMix(**kw)

    def forward(self, x: torch.Tensor, batch: int, frames: int) -> torch.Tensor:
        """x: (B*F, H, W, C_in) -> (B*F, H, W, C_out)."""
        bf, hh, ww, _ = x.shape
        hs = self.spatial_res_block(x)
        hs = hs.reshape(batch, frames, hh, ww, hs.shape[-1])
        ht = self.temporal_res_block(hs)
        return self.time_mixer.blend(hs, ht).reshape(bf, hh, ww, -1)


class _VAEAttention(Attention):
    """Single-head spatial self-attention with qkv bias and its GroupNorm
    (diffusers ``Attention`` with ``group_norm``)."""

    def __init__(self, cfg: VAEConfig, ch: int, **kw):
        super().__init__(ch, qkv_bias=True, **kw)
        self.cfg = cfg
        self.group_norm = Norm(ch, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C); attention over the H*W positions of each image."""
        n, hh, ww, c = x.shape
        h = group_norm(x, self.group_norm, self.cfg.norm_num_groups, self.cfg.eps)
        h = attention(h.reshape(n, hh * ww, c), self, heads=1)
        return x + h.reshape(n, hh, ww, c)


class TemporalDecoder(nn.Module):
    """diffusers ``TemporalDecoder``: parameters only, run by
    :class:`TemporalVAEDecoder`."""

    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        boc = cfg.block_out_channels
        top = boc[-1]
        self.conv_in = Conv2d(cfg.latent_channels, top, 3, **kw)
        self.mid_block = _Block(
            [_STResBlock(cfg, top, top, **kw), _STResBlock(cfg, top, top, **kw)],
            [_VAEAttention(cfg, top, **kw)],
        )
        up = []
        prev = top
        rev = list(reversed(boc))
        for i, out_ch in enumerate(rev):
            up.append(_Block(
                [_STResBlock(cfg, prev if j == 0 else out_ch, out_ch, **kw)
                 for j in range(cfg.layers_per_block + 1)],
                [],
                upsample=_Resample(out_ch, **kw) if i < len(rev) - 1 else None,
            ))
            prev = out_ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = Norm(boc[0], **kw)
        self.conv_out = Conv2d(boc[0], cfg.in_channels, 3, **kw)
        self.time_conv_out = ConvTemporal(cfg.in_channels, cfg.in_channels, 3, **kw)


class TemporalVAEDecoder(nn.Module):
    """Video decoder: ``apply`` decodes latents, ``decode_chunked`` decodes
    them in frame chunks. Parameters are allocated on ``device`` (``None``
    means CUDA, which must exist) and left unset: load a state dict (keys
    ``decoder.*``) or call :meth:`init_weights`."""

    def __init__(self, config: VAEConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = config or VAEConfig.svd()
        self.decoder = TemporalDecoder(self.config, device=resolve_device(device),
                                       dtype=self.config.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> TemporalVAEDecoder:
        """Random init: LeCun-normal weights, zero biases, unit norm scales,
        mix factors 0 (as the reference's ``init``)."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    @torch.inference_mode()
    def apply(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, F, h, w, C_lat) -> video (B, F, 8h, 8w, 3) for the
        4-level config. The caller divides by ``scaling_factor`` first."""
        cfg = self.config
        dec = self.decoder
        b, f, hh, ww, c = latents.shape
        x = conv2d(latents.to(cfg.dtype).reshape(b * f, hh, ww, c), dec.conv_in)
        mid = dec.mid_block
        x = mid.resnets[0](x, b, f)
        x = mid.attentions[0](x)
        x = mid.resnets[1](x, b, f)
        for block in dec.up_blocks:
            for res in block.resnets:
                x = res(x, b, f)
            if hasattr(block, "upsamplers"):
                x = conv2d(upsample_nearest_2x(x), block.upsamplers[0].conv)
        x = group_norm_silu(x, dec.conv_norm_out, cfg.norm_num_groups, cfg.eps)
        x = conv2d(x, dec.conv_out)
        x = x.reshape(b, f, x.shape[1], x.shape[2], cfg.in_channels)
        return conv_temporal(x, dec.time_conv_out)

    @torch.inference_mode()
    def decode_chunked(self, latents: torch.Tensor, chunk_frames: int = 4) -> torch.Tensor:
        """Decode in chunks of ``chunk_frames`` frames (the last one ragged)
        to bound activation memory; frames interact only within a chunk."""
        f = latents.shape[1]
        if f <= chunk_frames:
            return self.apply(latents)
        return torch.cat([self.apply(latents[:, s:s + chunk_frames])
                          for s in range(0, f, chunk_frames)], dim=1)
