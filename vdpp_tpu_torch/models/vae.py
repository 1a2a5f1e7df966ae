"""KL encoder and temporal VAE decoder of the SVD family in PyTorch: the port
of ``vdpp_tpu/models/vae.py`` (``VAEConfig``, ``VAEEncoder.apply`` and
``.mode``, the decoder's blocks, ``TemporalVAEDecoder.apply`` and
``.decode_chunked``).

The encoder turns images ``(N, H, W, 3)`` into moments ``(N, H/8, W/8, 8)``
(for the 4-level config) frame by frame: conv_in, down blocks of ResNets with
a stride-2 downsample padded on the right and bottom only (diffusers'
``Downsample2D`` with ``padding=0``) on every level but the last, a mid block
(ResNet, single-head attention, ResNet), a GroupNorm+SiLU head and conv_out.
``mode`` keeps the mean, the first ``latent_channels`` channels. Its modules
carry the diffusers ``Encoder`` names under ``encoder.``.

The decoder turns denoised latents ``(B, F, h, w, 4)`` into frames
``(B, F, 8h, 8w, 3)``: conv_in, a mid block (spatio-temporal ResNet,
single-head spatial self-attention, spatio-temporal ResNet), up blocks of
spatio-temporal ResNets with nearest-2x upsamples, a GroupNorm+SiLU head,
conv_out and a final (3, 1, 1) temporal conv over the frames. Modules carry
the diffusers ``AutoencoderKLTemporalDecoder`` names under ``decoder.``, so
``state_dict()`` has the keys of the checkpoint's decoder subtree.
Activations stay channels-last as in the reference; GroupNorm statistics are
fp32 and the default dtype is fp32.

The mid-block attentions run over all h * w latent positions with one head
of d = 512 (at SVD, 72 * 128 = 9216 positions, in the encoder once per
image and in the decoder once per chunk of frames): the port's ``attention``
sends them to the flash kernel at head dim 512, with the static-max softmax,
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
from vdpp_tpu_torch.parallel.collectives import Axis, gather_to
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


class Encoder(nn.Module):
    """diffusers KL ``Encoder``: parameters only, run by :class:`VAEEncoder`."""

    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, **kw)
        down = []
        ch = boc[0]
        for i, out_ch in enumerate(boc):
            down.append(_Block(
                [_SpatialResnet(cfg, ch if j == 0 else out_ch, out_ch, **kw)
                 for j in range(cfg.layers_per_block)],
                [],
                downsample=_Resample(out_ch, **kw) if i < len(boc) - 1 else None,
            ))
            ch = out_ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Block(
            [_SpatialResnet(cfg, ch, ch, **kw), _SpatialResnet(cfg, ch, ch, **kw)],
            [_VAEAttention(cfg, ch, **kw)],
        )
        self.conv_norm_out = Norm(ch, **kw)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, **kw)


class _VAEModule(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init: LeCun-normal weights, zero biases, unit norm scales,
        mix factors 0 (as the reference's ``init``)."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self


class VAEEncoder(_VAEModule):
    """Per-frame KL encoder: ``apply`` gives the latent moments (mean then
    log-variance), ``mode`` their mean. Parameters are allocated on
    ``device`` (``None`` means CUDA, which must exist) and left unset: load a
    state dict (keys ``encoder.*``) or call :meth:`init_weights`."""

    def __init__(self, config: VAEConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.config = config or VAEConfig.svd()
        self.encoder = Encoder(self.config, device=resolve_device(device),
                               dtype=self.config.dtype)

    @torch.inference_mode()
    def apply(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) -> moments (N, H/8, W/8, 2 * latent_channels)
        for the 4-level config."""
        cfg = self.config
        enc = self.encoder
        x = conv2d(images.to(cfg.dtype), enc.conv_in)
        for block in enc.down_blocks:
            for res in block.resnets:
                x = res(x)
            if hasattr(block, "downsamplers"):
                x = conv2d(x, block.downsamplers[0].conv, stride=2, padding=((0, 1), (0, 1)))
        mid = enc.mid_block
        x = mid.resnets[0](x)
        x = mid.attentions[0](x)
        x = mid.resnets[1](x)
        x = group_norm_silu(x, enc.conv_norm_out, cfg.norm_num_groups, cfg.eps)
        return conv2d(x, enc.conv_out)

    def mode(self, moments: torch.Tensor) -> torch.Tensor:
        """The distribution's mode, its mean: the first ``latent_channels``
        channels (the reference encodes with ``.mode()``, no sampling)."""
        return moments[..., :self.config.latent_channels]


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


class TemporalVAEDecoder(_VAEModule):
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

    @torch.inference_mode()
    def decode_data_parallel(self, latents: torch.Tensor, axis: Axis | None,
                             chunk_frames: int = 4, root: int = 0) -> torch.Tensor | None:
        """:meth:`decode_chunked` with its chunks split over the ranks of
        ``axis`` (a decode group), every rank of it calling with the same
        ``latents``. The chunks are independent, so the result equals
        :meth:`decode_chunked`'s element by element: the full chunks of
        ``chunk_frames`` frames go to the ranks in turn (chunk j to rank j mod
        D), the trailing partial chunk is decoded at its true length as one
        more chunk, and the frames are gathered in order, point to point, to
        rank ``root`` of the axis (the group's first rank by default).
        Returns the video there and None on the other ranks; without an axis,
        :meth:`decode_chunked`."""
        if axis is None or axis.size == 1:
            return self.decode_chunked(latents, chunk_frames)
        b, f, hh, ww, _ = latents.shape
        starts = list(range(0, f, chunk_frames))
        mine = starts[axis.index::axis.size]
        out = (torch.cat([self.apply(latents[:, s:s + chunk_frames]) for s in mine], dim=1)
               if mine else None)
        up = 2 ** (len(self.config.block_out_channels) - 1)

        def frames_of(i: int) -> int:
            return sum(min(chunk_frames, f - s) for s in starts[i::axis.size])

        shapes = [(b, frames_of(i), hh * up, ww * up, self.config.in_channels)
                  if frames_of(i) else None for i in range(axis.size)]
        parts = gather_to(out, axis, shapes, self.config.dtype, latents.device, root)
        if parts is None:
            return None
        # Rank i holds chunks i, i + D, ...: put them back in chunk order.
        pieces = {}
        for i, part in enumerate(parts):
            if part is None:
                continue
            at = 0
            for s in starts[i::axis.size]:
                n = min(chunk_frames, f - s)
                pieces[s] = part[:, at:at + n]
                at += n
        return torch.cat([pieces[s] for s in starts], dim=1)
