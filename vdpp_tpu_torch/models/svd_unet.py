"""Spatio-temporal conditioned video UNet (SVD architecture) in PyTorch.

Port of ``vdpp_tpu/models/svd_unet.py`` (``SVDUNet.apply`` and its blocks,
without the sequence/frame-sharding and int8 arguments). Modules carry the
diffusers ``UNetSpatioTemporalConditionModel`` parameter names, so
``state_dict()`` has exactly the keys of a diffusers checkpoint (1428 at
SVD-XT). Activations stay channels-last as in the reference:
``(B*F, H, W, C)`` spatially, ``(B, F, H, W, C)`` temporally.

Precision policy as in the reference: model-dtype (bf16) weights and
activations, fp32 norm statistics, sinusoids and softmax, fp32 matmul
accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.attention import Attention, attention, temporal_self_attention
from vdpp_tpu_torch.ops.conv import Conv2d, ConvTemporal, conv2d, conv_temporal, upsample_nearest_2x
from vdpp_tpu_torch.ops.embeddings import TimestepEmbedding, sinusoidal_embedding
from vdpp_tpu_torch.ops.linear import FeedForward, Linear, geglu_ff
from vdpp_tpu_torch.ops.normalization import Norm, group_norm, group_norm_silu, layer_norm
from vdpp_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SVDUNetConfig:
    """Architecture hyper-parameters. ``svd_xt()`` is the
    stable-video-diffusion-img2vid-xt UNet; ``tiny()`` is a structurally
    identical 2-level model for tests."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    num_attention_heads: tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    norm_num_groups: int = 32
    resnet_eps: float = 1e-6
    transformer_eps: float = 1e-6
    out_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Route GroupNorm->SiLU pairs through the fused GroupNorm+SiLU kernel
    # (ops/norm_kernel.py); the wrapper sets it from VDPP_GN_FUSED=1.
    fused_groupnorm: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def svd_xt(cls, dtype: torch.dtype = torch.bfloat16) -> SVDUNetConfig:
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> SVDUNetConfig:
        return cls(
            block_out_channels=(32, 64),
            num_attention_heads=(2, 4),
            layers_per_block=1,
            cross_attention_dim=48,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            norm_num_groups=8,
            dtype=dtype,
        )


class AlphaBlender(nn.Module):
    """diffusers ``AlphaBlender`` ("learned_with_images", not switched):
    ``alpha = sigmoid(mix_factor)`` weights the SPATIAL path."""

    def __init__(self, *, device=None, dtype=torch.float32):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1, device=device, dtype=dtype),
                                       requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mix_factor.fill_(0.5)

    def blend(self, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float()).to(spatial.dtype)
        return alpha * spatial + (1.0 - alpha) * temporal


# --------------------------------------------------------------------- #
# Spatio-temporal ResNet block
# --------------------------------------------------------------------- #
class SpatialResnet(nn.Module):
    def __init__(self, cfg: SVDUNetConfig, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(in_ch, **kw)
        self.conv1 = Conv2d(in_ch, out_ch, 3, **kw)
        self.time_emb_proj = Linear(cfg.time_embed_dim, out_ch, **kw)
        self.norm2 = Norm(out_ch, **kw)
        self.conv2 = Conv2d(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """x: (BF, H, W, C), emb: (BF, time_embed_dim)."""
        cfg = self.cfg
        h = group_norm_silu(x, self.norm1, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm)
        h = conv2d(h, self.conv1)
        temb = self.time_emb_proj(F.silu(emb.float()).to(emb.dtype))
        h = h + temb[:, None, None, :]
        h = group_norm_silu(h, self.norm2, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm)
        h = conv2d(h, self.conv2)
        shortcut = x if self.conv_shortcut is None else conv2d(x, self.conv_shortcut)
        return shortcut + h


class TemporalResnet(nn.Module):
    def __init__(self, cfg: SVDUNetConfig, ch: int, **kw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = Norm(ch, **kw)
        self.conv1 = ConvTemporal(ch, ch, 3, **kw)
        self.time_emb_proj = Linear(cfg.time_embed_dim, ch, **kw)
        self.norm2 = Norm(ch, **kw)
        self.conv2 = ConvTemporal(ch, ch, 3, **kw)

    def forward(self, x: torch.Tensor, emb_bf: torch.Tensor) -> torch.Tensor:
        """x: (B, F, H, W, C), emb_bf: (B, F, time_embed_dim)."""
        cfg = self.cfg
        h = group_norm_silu(x, self.norm1, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm)
        h = conv_temporal(h, self.conv1)
        temb = self.time_emb_proj(F.silu(emb_bf.float()).to(emb_bf.dtype))
        h = h + temb[:, :, None, None, :]
        h = group_norm_silu(h, self.norm2, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm)
        h = conv_temporal(h, self.conv2)
        return x + h


class STResBlock(nn.Module):
    """diffusers ``SpatioTemporalResBlock``: spatial ResNet, temporal ResNet,
    learned blend."""

    def __init__(self, cfg: SVDUNetConfig, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.spatial_res_block = SpatialResnet(cfg, in_ch, out_ch, **kw)
        self.temporal_res_block = TemporalResnet(cfg, out_ch, **kw)
        self.time_mixer = AlphaBlender(**kw)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, batch: int, frames: int) -> torch.Tensor:
        """x: (B*F, H, W, C) -> same."""
        bf, hh, ww, _ = x.shape
        hs = self.spatial_res_block(x, emb)
        c = hs.shape[-1]
        hs = hs.reshape(batch, frames, hh, ww, c)
        ht = self.temporal_res_block(hs, emb.reshape(batch, frames, -1))
        return self.time_mixer.blend(hs, ht).reshape(bf, hh, ww, c)


# --------------------------------------------------------------------- #
# Spatio-temporal transformer
# --------------------------------------------------------------------- #
class BasicTransformerBlock(nn.Module):
    """Self-attention + single-key cross-attention + GEGLU feed-forward."""

    def __init__(self, cfg: SVDUNetConfig, dim: int, **kw):
        super().__init__()
        self.norm1 = Norm(dim, **kw)
        self.attn1 = Attention(dim, **kw)
        self.norm2 = Norm(dim, **kw)
        self.attn2 = Attention(dim, cross_dim=cfg.cross_attention_dim, **kw)
        self.norm3 = Norm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, h: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
        """h: (BF, L, C), ctx: (BF, 1, cross_dim)."""
        h = h + attention(layer_norm(h, self.norm1), self.attn1, heads)
        h = h + attention(layer_norm(h, self.norm2), self.attn2, heads, context=ctx)
        return h + geglu_ff(layer_norm(h, self.norm3), self.ff)


class TemporalBasicTransformerBlock(nn.Module):
    """Temporal transformer block: the attention tokens are frames. ``h``
    stays (B*F, L, C); norms and feed-forwards are positionwise, the
    self-attention contracts the frame axis in place, and the single-key
    cross-attention is a broadcast (``norm2`` is mathematically dead and kept
    for checkpoint compatibility)."""

    def __init__(self, cfg: SVDUNetConfig, dim: int, **kw):
        super().__init__()
        self.norm_in = Norm(dim, **kw)
        self.ff_in = FeedForward(dim, **kw)
        self.norm1 = Norm(dim, **kw)
        self.attn1 = Attention(dim, **kw)
        self.norm2 = Norm(dim, **kw)
        self.attn2 = Attention(dim, cross_dim=cfg.cross_attention_dim, **kw)
        self.norm3 = Norm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def forward(self, h: torch.Tensor, time_ctx_b: torch.Tensor, heads: int, batch: int,
                frames: int) -> torch.Tensor:
        """time_ctx_b: (B, 1, cross_dim)."""
        h = geglu_ff(layer_norm(h, self.norm_in), self.ff_in) + h
        h = h + temporal_self_attention(self.attn1, layer_norm(h, self.norm1), heads, batch,
                                        frames)
        cross = self.attn2.to_out[0](self.attn2.to_v(time_ctx_b))  # (B, 1, C)
        h = h + cross.repeat_interleave(frames, dim=0)
        return h + geglu_ff(layer_norm(h, self.norm3), self.ff)


class STTransformer(nn.Module):
    """diffusers ``TransformerSpatioTemporalModel``."""

    def __init__(self, cfg: SVDUNetConfig, dim: int, **kw):
        super().__init__()
        self.cfg = cfg
        n = cfg.transformer_layers_per_block
        self.norm = Norm(dim, **kw)
        self.proj_in = Linear(dim, dim, **kw)
        self.time_pos_embed = TimestepEmbedding(dim, dim * 4, dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(cfg, dim, **kw) for _ in range(n)]
        )
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(cfg, dim, **kw) for _ in range(n)]
        )
        self.time_mixer = AlphaBlender(**kw)
        self.proj_out = Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, heads: int, batch: int,
                frames: int) -> torch.Tensor:
        """x: (B*F, H, W, C); ctx: (B*F, 1, cross_dim)."""
        bf, hh, ww, c = x.shape
        h = group_norm(x, self.norm, self.cfg.norm_num_groups, self.cfg.transformer_eps)
        h = self.proj_in(h.reshape(bf, hh * ww, c))

        # Frame-position embedding added before each temporal block.
        frame_idx = torch.arange(frames, dtype=torch.float32, device=x.device).repeat(batch)
        f_emb = sinusoidal_embedding(frame_idx, c).to(x.dtype)
        f_emb = self.time_pos_embed(f_emb)[:, None, :]  # (BF, 1, C)

        # Temporal cross-attention context: the first frame's embedding per batch element.
        time_ctx = ctx.reshape(batch, frames, *ctx.shape[1:])[:, 0]  # (B, 1, D)
        for sp, tp in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = sp(h, ctx, heads)
            h_mix = tp(h + f_emb, time_ctx, heads, batch, frames)
            h = self.time_mixer.blend(h, h_mix)
        h = self.proj_out(h)
        return h.reshape(bf, hh, ww, c) + x


# --------------------------------------------------------------------- #
# UNet
# --------------------------------------------------------------------- #
class _Resample(nn.Module):
    """``downsamplers.0`` / ``upsamplers.0``: holds ``conv``."""

    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, **kw)


class _Block(nn.Module):
    def __init__(self, resnets, attentions, downsample=None, upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class SVDUNet(nn.Module):
    """The SVD UNet. ``forward`` is the counterpart of the reference's
    ``SVDUNet.apply``. Parameters are allocated on ``device`` (``None``
    means CUDA, which must exist) and left unset: load a state dict or call
    :meth:`init_weights`."""

    def __init__(self, config: SVDUNetConfig, device: str | torch.device | None = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=resolve_device(device), dtype=cfg.dtype)
        boc = cfg.block_out_channels
        n = cfg.num_levels
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, **kw)
        self.time_embedding = TimestepEmbedding(boc[0], cfg.time_embed_dim, **kw)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim, **kw
        )

        down = []
        out_ch = boc[0]
        for i in range(n):
            in_ch, out_ch = out_ch, boc[i]
            is_final = i == n - 1
            down.append(_Block(
                [STResBlock(cfg, in_ch if j == 0 else out_ch, out_ch, **kw)
                 for j in range(cfg.layers_per_block)],
                [] if is_final else [STTransformer(cfg, out_ch, **kw)
                                     for _ in range(cfg.layers_per_block)],
                downsample=None if is_final else _Resample(out_ch, **kw),
            ))
        self.down_blocks = nn.ModuleList(down)

        mid = boc[-1]
        self.mid_block = _Block(
            [STResBlock(cfg, mid, mid, **kw), STResBlock(cfg, mid, mid, **kw)],
            [STTransformer(cfg, mid, **kw)],
        )

        up = []
        rev = list(reversed(boc))
        prev_out = rev[0]
        for i in range(n):
            out_up = rev[i]
            skip_ch = rev[min(i + 1, n - 1)]
            resnets, attentions = [], []
            for j in range(cfg.layers_per_block + 1):
                res_skip = skip_ch if j == cfg.layers_per_block else out_up
                res_in = prev_out if j == 0 else out_up
                resnets.append(STResBlock(cfg, res_in + res_skip, out_up, **kw))
                if i > 0:
                    attentions.append(STTransformer(cfg, out_up, **kw))
            up.append(_Block(resnets, attentions,
                             upsample=_Resample(out_up, **kw) if i != n - 1 else None))
            prev_out = out_up
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = Norm(boc[0], **kw)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> SVDUNet:
        """Random init as the reference's ``init``: LeCun-normal weights,
        zero biases, unit norm scales, mix factors 0.5."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def _time_embeddings(self, timestep, added_time_ids: torch.Tensor, b: int) -> torch.Tensor:
        """fp32 sinusoids -> model-dtype MLPs -> summed (B, TE) embedding."""
        cfg = self.config
        dev = added_time_ids.device
        t = torch.as_tensor(timestep, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        t_emb = sinusoidal_embedding(t, cfg.block_out_channels[0]).to(cfg.dtype)
        emb = self.time_embedding(t_emb)
        add_emb = sinusoidal_embedding(added_time_ids.float().reshape(-1),
                                       cfg.addition_time_embed_dim)
        add_emb = add_emb.reshape(b, -1).to(cfg.dtype)
        return emb + self.add_embedding(add_emb)

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        added_time_ids: torch.Tensor,
    ) -> torch.Tensor:
        """Denoise one step.

        Args:
            sample: (B, F, H, W, C_in) channels-last latent (+ image-latent concat).
            timestep: scalar or (B,) continuous timestep (0.25 * ln(sigma)).
            encoder_hidden_states: (B, 1, cross_attention_dim) CLIP image embedding.
            added_time_ids: (B, 3) [fps-1, motion_bucket_id, noise_aug_strength].

        Returns:
            (B, F, H, W, C_out) v-prediction in the model dtype.
        """
        cfg = self.config
        b, f, hh, ww, c_in = sample.shape
        heads = cfg.num_attention_heads
        n = cfg.num_levels
        emb_f = self._time_embeddings(timestep, added_time_ids, b).repeat_interleave(f, dim=0)
        ctx_f = encoder_hidden_states.to(cfg.dtype).repeat_interleave(f, dim=0)  # (B*F, 1, D)

        x = conv2d(sample.to(cfg.dtype).reshape(b * f, hh, ww, c_in), self.conv_in)
        res_stack = [x]
        for i, block in enumerate(self.down_blocks):
            for j, res in enumerate(block.resnets):
                x = res(x, emb_f, b, f)
                if i < n - 1:
                    x = block.attentions[j](x, ctx_f, heads[i], b, f)
                res_stack.append(x)
            if hasattr(block, "downsamplers"):
                x = conv2d(x, block.downsamplers[0].conv, stride=2)
                res_stack.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, emb_f, b, f)
        x = mid.attentions[0](x, ctx_f, heads[-1], b, f)
        x = mid.resnets[1](x, emb_f, b, f)

        rev_heads = list(reversed(heads))
        for i, block in enumerate(self.up_blocks):
            for j, res in enumerate(block.resnets):
                x = torch.cat([x, res_stack.pop()], dim=-1)
                x = res(x, emb_f, b, f)
                if i > 0:
                    x = block.attentions[j](x, ctx_f, rev_heads[i], b, f)
            if hasattr(block, "upsamplers"):
                x = conv2d(upsample_nearest_2x(x), block.upsamplers[0].conv)

        x = group_norm_silu(x, self.conv_norm_out, cfg.norm_num_groups, cfg.out_norm_eps,
                            fused=cfg.fused_groupnorm)
        x = conv2d(x, self.conv_out)
        return x.reshape(b, f, hh, ww, cfg.out_channels)
