"""Spatio-temporal conditioned video UNet (SVD architecture) in PyTorch.

Port of ``vdpp_tpu/models/svd_unet.py`` (``SVDUNet.apply``, ``apply_cached`` and their blocks,
with the sequence and frame sharding and the int8 weights). Modules carry the
diffusers ``UNetSpatioTemporalConditionModel`` parameter names, so
``state_dict()`` has exactly the keys of a diffusers checkpoint (1428 at
SVD-XT). Activations stay channels-last as in the reference:
``(B*F, H, W, C)`` spatially, ``(B, F, H, W, C)`` temporally.

Precision policy as in the reference: model-dtype (bf16) weights and
activations, fp32 norm statistics, sinusoids and softmax, fp32 matmul
accumulation.

Intra-sample parallelism, as in the reference: under ``seq_axis`` the
latent's W axis is split over the ranks of that axis (every 3x3 conv
exchanges a one-column halo, the spatial and temporal GroupNorm statistics
are averaged across the shards, spatial self-attention gathers K/V); under
``frame_axis`` the frame axis is split (temporal convs exchange an edge
frame, temporal attention gathers K/V over frames, the temporal GroupNorm
statistics are averaged); the two compose. The latent enters whole on every
rank and the output is gathered whole again. Under W8A8 (``ops/quant.py``)
every spatial conv takes its activation scale over both axes (``amax_axes``),
so a split conv quantizes as the unsplit one does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.ops.attention import Attention, attention, temporal_self_attention
from vdpp_tpu_torch.ops.conv import (
    Conv2d,
    ConvTemporal,
    conv2d,
    conv2d_halo,
    conv_temporal,
    conv_temporal_halo,
    upsample_nearest_2x,
)
from vdpp_tpu_torch.ops.embeddings import TimestepEmbedding, sinusoidal_embedding
from vdpp_tpu_torch.ops.linear import FeedForward, Linear, geglu_ff
from vdpp_tpu_torch.ops.normalization import Norm, group_norm, group_norm_silu, layer_norm
from vdpp_tpu_torch.parallel.collectives import Axis, all_gather
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

    def seq_min_divisor(self, shards: int) -> int:
        """Under W-halo sequence parallelism the latent width must divide by
        ``shards * 2^(levels-1)``, so that every level's local width stays
        even for the stride-2 downsample grid."""
        return shards * 2 ** (self.num_levels - 1)

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


def cache_feature_shape(cfg: SVDUNetConfig, batch: int, frames: int, height: int, width: int,
                        split: int) -> tuple[int, ...]:
    """Shape of the DeepCache deep feature for ``split`` shallow levels: the
    tensor entering up block ``n_levels - split``, at ``H / 2^(split-1)``
    with ``block_out_channels[split]`` channels."""
    if not 1 <= split <= cfg.num_levels - 1:
        raise ValueError(f"deepcache split must be in [1, {cfg.num_levels - 1}], got {split}")
    r = 2 ** (split - 1)
    return (batch, frames, height // r, width // r, cfg.block_out_channels[split])


def _conv3(x: torch.Tensor, conv: Conv2d, seq: Axis | None, stride: int = 1,
           amax_axes: tuple[Axis, ...] = ()) -> torch.Tensor:
    """A 3x3 site of the UNet (one pixel of zero padding on each side, the
    downsample's stride 2 included): ``conv2d``, or its halo form under a W
    split; ``amax_axes``: every axis that splits ``x`` (W8A8 only)."""
    if seq is not None:
        return conv2d_halo(x, conv, seq, stride=stride, amax_axes=amax_axes)
    return conv2d(x, conv, stride=stride, padding=((1, 1), (1, 1)), amax_axes=amax_axes)


@dataclass(frozen=True)
class _Shards:
    """How a forward is split: the W axis over ``seq``, the frames over
    ``frame``, this rank's first frame ``frame_offset``."""

    seq: Axis | None = None
    frame: Axis | None = None
    frame_offset: int = 0

    @property
    def amax_axes(self) -> tuple[Axis, ...]:
        """The axes that split a spatial tensor's elements."""
        return tuple(a for a in (self.seq, self.frame) if a is not None)


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

    def forward(self, x: torch.Tensor, emb: torch.Tensor, seq: Axis | None = None,
                amax_axes: tuple[Axis, ...] = ()) -> torch.Tensor:
        """x: (BF, H, W, C), emb: (BF, time_embed_dim). Under ``seq`` (W
        split) the 3x3 convs exchange halos and the GroupNorm statistics are
        averaged across the shards; the 1x1 shortcut stays local.
        ``amax_axes``: every axis that splits ``x`` (seq and frame), for the
        W8A8 convs' activation scale."""
        cfg = self.cfg
        h = group_norm_silu(x, self.norm1, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm, psum_axis=seq)
        h = _conv3(h, self.conv1, seq, amax_axes=amax_axes)
        temb = self.time_emb_proj(F.silu(emb.float()).to(emb.dtype))
        h = h + temb[:, None, None, :]
        h = group_norm_silu(h, self.norm2, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm, psum_axis=seq)
        h = _conv3(h, self.conv2, seq, amax_axes=amax_axes)
        shortcut = (x if self.conv_shortcut is None
                    else conv2d(x, self.conv_shortcut, amax_axes=amax_axes))
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

    def forward(self, x: torch.Tensor, emb_bf: torch.Tensor, seq: Axis | None = None,
                frame: Axis | None = None) -> torch.Tensor:
        """x: (B, F, H, W, C), emb_bf: (B, F, time_embed_dim). The (k, 1, 1)
        convs touch no spatial neighbour, so under ``seq`` only the GroupNorm
        statistics are averaged; under ``frame`` the convs exchange an edge
        frame with each neighbour and the statistics, which span the
        frames, are averaged over that axis too."""
        cfg = self.cfg
        axes = tuple(a for a in (seq, frame) if a is not None) or None

        def ct(h, conv):
            return conv_temporal(h, conv) if frame is None else conv_temporal_halo(h, conv, frame)

        h = group_norm_silu(x, self.norm1, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm, psum_axis=axes)
        h = ct(h, self.conv1)
        temb = self.time_emb_proj(F.silu(emb_bf.float()).to(emb_bf.dtype))
        h = h + temb[:, :, None, None, :]
        h = group_norm_silu(h, self.norm2, cfg.norm_num_groups, cfg.resnet_eps,
                            fused=cfg.fused_groupnorm, psum_axis=axes)
        h = ct(h, self.conv2)
        return x + h


class STResBlock(nn.Module):
    """diffusers ``SpatioTemporalResBlock``: spatial ResNet, temporal ResNet,
    learned blend."""

    def __init__(self, cfg: SVDUNetConfig, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.spatial_res_block = SpatialResnet(cfg, in_ch, out_ch, **kw)
        self.temporal_res_block = TemporalResnet(cfg, out_ch, **kw)
        self.time_mixer = AlphaBlender(**kw)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, batch: int, frames: int,
                seq: Axis | None = None, frame: Axis | None = None) -> torch.Tensor:
        """x: (B*F, H, W, C) -> same; ``frames`` is the local count under
        ``frame``."""
        bf, hh, ww, _ = x.shape
        hs = self.spatial_res_block(x, emb, seq, _Shards(seq, frame).amax_axes)
        if os.environ.get("VDPP_ABLATE_TEMPORAL_RESNET") == "1":  # profiling only
            return hs
        c = hs.shape[-1]
        hs = hs.reshape(batch, frames, hh, ww, c)
        ht = self.temporal_res_block(hs, emb.reshape(batch, frames, -1), seq, frame)
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

    def forward(self, h: torch.Tensor, ctx: torch.Tensor, heads: int,
                seq: Axis | None = None) -> torch.Tensor:
        """h: (BF, L, C), ctx: (BF, 1, cross_dim). Under ``seq`` L is the
        local token shard: self-attention gathers K/V, the single-key
        cross-attention and the feed-forward are token-local."""
        h = h + attention(layer_norm(h, self.norm1), self.attn1, heads, seq_axis=seq)
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
                frames: int, frame: Axis | None = None) -> torch.Tensor:
        """time_ctx_b: (B, 1, cross_dim); ``frames`` is the local count under
        ``frame`` (the attention gathers K/V over it)."""
        h = geglu_ff(layer_norm(h, self.norm_in), self.ff_in) + h
        h = h + temporal_self_attention(self.attn1, layer_norm(h, self.norm1), heads, batch,
                                        frames, frame_axis=frame)
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
                frames: int, seq: Axis | None = None, frame: Axis | None = None,
                frame_offset: int = 0) -> torch.Tensor:
        """x: (B*F, H, W, C); ctx: (B*F, 1, cross_dim). Under ``frame``,
        ``frames`` is the local count and ``frame_offset`` the shard's first
        global frame: the frame-position embedding is global."""
        bf, hh, ww, c = x.shape
        # The statistics are per (batch, frame) row, so only the W split needs
        # them averaged.
        h = group_norm(x, self.norm, self.cfg.norm_num_groups, self.cfg.transformer_eps,
                       psum_axis=seq)
        h = self.proj_in(h.reshape(bf, hh * ww, c))

        # Frame-position embedding added before each temporal block.
        frame_idx = (torch.arange(frames, dtype=torch.float32, device=x.device).repeat(batch)
                     + frame_offset)
        f_emb = sinusoidal_embedding(frame_idx, c).to(x.dtype)
        f_emb = self.time_pos_embed(f_emb)[:, None, :]  # (BF, 1, C)

        # Temporal cross-attention context: the first frame's embedding per batch element.
        time_ctx = ctx.reshape(batch, frames, *ctx.shape[1:])[:, 0]  # (B, 1, D)
        ablate_temporal = os.environ.get("VDPP_ABLATE_TEMPORAL") == "1"  # profiling only
        for sp, tp in zip(self.transformer_blocks, self.temporal_transformer_blocks):
            h = sp(h, ctx, heads, seq)
            if not ablate_temporal:
                h_mix = tp(h + f_emb, time_ctx, heads, batch, frames, frame)
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

    # ``forward`` and ``apply_cached`` are built from these bodies alone, so
    # the cache's full branch runs exactly the forward's ops.
    def _embeddings(self, timestep, added_time_ids: torch.Tensor,
                    encoder_hidden_states: torch.Tensor, b: int, f: int):
        """The time embedding and the context, each repeated per frame."""
        cfg = self.config
        emb_f = self._time_embeddings(timestep, added_time_ids, b).repeat_interleave(f, dim=0)
        ctx_f = encoder_hidden_states.to(cfg.dtype).repeat_interleave(f, dim=0)  # (B*F, 1, D)
        return emb_f, ctx_f

    def _down_path(self, x: torch.Tensor, emb_f: torch.Tensor, ctx_f: torch.Tensor, b: int,
                   f: int, sh: _Shards = _Shards(), n_levels_to_run: int | None = None,
                   run_last_downsample: bool = True) -> tuple[torch.Tensor, list]:
        """Down levels ``0..n-1`` on a post-``conv_in`` tensor. Returns ``(x,
        skips)``, the entry tensor first among the skips.
        ``run_last_downsample=False`` skips level ``n-1``'s downsample, whose
        skip would feed an up block the cache step never reaches."""
        heads = self.config.num_attention_heads
        n_levels = self.config.num_levels
        n = n_levels if n_levels_to_run is None else n_levels_to_run
        res_stack = [x]
        for i in range(n):
            block = self.down_blocks[i]
            for j, res in enumerate(block.resnets):
                x = res(x, emb_f, b, f, sh.seq, sh.frame)
                if i < n_levels - 1:
                    x = block.attentions[j](x, ctx_f, heads[i], b, f, sh.seq, sh.frame,
                                            sh.frame_offset)
                res_stack.append(x)
            if hasattr(block, "downsamplers") and (i < n - 1 or run_last_downsample):
                x = _conv3(x, block.downsamplers[0].conv, sh.seq, stride=2,
                           amax_axes=sh.amax_axes)
                res_stack.append(x)
        return x, res_stack

    def _mid(self, x: torch.Tensor, emb_f: torch.Tensor, ctx_f: torch.Tensor, b: int,
             f: int, sh: _Shards = _Shards()) -> torch.Tensor:
        mid = self.mid_block
        x = mid.resnets[0](x, emb_f, b, f, sh.seq, sh.frame)
        x = mid.attentions[0](x, ctx_f, self.config.num_attention_heads[-1], b, f, sh.seq,
                              sh.frame, sh.frame_offset)
        return mid.resnets[1](x, emb_f, b, f, sh.seq, sh.frame)

    def _up_path(self, x: torch.Tensor, res_stack: list, emb_f: torch.Tensor,
                 ctx_f: torch.Tensor, b: int, f: int, sh: _Shards = _Shards(), start: int = 0,
                 stop: int | None = None) -> torch.Tensor:
        """Up blocks ``start..stop-1``, popping their skips off ``res_stack``
        (so a second call goes on where the first stopped)."""
        rev_heads = list(reversed(self.config.num_attention_heads))
        stop = self.config.num_levels if stop is None else stop
        for i in range(start, stop):
            block = self.up_blocks[i]
            for j, res in enumerate(block.resnets):
                x = torch.cat([x, res_stack.pop()], dim=-1)
                x = res(x, emb_f, b, f, sh.seq, sh.frame)
                if i > 0:
                    x = block.attentions[j](x, ctx_f, rev_heads[i], b, f, sh.seq, sh.frame,
                                            sh.frame_offset)
            if hasattr(block, "upsamplers"):
                x = _conv3(upsample_nearest_2x(x), block.upsamplers[0].conv, sh.seq,
                           amax_axes=sh.amax_axes)
        return x

    def _head(self, x: torch.Tensor, sh: _Shards = _Shards()) -> torch.Tensor:
        cfg = self.config
        x = group_norm_silu(x, self.conv_norm_out, cfg.norm_num_groups, cfg.out_norm_eps,
                            fused=cfg.fused_groupnorm, psum_axis=sh.seq)
        return _conv3(x, self.conv_out, sh.seq, amax_axes=sh.amax_axes)

    def _shard(self, sample: torch.Tensor, seq_axis: Axis | None, frame_axis: Axis | None,
               cache: torch.Tensor | None = None, split: int = 1):
        """Check the split as the reference does, and take this rank's block
        of ``sample (B, F, H, W, C_in)`` (its frames, then its columns) as
        ``(B*F_local, H, W_local, C_in)`` in the model dtype, with the
        :class:`_Shards` and the local frame count, and of ``cache`` (whose
        grid is the latent's over ``2^(split-1)``) when given."""
        cfg = self.config
        b, f, hh, ww, c_in = sample.shape
        if seq_axis is not None and ww % cfg.seq_min_divisor(seq_axis.size):
            raise ValueError(f"latent width {ww} not divisible by seq_shards x 2^(levels-1) = "
                             f"{cfg.seq_min_divisor(seq_axis.size)}")
        if frame_axis is not None and f % frame_axis.size:
            raise ValueError(f"frame count {f} not divisible by frame_shards {frame_axis.size}")
        if cfg.fused_groupnorm and (seq_axis is not None or frame_axis is not None):
            # The sharded statistics take the two-pass composition while the
            # unsharded forward takes the kernel: the two would no longer agree.
            raise ValueError("fused_groupnorm is incompatible with seq/frame sharding: "
                             "construct the UNet with fused_groupnorm=False (or unset "
                             "VDPP_GN_FUSED) for intra-sample-parallel runs")
        xs = sample.to(cfg.dtype)
        offset = 0
        if frame_axis is not None:
            f //= frame_axis.size
            offset = frame_axis.index * f
            xs = xs[:, offset:offset + f]
            cache = None if cache is None else cache[:, offset:offset + f]
        x = xs.reshape(b * f, hh, ww, c_in)
        if seq_axis is not None:
            wl = ww // seq_axis.size
            x = x[:, :, seq_axis.index * wl:(seq_axis.index + 1) * wl]
            if cache is not None:
                wc = wl // 2 ** (split - 1)
                cache = cache[:, :, :, seq_axis.index * wc:(seq_axis.index + 1) * wc]
        return x, _Shards(seq_axis, frame_axis, offset), f, cache

    @staticmethod
    def _gather(x: torch.Tensor, sh: _Shards) -> torch.Tensor:
        """A ``(B, F_local, H', W_local', C)`` block whole again: its columns
        gathered over the seq shards, then its frames over the frame
        shards."""
        if sh.seq is not None:
            x = all_gather(x, sh.seq, 3)
        if sh.frame is not None:
            x = all_gather(x, sh.frame, 1)
        return x

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        added_time_ids: torch.Tensor,
        seq_axis: Axis | None = None,
        frame_axis: Axis | None = None,
    ) -> torch.Tensor:
        """Denoise one step.

        Args:
            sample: (B, F, H, W, C_in) channels-last latent (+ image-latent concat).
            timestep: scalar or (B,) continuous timestep (0.25 * ln(sigma)).
            encoder_hidden_states: (B, 1, cross_attention_dim) CLIP image embedding.
            added_time_ids: (B, 3) [fps-1, motion_bucket_id, noise_aug_strength].
            seq_axis: split W over this axis (W must divide by
                ``config.seq_min_divisor(seq_axis.size)``).
            frame_axis: split the frames over this axis (F must divide by its
                size). Every rank of both axes passes the whole ``sample``.

        Returns:
            (B, F, H, W, C_out) v-prediction in the model dtype, whole on
            every rank.
        """
        b, f, hh, ww, _ = sample.shape
        x, sh, fl, _ = self._shard(sample, seq_axis, frame_axis)
        emb_f, ctx_f = self._embeddings(timestep, added_time_ids, encoder_hidden_states, b, fl)
        x = _conv3(x, self.conv_in, sh.seq, amax_axes=sh.amax_axes)
        x, res_stack = self._down_path(x, emb_f, ctx_f, b, fl, sh)
        x = self._mid(x, emb_f, ctx_f, b, fl, sh)
        x = self._up_path(x, res_stack, emb_f, ctx_f, b, fl, sh)
        x = self._head(x, sh)
        return self._gather(x.reshape(b, fl, hh, x.shape[2], self.config.out_channels), sh)

    # ------------------- cached (DeepCache) forward ------------------- #
    def cache_feature_shape(self, batch: int, frames: int, height: int, width: int,
                            split: int) -> tuple[int, ...]:
        return cache_feature_shape(self.config, batch, frames, height, width, split)

    def apply_cached(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        added_time_ids: torch.Tensor,
        cache: torch.Tensor,
        use_full: bool,
        split: int = 1,
        seq_axis: Axis | None = None,
        frame_axis: Axis | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One step with a deep-feature cache (DeepCache, Ma et al. 2023).

        ``use_full``: the whole UNet (:meth:`forward`'s ops, one by one),
        capturing the tensor that enters up block ``n_levels - split`` as the
        new cache. Otherwise only ``conv_in``, down levels ``0..split-1``
        (without the last one's downsample) and up blocks ``n_levels - split
        ..`` run, on the cached deep feature, which passes through unchanged.
        The branch is a host ``if``: a cache step does none of the deep work.

        ``seq_axis``/``frame_axis`` split the step as in :meth:`forward`: the
        sample and the cache enter whole, each rank takes its block of both
        (the cache's grid splits as the latent's, at ``W / 2^(split-1)``),
        and the v-prediction and the cache are gathered whole at the end.

        Returns ``(v_prediction (B, F, H, W, C_out), cache)``, the cache in the
        model dtype, of :meth:`cache_feature_shape`.
        """
        cfg = self.config
        n_levels = cfg.num_levels
        b, f, hh, ww, _ = sample.shape
        want = self.cache_feature_shape(b, f, hh, ww, split)
        if tuple(cache.shape) != want:
            raise ValueError(f"cache shape {tuple(cache.shape)} != expected {want}")
        u_start = n_levels - split
        x, sh, fl, cache = self._shard(sample, seq_axis, frame_axis, cache, split)
        want_local = (b, fl, *cache.shape[2:])
        emb_f, ctx_f = self._embeddings(timestep, added_time_ids, encoder_hidden_states, b, fl)
        x = _conv3(x, self.conv_in, sh.seq, amax_axes=sh.amax_axes)
        if use_full:
            x, res_stack = self._down_path(x, emb_f, ctx_f, b, fl, sh)
            x = self._mid(x, emb_f, ctx_f, b, fl, sh)
            x = self._up_path(x, res_stack, emb_f, ctx_f, b, fl, sh, stop=u_start)
            cache = x.reshape(want_local).to(cfg.dtype)
        else:
            _, res_stack = self._down_path(x, emb_f, ctx_f, b, fl, sh, n_levels_to_run=split,
                                           run_last_downsample=False)
            cache = cache.to(cfg.dtype)
            x = cache.reshape(b * fl, *want_local[2:])
        x = self._up_path(x, res_stack, emb_f, ctx_f, b, fl, sh, start=u_start)
        x = self._head(x, sh)
        out = x.reshape(b, fl, hh, x.shape[2], cfg.out_channels)
        return self._gather(out, sh), self._gather(cache, sh)
