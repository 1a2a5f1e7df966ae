"""Latte/CogVideoX-style video Diffusion Transformer (DiT) in PyTorch.

Port of ``vdpp_tpu/models/dit.py`` (``DiTVideo.apply`` and
``DiTVideoWrapper``) with its sequence, CFG and expert axes:

* a 2x2 spatial patchify of the ``(B, F, H, W, C)`` latent into per-frame
  tokens, fp32 sinusoidal spatial and temporal position embeddings;
* ``factorized`` attention (Latte): blocks alternate SPATIAL self-attention
  over a frame's tokens and TEMPORAL self-attention over the frames at each
  token, or ``joint3d`` (CogVideoX): every block attends over all F * N
  tokens at once;
* adaLN modulation (shift, scale, gate) from the timestep embedding,
  qkv-bias attention, cross-attention on T5 tokens, tanh-GELU MLPs, or with
  ``num_experts > 0`` a top-1 MoE feed-forward (``ops/moe.py``) in every
  ``moe_every``-th eligible block (joint3d: every block; factorized: the
  spatial ones, the phase counted over them);
* a final adaLN + linear head and the unpatchify.

Self-attention goes through :func:`vdpp_tpu_torch.ops.attention.attention`,
so every site with L >= 512 takes the flash kernel at head dim 72 (DiT-XL:
1152 / 16): 28 launches per joint3d forward (L = 8 * 640 = 5120 at the
app's 512x320, 8 frames), 14 per factorized forward (the spatial blocks,
L = 640). Under ``VDPP_TEMPORAL_ATTN=pallas`` the factorized temporal blocks
take the frame-attention kernel (14 per forward). Cross-attention over the
text tokens stays plain, as in the reference.

Sequence parallelism (``forward(seq_axis=)``): after the patch embedding
each rank of the axis keeps its contiguous slice of the tokens (joint3d: of
all F * N; factorized: of each frame's N, so temporal attention stays
local), self-attention gathers K and V over the axis, everything else is
token-local, and the head's output is gathered whole once. The flash route
is chosen on the local query length, as in the reference: at DiT-XL's 8
frames of 40x64, joint3d seq 2 launches flash at (Lq, Lk) = (2560, 5120),
factorized seq 2 (Lq = 320) takes the plain path. CFG parallelism
(``step(cfg_axis=)``): rank 0 of a size-2 axis runs the uncond branch,
rank 1 the cond one, and one swap gives both ranks both outputs. Expert
parallelism (``forward(expert_axis=)``): each rank of the axis holds its
share of every MoE block's experts (``ops/moe.py::shard_experts``) and the
block's output is summed over the axis. The MoE dispatch
(``VDPP_MOE_DISPATCH``: ``dense`` or ``gather``; ``VDPP_MOE_CAPACITY``) is
read once, when the wrapper is built, as in the reference.

Module names follow the reference's parameter tree (``patch_embed``,
``t_embed.linear_1``, ``blocks.{i}.attn.to_q``, ``blocks.{i}.ada``, ...);
:func:`vdpp_tpu_torch.utils.weights.from_jax_dit_params` maps that tree onto
them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vdpp_tpu_torch.diffusion.scheduler import (
    EulerKarrasSchedule,
    FlowMatchSchedule,
    ancestral_noise,
    dpmpp2m_step_v_prediction,
    euler_ancestral_step_v_prediction,
    euler_step_v_prediction,
    flowmatch_step,
    heun_step_v_prediction,
)
from vdpp_tpu_torch.ops.attention import Attention, attention, temporal_self_attention
from vdpp_tpu_torch.ops.embeddings import TimestepEmbedding, sinusoidal_embedding
from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.ops.moe import MoEFF, moe_ff, moe_ff_gather
from vdpp_tpu_torch.ops.normalization import Norm, layer_norm
from vdpp_tpu_torch.parallel.collectives import Axis, all_gather, swap
from vdpp_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class DiTVideoConfig:
    in_channels: int = 4
    out_channels: int = 4
    patch_size: int = 2
    hidden_size: int = 1152
    depth: int = 28               # alternating spatial/temporal blocks when factorized
    num_heads: int = 16
    mlp_ratio: float = 4.0
    cross_attention_dim: int | None = 1024
    attention_mode: str = "factorized"  # "factorized" | "joint3d"
    num_experts: int = 0          # > 0: MoE feed-forward (ops/moe.py)
    moe_every: int = 2            # MoE in every moe_every-th eligible block
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.attention_mode not in ("factorized", "joint3d"):
            raise ValueError(f"unknown attention_mode {self.attention_mode!r}")
        if self.num_experts < 0 or (self.num_experts and self.moe_every < 1):
            raise ValueError("num_experts must be >= 0, moe_every >= 1")

    @classmethod
    def latte_xl(cls, dtype: torch.dtype = torch.bfloat16) -> DiTVideoConfig:
        return cls(dtype=dtype)

    @classmethod
    def joint3d_xl(cls, dtype: torch.dtype = torch.bfloat16) -> DiTVideoConfig:
        """CogVideoX-style joint spatio-temporal attention at DiT-XL width."""
        return cls(attention_mode="joint3d", dtype=dtype)

    @classmethod
    def tiny(cls, dtype: torch.dtype = torch.float32) -> DiTVideoConfig:
        return cls(hidden_size=32, depth=4, num_heads=2, cross_attention_dim=16, dtype=dtype)

    @classmethod
    def joint3d_tiny(cls, dtype: torch.dtype = torch.float32) -> DiTVideoConfig:
        return cls(hidden_size=32, depth=4, num_heads=2, cross_attention_dim=16,
                   attention_mode="joint3d", dtype=dtype)

    @classmethod
    def moe_tiny(cls, num_experts: int = 4, dtype: torch.dtype = torch.float32
                 ) -> DiTVideoConfig:
        """Tiny MoE joint-3D variant for the expert-parallelism tests."""
        return cls(hidden_size=32, depth=4, num_heads=2, cross_attention_dim=16,
                   attention_mode="joint3d", num_experts=num_experts, dtype=dtype)


class _Ada(Linear):
    """adaLN projection ``(D -> n * D)``: N(0, 1) x ``init_std`` weights
    (0.02 in the blocks, so an untrained model is not the identity; 0 in the
    final head), zero bias, as the reference's ``init``."""

    def __init__(self, in_dim: int, out_dim: int, init_std: float, **kw):
        super().__init__(in_dim, out_dim, **kw)
        self.init_std = init_std

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = torch.randn(self.weight.shape, generator=generator, device=self.weight.device)
        self.weight.copy_(w * self.init_std)
        self.bias.zero_()


class DiTBlock(nn.Module):
    """One transformer block; spatial, joint3d or temporal by how it is
    called (a temporal block has no cross-attention). ``moe``: a MoE
    feed-forward (``self.moe``) in place of the MLP."""

    def __init__(self, cfg: DiTVideoConfig, cross: bool, moe: bool = False, **kw):
        super().__init__()
        d = cfg.hidden_size
        mlp = int(d * cfg.mlp_ratio)
        self.norm1 = Norm(d, **kw)
        self.attn = Attention(d, qkv_bias=True, **kw)
        self.norm2 = Norm(d, **kw)
        if moe:
            self.moe = MoEFF(d, cfg.num_experts, mlp, **kw)
        else:
            self.mlp_in = Linear(d, mlp, **kw)
            self.mlp_out = Linear(mlp, d, **kw)
        self.ada = _Ada(d, 6 * d, 0.02, **kw)
        if cross and cfg.cross_attention_dim:
            self.norm_cross = Norm(d, **kw)
            self.cross_attn = Attention(d, cfg.cross_attention_dim, qkv_bias=True, **kw)

    def _ada_chunks(self, c_emb: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.ada(F.silu(c_emb.float()).to(c_emb.dtype)).chunk(6, dim=-1)

    def _mlp(self, x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.mlp_in(h).float(), approximate="tanh").to(x.dtype)
        return x + gate[:, None, :] * self.mlp_out(h)

    def forward(self, x: torch.Tensor, c_emb: torch.Tensor, ctx: torch.Tensor | None,
                heads: int, seq_axis: Axis | None = None, expert_axis: Axis | None = None,
                moe_dispatch: str = "dense", moe_capacity: float = 2.0) -> torch.Tensor:
        """x ``(B', L, D)``; c_emb ``(B', D)``; ctx ``(B', M, Dc)`` or None;
        ``seq_axis``: L is this rank's shard, self-attention gathers K/V;
        ``expert_axis``: the MoE experts are split over it. ``moe_dispatch``
        ``"gather"`` takes the capacity-based form at ``moe_capacity``."""
        sh1, sc1, g1, sh2, sc2, g2 = self._ada_chunks(c_emb)
        h = _modulate(layer_norm(x, self.norm1), sh1, sc1)
        x = x + g1[:, None, :] * attention(h, self.attn, heads, seq_axis=seq_axis)
        if hasattr(self, "cross_attn") and ctx is not None:
            h = layer_norm(x, self.norm_cross)
            x = x + attention(h, self.cross_attn, heads, context=ctx)
        h = _modulate(layer_norm(x, self.norm2), sh2, sc2)
        if not hasattr(self, "moe"):
            return self._mlp(x, h, g2)
        if moe_dispatch == "gather":
            ff = moe_ff_gather(self.moe, h, expert_axis, capacity_factor=moe_capacity)
        else:
            ff = moe_ff(self.moe, h, expert_axis)
        return x + g2[:, None, :] * ff

    def temporal(self, x: torch.Tensor, c_emb: torch.Tensor, heads: int, batch: int,
                 frames: int) -> torch.Tensor:
        """The temporal block in the resident ``(B*F, N, D)`` layout: the
        modulation is per batch element (repeated over the frames) and the
        frame mixing happens inside ``temporal_self_attention``."""
        sh1, sc1, g1, sh2, sc2, g2 = (t.repeat_interleave(frames, dim=0)
                                      for t in self._ada_chunks(c_emb))
        h = _modulate(layer_norm(x, self.norm1), sh1, sc1)
        x = x + g1[:, None, :] * temporal_self_attention(self.attn, h, heads, batch, frames)
        return self._mlp(x, _modulate(layer_norm(x, self.norm2), sh2, sc2), g2)


def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTVideo(nn.Module):
    """The video DiT. ``forward`` is the counterpart of the reference's
    ``DiTVideo.apply``. Parameters are allocated on ``device`` (``None``
    means CUDA, which must exist) and left unset: load a state dict or call
    :meth:`init_weights`."""

    def __init__(self, config: DiTVideoConfig, device: str | torch.device | None = None):
        super().__init__()
        self.config = cfg = config
        kw = dict(device=resolve_device(device), dtype=cfg.dtype)
        d = cfg.hidden_size
        p2 = cfg.patch_size ** 2
        self.patch_embed = Linear(cfg.in_channels * p2, d, **kw)
        self.t_embed = TimestepEmbedding(256, d, **kw)
        joint = cfg.attention_mode == "joint3d"
        blocks, eligible = [], 0
        for i in range(cfg.depth):
            # The MoE phase counts ELIGIBLE blocks (factorized: the spatial
            # ones), as the reference's init does.
            moe = False
            if cfg.num_experts > 0 and (joint or i % 2 == 0):
                moe = eligible % cfg.moe_every == cfg.moe_every - 1
                eligible += 1
            blocks.append(DiTBlock(cfg, cross=joint or i % 2 == 0, moe=moe, **kw))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = Norm(d, **kw)
        self.final_ada = _Ada(d, 2 * d, 0.0, **kw)
        self.final_proj = Linear(d, cfg.out_channels * p2, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> DiTVideo:
        """Random init as the reference's ``init``: LeCun-normal linears,
        zero biases, unit norm scales, 0.02-scaled block adaLN, a zero final
        adaLN."""
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def _final_head(self, x: torch.Tensor, c_rows: torch.Tensor) -> torch.Tensor:
        ada = self.final_ada(F.silu(c_rows.float()).to(c_rows.dtype))
        shift, scale = ada.chunk(2, dim=-1)
        return self.final_proj(_modulate(layer_norm(x, self.final_norm), shift, scale))

    def forward(self, latent: torch.Tensor, timestep, context: torch.Tensor | None = None,
                seq_axis: Axis | None = None, expert_axis: Axis | None = None,
                moe_dispatch: str = "dense", moe_capacity: float = 2.0) -> torch.Tensor:
        """latent ``(B, F, H, W, C)`` -> ``(B, F, H, W, C_out)``; context:
        optional ``(B, M, cross_dim)`` conditioning tokens.

        ``seq_axis``: the tokens are split over that axis after the patch
        embedding (factorized: each frame's tokens; joint3d: all F * N) and
        gathered whole before the unpatchify, so every rank of the axis
        returns the whole output. The token count must divide by its size.
        ``expert_axis``, ``moe_dispatch`` and ``moe_capacity`` go to the MoE
        blocks (:meth:`DiTBlock.forward`)."""
        cfg = self.config
        b, f, hh, ww, cch = latent.shape
        p = cfg.patch_size
        gh, gw = hh // p, ww // p
        n = gh * gw
        d = cfg.hidden_size
        heads = cfg.num_heads
        dev = self.final_norm.weight.device  # a norm: never held in int8

        x = latent.to(dev, cfg.dtype).reshape(b * f, gh, p, gw, p, cch)
        x = self.patch_embed(x.permute(0, 1, 3, 2, 4, 5).reshape(b * f, n, p * p * cch))
        pos_s = sinusoidal_embedding(torch.arange(n, dtype=torch.float32, device=dev), d)
        pos_t = sinusoidal_embedding(torch.arange(f, dtype=torch.float32, device=dev), d)
        x = x + pos_s[None].to(x.dtype)

        t = torch.as_tensor(timestep, dtype=torch.float32, device=dev).reshape(-1).expand(b)
        c_emb = self.t_embed(sinusoidal_embedding(t, 256).to(cfg.dtype))  # (B, D)
        ctx = None if context is None else context.to(dev, cfg.dtype)
        moe = dict(expert_axis=expert_axis, moe_dispatch=moe_dispatch, moe_capacity=moe_capacity)

        if cfg.attention_mode == "joint3d":
            # One set of F * N tokens, the temporal position added up front.
            x = (x.reshape(b, f, n, d) + pos_t[None, :, None, :].to(x.dtype)).reshape(b, f * n, d)
            x = _shard_tokens(x, seq_axis)
            for blk in self.blocks:
                x = blk(x, c_emb, ctx, heads, seq_axis, **moe)
            # The head in the (B, L, D) layout (the modulation is per batch
            # element), then the tokens gathered whole.
            x = _gather_tokens(self._final_head(x, c_emb), seq_axis).reshape(b * f, n, -1)
        else:
            x = _shard_tokens(x, seq_axis)  # each frame's tokens
            c_f = c_emb.repeat_interleave(f, dim=0)  # (B*F, D)
            ctx_f = None if ctx is None else ctx.repeat_interleave(f, dim=0)
            for i, blk in enumerate(self.blocks):
                if i % 2 == 0:
                    x = blk(x, c_f, ctx_f, heads, seq_axis, **moe)
                else:
                    if i == 1:  # the temporal position, before the first temporal block
                        nl = x.shape[1]  # this rank's tokens a frame
                        x = (x.reshape(b, f, nl, d) + pos_t[None, :, None, :].to(x.dtype)
                             ).reshape(b * f, nl, d)
                    x = blk.temporal(x, c_emb, heads, b, f)
            x = _gather_tokens(self._final_head(x, c_f), seq_axis)

        x = x.reshape(b * f, gh, gw, p, p, cfg.out_channels)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, f, hh, ww, cfg.out_channels)


def _shard_tokens(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """This rank's contiguous slice of the token axis (dim 1), the order the
    gather puts back together."""
    if axis is None:
        return x
    ln = x.shape[1]
    if ln % axis.size:
        raise ValueError(f"token axis {ln} not divisible by seq_shards {axis.size}")
    loc = ln // axis.size
    return x[:, axis.index * loc:(axis.index + 1) * loc]


def _gather_tokens(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    return x if axis is None else all_gather(x, axis, 1)


class DiTVideoWrapper:
    """Schedule + CFG wrapper with the pipeline's ``step_fn(bundle, latent,
    step)`` contract; ``bundle = (dit, context, guidance)``.

    ``solver="euler"``: Karras sigmas, input scaled by ``rsqrt(sigma^2 + 1)``,
    timestep ``0.25 * log(sigma)``, fp32 v-prediction Euler update.
    ``solver="euler_a"``: the same with the ancestral update, its noise drawn
    from ``(sampler_seed, step)``. ``solver="heun"`` and ``"dpmpp2m"``: the
    same sigmas and scaling with the second-order updates; dpmpp2m's payload
    is ``[x | previous x0_hat]`` along channels (``pack_initial``).
    ``solver="flowmatch"``: shifted-linear flow-matching sigmas, no input
    scaling, timestep ``sigma * 1000``, fp32 velocity update. CFG blends in
    fp32 with per-frame ``guidance``; the uncond branch gets zeros, or the
    negative prompt's tokens when ``context`` is a ``(neg_ctx, pos_ctx)``
    tuple. ``seq_axis`` splits every forward's tokens over that axis,
    ``cfg_axis`` (a size-2 axis) runs one branch a rank, ``expert_axis``
    splits the MoE experts. ``VDPP_MOE_DISPATCH`` and ``VDPP_MOE_CAPACITY``
    are read here, once (build a new wrapper to change them).
    """

    def __init__(
        self,
        config: DiTVideoConfig | None = None,
        num_steps: int = 25,
        sigma_min: float = 0.002,
        sigma_max: float = 700.0,
        solver: str = "euler",
        flow_shift: float = 3.0,
        sampler_seed: int = 0,
        device: str | torch.device | None = None,
        noise_source=None,
    ):
        if solver not in ("euler", "euler_a", "heun", "dpmpp2m", "flowmatch"):
            raise ValueError("solver must be 'euler', 'euler_a', 'heun', 'dpmpp2m' or "
                             "'flowmatch'")
        self.solver = solver
        # euler_a draws its noise from (sampler_seed, step_idx), as the
        # reference's DiT wrapper folds it (the SVD wrapper folds the real
        # step instead); ``noise_source(step, shape)`` replaces the draw.
        self.sampler_seed = int(sampler_seed)
        self.noise_source = noise_source
        self.config = config or DiTVideoConfig.latte_xl()
        self.device = resolve_device(device)
        self.moe_dispatch = os.environ.get("VDPP_MOE_DISPATCH", "dense")
        self.moe_capacity = float(os.environ.get("VDPP_MOE_CAPACITY", "2.0"))
        if solver == "flowmatch":
            self.schedule: EulerKarrasSchedule | FlowMatchSchedule = (
                FlowMatchSchedule.create(num_steps, shift=flow_shift))
        else:
            self.schedule = EulerKarrasSchedule.create(num_steps, sigma_min, sigma_max)

    @property
    def init_noise_sigma(self) -> float:
        return self.schedule.init_noise_sigma

    @property
    def latent_channel_multiplier(self) -> int:
        """Channel slots the pipeline payload carries (2 for dpmpp2m:
        [x | previous x0_hat])."""
        return 2 if self.solver == "dpmpp2m" else 1

    def pack_initial(self, latent: torch.Tensor) -> torch.Tensor:
        if self.latent_channel_multiplier == 1:
            return latent
        return torch.cat([latent, torch.zeros_like(latent)], dim=-1)

    def unpack_final(self, latent: torch.Tensor) -> torch.Tensor:
        if self.latent_channel_multiplier == 1:
            return latent
        return latent[..., : latent.shape[-1] // 2]

    def init(self, generator: torch.Generator) -> DiTVideo:
        """A randomly initialised DiT on this wrapper's device."""
        return DiTVideo(self.config, device=self.device).init_weights(generator)

    def _eps(self, params: DiTVideo, scaled: torch.Tensor, timestep, context, neg_context,
             guidance, seq_axis: Axis | None = None, cfg_axis: Axis | None = None,
             expert_axis: Axis | None = None) -> torch.Tensor:
        """The model output at one point, CFG-blended in fp32 when guided.

        ``cfg_axis``: rank 0 of the axis runs the uncond branch, rank 1 the
        cond one, and one swap gives each the other's output, so both blend
        the two outputs that sequential CFG computes."""
        def fwd(ctx):
            return params(scaled, timestep, ctx, seq_axis=seq_axis, expert_axis=expert_axis,
                          moe_dispatch=self.moe_dispatch, moe_capacity=self.moe_capacity)

        if guidance is None or context is None:
            return fwd(context)
        uncond_ctx = torch.zeros_like(context) if neg_context is None else neg_context
        if cfg_axis is not None:
            if neg_context is not None and neg_context.shape != context.shape:
                raise ValueError(f"cfg-axis CFG needs neg/pos contexts of equal shape, got "
                                 f"{tuple(neg_context.shape)} vs {tuple(context.shape)} (pad "
                                 "token ids to a common length)")
            is_cond = cfg_axis.index == 1
            local = fwd(context if is_cond else uncond_ctx)
            other = swap(local, cfg_axis)
            uncond, cond = (other, local) if is_cond else (local, other)
        else:
            uncond = fwd(uncond_ctx)
            cond = fwd(context)
        cond, uncond = cond.float(), uncond.float()
        return uncond + guidance.float() * (cond - uncond)

    def step(self, params: DiTVideo, latent: torch.Tensor, step_idx: int, context=None,
             guidance: torch.Tensor | None = None, seq_axis: Axis | None = None,
             cfg_axis: Axis | None = None, expert_axis: Axis | None = None) -> torch.Tensor:
        """One denoising step; ``context`` may be a ``(neg_ctx, pos_ctx)``
        tuple for negative-prompt CFG. The axes go to every model call
        (heun's two included)."""
        axes = dict(seq_axis=seq_axis, cfg_axis=cfg_axis, expert_axis=expert_axis)
        neg_context = None
        if isinstance(context, tuple):
            neg_context, context = context
        sigma = self.schedule.sigmas[step_idx]
        sigma_next = self.schedule.sigmas[step_idx + 1]
        lat32 = latent.float()
        s = torch.as_tensor(sigma, dtype=torch.float32, device=latent.device)
        if self.solver == "flowmatch":
            v = self._eps(params, lat32, s * 1000.0, context, neg_context, guidance, **axes)
            return flowmatch_step(lat32, v, sigma, sigma_next, latent.dtype)
        if self.solver == "heun":
            return heun_step_v_prediction(
                lat32, lambda x, t: self._eps(params, x, t, context, neg_context, guidance, **axes),
                sigma, sigma_next, latent.dtype)
        if self.solver == "dpmpp2m":
            lat32, old_den = lat32.chunk(2, dim=-1)
        scaled = lat32 * torch.rsqrt(s * s + 1.0)
        eps = self._eps(params, scaled, 0.25 * torch.log(s), context, neg_context, guidance,
                        **axes)
        if self.solver == "dpmpp2m":
            x_next, denoised = dpmpp2m_step_v_prediction(
                lat32, eps, old_den, self.schedule.sigmas[max(step_idx - 1, 0)], sigma,
                sigma_next, latent.dtype)
            return torch.cat([x_next, denoised], dim=-1)
        if self.solver == "euler_a":
            z = (ancestral_noise(self.sampler_seed, step_idx, lat32.shape, lat32.device)
                 if self.noise_source is None else
                 self.noise_source(step_idx, tuple(lat32.shape)).to(lat32.device, torch.float32))
            return euler_ancestral_step_v_prediction(lat32, eps, z, sigma, sigma_next,
                                                     latent.dtype)
        return euler_step_v_prediction(lat32, eps, sigma, sigma_next, latent.dtype)

    def pipeline_step_fn(self, seq_axis: Axis | None = None, cfg_axis: Axis | None = None,
                         expert_axis: Axis | None = None, frame_axis: Axis | None = None):
        """``step_fn(bundle, latent, step)`` with ``bundle = (dit, context,
        guidance)``, over the given intra-sample axes (``Stage.axes``: a
        rank's axes on a (stage, seq, cfg, expert) mesh; with an expert axis
        the DiT must hold this rank's experts, which ``StepPipeline(
        param_spec=ops.moe.expert_layout)`` leaves it). The DiT has no frame
        axis."""
        if frame_axis is not None:
            raise ValueError("the DiT has no frame axis (--frame-parallel needs an svd model)")

        def step_fn(bundle, latent: torch.Tensor, step_idx: int) -> torch.Tensor:
            params, context, guidance = bundle
            return self.step(params, latent, step_idx, context, guidance, seq_axis=seq_axis,
                             cfg_axis=cfg_axis, expert_axis=expert_axis)

        return step_fn
