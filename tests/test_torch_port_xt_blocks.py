"""The port's blocks at TRUE svd-xt dimensions against the JAX package's, fp32
on the CPU.

The tiny configs hold the port's wiring; these cases hold one instance of
each block class at the real channel, group, head, context and frame
dimensions, where a detail that the tiny configs cannot tell apart would
show: the spatio-temporal ResBlock at 320 channels with 32 groups and a
1280-wide time embedding, the spatio-temporal transformer at 320 channels
with 5 heads of 64 and a 1024-wide context, the mid-block temporal
transformer block at 1280 channels and 20 heads over 25 frames, the VAE's
single-head attention at d = 512, and one CLIP ViT-H/14 layer (width 1280,
16 heads of 80, L = 257) through the tower's embeddings and head. The case
table, the seeds and the fan-in rescale are those of
``tests/fixtures/gen_xt_goldens.py``, with one spatial tile of the 72x128
latent.

Both sides run the same weights: the JAX trees come from the JAX package's
converters and reach the port through its carriers (``weights._Out`` and
``from_jax_clip_params``). The JAX blocks run jitted (one compile each, in
place of one a primitive). The reference is the JAX block itself, not the
frozen torch-oracle outputs of ``tests/test_xt_dim_goldens.py``, which
drift with torch's CPU thread count.

Tolerance: max|diff| <= 1e-5 * max|ref| for every block (fp32 both sides;
summation order alone, over fan-ins up to 5120 and 25-frame softmaxes,
measured at most 1.7e-6 of max|ref|, at the ResBlock).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_svd_oracle as oracle
from tests.fixtures.gen_xt_goldens import (
    B,
    CROSS,
    FRAMES,
    L0_CH,
    L0_HEADS,
    MID_CH,
    MID_HEADS,
    TEMB,
    TILE_H,
    TILE_W,
    VAE_CH,
    rescale_weights,
)
from vdpp_tpu.models import vae as jax_vae
from vdpp_tpu.models.clip_encoder import CLIPVisionConfig as JaxClipConfig
from vdpp_tpu.models.clip_encoder import CLIPVisionEncoder as JaxClip
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxUNetConfig
from vdpp_tpu.models.svd_unet import _st_resblock, _st_transformer, _temporal_tblock
from vdpp_tpu.utils.weights import (
    _SD,
    _conv_st_resblock,
    _conv_st_transformer,
    _conv_temporal_tblock,
    _conv_vae_attention,
    convert_clip_state_dict,
)

from vdpp_tpu_torch.models.clip_encoder import CLIPVisionConfig, CLIPVisionEncoder
from vdpp_tpu_torch.models.svd_unet import STResBlock, STTransformer, SVDUNetConfig
from vdpp_tpu_torch.models.svd_unet import TemporalBasicTransformerBlock
from vdpp_tpu_torch.models.vae import VAEConfig, _VAEAttention
from vdpp_tpu_torch.utils.weights import _Out, from_jax_clip_params

from torch_port_helpers import one_torch_thread, random_state_dict  # noqa: F401

REL_TOL = 1e-5
KW = dict(device="cpu", dtype=torch.float32)
CFG = SVDUNetConfig.svd_xt(torch.float32)


def _jax_tree(convert, sd: dict, prefix: str, *args):
    """The JAX block's parameters from a diffusers-named torch state dict."""
    np_sd = {k: v.numpy() for k, v in sd.items()}
    return jax.tree_util.tree_map(np.asarray, convert(_SD(np_sd, jnp.float32), prefix, *args))


def _load(module: torch.nn.Module, carry, prefix: str, tree) -> None:
    """Carry a JAX tree to ``module`` through a ``_Out`` method."""
    out = _Out()
    carry(out, prefix, tree)
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in out.sd.items()})


def _assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.numpy().transpose(0, 2, 3, 1).copy()


def test_st_resblock_xt():
    gen = torch.Generator().manual_seed(101)
    sd = {}
    oracle.sd_st_resblock(sd, "res", L0_CH, L0_CH, gen, TEMB)
    rescale_weights(sd, 1 / 8)
    x = _nhwc(torch.randn(B * FRAMES, L0_CH, TILE_H, TILE_W, generator=gen))
    temb = torch.randn(B * FRAMES, TEMB, generator=gen).numpy()
    params = _jax_tree(_conv_st_resblock, sd, "res")
    want = jax.jit(_st_resblock, static_argnums=(3, 4, 5))(
        params, jnp.asarray(x), jnp.asarray(temb), JaxUNetConfig(dtype=jnp.float32), B, FRAMES)
    block = STResBlock(CFG, L0_CH, L0_CH, **KW)
    _load(block, _Out.resblock, "res", params)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), torch.from_numpy(temb), B, FRAMES)
    _assert_close(got, want)


def test_st_transformer_xt():
    gen = torch.Generator().manual_seed(102)
    sd = {}
    oracle.sd_st_transformer(sd, "attn", L0_CH, CROSS, gen)
    rescale_weights(sd, 1 / 16)
    x = _nhwc(torch.randn(B * FRAMES, L0_CH, TILE_H, TILE_W, generator=gen))
    ctx = torch.randn(B * FRAMES, 1, CROSS, generator=gen).numpy()
    params = _jax_tree(_conv_st_transformer, sd, "attn", 1)
    want = jax.jit(_st_transformer, static_argnums=(3, 4, 5, 6))(
        params, jnp.asarray(x), jnp.asarray(ctx), JaxUNetConfig(dtype=jnp.float32), L0_HEADS, B,
        FRAMES)
    block = STTransformer(CFG, L0_CH, **KW)
    _load(block, _Out.transformer, "attn", params)
    with torch.inference_mode():
        got = block(torch.from_numpy(x), torch.from_numpy(ctx), L0_HEADS, B, FRAMES)
    _assert_close(got, want)


def test_temporal_tblock_xt():
    """The mid block's temporal transformer block: 25 frames as the
    attention tokens, 1280 channels over 20 heads, at 12 locations."""
    gen = torch.Generator().manual_seed(103)
    sd = {}
    oracle.sd_temporal_tblock(sd, "tb", MID_CH, CROSS, gen)
    rescale_weights(sd, 1 / 16)
    h = torch.randn(B * FRAMES, 12, MID_CH, generator=gen).numpy()
    time_ctx_b = torch.randn(B, 1, CROSS, generator=gen).numpy()
    params = _jax_tree(_conv_temporal_tblock, sd, "tb")
    want = jax.jit(_temporal_tblock, static_argnums=(3, 4, 5))(
        params, jnp.asarray(h), jnp.asarray(time_ctx_b), MID_HEADS, B, FRAMES)
    block = TemporalBasicTransformerBlock(CFG, MID_CH, **KW)
    _load(block, _Out.temporal_block, "tb", params)
    with torch.inference_mode():
        got = block(torch.from_numpy(h), torch.from_numpy(time_ctx_b), MID_HEADS, B, FRAMES)
    _assert_close(got, want)


def test_vae_attention_d512_xt():
    """The VAE mid block's single-head attention at d = 512 with 32 groups,
    3 frames of a 12x16 latent tile."""
    gen = torch.Generator().manual_seed(104)
    sd = {}
    prefix = "mid_block.attentions.0"
    oracle.sd_vae_attention(sd, prefix, VAE_CH, gen)
    rescale_weights(sd, 1 / 8)
    x = _nhwc(torch.randn(3, VAE_CH, 12, 16, generator=gen))
    params = _jax_tree(_conv_vae_attention, sd, prefix)
    want = jax.jit(jax_vae._vae_attention, static_argnums=2)(params, jnp.asarray(x),
                                                             jax_vae.VAEConfig.svd())

    def carry(out, p, tree):
        out.norm(p + ".group_norm", tree["norm"])
        out.attention(p, tree["attn"])

    attn = _VAEAttention(VAEConfig.svd(), VAE_CH, **KW)
    _load(attn, carry, prefix, params)
    with torch.inference_mode():
        got = attn(torch.from_numpy(x))
    _assert_close(got, want)


@pytest.fixture(scope="module")
def clip_one_layer():
    cfg = CLIPVisionConfig(num_layers=1)  # ViT-H/14's width, heads, patch and tokens
    enc = CLIPVisionEncoder(cfg, device="cpu")
    sd = random_state_dict(enc, 105)
    params = jax.tree_util.tree_map(
        np.asarray, convert_clip_state_dict(sd, num_layers=1, patch_size=14, strict=True))
    enc.load_state_dict(from_jax_clip_params(params))
    return params, enc


def test_clip_layer_vit_h_xt(clip_one_layer):
    params, enc = clip_one_layer
    px = np.random.default_rng(106).standard_normal((1, 224, 224, 3)).astype(np.float32)
    want = jax.jit(JaxClip(JaxClipConfig(num_layers=1)).apply)(params, jnp.asarray(px))
    got = enc.apply(torch.from_numpy(px))
    assert tuple(got.shape) == (1, 1024)
    _assert_close(got, want)
