"""The port's CLIP vision tower and preprocessing
(``vdpp_tpu_torch.models.clip_encoder``) and its weight carrier against the
JAX package's (``vdpp_tpu.models.clip_encoder``,
``vdpp_tpu.utils.weights.convert_clip_state_dict``), fp32 on the CPU.

Weights are drawn from a numpy seed with transformers names, reach the JAX
side through the JAX package's converter and come back to the port through
``from_jax_clip_params``. Biases, norm parameters and the class embedding
are moved off the 0 and 1 the inits give them.

Tolerances: the tower to max|diff| <= 1e-5 * max|ref| (both sides fp32, two
layers; summation order alone, measured about 2e-7). Preprocessing to one
uint8 level after normalization, 1 / (255 * min(CLIP_STD)) = 0.0150, plus
1e-6 for the port's fp32 result against the reference's fp64: the port
resizes with PyTorch's bicubic antialias on uint8, the reference with
Pillow, and the two round a few pixels the other way.
"""

import jax
import numpy as np
import pytest
import torch

from vdpp_tpu.models.clip_encoder import CLIPVisionConfig as JaxConfig
from vdpp_tpu.models.clip_encoder import CLIPVisionEncoder as JaxEncoder
from vdpp_tpu.models.clip_encoder import preprocess_image as jax_preprocess
from vdpp_tpu.utils.weights import convert_clip_state_dict

from vdpp_tpu_torch.models.clip_encoder import (
    CLIP_STD,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    preprocess_image,
)
from vdpp_tpu_torch.ops import attention as attention_mod
from vdpp_tpu_torch.utils.weights import from_jax_clip_params

from torch_port_helpers import one_torch_thread, random_state_dict  # noqa: F401

REL_TOL = 1e-5
PIXEL_TOL = 1.0 / (255.0 * min(CLIP_STD)) + 1e-6


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, the port's tower holding the same)."""
    enc = CLIPVisionEncoder(CLIPVisionConfig.tiny(), device="cpu")
    sd = random_state_dict(enc, 0)
    params = jax.tree_util.tree_map(
        np.asarray, convert_clip_state_dict(sd, num_layers=2, patch_size=8, strict=True))
    enc.load_state_dict(from_jax_clip_params(params))
    return params, enc


def test_tower_matches_jax(tiny):
    params, enc = tiny
    px = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxEncoder(JaxConfig.tiny()).apply)(params, px))
    got = enc.apply(torch.from_numpy(px))
    assert tuple(got.shape) == want.shape == (2, 16)
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_patch_embedding_order(tiny):
    """The port's stride-p conv over (B, 3, H, W) equals the reference's
    linear over patches flattened in (row, column, channel) order, patch by
    patch in row-major order. The carrier with rows and columns swapped (a
    silent mistake: the shapes agree) does not."""
    params, enc = tiny
    p = 8
    px = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32)
    patches = px.reshape(1, 4, p, 4, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(1, 16, p * p * 3)
    want = patches @ params["patch_embed"]["w"]  # the reference's patch linear
    weight = enc.vision_model.embeddings.patch_embedding.weight
    conv = torch.nn.functional.conv2d(torch.from_numpy(px).permute(0, 3, 1, 2), weight, stride=p)
    got = conv.flatten(2).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())
    swapped = torch.nn.functional.conv2d(torch.from_numpy(px).permute(0, 3, 1, 2),
                                         weight.transpose(2, 3), stride=p)
    assert np.abs(swapped.flatten(2).transpose(1, 2).numpy() - want).max() > 0.1


def test_clip_never_takes_flash(tiny, monkeypatch):
    """CLIP's attention stays on the plain path at any length (L = 530 here,
    above the flash gate of 512), as the reference's ``use_flash=False``."""
    import dataclasses

    def refuse(*a, **k):
        raise AssertionError("CLIP reached flash_attention")

    monkeypatch.setattr(attention_mod, "flash_attention", refuse)
    cfg = dataclasses.replace(CLIPVisionConfig.tiny(), image_size=184)
    enc = CLIPVisionEncoder(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0))
    out = enc.apply(torch.randn(1, 184, 184, 3, generator=torch.Generator().manual_seed(1)))
    assert cfg.num_patches + 1 == 530 and torch.isfinite(out).all()


@pytest.mark.parametrize("hw", [(576, 1024), (300, 200), (100, 150)],
                         ids=["landscape", "portrait", "smaller-than-224"])
def test_preprocess_matches_jax(hw):
    img = (np.random.default_rng(3).random((*hw, 3)) * 255).astype(np.uint8)
    want = jax_preprocess(img, 224)
    got = preprocess_image(img, 224)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (224, 224, 3)
    assert np.abs(got.numpy() - want).max() <= PIXEL_TOL


def test_params_survive_conversion_and_back(tiny):
    """``from_jax_clip_params`` gives exactly the names the JAX converter
    reads (it runs strict) and the module holds, and carries the JAX tree
    back leaf for leaf."""
    params, enc = tiny
    sd = {k: v.numpy() for k, v in from_jax_clip_params(params).items()}
    assert set(sd) == set(enc.state_dict())
    back = convert_clip_state_dict(sd, num_layers=2, patch_size=8, strict=True)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_vit_h_14_shapes():
    """ViT-H/14: 632 M parameters, 257 tokens at 224x224, head dim 80."""
    enc = CLIPVisionEncoder(CLIPVisionConfig.vit_h_14(), device="meta")
    assert sum(p.numel() for p in enc.parameters()) == pytest.approx(632.08e6, rel=1e-3)
    emb = enc.vision_model.embeddings
    assert emb.patch_embedding.weight.shape == (1280, 3, 14, 14)
    assert emb.position_embedding.weight.shape == (257, 1280)
    assert enc.visual_projection.bias is None
    assert len(enc.vision_model.encoder.layers) == 32
