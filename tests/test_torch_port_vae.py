"""The port's temporal VAE decoder and KL encoder (``vdpp_tpu_torch.models.vae``),
their weight carriers and the port's ``conv2d`` padding forms against the
JAX package's (``vdpp_tpu.models.vae``, ``vdpp_tpu.utils.weights.
convert_vae_decoder_state_dict`` and ``convert_vae_encoder_state_dict``,
``vdpp_tpu.ops.conv.conv2d``), fp32 on the CPU.

Weights are drawn from a numpy seed with diffusers names, reach the JAX side
through the JAX package's converter and come back to the port through
``from_jax_vae_decoder_params``. Biases, norm parameters and mix factors are
moved off the 0, 1 and 0 the inits give them, which would hide a misplaced
one. Latents are numpy arrays handed to both sides; the JAX decoder's
``apply`` is jitted (also under its ``decode_chunked``).

Tolerance: max|diff| <= 1e-4 * max|ref| for the decoder. Both sides compute
in fp32 and differ in summation order (convolutions, norm statistics,
attention) through a dozen layers, which stays around 1e-6 relative. The
encoder is held to 1e-5 * max|ref| (measured about 8e-7: fewer layers, no
temporal mixing), and one convolution to 1e-6 * max|ref|.
"""

import jax
import numpy as np
import pytest
import torch

from vdpp_tpu.models.vae import TemporalVAEDecoder as JaxDecoder
from vdpp_tpu.models.vae import VAEConfig as JaxVAEConfig
from vdpp_tpu.models.vae import VAEEncoder as JaxEncoder
from vdpp_tpu.ops.conv import conv2d as jax_conv2d
from vdpp_tpu.utils.weights import convert_vae_decoder_state_dict, convert_vae_encoder_state_dict

from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig, VAEEncoder
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops.conv import Conv2d, conv2d
from vdpp_tpu_torch.utils.weights import from_jax_vae_decoder_params, from_jax_vae_encoder_params

from torch_port_helpers import one_torch_thread, random_state_dict  # noqa: F401

REL_TOL = 1e-4
ENCODER_REL_TOL = 1e-5
CONV_REL_TOL = 1e-6


def _assert_close(got: torch.Tensor, want, rel_tol: float = REL_TOL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= rel_tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """(JAX decoder, its params, the port's decoder holding the same)."""
    dec = TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")
    sd = random_state_dict(dec, 0)
    params = jax.tree_util.tree_map(
        np.asarray, convert_vae_decoder_state_dict(sd, num_levels=2, layers_per_block=1))
    dec.load_state_dict(from_jax_vae_decoder_params(params))
    jdec = JaxDecoder(JaxVAEConfig.tiny())
    jdec.apply = jax.jit(jdec.apply)
    return jdec, params, dec


@pytest.mark.parametrize("hw", [(8, 8), (16, 32)])
def test_decoder_apply_matches_jax(tiny, hw):
    """16x32 gives the mid-block 512 positions: both sides take the flash
    route there (the JAX Pallas kernel in interpret mode, the port's plain
    version)."""
    jdec, params, dec = tiny
    lat = np.random.default_rng(1).standard_normal((1, 3, *hw, 4)).astype(np.float32)
    fa.launches.clear()
    got = dec.apply(torch.from_numpy(lat))
    assert not fa.launches  # CPU tensors take the plain version, never the kernel
    assert tuple(got.shape) == (1, 3, 2 * hw[0], 2 * hw[1], 3)
    _assert_close(got, jdec.apply(params, lat))


def test_decode_chunked_matches_jax(tiny):
    """5 frames in chunks of 2: the last chunk is ragged."""
    jdec, params, dec = tiny
    lat = np.random.default_rng(2).standard_normal((1, 5, 8, 8, 4)).astype(np.float32)
    got = dec.decode_chunked(torch.from_numpy(lat), chunk_frames=2)
    _assert_close(got, jdec.decode_chunked(params, lat, chunk_frames=2))
    # the chunks decode apart: the last frame is its own decode
    _assert_close(got[:, 4:], jdec.apply(params, lat[:, 4:]))


def test_decoder_params_survive_conversion_and_back(tiny):
    """``convert_vae_decoder_state_dict(from_jax_vae_decoder_params(tree))``
    gives back the JAX tree, leaf for leaf."""
    _, params, dec = tiny
    sd = {k: v.numpy() for k, v in from_jax_vae_decoder_params(params).items()}
    assert set(sd) == set(dec.state_dict())
    back = convert_vae_decoder_state_dict(sd, num_levels=2, layers_per_block=1)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_svd_decoder_shapes():
    """The full-width decoder: 4 levels, 512 top channels, 63.6 M parameters,
    and the mid-block attention is one head of d = 512."""
    dec = TemporalVAEDecoder(VAEConfig.svd(), device="meta")
    assert sum(p.numel() for p in dec.parameters()) == pytest.approx(63.58e6, rel=1e-3)
    attn = dec.decoder.mid_block.attentions[0]
    assert attn.to_q.weight.shape == (512, 512) and attn.to_q.bias is not None
    assert len(dec.decoder.up_blocks) == 4
    assert not hasattr(dec.decoder.up_blocks[3], "upsamplers")


@pytest.mark.parametrize("hw", [(9, 9), (10, 14)])
@pytest.mark.parametrize("padding", [((0, 1), (0, 1)), ((1, 1), (1, 1)), "SAME"])
def test_conv2d_padding_matches_jax(hw, padding):
    """The stride-2 3x3 conv with the KL encoder's right/bottom-only padding,
    the UNet downsample's symmetric one and ``"SAME"`` (whose odd pixel of
    padding goes right and bottom), on odd and even sizes. On even sizes
    (the app's) symmetric padding in place of the encoder's gives the same
    shape on a grid shifted by one pixel, so only the values tell them
    apart."""
    rng = np.random.default_rng(3)
    conv = Conv2d(8, 6, 3, device="cpu")
    w = (rng.standard_normal((3, 3, 8, 6)) / np.sqrt(72)).astype(np.float32)
    b = (0.1 * rng.standard_normal(6)).astype(np.float32)
    conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
    conv.bias.copy_(torch.from_numpy(b))
    x = rng.standard_normal((2, *hw, 8)).astype(np.float32)
    want = np.asarray(jax_conv2d(x, {"w": w, "b": b}, stride=2, padding=padding))
    got = conv2d(torch.from_numpy(x), conv, stride=2, padding=padding)
    _assert_close(got, want, CONV_REL_TOL)
    if padding == ((0, 1), (0, 1)) and hw[0] % 2 == 0:  # differs in value, not shape
        other = conv2d(torch.from_numpy(x), conv, stride=2, padding=((1, 1), (1, 1)))
        assert other.shape == got.shape and not torch.allclose(other, got, atol=1e-2)


@pytest.fixture(scope="module")
def tiny_encoder():
    """(JAX encoder, its params, the port's encoder holding the same)."""
    enc = VAEEncoder(VAEConfig.tiny(), device="cpu")
    sd = random_state_dict(enc, 4)
    params = jax.tree_util.tree_map(
        np.asarray, convert_vae_encoder_state_dict(sd, num_levels=2, layers_per_block=1))
    enc.load_state_dict(from_jax_vae_encoder_params(params))
    jenc = JaxEncoder(JaxVAEConfig.tiny())
    jenc.apply = jax.jit(jenc.apply)
    return jenc, params, enc


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_encoder_apply_and_mode_match_jax(tiny_encoder, hw):
    """48x64 gives the mid-block 24 x 32 = 768 positions: both sides take the
    flash route there (the JAX Pallas kernel in interpret mode, the port's
    plain version); 32x32 (256 positions) stays on the plain path."""
    jenc, params, enc = tiny_encoder
    x = np.random.default_rng(5).standard_normal((2, *hw, 3)).astype(np.float32)
    fa.launches.clear()
    moments = enc.apply(torch.from_numpy(x))
    assert not fa.launches  # CPU tensors take the plain version, never the kernel
    want = jenc.apply(params, x)
    _assert_close(moments, want, ENCODER_REL_TOL)
    assert tuple(moments.shape) == (2, hw[0] // 2, hw[1] // 2, 8)
    _assert_close(enc.mode(moments), jenc.mode(want), ENCODER_REL_TOL)


def test_encoder_params_survive_conversion_and_back(tiny_encoder):
    """``from_jax_vae_encoder_params`` gives exactly the names the JAX
    converter reads (it runs strict) and the module holds, and carries the
    JAX tree back leaf for leaf."""
    _, params, enc = tiny_encoder
    sd = {k: v.numpy() for k, v in from_jax_vae_encoder_params(params).items()}
    assert set(sd) == set(enc.state_dict())
    back = convert_vae_encoder_state_dict(sd, num_levels=2, layers_per_block=1, strict=True)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_svd_encoder_shapes():
    """The full-width encoder: 34.2 M parameters, right/bottom-padded
    downsamples on 3 of 4 levels, and a mid-block attention of one head at
    d = 512 (at 1024x576 it attends over 72 * 128 = 9216 positions)."""
    enc = VAEEncoder(VAEConfig.svd(), device="meta")
    assert sum(p.numel() for p in enc.parameters()) == pytest.approx(34.16e6, rel=1e-3)
    blocks = enc.encoder.down_blocks
    assert [hasattr(b, "downsamplers") for b in blocks] == [True, True, True, False]
    assert enc.encoder.mid_block.attentions[0].to_q.weight.shape == (512, 512)
    assert enc.encoder.conv_out.weight.shape == (8, 512, 3, 3)
