"""The port's temporal VAE decoder (``vdpp_tpu_torch.models.vae``) and its
weight carrier against the JAX package's (``vdpp_tpu.models.vae``,
``vdpp_tpu.utils.weights.convert_vae_decoder_state_dict``), fp32 on the CPU.

Weights are drawn from a numpy seed with diffusers names, reach the JAX side
through the JAX package's converter and come back to the port through
``from_jax_vae_decoder_params``. Biases, norm parameters and mix factors are
moved off the 0, 1 and 0 the inits give them, which would hide a misplaced
one. Latents are numpy arrays handed to both sides; the JAX decoder's
``apply`` is jitted (also under its ``decode_chunked``).

Tolerance: max|diff| <= 1e-4 * max|ref|. Both sides compute in fp32 and
differ in summation order (convolutions, norm statistics, attention)
through a dozen layers, which stays around 1e-6 relative.
"""

import jax
import numpy as np
import pytest
import torch

from vdpp_tpu.models.vae import TemporalVAEDecoder as JaxDecoder
from vdpp_tpu.models.vae import VAEConfig as JaxVAEConfig
from vdpp_tpu.utils.weights import convert_vae_decoder_state_dict

from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.utils.weights import from_jax_vae_decoder_params

REL_TOL = 1e-4


def _assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """(JAX decoder, its params, the port's decoder holding the same)."""
    dec = TemporalVAEDecoder(VAEConfig.tiny(), device="cpu")
    rng = np.random.default_rng(0)
    sd = {}
    for name, p in dec.state_dict().items():
        noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if p.ndim >= 2:
            sd[name] = noise / np.sqrt(p[0].numel())
        else:  # a 1-D ".weight" is a norm scale
            sd[name] = (float(name.endswith(".weight")) + 0.1 * noise).astype(np.float32)
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
    fa.launches = 0
    got = dec.apply(torch.from_numpy(lat))
    assert fa.launches == 0  # CPU tensors take the plain version, never the kernel
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
