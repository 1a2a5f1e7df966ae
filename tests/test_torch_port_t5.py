"""The port's T5 text encoder (``vdpp_tpu_torch.models.t5_encoder``) and its
weight carrier against the JAX package's (``vdpp_tpu.models.t5_encoder``,
``vdpp_tpu.utils.weights.convert_t5_encoder_state_dict``), fp32 on the CPU.

Weights are drawn from a numpy seed under transformers' ``T5EncoderModel``
names (the port's own), reach the JAX side through the JAX package's
converter and come back through ``from_jax_t5_params``. Token ids and masks
are numpy arrays handed to both sides.

Tolerances: buckets and the hash tokenizer exactly equal; hidden states
max|diff| <= 1e-5 * max|ref| (fp32 on both sides, sums in other orders
through two layers; measured under 1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models import t5_encoder as jt5
from vdpp_tpu.utils.weights import convert_t5_encoder_state_dict

from vdpp_tpu_torch.models import t5_encoder as tt5
from vdpp_tpu_torch.utils.weights import from_jax_t5_params

from torch_port_helpers import one_torch_thread  # noqa: F401

REL_TOL = 1e-5


@pytest.mark.parametrize("l,buckets,max_distance", [(64, 32, 128), (300, 32, 128),
                                                    (40, 8, 16), (7, 8, 16)])
def test_relative_position_buckets_equal(l, buckets, max_distance):
    got = tt5.relative_position_buckets(l, l, buckets, max_distance).numpy()
    want = np.asarray(jt5.relative_position_buckets(l, l, buckets, max_distance))
    np.testing.assert_array_equal(got, want)


def test_hash_tokenize_equal():
    for prompt in ("a red panda eating bamboo", "", "x " * 80):
        assert tt5.hash_tokenize(prompt, 32128, 64) == jt5.hash_tokenize(prompt, 32128, 64)


def _random_state_dict(enc: tt5.T5TextEncoder, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in enc.state_dict().items():
        noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if name.endswith("layer_norm.weight"):
            sd[name] = (1.0 + 0.1 * noise).astype(np.float32)
        elif "relative_attention_bias" in name or name == "shared.weight":
            sd[name] = noise
        else:
            sd[name] = noise / np.sqrt(p.shape[1])
    return sd


def _pair(ff_proj: str):
    cfg = tt5.T5EncoderConfig(**{**tt5.T5EncoderConfig.tiny().__dict__,
                                 "feed_forward_proj": ff_proj})
    enc = tt5.T5TextEncoder(cfg, device="cpu")
    sd = _random_state_dict(enc, 0)
    params = jax.tree_util.tree_map(np.asarray, convert_t5_encoder_state_dict(
        sd, num_layers=cfg.num_layers, gated=ff_proj == "gated-gelu"))
    enc.load_state_dict(from_jax_t5_params(params))
    jcfg = jt5.T5EncoderConfig(**{**jt5.T5EncoderConfig.tiny().__dict__,
                                  "feed_forward_proj": ff_proj})
    return enc, jt5.T5TextEncoder(jcfg), params


@pytest.mark.parametrize("ff_proj", ["gated-gelu", "relu"])
@pytest.mark.parametrize("masked", [False, True])
def test_t5_tiny_matches_jax(ff_proj, masked):
    enc, jenc, params = _pair(ff_proj)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 128, size=(2, 9)).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones((2, 9), np.int32)
        mask[1, 5:] = 0  # the second prompt is 5 tokens, padded to 9
    got = enc(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jenc.apply(params, jnp.asarray(ids),
                                 None if mask is None else jnp.asarray(mask)))
    assert tuple(got.shape) == want.shape == (2, 9, 32)
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), err


@pytest.mark.parametrize("ff_proj", ["gated-gelu", "relu"])
def test_t5_state_dict_round_trip(ff_proj):
    """port state dict -> convert_t5_encoder_state_dict -> from_jax_t5_params
    gives back every key and value, and a strict load takes it."""
    enc, _, _ = _pair(ff_proj)
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    params = convert_t5_encoder_state_dict(sd, num_layers=enc.config.num_layers,
                                           gated=ff_proj == "gated-gelu")
    back = from_jax_t5_params(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    tt5.T5TextEncoder(enc.config, device="cpu").load_state_dict(back, strict=True)
