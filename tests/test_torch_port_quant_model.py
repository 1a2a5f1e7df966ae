"""The tiny SVD UNet with int8 weights and W8A8 (``ops/quant.py::
quantize_model``, the ``amax_axes`` threading of ``models/svd_unet.py``)
against the JAX package's (``quantize_tree``, ``tests/test_quant.py``,
``tests/test_deepcache.py``), fp32 on the CPU.

The same weights on both sides (``torch_port_helpers.tiny_svd_weights``).
What is held, and how closely:

* ``quantize_model`` against ``quantize_tree`` (run eagerly, as JAX's
  benchmark runs it): the same tensors quantized, the same ``q8`` marks
  (spatial convs and linears with 64 or more channels each way, or with
  ``a8_convs=False`` the linears only; never the temporal convs), the int8
  values and scales bit for bit.
* Forwards: weight-only int8 within 1e-4 x max|ref| of JAX's, as the float
  UNet (``tests/test_torch_port_model.py``). W8A8 within a quantization
  step: a 1-ulp difference of an activation (the two libraries' fp32 sums
  differ) at a rounding boundary moves its int8 value by one step (amax /
  127), so the bound is JAX's for W8A8 runs whose fp32 sums differ
  (``tests/test_quant.py::_assert_quant_step_bounded``: relative L2 < 0.06,
  cosine > 0.999); one flipped step of a conv's per-tensor scale moves a
  few outputs by a few percent of the maximum. Against the float model,
  JAX's drift bounds: relative L2 < 0.05 (weight-only) and < 0.1 (W8A8).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.ops import quant as jq

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.ops import quant as tq
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.weights import from_jax_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

REL_TOL = 1e-4
STEPS, F, HW = 4, 4, 16
QUANT_KW = {"weight_only": {}, "w8a8": {"act_int8": True},
            "w8a8_linears": {"act_int8": True, "a8_convs": False}}


@functools.cache
def _svd():
    """(JAX params, port state dict) of the tiny SVD UNet, the same weights."""
    return helpers.tiny_svd_weights(0)


def _port_unet(mode: str | None = None) -> SVDUNet:
    """The port's tiny UNet with ``_svd``'s weights, quantized as ``mode``
    (a key of QUANT_KW) or float."""
    unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu")
    unet.load_state_dict(_svd()[1])
    return unet if mode is None else tq.quantize_model(unet, **QUANT_KW[mode])


@functools.cache
def _jax_quantized(mode: str):
    return jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, _svd()[0]), **QUANT_KW[mode])


@pytest.mark.parametrize("mode", list(QUANT_KW))
def test_quantize_model_matches_quantize_tree(mode):
    """Every quantized tensor, mark, int8 value and scale, bit for bit; the
    5-D temporal kernels weight-only (those of at least 4096 elements) and,
    under W8A8, both forms present (the 32-channel level and the first and
    last convs stay weight-only)."""
    forms = helpers.assert_quantized_like_jax(
        _port_unet(mode), jax.tree_util.tree_map(np.asarray, _jax_quantized(mode)),
        from_jax_params)
    assert forms["q"] and bool(forms["q8"]) == (mode != "weight_only")
    unet = _port_unet(mode)
    temporal = [tq.int8_forms(m.conv1).get("weight") for name, m in unet.named_modules()
                if name.endswith("temporal_res_block")]
    assert "q" in temporal and "q8" not in temporal


def _svd_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, F, HW, HW, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 1, 48)).astype(np.float32)
    ids = np.array([[5.0, 127.0, 0.02]], np.float32)
    return x, np.float32(0.25 * np.log(80.0)), ctx, ids


@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def test_svd_forward_matches_jax(mode):
    """The forward with int8 weights against JAX's on the same quantized
    tree: weight-only within 1e-4 x max|ref|; W8A8 within a quantization
    step (module docstring). Against the port's float forward, the drift
    stays within JAX's bounds (< 0.05 weight-only, < 0.1 W8A8), the bounds
    ``chip_smoke.py`` holds SVD-XT to."""
    x, t, ctx, ids = _svd_inputs()
    want = np.asarray(jax.jit(JaxUNet(JaxConfig.tiny()).apply)(
        _jax_quantized(mode), jnp.asarray(x), t, jnp.asarray(ctx), jnp.asarray(ids)))
    x, ctx, ids = (torch.from_numpy(a) for a in (x, ctx, ids))
    with torch.inference_mode():
        got = _port_unet(mode)(x, float(t), ctx, ids).numpy()
        float_ref = _port_unet()(x, float(t), ctx, ids).numpy()
    if mode == "weight_only":
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    else:
        helpers.assert_quant_step_bounded(got, want)
    drift = np.linalg.norm(got - float_ref) / np.linalg.norm(float_ref)
    assert 0 < drift < (0.05 if mode == "weight_only" else 0.1), drift


@pytest.mark.parametrize("interval", [0, 2], ids=["plain", "deepcache2"])
@pytest.mark.parametrize("mode", ["weight_only", "w8a8"])
def test_trajectory_over_int8_weights(mode, interval):
    """4 steps of CFG 3 over int8 and W8A8 weights, plain and with DeepCache
    (interval 2, as ``tests/test_deepcache.py::test_composes_with_int8_
    weights`` runs it: both branches read the same int8 tensors): finite, and
    within JAX's trajectory bound 0.2 of the float run of the same steps, the
    bound ``chip_smoke.py`` holds SVD-XT's int8 latents to. (The int8 forward
    is held to JAX above, the DeepCache steps by ``tests/test_torch_port_
    deepcache.py``.)"""
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal((1, 1, 48)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((1, F, HW, HW, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, 1, F, HW, HW, 4)).astype(np.float32))
    cond = make_conditioning(emb, img, F, guidance_scale=3.0)
    wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=STEPS,
                              deepcache_interval=interval, device="cpu")
    inputs = wrapper.pack_initial(noise * wrapper.init_noise_sigma)
    outs = {m: run_reference_single_device(wrapper.pipeline_step_fn(), (_port_unet(m), cond),
                                           inputs, STEPS)[0]
            for m in (mode, None)}
    got, ref = (outs[m].numpy()[..., :4] for m in (mode, None))
    assert np.isfinite(got).all()
    assert 0 < np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.2
