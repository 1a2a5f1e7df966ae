"""The port's SVD UNet, CFG Euler wrapper and weight carrier against the JAX
package, fp32 on the CPU.

Weights are drawn from a numpy seed with diffusers names, reach the JAX side
through the JAX package's converter and come back to the port through
``from_jax_params``. Biases, norm parameters and mix factors are moved off
the 0, 1 and 0.5 the inits give them, which would hide a misplaced one.
Latents and conditioning are numpy arrays handed to both sides.

Tolerance: max|diff| <= 1e-4 * max|ref|. Both sides compute in fp32 and
differ in summation order (convolutions, matmuls, norm statistics); through
a few dozen layers that stays around 1e-6 relative, and the Euler steps
scale the UNet output by at most sigma_max / sqrt(sigma_max^2 + 1) ~ 1.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning
from vdpp_tpu.parallel.pipeline import run_reference_single_device as jax_reference
from vdpp_tpu.utils.weights import convert_unet_state_dict

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.weights import from_jax_params

REL_TOL = 1e-4
KEYS_FIXTURE = Path(__file__).parent / "fixtures" / "svd_xt_unet_keys.txt"


def _assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port UNet) holding the same tiny weights: LeCun-normal
    matrices and kernels as both packages' inits draw them, and biases, norm
    parameters and mix factors moved off 0, 1 and 0.5, all from a numpy
    seed. The JAX tree comes from the JAX package's converter and the port
    loads it back through ``from_jax_params``."""
    unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu")
    rng = np.random.default_rng(0)
    sd = {}
    for name, p in unet.state_dict().items():
        noise = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        if p.ndim >= 2:
            sd[name] = noise / np.sqrt(p[0].numel())
        else:  # a 1-D ".weight" is a norm scale
            base = 0.5 if name.endswith("mix_factor") else float(name.endswith(".weight"))
            sd[name] = (base + 0.1 * noise).astype(np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, convert_unet_state_dict(sd, num_levels=2, layers_per_block=1,
                                            dtype=jnp.float32))
    unet.load_state_dict(from_jax_params(params))
    return params, unet


@pytest.mark.parametrize("hw", [(16, 16), (16, 32)])
def test_unet_forward_matches_jax(tiny, hw):
    """16x32 gives level 0 512 tokens: both sides take the flash route there
    (the JAX Pallas kernel in interpret mode, the port's plain version)."""
    params, unet = tiny
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, *hw, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 1, 48)).astype(np.float32)
    ids = np.array([[5.0, 127.0, 0.02]], np.float32)
    t = np.float32(0.25 * np.log(80.0))
    want = jax.jit(JaxUNet(JaxConfig.tiny()).apply)(params, jnp.asarray(x), t, jnp.asarray(ctx),
                                                    jnp.asarray(ids))
    fa.launches = 0
    with torch.inference_mode():
        got = unet(torch.from_numpy(x), float(t), torch.from_numpy(ctx), torch.from_numpy(ids))
    assert fa.launches == 0  # CPU tensors take the plain version, never the kernel
    _assert_close(got, want)


@pytest.mark.parametrize("cfg_mode", ["sequential", "batched"])
@pytest.mark.parametrize("steps,run", [(4, 1), (4, 4)])
def test_cfg_euler_schedule_matches_jax(tiny, cfg_mode, steps, run):
    """``run`` steps of a ``steps``-step schedule through
    ``run_reference_single_device``, CFG ramp to 3 over 3 frames."""
    params, unet = tiny
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((1, 1, 48)).astype(np.float32)
    img = rng.standard_normal((1, 3, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 1, 3, 16, 16, 4)).astype(np.float32)

    jmodel = JaxSVD(JaxConfig.tiny(), num_steps=steps, cfg_mode=cfg_mode)
    jcond = jax_conditioning(jnp.asarray(emb), jnp.asarray(img), 3, guidance_scale=3.0)
    x0 = noise * jmodel.init_noise_sigma
    want = jax_reference(jmodel.pipeline_step_fn(), (params, jcond), jnp.asarray(x0), run)

    model = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=steps, cfg_mode=cfg_mode,
                            device="cpu")
    assert model.init_noise_sigma == jmodel.init_noise_sigma
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), 3, guidance_scale=3.0)
    got = run_reference_single_device(model.pipeline_step_fn(), (unet, cond),
                                      torch.from_numpy(x0), run)
    _assert_close(got, want)


def test_state_dict_keys_are_the_diffusers_checkpoint_keys():
    keys = set(KEYS_FIXTURE.read_text().split())
    unet = SVDUNet(SVDUNetConfig.svd_xt(), device="meta")
    assert len(keys) == 1428
    assert set(unet.state_dict()) == keys
    assert sum(p.numel() for p in unet.parameters()) == pytest.approx(1.52e9, rel=0.01)


def test_state_dict_survives_jax_conversion_and_back(tiny):
    """A diffusers-named tiny state dict -> the JAX package's converter ->
    ``from_jax_params`` gives the same names, shapes and values."""
    sd = {k: v.numpy() for k, v in tiny[1].state_dict().items()}
    tree = convert_unet_state_dict(sd, num_levels=2, layers_per_block=1, dtype=jnp.float32)
    back = from_jax_params(jax.tree_util.tree_map(np.asarray, tree))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_unported_options_raise(monkeypatch):
    for kw in ({"solver": "heun"}, {"deepcache_interval": 2}):
        with pytest.raises(NotImplementedError):
            StableVideoUNet(SVDUNetConfig.tiny(), device="cpu", **kw)
    # VDPP_GN_FUSED=1 is ported; a UNet built without it cannot run under it
    monkeypatch.setenv("VDPP_GN_FUSED", "1")
    model = StableVideoUNet(SVDUNetConfig.tiny(), device="cpu")
    assert model.config.fused_groupnorm
    cond = make_conditioning(torch.zeros(1, 1, 48), torch.zeros(1, 3, 8, 8, 4), 3)
    with pytest.raises(ValueError, match="fused_groupnorm"):
        model.step(SVDUNet(SVDUNetConfig.tiny(), device="cpu"), torch.zeros(1, 3, 8, 8, 4), 0,
                   cond)


def test_kernel_switches_match_jax(tiny, monkeypatch):
    """``VDPP_GN_FUSED=1`` and ``VDPP_TEMPORAL_ATTN=pallas`` on both sides:
    the JAX package's fused GroupNorm and frame-attention kernels (interpret
    mode, in a freshly traced model, so no jit cache pins the default forms)
    against the port's routes (their plain versions on the CPU). Both sides
    count their kernel-route calls: every GroupNorm+SiLU pair (4 per ResBlock
    x 8 ResBlocks + the head) and every temporal attention (4) of a
    ``tiny()`` forward at 16x32 (the flash route too). The wrappers, built
    under the switches, give the UNet its config (the CFG Euler step around
    the forward is held to JAX above)."""
    import dataclasses

    import vdpp_tpu.ops.norm_kernel as jnk
    import vdpp_tpu.ops.temporal_attention_kernel as jtak

    from vdpp_tpu_torch.ops import attention as tattn
    from vdpp_tpu_torch.ops import normalization as tnorm

    params, unet = tiny
    calls = {"jax_gn": 0, "jax_frame": 0, "gn": 0, "frame": 0}

    def spy(module, name, key):
        real = getattr(module, name)

        def counted(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(jnk, "group_norm_silu_fused", "jax_gn")
    spy(jtak, "frame_attention", "jax_frame")
    spy(tnorm, "group_norm_silu_fused", "gn")
    spy(tattn, "frame_attention", "frame")
    monkeypatch.setenv("VDPP_GN_FUSED", "1")
    monkeypatch.setenv("VDPP_TEMPORAL_ATTN", "pallas")

    jmodel = JaxSVD(JaxConfig.tiny(), num_steps=4)
    model = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=4, device="cpu")
    assert jmodel.config.fused_groupnorm and model.config.fused_groupnorm
    assert jmodel.config == dataclasses.replace(JaxConfig.tiny(), fused_groupnorm=True)
    funet = SVDUNet(model.config, device="cpu")
    funet.load_state_dict(unet.state_dict())

    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 3, 16, 32, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 1, 48)).astype(np.float32)
    ids = np.array([[5.0, 127.0, 0.02]], np.float32)
    t = np.float32(0.25 * np.log(80.0))
    want = jax.jit(JaxUNet(jmodel.config).apply)(params, jnp.asarray(x), t, jnp.asarray(ctx),
                                                 jnp.asarray(ids))
    with torch.inference_mode():
        got = funet(torch.from_numpy(x), float(t), torch.from_numpy(ctx), torch.from_numpy(ids))
    _assert_close(got, want)
    assert calls == {"jax_gn": 33, "jax_frame": 4, "gn": 33, "frame": 4}
