"""What the intra-sample axes' parity tests share
(``tests/test_torch_port_{seq,frame,cfg}_parallel.py``): the tiny fp32 SVD
weights, conditioning and noise drawn once from numpy seeds, the JAX
package's single-device oracle over them, computed once per process, and
the port's builds and spawned groups.

The yardstick is the one of ``tests/test_sequence_parallel.py:149``,
``test_frame_parallel.py:150`` and ``test_cfg_parallel.py:56``: a sharded
run equals the single-device oracle within ``rtol = atol = 2e-5``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning

from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.ops.normalization import Norm
from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

import torch_port_helpers as helpers

B, F, H, W = 1, 4, 8, 16  # W: 16 divides by 4 seq shards x 2 levels' halving
STEPS, SAMPLES, GUIDANCE = 4, 2, 3.0
RTOL = ATOL = 2e-5
# The DeepCache case: dpmpp2m, the whole UNet every 2nd step, one sample.
DEEPCACHE = dict(solver="dpmpp2m", deepcache_interval=2)


@functools.cache
def draws():
    """``(JAX params, port state dict, CLIP embedding, image latents, noise
    (SAMPLES, B, F, H, W, 4))`` from numpy seeds."""
    params, state = helpers.tiny_svd_weights(0)
    rng = np.random.default_rng(13)
    emb = rng.standard_normal((B, 1, 48)).astype(np.float32)
    img = rng.standard_normal((B, F, H, W, 4)).astype(np.float32)
    noise = rng.standard_normal((SAMPLES, B, F, H, W, 4)).astype(np.float32)
    return params, state, emb, img, noise


def port_case(**wrapper_kw):
    """``(build, packed inputs)`` of the port for the wrapper arguments:
    ``build(device, axes)`` gives ``(step_fn, params)`` (it pickles into
    spawned ranks), the inputs are the noise x init_noise_sigma, packed."""
    _, state, emb, img, noise = draws()
    kw = dict(cfg_mode="sequential", **wrapper_kw)
    solver = kw.pop("solver", "euler")
    wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=STEPS, solver=solver,
                              device="cpu", **kw)
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), F,
                             guidance_scale=GUIDANCE)
    inputs = wrapper.pack_initial(torch.from_numpy(noise) * wrapper.init_noise_sigma)
    build = functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), solver, STEPS, None,
                              state, cond, **kw)
    return build, inputs


def port_single_device(**wrapper_kw) -> torch.Tensor:
    """The port's run of every step in this process (no axis)."""
    build, inputs = port_case(**wrapper_kw)
    step_fn, params = build("cpu", {})
    return run_reference_single_device(step_fn, params, inputs, STEPS)


@functools.cache
def _jax_unet():
    """JAX's tiny ``SVDUNet.apply_cached`` jitted once for the process (its
    unsharded form), and ``apply`` through its full branch, which the JAX
    package holds equal to ``apply`` (``tests/test_deepcache.py``)."""
    unet = JaxUNet(JaxConfig.tiny())
    jitted = jax.jit(unet.apply_cached, static_argnames=("split",))

    def apply_cached(params, x, t, ctx, ids, cache, use_full, split=1, **_):
        return jitted(params, x, t, ctx, ids, cache, use_full, split=split)

    def apply(params, x, t, ctx, ids, **_):
        b, f, h, w = x.shape[:4]
        cache = jnp.zeros(unet.cache_feature_shape(b, f, h, w, 1), jnp.float32)
        return apply_cached(params, x, t, ctx, ids, cache, jnp.bool_(True))[0]

    return apply, apply_cached


@functools.cache
def jax_oracle(deepcache: bool = False) -> np.ndarray:
    """The JAX package's single-device run of every step of every sample
    (Euler), or of the first one with dpmpp2m x DeepCache-2: packed
    payloads. Its wrapper's ``pipeline_step_fn`` steps each sample in turn
    as ``run_reference_single_device`` does, eagerly around one jitted UNet
    call: the scanned program would compile the UNet once for each CFG
    branch and cache branch, 10-12 s each here against one compile of 4 s."""
    params, _, emb, img, noise = draws()
    kw = DEEPCACHE if deepcache else {}
    model = JaxSVD(JaxConfig.tiny(), num_steps=STEPS, cfg_mode="sequential", **kw)
    model.unet.apply, model.unet.apply_cached = _jax_unet()
    cond = jax_conditioning(jnp.asarray(emb), jnp.asarray(img), F, guidance_scale=GUIDANCE)
    step = model.pipeline_step_fn()
    outs = []
    for x in noise[:1] if deepcache else noise:
        x = model.pack_initial(jnp.asarray(x) * model.init_noise_sigma)
        for k in range(STEPS):
            x = step((params, cond), x, k)
        outs.append(np.asarray(x))
    return np.stack(outs)


def assert_oracle(got: torch.Tensor, want: np.ndarray) -> None:
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def spawn(world: int, cases: list) -> dict:
    """Every case on one spawned gloo group of ``world`` CPU ranks at one
    thread each (:func:`torch_port_helpers.intra_cases`); the last rank's
    results."""
    mesh = make_pipeline_mesh(world, device="cpu")
    return run_stages(mesh, helpers.intra_cases, cases, threads=1, timeout=600)[-1]


def op_weights(module: torch.nn.Module, seed: int, convert) -> tuple[dict, dict]:
    """``(port state dict, JAX params)`` of ``module`` filled from a numpy
    seed (N(0, 0.04); norm scales about 1), the JAX side through the JAX
    package's converter: ``convert(_SD, prefix)``."""
    from vdpp_tpu.utils.weights import _SD

    rng = np.random.default_rng(seed)
    state = {}
    for k, v in module.state_dict().items():
        vals = (0.2 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
        if isinstance(module, Norm) and k == "weight":
            vals += 1.0
        state[k] = torch.from_numpy(vals)
    sd = {f"m.{k}": v.numpy() for k, v in state.items()}
    return state, convert(_SD(sd), "m")


def x_of(seed: int, *shape, scale: float = 1.0, offset: float = 0.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(
        np.float32)
