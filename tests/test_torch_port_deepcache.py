"""The port's DeepCache (``SVDUNet.apply_cached`` and the wrapper's cache in
the payload) and euler_a on the SVD wrapper, against the JAX package's, fp32
on the CPU, with the JAX package's ``tests/test_deepcache.py`` as the model.

Weights are drawn from a numpy seed with diffusers names and reach JAX through
its converter, the port through ``from_jax_params``. JAX's euler_a noise
(``fold_in(sampler_seed, real step)``) is injected into the port through the
wrapper's ``noise_source``; the port's own draw is held to be a pure function
of (seed, step) by the pipelined runs, which use it.

Tolerances: a UNet call, max|diff| <= 1e-5 * max|ref| (fp32 both sides,
summation order alone); four wrapper steps, 1e-4 * max|ref| of each part of
the payload (latent, x0_hat, each branch's cache), as the model tests hold
the Euler steps. Within the port, bit for bit: the full branch against
``forward``, padded against unpadded schedules, interval 1 against no cache,
and the step pipeline at 1 and 2 stages (gloo, spawned ranks) against the
single-device run. The JAX side runs each wrapper step eagerly around one
jitted ``apply_cached``, compiled once per batch size for the whole module;
its no-cache steps call that program's full branch, which the reference
holds equal to ``apply`` (``tests/test_deepcache.py``).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning
from vdpp_tpu.utils.weights import convert_unet_state_dict

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    StepPipeline,
    run_reference_single_device,
)
from vdpp_tpu_torch.utils.weights import from_jax_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

B, F, H, W = 1, 3, 8, 8
STEPS, SAMPLES, SEED = 4, 2, 5
UNSHARDED = ("seq_axis", "seq_shards", "frame_axis", "frame_shards")
THREE = dict(block_out_channels=(32, 64, 64), num_attention_heads=(2, 4, 4),
             layers_per_block=1, cross_attention_dim=48, addition_time_embed_dim=8,
             projection_class_embeddings_input_dim=24, norm_num_groups=8)
# (name, solver, interval, cfg_mode, guidance, noise): the wrapper cases held
# to JAX and run through the pipeline. "table" injects JAX's euler_a draws,
# "gen" uses the port's generator (pipeline against the port only).
CASES = [("euler", "euler", 0, "sequential", 3.0, "table"),
         ("euler_dc2", "euler", 2, "sequential", 3.0, "table"),
         ("euler_dc2_noguide", "euler", 2, "sequential", None, "table"),
         ("dpmpp2m", "dpmpp2m", 0, "sequential", 3.0, "table"),
         ("dpmpp2m_dc2", "dpmpp2m", 2, "sequential", 3.0, "table"),
         ("euler_a", "euler_a", 0, "sequential", 3.0, "table"),
         ("euler_a_dc2", "euler_a", 2, "sequential", 3.0, "table"),
         ("euler_a_dc2_batched", "euler_a", 2, "batched", 3.0, "table"),
         ("euler_a_dc2_gen", "euler_a", 2, "sequential", 3.0, "gen")]


def _weights(cfg: SVDUNetConfig, levels: int, seed: int):
    """(JAX params, port UNet) holding the same weights, from a numpy seed."""
    unet = SVDUNet(cfg, device="cpu")
    sd = helpers.random_state_dict(unet, seed, mix_base=0.5)
    params = jax.tree_util.tree_map(np.asarray, convert_unet_state_dict(
        sd, num_levels=levels, layers_per_block=1, dtype=jnp.float32))
    unet.load_state_dict(from_jax_params(params))
    return params, unet


@pytest.fixture(scope="module")
def tiny():
    return _weights(SVDUNetConfig.tiny(), 2, 0)


@pytest.fixture(scope="module")
def jax_unet():
    """JAX's tiny UNet's ``apply_cached`` jitted once for the module, and an
    ``apply`` through its full branch; every JAX wrapper below calls these."""
    unet = JaxUNet(JaxConfig.tiny())
    jitted = jax.jit(unet.apply_cached, static_argnames=("split",) + UNSHARDED)

    def apply_cached(*args, split=1, **_):  # one set of static arguments: one compile
        return jitted(*args, split=split, **dict.fromkeys(UNSHARDED[::2]),
                      **dict.fromkeys(UNSHARDED[1::2], 1))

    def apply(params, x, t, ctx, ids, **_):
        b, f, h, w = x.shape[:4]
        cache = jnp.zeros(unet.cache_feature_shape(b, f, h, w, 1), jnp.float32)
        return apply_cached(params, x, t, ctx, ids, cache, jnp.bool_(True))[0]

    return apply, apply_cached


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, 1, 48)).astype(np.float32)
    img = rng.standard_normal((B, F, H, W, 4)).astype(np.float32)
    noise = rng.standard_normal((SAMPLES, B, F, H, W, 4)).astype(np.float32)
    return emb, img, noise


def _jax_noise(seed: int, steps: int) -> dict:
    """JAX's euler_a draws, by real step."""
    return {k: np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(seed), k),
                                            (B, F, H, W, 4), jnp.float32))
            for k in range(steps)}


def _case(name, solver, interval, cfg_mode, guidance, noise, steps=STEPS, pad=None):
    """The port's wrapper kwargs, conditioning and packed inputs for a case."""
    emb, img, x = _inputs([c[0] for c in CASES].index(name))
    kw = dict(deepcache_interval=interval, cfg_mode=cfg_mode, sampler_seed=SEED)
    if noise == "table":
        kw["noise_source"] = helpers.NoiseTable(_jax_noise(SEED, steps))
    model = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=steps, pad_steps_to=pad,
                            solver=solver, device="cpu", **kw)
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), F,
                             guidance_scale=guidance)
    x = x * model.init_noise_sigma
    return model, cond, model.pack_initial(torch.from_numpy(x)), kw, (emb, img, x)


def _jax_case(jax_unet, name, solver, interval, cfg_mode, guidance, noise):
    """JAX's single-device run of a case's first sample, its steps eager
    around the module's jitted UNet calls."""
    _, _, _, _, (emb, img, x) = _case(name, solver, interval, cfg_mode, guidance, noise)
    jmodel = JaxSVD(JaxConfig.tiny(), num_steps=STEPS, solver=solver, cfg_mode=cfg_mode,
                    deepcache_interval=interval, sampler_seed=SEED)
    jmodel.unet.apply, jmodel.unet.apply_cached = jax_unet
    jcond = jax_conditioning(jnp.asarray(emb), jnp.asarray(img), F, guidance_scale=guidance)
    return jmodel, jcond, jmodel.pack_initial(jnp.asarray(x[0]))


@pytest.fixture(scope="module")
def runs(tiny, jax_unet):
    """Every case: the port's single-device run (both samples), the same
    through a one-stage pipeline in this process and a two-stage one (two
    spawned ranks over gloo, every case in one group), and JAX's
    single-device run of the first sample; the ranks and JAX run beside the
    port's own runs."""
    params, unet = tiny
    cases = {c[0]: _case(*c) for c in CASES}

    def jax_runs():
        out = {}
        for case in CASES:
            if case[5] == "table":
                jmodel, jcond, jx = _jax_case(jax_unet, *case)
                for k in range(STEPS):
                    jx = jmodel.step(params, jx, k, jcond)
                out[case[0]] = np.asarray(jx)
        return out

    jobs = [(c[0], functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), c[1], STEPS, None,
                                     unet.state_dict(), cases[c[0]][1], **cases[c[0]][3]),
             cases[c[0]][2], STEPS, False) for c in CASES]
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(run_stages, make_pipeline_mesh(2, device="cpu"),
                            helpers.pipeline_cases, jobs, timeout=300)
        jax_out = pool.submit(jax_runs)
        out = {}
        for name, (model, cond, inputs, _, _) in cases.items():
            step_fn = model.pipeline_step_fn()
            one = StepPipeline(Stage(make_pipeline_mesh(1, device="cpu"), 0), step_fn,
                               PipelineConfig(STEPS, 1))
            out[name] = {"model": model, "inputs": inputs,
                         "oracle": run_reference_single_device(step_fn, (unet, cond), inputs,
                                                               STEPS),
                         "one_stage": one.run((unet, cond), inputs)}
        for name, got in ranks.result()[-1].items():
            out[name]["two_stages"] = got
        for name, got in jax_out.result().items():
            out[name]["jax"] = got
    return out


def _parts(model: StableVideoUNet) -> list[tuple[str, slice]]:
    """The payload's parts: latent, dpmpp2m's x0_hat, each branch's cache."""
    n = 4 * model.latent_channel_multiplier
    parts = [("latent", slice(0, 4))] + ([("x0_hat", slice(4, n))] if n > 4 else [])
    if model.deepcache_interval:
        kf = model.payload_extra_channels // 2
        parts += [("cache_u", slice(n, n + kf)), ("cache_c", slice(n + kf, n + 2 * kf))]
    return parts


@pytest.mark.parametrize("case", [c for c in CASES if c[5] == "table"], ids=lambda c: c[0])
def test_wrapper_matches_jax(runs, case):
    """Four steps (a full and a cache step twice under DeepCache-2): every
    part of the payload within 1e-4 * its max|ref| of JAX's; without
    guidance the uncond cache stays at its zeros on both sides."""
    run = runs[case[0]]
    got, want = run["oracle"][0].numpy(), run["jax"]
    assert got.shape == want.shape == (B, F, H, W, run["inputs"].shape[-1])
    for part, sl in _parts(run["model"]):
        g, w = got[..., sl], want[..., sl]
        assert np.isfinite(w).all() and np.isfinite(g).all(), part
        top = np.abs(w).max()
        if part == "cache_u" and case[4] is None:
            assert top == 0 and not g.any()
            continue
        assert np.abs(g - w).max() <= 1e-4 * top, (part, np.abs(g - w).max(), top)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_pipeline_matches_single_device(runs, case):
    """The payload (cache lanes and all) through the port's StepPipeline at 1
    stage (in this process) and at 2 (two processes over gloo) equals the
    single-device run bit for bit; euler_a with the port's own generator
    draws the same noise on both ranks."""
    run = runs[case[0]]
    assert run["oracle"].shape == (SAMPLES, B, F, H, W, run["model"].payload_extra_channels
                                   + 4 * run["model"].latent_channel_multiplier)
    for stages in ("one_stage", "two_stages"):
        assert torch.equal(run[stages].view(torch.int32), run["oracle"].view(torch.int32)), stages


def test_generator_noise_is_a_pure_function_of_seed_and_step(runs):
    """The port's own euler_a draw: the same for the same (seed, step), on a
    fresh wrapper too; another seed or step draws other noise; the cases
    that use it differ from the injected-noise run."""
    model = StableVideoUNet(SVDUNetConfig.tiny(), solver="euler_a", sampler_seed=SEED,
                            device="cpu")
    again = StableVideoUNet(SVDUNetConfig.tiny(), solver="euler_a", sampler_seed=SEED,
                            device="cpu")
    other = StableVideoUNet(SVDUNetConfig.tiny(), solver="euler_a", sampler_seed=SEED + 1,
                            device="cpu")
    shape = (B, F, H, W, 4)
    z = model._ancestral_noise(2, shape)
    assert torch.equal(z, again._ancestral_noise(2, shape))
    assert not torch.equal(z, model._ancestral_noise(1, shape))
    assert not torch.equal(z, other._ancestral_noise(2, shape))
    assert abs(z.std().item() - 1.0) < 0.1
    gen, table = runs["euler_a_dc2_gen"]["oracle"], runs["euler_a_dc2"]["oracle"]
    assert not torch.equal(gen[..., :4], table[..., :4])


@pytest.mark.parametrize("split", [1, 2])
def test_apply_cached_matches_jax(split, jax_unet):
    """``tiny()`` at split 1 and a three-level variant at split 2 (its cache
    at H/2): the full branch equals ``forward`` bit for bit and returns the
    cache ``cache_feature_shape`` names; both branches match JAX's
    ``apply_cached`` to 1e-5 * max|ref|; a cache step fed the cache its own
    input's full step made reproduces that step bit for bit and passes the
    cache through."""
    if split == 1:
        cfg, jcfg, levels = SVDUNetConfig.tiny(), JaxConfig.tiny(), 2
    else:
        cfg = SVDUNetConfig(**THREE, dtype=torch.float32)
        jcfg, levels = JaxConfig(**THREE, dtype=jnp.float32), 3
    params, unet = _weights(cfg, levels, 10 + split)
    rng = np.random.default_rng(20 + split)
    x = rng.standard_normal((B, F, H, W, 8)).astype(np.float32)
    ctx = rng.standard_normal((B, 1, 48)).astype(np.float32)
    ids = np.array([[5.0, 127.0, 0.02]], np.float32)
    cshape = unet.cache_feature_shape(B, F, H, W, split)
    assert cshape == JaxUNet(jcfg).cache_feature_shape(B, F, H, W, split)
    old = rng.standard_normal(cshape).astype(np.float32)
    apply_cached = (jax_unet[1] if split == 1 else
                    jax.jit(JaxUNet(jcfg).apply_cached, static_argnames=("split",)))
    tx, tctx, tids = (torch.from_numpy(a) for a in (x, ctx, ids))
    with torch.inference_mode():
        fwd = unet(tx, 0.3, tctx, tids)
        full, cache = unet.apply_cached(tx, 0.3, tctx, tids, torch.from_numpy(old), True,
                                        split=split)
        shallow, kept = unet.apply_cached(tx, 0.3, tctx, tids, torch.from_numpy(old), False,
                                          split=split)
        again, same = unet.apply_cached(tx, 0.3, tctx, tids, cache, False, split=split)
    assert torch.equal(full, fwd)
    assert tuple(cache.shape) == cshape
    assert torch.equal(kept, torch.from_numpy(old)) and torch.equal(same, cache)
    assert torch.equal(again, full)
    for use_full, got in ((True, (full, cache)), (False, (shallow, kept))):
        want = apply_cached(params, jnp.asarray(x), jnp.float32(0.3), jnp.asarray(ctx),
                            jnp.asarray(ids), jnp.asarray(old), jnp.bool_(use_full), split=split)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), use_full


def test_cache_packing_is_the_jax_bit_layout():
    """bf16 caches pack two values to an fp32 payload word, the first in the
    low 16 bits as on JAX's CPU backend: the packed lanes equal JAX's
    ``_pack_cache`` viewed as int32 (NaN patterns included), and unpack back
    bit for bit; fp32 caches ride one to a word."""
    rng = np.random.default_rng(30)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        model = StableVideoUNet(SVDUNetConfig.tiny(dtype), deepcache_interval=2, device="cpu")
        jmodel = JaxSVD(JaxConfig.tiny(jdtype), deepcache_interval=2)
        kf = model._deepcache_packed_channels()
        assert kf == jmodel._deepcache_packed_channels() == (32 if dtype == torch.bfloat16
                                                              else 64)
        assert model.payload_extra_channels == jmodel.payload_extra_channels == 2 * kf
        shape = model._unpack_cache(torch.zeros(B, F, H, W, kf), H, W).shape
        if dtype == torch.bfloat16:
            bits = rng.integers(0, 2 ** 16, size=shape)
            cache = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
            jcache = jax.lax.bitcast_convert_type(jnp.asarray(bits.astype(np.uint16)),
                                                  jnp.bfloat16)
        else:
            cache = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            jcache = jnp.asarray(cache.numpy())
        packed = model._pack_cache(cache, H, W)
        want = np.asarray(jmodel._pack_cache(jcache, H, W))
        assert packed.dtype == torch.float32 and packed.shape == (B, F, H, W, kf)
        np.testing.assert_array_equal(packed.numpy().view(np.int32), want.view(np.int32))
        back = model._unpack_cache(packed, H, W)
        assert back.dtype == dtype
        assert torch.equal(back.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           cache.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def _schedule(model, unet, cond, x):
    with torch.inference_mode():
        return model.unpack_final(run_reference_single_device(
            model.pipeline_step_fn(), (unet, cond), model.pack_initial(x), model.num_steps))


@pytest.mark.parametrize("solver", ["euler", "dpmpp2m", "euler_a"])
def test_padding_and_interval_one_change_nothing(tiny, solver):
    """DeepCache-2 over 3 steps padded to 4 equals the unpadded run bit for
    bit (the cadence and euler_a's noise count real steps); interval 1
    equals no cache bit for bit; interval 2 changes the output."""
    _, unet = tiny
    emb, img, x = _inputs(40)
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), F,
                             guidance_scale=3.0)
    x = torch.from_numpy(x[:1] * 700.0)

    def run(**kw):
        model = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=3, solver=solver,
                                sampler_seed=SEED, device="cpu", **kw)
        return _schedule(model, unet, cond, x)

    dc2 = run(deepcache_interval=2)
    padded = run(deepcache_interval=2, pad_steps_to=2)
    assert torch.equal(padded, dc2)
    assert torch.equal(run(deepcache_interval=1), run())
    assert not torch.equal(dc2, run())
    assert torch.isfinite(dc2).all()


def test_invalid_compositions_rejected():
    """As the reference: heun with DeepCache, a split the architecture has no
    level for or cannot pack, a non-fp32 payload, a bad cache shape; the
    sharded cached forward refuses a width its seq shards do not split
    evenly at every level, before any collective."""
    tiny_cfg = SVDUNetConfig.tiny()
    with pytest.raises(ValueError, match="heun"):
        StableVideoUNet(tiny_cfg, deepcache_interval=2, solver="heun", device="cpu")
    with pytest.raises(ValueError, match="split"):
        StableVideoUNet(tiny_cfg, deepcache_interval=2, deepcache_split=2, device="cpu")
    with pytest.raises(ValueError, match="packable"):  # 33 channels at r = 2: not r^2-divisible
        StableVideoUNet(dataclasses.replace(SVDUNetConfig(**THREE, dtype=torch.float32),
                                            block_out_channels=(32, 64, 66)),
                        deepcache_interval=2, deepcache_split=2, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        StableVideoUNet(tiny_cfg, deepcache_interval=-1, device="cpu")
    model = StableVideoUNet(tiny_cfg, deepcache_interval=2, device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        model.pack_initial(torch.zeros(B, F, H, W, 4, dtype=torch.bfloat16))
    unet = SVDUNet(tiny_cfg, device="cpu")
    x, ctx, ids = torch.zeros(B, F, H, W, 8), torch.zeros(B, 1, 48), torch.zeros(B, 3)
    with pytest.raises(ValueError, match="cache shape"):
        unet.apply_cached(x, 0.0, ctx, ids, torch.zeros(B, F, H, W, 32), False)
    three = Axis("seq", 3, 0, (0, 1, 2), group=None)  # W = 8 is not a multiple of 3 x 2
    with pytest.raises(ValueError, match="not divisible"):
        unet.apply_cached(x, 0.0, ctx, ids, torch.zeros(B, F, H, W, 64), False, seq_axis=three)
