"""The port's plain ops against the JAX package's, fp32 on the CPU, same
numpy-seeded inputs and weights. Module weights are set on the port side and
carried to the JAX side through the JAX package's own diffusers-name
converter (``vdpp_tpu.utils.weights``). Tolerance 1e-5 absolute unless
stated: both sides compute in fp32 and differ only in summation order and in
transcendental implementations (a few ulps of O(1) values)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.ops import conv as jconv
from vdpp_tpu.ops import embeddings as jemb
from vdpp_tpu.ops import normalization as jnorm
from vdpp_tpu.utils.weights import _SD, _conv_attention, _conv_ff

from vdpp_tpu_torch.ops import attention as tattn
from vdpp_tpu_torch.ops import conv as tconv
from vdpp_tpu_torch.ops import embeddings as temb
from vdpp_tpu_torch.ops import linear as tlin
from vdpp_tpu_torch.ops import normalization as tnorm

from torch_port_helpers import one_torch_thread  # noqa: F401

# vdpp_tpu.ops re-exports functions named like these two modules
jattn = importlib.import_module("vdpp_tpu.ops.attention")
jlin = importlib.import_module("vdpp_tpu.ops.linear")

ATOL = 1e-5


def randomize(module: torch.nn.Module, seed: int, scale: float = 0.2) -> torch.nn.Module:
    """Fill every parameter with N(0, scale^2) from a numpy seed; norm
    scales get 1 + N(0, scale^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                vals = rng.standard_normal(tuple(p.shape)).astype(np.float32) * scale
                if isinstance(mod, tnorm.Norm) and name == "weight":
                    vals += 1.0
                p.copy_(torch.from_numpy(vals))
    return module


def jax_params(module: torch.nn.Module, convert) -> dict:
    """The JAX parameter tree of ``module`` via the reference converter:
    ``convert(_SD, prefix)`` is e.g. ``lambda sd, p: sd.linear(p)``."""
    sd = {f"m.{k}": v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    return convert(_SD(sd), "m")


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _check(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 32), 8), ((1, 3, 4, 4, 64), 32)])
def test_group_norm(shape, groups):
    x = _x(0, *shape, scale=3.0) + 5.0  # offset: two-pass statistics matter
    norm = randomize(tnorm.Norm(shape[-1]), 1)
    p = jax_params(norm, lambda sd, pf: sd.norm(pf))
    _check(tnorm.group_norm(torch.from_numpy(x), norm, groups),
           jnorm.group_norm(jnp.asarray(x), p, groups))
    _check(tnorm.group_norm_silu(torch.from_numpy(x), norm, groups),
           jnorm.group_norm_silu(jnp.asarray(x), p, groups))


def test_group_norm_fused_raises():
    """The fused route refuses what the reference refuses: channels that
    the groups do not divide (the fused kernel's own checks are in
    tests/test_torch_port_norm_kernel.py)."""
    with pytest.raises(ValueError, match="not divisible"):
        tnorm.group_norm_silu(torch.zeros(1, 4, 8), tnorm.Norm(8), 3, fused=True)


def test_layer_norm():
    x = _x(2, 3, 7, 48, scale=2.0) - 1.0
    norm = randomize(tnorm.Norm(48), 3)
    _check(tnorm.layer_norm(torch.from_numpy(x), norm),
           jnorm.layer_norm(jnp.asarray(x), jax_params(norm, lambda sd, pf: sd.norm(pf))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm(dtype):
    """fp32 statistics, the scale applied in fp32, one rounding to the input
    dtype: bf16 within one bf16 ulp of the largest output, fp32 1e-5."""
    x = _x(7, 2, 5, 64, scale=3.0)
    scale = 1.0 + 0.2 * _x(8, 64)
    norm = tnorm.RMSNorm(64, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
    xt = torch.from_numpy(x).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jnorm.rms_norm(jnp.asarray(xt.float().numpy(), jdt),
                          {"scale": jnp.asarray(norm.weight.float().numpy(), jdt)}, 1e-6)
    want = np.asarray(want.astype(jnp.float32))
    got = tnorm.rms_norm(xt, norm, 1e-6)
    assert got.dtype == dtype
    atol = ATOL if dtype == torch.float32 else 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    _check(got.float(), want, atol=atol)


def test_linear_and_geglu():
    x = _x(4, 2, 5, 16)
    lin = randomize(tlin.Linear(16, 24), 5)
    _check(lin(torch.from_numpy(x)),
           jlin.linear(jnp.asarray(x), jax_params(lin, lambda sd, pf: sd.linear(pf))))
    ff = randomize(tlin.FeedForward(16), 6)
    _check(tlin.geglu_ff(torch.from_numpy(x), ff),
           jlin.geglu_ff(jnp.asarray(x), jax_params(ff, _conv_ff)))


def test_sinusoid_and_timestep_mlp():
    t = np.array([0.0, 0.25 * np.log(700.0), -1.55, 127.0], np.float32)
    for dim in (8, 32, 320):
        _check(temb.sinusoidal_embedding(torch.from_numpy(t), dim),
               jemb.sinusoidal_embedding(jnp.asarray(t), dim), atol=2e-5)
    mlp = randomize(temb.TimestepEmbedding(32, 64), 7)
    p = {"linear_1": jax_params(mlp.linear_1, lambda sd, pf: sd.linear(pf)),
         "linear_2": jax_params(mlp.linear_2, lambda sd, pf: sd.linear(pf))}
    e = _x(8, 4, 32)
    _check(temb.timestep_mlp(torch.from_numpy(e), mlp), jemb.timestep_mlp(jnp.asarray(e), p))


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv2d(kernel, stride):
    x = _x(9, 2, 8, 8, 5)
    conv = randomize(tconv.Conv2d(5, 7, kernel), 10)
    p = jax_params(conv, lambda sd, pf: sd.conv2d(pf))
    pad = "SAME" if stride == 1 else ((1, 1), (1, 1))
    want = jconv.conv2d(jnp.asarray(x), p, stride=stride, padding=pad)
    got = tconv.conv2d(torch.from_numpy(x), conv, stride=stride, padding=pad)
    assert tuple(got.shape) == want.shape
    _check(got, want)


def test_conv_temporal_and_upsample():
    x = _x(11, 2, 6, 4, 5, 3)
    conv = randomize(tconv.ConvTemporal(3, 4), 12)
    _check(tconv.conv_temporal(torch.from_numpy(x), conv),
           jconv.conv_temporal(jnp.asarray(x), jax_params(conv, lambda sd, pf: sd.conv3d(pf))))
    y = _x(13, 2, 3, 4, 6)
    np.testing.assert_array_equal(tconv.upsample_nearest_2x(torch.from_numpy(y)).numpy(),
                                  np.asarray(jconv.upsample_nearest_2x(jnp.asarray(y))))


@pytest.mark.parametrize("l", [10, 144, 512])
def test_self_attention(l):
    """l < 512 takes the plain fp32-softmax form, l = 512 the flash route
    (the JAX side runs its Pallas kernel in interpret mode)."""
    b, c, heads = 2, 32, 4
    x = _x(14, b, l, c)
    attn = randomize(tattn.Attention(c), 15)
    _check(tattn.attention(torch.from_numpy(x), attn, heads),
           jattn.attention(jnp.asarray(x), jax_params(attn, _conv_attention), heads),
           atol=2e-5)


def test_single_key_cross_attention_shortcut():
    b, l, c, heads = 2, 6, 16, 2
    x = _x(16, b, l, c)
    ctx = _x(17, b, 1, 24)
    attn = randomize(tattn.Attention(c, cross_dim=24), 18)
    got = tattn.attention(torch.from_numpy(x), attn, heads, context=torch.from_numpy(ctx))
    _check(got, jattn.attention(jnp.asarray(x), jax_params(attn, _conv_attention), heads,
                                context=jnp.asarray(ctx)))
    # to_out ran before the broadcast: every query row is the same row
    assert torch.equal(got, got[:, :1].expand_as(got))


def test_cross_attention_plain_path():
    b, l, c, heads = 2, 9, 16, 2
    x, ctx = _x(19, b, l, c), _x(20, b, 5, 24)
    attn = randomize(tattn.Attention(c, cross_dim=24), 21)
    _check(tattn.attention(torch.from_numpy(x), attn, heads, context=torch.from_numpy(ctx)),
           jattn.attention(jnp.asarray(x), jax_params(attn, _conv_attention), heads,
                           context=jnp.asarray(ctx)))


@pytest.mark.parametrize("frames,l", [(3, 16), (5, 24)])
def test_temporal_self_attention(frames, l):
    batch, c, heads = 2, 32, 4
    x = _x(22, batch * frames, l, c)
    attn = randomize(tattn.Attention(c), 23)
    _check(tattn.temporal_self_attention(attn, torch.from_numpy(x), heads, batch, frames),
           jattn.temporal_self_attention(jax_params(attn, _conv_attention), jnp.asarray(x),
                                         heads, batch, frames))


@pytest.mark.parametrize("frames,l", [(3, 16), (5, 40)])
def test_temporal_self_attention_pallas(frames, l, monkeypatch):
    """``VDPP_TEMPORAL_ATTN=pallas`` on both sides: the JAX package's frame
    attention kernel (interpret mode) against the port's, which runs its
    plain version on the CPU. The switch is read at call time."""
    from vdpp_tpu_torch.ops import temporal_attention_kernel as tak

    batch, c, heads = 2, 32, 4
    x = _x(24, batch * frames, l, c)
    attn = randomize(tattn.Attention(c), 25)
    calls = []

    def spy(q, k, v):
        calls.append(tuple(q.shape))
        return tak.frame_attention(q, k, v)

    monkeypatch.setattr(tattn, "frame_attention", spy)
    monkeypatch.setenv("VDPP_TEMPORAL_ATTN", "pallas")
    got = tattn.temporal_self_attention(attn, torch.from_numpy(x), heads, batch, frames)
    assert calls == [(batch, frames, l, heads, c // heads)]
    _check(got, jattn.temporal_self_attention(jax_params(attn, _conv_attention), jnp.asarray(x),
                                              heads, batch, frames))


def test_unported_attention_switches_raise(monkeypatch):
    """The switches this test once found refused are ported: the temporal
    forms ``einsum`` and ``transpose`` and the long-sequence routes ``xla``
    and ``naive`` now run and give the reference's result (each switch has
    its own cases in tests/test_torch_port_switches.py)."""
    attn = randomize(tattn.Attention(16), 27)
    jp = jax_params(attn, _conv_attention)
    x = _x(28, 2, 4, 16)
    for impl in ("einsum", "transpose"):
        monkeypatch.setenv("VDPP_TEMPORAL_ATTN", impl)
        _check(tattn.temporal_self_attention(attn, torch.from_numpy(x), 2, 1, 2),
               jattn.temporal_self_attention(jp, jnp.asarray(x), 2, 1, 2))
    x = _x(29, 1, 512, 16)
    for impl in ("xla", "naive"):
        monkeypatch.setenv("VDPP_ATTN_IMPL", impl)
        _check(tattn.attention(torch.from_numpy(x), attn, 2),
               jattn.attention(jnp.asarray(x), jp, 2))


@pytest.mark.parametrize("impl", ["pallas", "splash"])
def test_attn_impl_takes_the_flash_kernel_from_512_tokens(monkeypatch, impl):
    """Both reference choices map onto the port's flash kernel, and only
    self-attention with L >= 512 reaches it."""
    calls = []

    def flash(q, k, v):
        calls.append(q.shape[1])
        return tattn.sdpa_plain(q, k, v)

    monkeypatch.setenv("VDPP_ATTN_IMPL", impl)
    monkeypatch.setattr(tattn, "flash_attention", flash)
    attn = tattn.Attention(16)
    for l in (511, 512):
        tattn.attention(torch.zeros(1, l, 16), attn, 2)
    assert calls == [512]
