"""The reference's routing and profiling switches in the port
(``vdpp_tpu_torch.ops.attention``, ``.normalization``, ``models.svd_unet``)
against the JAX package with the same switch set, at ``tiny()`` sizes on the
CPU, each read at call time on both sides.

Ops: the same numpy-seeded weights through the JAX package's converter and
inputs on both sides; fp32 1e-5 x max|want| (outputs of a few units; sums in
other orders), bf16 2e-2 x max|want| (the projections and the weights
rounded to bf16 at the same points on both sides, the fp32 sums in other
orders flipping a rounding here and there). The UNet-level ablations: the tiny UNet's forward, 1e-4 x max|want|,
as tests/test_torch_port_model.py holds it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.ops import normalization as jnorm
from vdpp_tpu.utils.weights import _SD, _conv_attention

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.ops import attention as tattn
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops import normalization as tnorm

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

jattn = importlib.import_module("vdpp_tpu.ops.attention")

SWITCHES = ("VDPP_ATTN_IMPL", "VDPP_FLASH_MIN_L", "VDPP_FUSE_QKV", "VDPP_TEMPORAL_ATTN",
            "VDPP_ABLATE_TEMPORAL_ATTN", "VDPP_ABLATE_GROUPNORM", "VDPP_ABLATE_TEMPORAL",
            "VDPP_ABLATE_TEMPORAL_RESNET", "VDPP_FLASH_SOFTMAX", "VDPP_FLASH_EXP",
            "VDPP_GN_FUSED")


@pytest.fixture(autouse=True)
def switches_off(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _attn(c: int, seed: int, bias: bool = False, dtype=torch.float32):
    """A port ``Attention`` with numpy-seeded weights, and its JAX tree."""
    attn = tattn.Attention(c, qkv_bias=bias)
    sd = helpers.random_state_dict(attn, seed)
    sd = {k: v.astype(np.float32) * 2.0 for k, v in sd.items()}  # logits of a few units
    attn.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    jp = _conv_attention(_SD({f"m.{k}": v for k, v in sd.items()}), "m")
    if dtype != torch.float32:
        attn.to(dtype)
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jp)
    return attn, jp


def _x(seed, *shape, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, jnp.float32 if dtype == torch.float32
                                                      else jnp.bfloat16)


def _check(got: torch.Tensor, want, dtype=torch.float32):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    atol = (1e-5 if dtype == torch.float32 else 2e-2) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "naive", "identity"])
def test_attn_impl_routes_match_jax(impl, monkeypatch):
    """``VDPP_ATTN_IMPL`` at a long self-attention site (L = 512, d = 16):
    ``xla`` and ``naive`` are plain attention on both sides, ``identity``
    returns the projections without the core; none reaches the flash
    kernel."""
    monkeypatch.setenv("VDPP_ATTN_IMPL", impl)
    attn, jp = _attn(32, 1)
    x, jx = _x(2, 1, 512, 32)
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda *a: calls.append(1))
    _check(tattn.attention(x, attn, 2), jattn.attention(jx, jp, 2))
    assert not calls


def test_flash_min_l_moves_the_flash_route(monkeypatch):
    """``VDPP_FLASH_MIN_L``: at 64 a 100-token self-attention takes the flash
    route on both sides (the JAX Pallas kernel in interpret mode, the port's
    plain flash version on the CPU); at 1000 a 512-token one takes plain
    attention. Both are held to JAX and the port's route is counted."""
    attn, jp = _attn(32, 3)
    calls = []

    def flash(q, k, v):
        calls.append(q.shape[1])
        return fa.flash_attention(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", flash)
    monkeypatch.setenv("VDPP_FLASH_MIN_L", "64")
    x, jx = _x(4, 1, 100, 32)
    _check(tattn.attention(x, attn, 2), jattn.attention(jx, jp, 2))
    monkeypatch.setenv("VDPP_FLASH_MIN_L", "1000")
    x, jx = _x(5, 1, 512, 32)
    _check(tattn.attention(x, attn, 2), jattn.attention(jx, jp, 2))
    assert calls == [100]


@pytest.mark.parametrize("bias", [False, True])
def test_fused_qkv_is_exact(bias, monkeypatch):
    """``VDPP_FUSE_QKV=1`` (the oracle is
    tests/test_ops.py::test_fused_qkv_projection_is_exact): the port's fused
    self- and temporal attention bit-equal to its unfused ones, for the
    biasless (diffusers) and biased (CLIP-style) projections, and equal to
    the JAX package's fused forms."""
    attn, jp = _attn(32, 6, bias)
    x, jx = _x(7, 2, 24, 32)
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("VDPP_FUSE_QKV", flag)
        outs[flag] = (tattn.attention(x, attn, 4, use_flash=False),
                      tattn.temporal_self_attention(attn, x, 4, 1, 2))
        if flag == "1":
            _check(outs[flag][0], jattn.attention(jx, jp, 4, use_flash=False))
            _check(outs[flag][1], jattn.temporal_self_attention(jp, jx, 4, 1, 2))
    assert torch.equal(outs["1"][0], outs["0"][0])
    assert torch.equal(outs["1"][1], outs["0"][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["vpu", "transpose", "einsum", "pallas"])
def test_temporal_forms_match_jax(impl, dtype, monkeypatch):
    """``VDPP_TEMPORAL_ATTN``: the reference's four forms of frame attention
    (d = 16, 3 frames, 40 locations, B = 2); in bf16 ``transpose`` and
    ``einsum`` round the weights to bf16 before the product on both sides."""
    monkeypatch.setenv("VDPP_TEMPORAL_ATTN", impl)
    attn, jp = _attn(32, 8, dtype=dtype)
    x, jx = _x(9, 2 * 3, 40, 32, dtype=dtype)
    _check(tattn.temporal_self_attention(attn, x, 2, 2, 3),
           jattn.temporal_self_attention(jp, jx, 2, 2, 3), dtype)


def test_ablate_temporal_attn_matches_jax(monkeypatch):
    """``VDPP_ABLATE_TEMPORAL_ATTN=1``: ``to_out(v)`` on both sides."""
    monkeypatch.setenv("VDPP_ABLATE_TEMPORAL_ATTN", "1")
    attn, jp = _attn(32, 10)
    x, jx = _x(11, 6, 40, 32)
    got = tattn.temporal_self_attention(attn, x, 2, 2, 3)
    _check(got, jattn.temporal_self_attention(jp, jx, 2, 2, 3))
    assert torch.equal(got, attn.to_out[0](attn.to_v(x)))


def test_ablate_groupnorm_matches_jax(monkeypatch):
    """``VDPP_ABLATE_GROUPNORM=1``: only the affine, in ``group_norm`` and so
    in the unfused ``group_norm_silu``, on both sides."""
    monkeypatch.setenv("VDPP_ABLATE_GROUPNORM", "1")
    norm = tnorm.Norm(32)
    rng = np.random.default_rng(12)
    w, b = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32), rng.standard_normal(
        32).astype(np.float32)
    norm.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    jp = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    x, jx = _x(13, 2, 5, 4, 32)
    _check(tnorm.group_norm(x, norm, 8), jnorm.group_norm(jx, jp, 8))
    _check(tnorm.group_norm_silu(x, norm, 8), jnorm.group_norm_silu(jx, jp, 8))


@pytest.fixture(scope="module")
def tiny():
    params, state = helpers.tiny_svd_weights(40)
    unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu")
    unet.load_state_dict(state)
    rng = np.random.default_rng(41)
    inputs = (rng.standard_normal((1, 3, 16, 16, 8)).astype(np.float32),
              np.float32(0.25 * np.log(80.0)),
              rng.standard_normal((1, 1, 48)).astype(np.float32),
              np.array([[5.0, 127.0, 0.02]], np.float32))
    return params, unet, inputs


@pytest.mark.parametrize("switch", ["VDPP_ABLATE_TEMPORAL", "VDPP_ABLATE_TEMPORAL_RESNET"])
def test_unet_ablations_match_jax(tiny, switch, monkeypatch):
    """The UNet's profiling ablations (the temporal transformer blocks, the
    temporal ResNets) in a ``tiny()`` forward at 16x16, the JAX UNet traced
    afresh under the switch; the ablated forward differs from the full one."""
    params, unet, (x, t, ctx, ids) = tiny
    with torch.inference_mode():
        full = unet(torch.from_numpy(x), float(t), torch.from_numpy(ctx), torch.from_numpy(ids))
        monkeypatch.setenv(switch, "1")
        got = unet(torch.from_numpy(x), float(t), torch.from_numpy(ctx), torch.from_numpy(ids))
    want = np.asarray(jax.jit(JaxUNet(JaxConfig.tiny()).apply)(
        params, jnp.asarray(x), t, jnp.asarray(ctx), jnp.asarray(ids)))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert not torch.equal(got, full)
