"""The kernels' last variants against the JAX package, and the fused QKV
layout against the kernels' input rule.

* Flash attention above d = 512 (the port's plain version, which the CUDA
  kernel ``flash_fwd_wide`` is held to on the card) against the JAX package's
  ``flash_attention``, its Pallas kernel in interpret mode, fp32 and bf16,
  both softmax modes. Tolerances as tests/test_torch_port_flash.py: fp32 2e-5
  absolute, bf16 1e-2 x max|want|.
* GroupNorm+SiLU past 4096 channels and 256 groups (the plain version, which
  the kernel's channel tiles are held to on the card) against the JAX
  package's ``group_norm_silu_fused`` in interpret mode. Tolerances as
  tests/test_torch_port_norm_kernel.py: bf16 one ulp at max|want|, fp32
  2e-6 x max|want|.
* ``VDPP_FUSE_QKV=1``: the q, k and v that ``attention`` and
  ``temporal_self_attention`` hand the flash and frame-attention wrappers
  are the fused projection's strided chunks, and they pass the wrappers'
  card-side input rule (``utils.kernels.operand_strides``) as they are, with
  no copy, at a tiny UNet's and DiT's widths and at the full models' widths.
  Before the kernels took strides, that rule was "contiguous", which these
  chunks are not.

Past 65,535 batch-heads and 65,535 GroupNorm rows the kernels' grids change,
not their arithmetic: that is held on the card only
(tests/test_torch_port_kernels.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vdpp_tpu.ops import norm_kernel as jnk
from vdpp_tpu.ops.flash_attention import flash_attention as jax_flash

from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig
from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.ops import attention as tattn
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops import norm_kernel as nk
from vdpp_tpu_torch.ops import normalization as tnorm
from vdpp_tpu_torch.utils import kernels

from torch_port_helpers import one_torch_thread  # noqa: F401

NP_DTYPE = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("d,l", [(640, 64), (1000, 40), (1024, 72)])
def test_flash_above_512_matches_jax(d, l, static_max, dtype):
    rng = np.random.default_rng(d + l)
    arrs = [rng.standard_normal((1, l, 2, d)).astype(NP_DTYPE[dtype]).astype(np.float32)
            for _ in range(3)]
    got = fa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in arrs),
                             static_max=static_max).float().numpy()
    want = np.asarray(jax_flash(*(jnp.asarray(a, JNP_DTYPE[dtype]) for a in arrs),
                                static_max=static_max).astype(jnp.float32))
    atol = 1e-2 * np.abs(want).max() if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,groups", [(4608, 32), (4608, 512), (8192, 32), (8192, 512)])
def test_group_norm_past_4096_channels_matches_jax(c, groups, dtype):
    rng = np.random.default_rng(c + groups)
    x = (rng.standard_normal((2, 8, c)) * 3.0 + 1.0).astype(NP_DTYPE[dtype]).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    norm = tnorm.Norm(c)
    norm.weight.copy_(torch.from_numpy(scale))
    norm.bias.copy_(torch.from_numpy(bias))
    got = nk.group_norm_silu_fused(torch.from_numpy(x).to(dtype), norm, groups, 1e-6)
    want = np.asarray(jnk.group_norm_silu_fused(
        jnp.asarray(x, JNP_DTYPE[dtype]), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        groups, 1e-6).astype(jnp.float32))
    top = np.abs(want).max()
    atol = float(np.spacing(np.float32(top))) * 2 ** 16 if dtype == torch.bfloat16 else 2e-6 * top
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.fixture
def handed(monkeypatch):
    """Every (q, k, v) that attention() and temporal_self_attention() hand
    the kernel wrappers under VDPP_FUSE_QKV=1, with every self-attention on
    the flash route (VDPP_FLASH_MIN_L=1) and frame attention on its kernel's
    (VDPP_TEMPORAL_ATTN=pallas)."""
    calls = {"flash": [], "frame": []}

    def spy(name, real):
        def recorded(q, k, v, *args, **kwargs):
            calls[name].append((q, k, v))
            return real(q, k, v, *args, **kwargs)

        return recorded

    monkeypatch.setattr(tattn, "flash_attention", spy("flash", tattn.flash_attention))
    monkeypatch.setattr(tattn, "frame_attention", spy("frame", tattn.frame_attention))
    monkeypatch.setenv("VDPP_FUSE_QKV", "1")
    monkeypatch.setenv("VDPP_FLASH_MIN_L", "1")
    monkeypatch.setenv("VDPP_TEMPORAL_ATTN", "pallas")
    return calls


def _assert_read_in_place(calls, kinds=("flash", "frame")) -> None:
    for kind in kinds:
        assert calls[kind], f"no {kind} call"
        for qkv in calls[kind]:
            assert not any(t.is_contiguous() for t in qkv)  # the parent's rule copied or raised
            assert all(kernels.operand_strides(t) is not None for t in qkv)
            _, _, copies = kernels.kernel_operands(*qkv)
            assert copies == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_reaches_the_kernels_in_place_tiny_unet(handed, dtype):
    unet = SVDUNet(SVDUNetConfig.tiny(dtype), device="cpu")
    unet.init_weights(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        out = unet(torch.randn(1, 3, 8, 8, 8, generator=g).to(dtype), 0.5,
                   torch.randn(1, 1, 48, generator=g).to(dtype),
                   torch.tensor([[5.0, 127.0, 0.02]]))
    assert torch.isfinite(out).all()
    _assert_read_in_place(handed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["factorized", "joint3d"])
def test_fused_qkv_reaches_the_kernels_in_place_tiny_dit(handed, mode, dtype):
    cfg = DiTVideoConfig(hidden_size=32, depth=2, num_heads=2, cross_attention_dim=16,
                         attention_mode=mode, dtype=dtype)
    dit = DiTVideo(cfg, device="cpu").init_weights(torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    with torch.inference_mode():
        out = dit(torch.randn(1, 3, 4, 4, 4, generator=g).to(dtype), 0.5,
                  torch.randn(1, 5, 16, generator=g).to(dtype))
    assert torch.isfinite(out).all()
    _assert_read_in_place(handed, ("flash", "frame") if mode == "factorized" else ("flash",))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width,heads,bias", [
    (320, 5, False), (640, 10, False), (1280, 20, False),  # SVD-XT's UNet levels, d = 64
    (1152, 16, True),                                       # DiT-XL, d = 72
    (512, 1, True),                                         # the VAE's mid-block, d = 512
])
def test_fused_qkv_reaches_the_kernels_in_place_at_model_widths(handed, width, heads, bias,
                                                                dtype):
    """The models' own widths: the fused chunks' strides and offsets are
    multiples of 16 bytes at each, so no site copies."""
    attn = tattn.Attention(width, qkv_bias=bias, dtype=dtype)
    for lin in (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0]):
        lin.reset_parameters(torch.Generator().manual_seed(width))
    x = torch.randn(2, 4, width, generator=torch.Generator().manual_seed(4)).to(dtype)
    with torch.inference_mode():
        tattn.attention(x, attn, heads)
        tattn.temporal_self_attention(attn, x, heads, 1, 2)
    _assert_read_in_place(handed)


@pytest.mark.parametrize("key,bump", [
    ("flash_wide", lambda: fa.variant_launches.update(["wide"])),
    ("flash_many_heads", lambda: fa.variant_launches.update(["many_heads"])),
    ("group_norm_silu_wide", lambda: setattr(nk, "wide_launches", nk.wide_launches + 1)),
])
def test_variant_launches_reach_the_launch_counts(monkeypatch, key, bump):
    """The counters of the variants no model reaches travel with every
    process's launch counts (``launches_since``), which the ranks, the apps,
    production and the server report; the CUDA wrappers add to them where
    they launch (on the card only)."""
    monkeypatch.setattr(fa, "variant_launches", type(fa.variant_launches)())
    monkeypatch.setattr(nk, "wide_launches", 0)
    before = kernels.launch_counts()
    assert before["variants"] == {"flash_wide": 0, "flash_many_heads": 0,
                                  "group_norm_silu_wide": 0}
    bump()
    bump()
    since = kernels.launches_since(before)
    assert since["variants"] == {k: 2 if k == key else 0 for k in before["variants"]}
    assert since["flash"] == {} and since["group_norm_silu"] == since["frame_attention"] == 0
