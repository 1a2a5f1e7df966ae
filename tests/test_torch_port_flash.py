"""The port's flash attention against the JAX package's
(``vdpp_tpu.ops.flash_attention.flash_attention``, its Pallas kernel in
interpret mode on the CPU), mirroring tests/test_ops.py's flash cases.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version in tests/test_torch_port_kernels.py.
Tolerances: fp32 2e-5 absolute (both sides sum fp32 in other orders); bf16
1e-2 x max|want|, 1.3 to 2.6 bf16 ulps of the largest output (a bf16 ulp is
2^-8 to 2^-7 of its value). Relative, because the outputs are softmax-weighted
means of N(0, 1) values, std about sqrt(e / L), well under 1. Both sides round
q', P and o to bf16 at the same points, so only the fp32 summation order
differs before the rounding, which flips it by an ulp here and there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vdpp_tpu.ops.attention import _sdpa_xla
from vdpp_tpu.ops.flash_attention import flash_attention as jax_flash

from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.utils import kernels

from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
NP_DTYPE = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(seed, b, l, h, d, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((b, l, h, d)) * scale).astype(np.float32) for _ in range(3)]
    arrs = [a.astype(NP_DTYPE[dtype]).astype(np.float32) for a in arrs]  # same values both sides
    return arrs


def _both(arrs, dtype, static_max, jax_blocks=(128, 128, 128)):
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    j = [jnp.asarray(a, JNP_DTYPE[dtype]) for a in arrs]
    got = fa.flash_attention(*t, static_max=static_max).float().numpy()
    bq, bkm, bk = jax_blocks
    want = np.asarray(jax_flash(*j, block_q=bq, block_k_major=bkm, block_k=bk,
                                static_max=static_max).astype(jnp.float32))
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("l", [128, 200, 512, 600])
def test_flash_matches_jax(l, static_max, dtype):
    got, want = _both(_qkv(9, 2, l, 3, 64, dtype), dtype, static_max)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == torch.bfloat16 else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_flash_static_matches_running_and_plain_sdpa():
    arrs = _qkv(12, 2, 384, 3, 64, torch.float32)
    t = [torch.from_numpy(a) for a in arrs]
    ref = np.asarray(_sdpa_xla(*(jnp.asarray(a) for a in arrs)))
    for mode in (True, False):
        np.testing.assert_allclose(fa.flash_attention(*t, static_max=mode).numpy(), ref,
                                   atol=2e-5)
    # 8x queries: logits ~50, inside the static clamp's exactness bound
    q8 = [t[0] * 8.0, t[1], t[2]]
    ref8 = np.asarray(_sdpa_xla(jnp.asarray(arrs[0] * 8.0), *(jnp.asarray(a) for a in arrs[1:])))
    np.testing.assert_allclose(fa.flash_attention(*q8, static_max=True).numpy(), ref8, atol=5e-5)
    # 64x queries: the clamp engages; like the reference, only finiteness holds
    got, want = _both([arrs[0] * 64.0, arrs[1], arrs[2]], torch.float32, True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_flash_all_negative_logits_no_collapse():
    """A row whose logits all underflow exp2 must not collapse to zero: the
    lower clamp flattens it to the uniform average (the exact softmax for
    equal logits)."""
    b, l, h, d = 1, 200, 1, 64
    q = np.full((b, l, h, d), 4.0, np.float32)
    k = np.full((b, l, h, d), -4.0, np.float32)
    v = np.broadcast_to(np.linspace(0.5, 1.5, l, dtype=np.float32)[None, :, None, None],
                        (b, l, h, d)).copy()
    got, want = _both([q, k, v], torch.float32, True)
    assert np.isfinite(got).all() and np.abs(got).min() > 0.5
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, np.asarray(_sdpa_xla(*(jnp.asarray(a) for a in (q, k, v)))),
                               atol=5e-5)


@pytest.mark.parametrize("d", [16, 256])
def test_flash_plain_any_head_dim(d):
    got, want = _both(_qkv(10, 1, 512, 2, d, torch.float32), torch.float32, True,
                      jax_blocks=(128, 256, 128))
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_flash_plain_chunks_queries(monkeypatch):
    arrs = [torch.from_numpy(a) for a in _qkv(13, 2, 300, 3, 64, torch.float32)]
    whole = fa.flash_attention_plain(*arrs)
    monkeypatch.setattr(fa, "_PLAIN_SCORE_ELEMS", 7 * 2 * 3 * 300)  # 7-row chunks
    torch.testing.assert_close(fa.flash_attention_plain(*arrs), whole, atol=1e-6, rtol=0)


def test_flash_wrapper_checks():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(meta, meta, meta)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
def test_flash_d512_fp32_matches_jax(static_max, dtype):
    """The VAE mid-block's case: one head, d = 512, a ragged 600 keys (the
    JAX side's blocks as its ``_pick_blocks`` would shrink them); fp32 as the
    decoder runs by default, bf16 as ``VAEConfig.svd(torch.bfloat16)`` runs
    it (``--vae-dtype bfloat16`` in the JAX scripts)."""
    got, want = _both(_qkv(14, 2, 600, 1, 512, dtype), dtype, static_max,
                      jax_blocks=(256, 256, 256))
    atol = TOL[dtype] * (np.abs(want).max() if dtype == torch.bfloat16 else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("l", [200, 600])
def test_flash_d72_matches_jax(l, static_max, dtype):
    """DiT-XL's head dim, 72, at ragged lengths (not multiples of the
    kernel's 64-key tiles or the JAX side's 128-key blocks)."""
    got, want = _both(_qkv(15, 1, l, 2, 72, dtype), dtype, static_max)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == torch.bfloat16 else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("d", [16, 40, 136, 256, 264])
def test_flash_matches_jax_at_other_head_dims(d, static_max, dtype):
    """d = 16 (the tiny SVD UNet's and DiT's), 256
    (tests/test_ops.py::test_flash_attention_large_head_dim's) and 40, 136
    and 264 (either side of the CUDA kernel's layout switches at 128 and 256,
    and of the width classes): the reference pads V to _aug_width(d), the
    port's CUDA side has a generic kernel; on the CPU both are held to the
    same arithmetic. Tolerances as above."""
    got, want = _both(_qkv(21 + d, 1, 200, 2, d, dtype), dtype, static_max)
    atol = TOL[dtype] * (np.abs(want).max() if dtype == torch.bfloat16 else 1.0)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# VDPP_FLASH_EXP=bf16: s - m rounded to bf16 moves each p by up to about 1 %
# at these logit spreads, and the reference's running max (tile by tile) and
# the plain version's global max round different arguments: 5e-2 x max|want|.
EXP_TOL = 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_exp_bf16_matches_jax(d, dtype, monkeypatch):
    """``VDPP_FLASH_EXP=bf16`` with ``VDPP_FLASH_SOFTMAX=running`` on both
    sides (read at call time by both wrappers); static max ignores it on both
    (bitwise the same as without it here)."""
    monkeypatch.setenv("VDPP_FLASH_EXP", "bf16")
    arrs = _qkv(31 + d, 2, 300, 2, d, dtype)
    t = [torch.from_numpy(a).to(dtype) for a in arrs]
    j = [jnp.asarray(a, JNP_DTYPE[dtype]) for a in arrs]
    monkeypatch.setenv("VDPP_FLASH_SOFTMAX", "running")
    got = fa.flash_attention(*t).float().numpy()
    want = np.asarray(jax_flash(*j, block_q=128, block_k_major=128, block_k=128)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=EXP_TOL * np.abs(want).max(), rtol=0)
    exact = fa.flash_attention(*t, exp_bf16=False).float().numpy()
    assert np.abs(got - exact).max() > 0  # the rounding is there
    monkeypatch.setenv("VDPP_FLASH_SOFTMAX", "static")
    assert torch.equal(fa.flash_attention(*t), fa.flash_attention(*t, exp_bf16=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [7, 33, 1003])
def test_padded_operands_keep_the_result_bit_for_bit(d, dtype):
    """A head dim that is no whole number of 16-byte words reaches the CUDA
    kernels in rows padded with zeros (``utils.kernels.padded_operands``):
    the same values, zeros past d, every stride but the head dim's a multiple
    of 16 bytes (an axis of size 1 included), each operand counted as a copy;
    and the plain version gives the unpadded result bit for bit on them."""
    t = [torch.from_numpy(a).to(dtype) for a in _qkv(40 + d, 2, 24, 1, d, dtype)]
    padded, strides, copies = kernels.padded_operands(*t)
    assert copies == 3
    size = t[0].element_size()
    pitch = -(-d * size // 16) * 16 // size
    for a, p in zip(t, padded):
        assert torch.equal(a, p)
        assert p.stride()[-1] == 1 and all(s * size % 16 == 0 for s in p.stride()[:-1])
        rows = torch.as_strided(p, (*p.shape[:-1], pitch), p.stride())
        assert not rows[..., d:].any()
    assert list(strides) == [s for p in padded for s in p.stride()[:-1]]
    for static_max in (True, False):
        assert torch.equal(fa.flash_attention_plain(*padded, static_max),
                           fa.flash_attention_plain(*t, static_max))
