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



@pytest.mark.parametrize("static_max", [True, False])
def test_flash_d512_fp32_matches_jax(static_max):
    """The VAE mid-block's case: one head, d = 512, fp32, a ragged 600 keys
    (the JAX side's blocks as its ``_pick_blocks`` would shrink them)."""
    got, want = _both(_qkv(14, 2, 600, 1, 512, torch.float32), torch.float32, static_max,
                      jax_blocks=(256, 256, 256))
    np.testing.assert_allclose(got, want, atol=TOL[torch.float32], rtol=0)
