"""The port's frame attention (``vdpp_tpu_torch.ops.temporal_attention_kernel``)
against the JAX package's (``vdpp_tpu.ops.temporal_attention_kernel.
frame_attention``, its Pallas kernel in interpret mode on the CPU), mirroring
tests/test_ops.py::test_frame_attention_kernel_matches_einsum.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version in tests/test_torch_port_kernels.py.
Tolerances: fp32 2e-6 absolute (both sides compute the softmax in fp32 and
sum in other orders; the outputs are weighted means of N(0, 1) values, O(1));
bf16 one bf16 ulp at the largest output (both sides round once, from fp32
values that agree to a few fp32 ulps).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vdpp_tpu.ops.temporal_attention_kernel import frame_attention as jax_frame_attention

from vdpp_tpu_torch.ops import temporal_attention_kernel as tak

from torch_port_helpers import one_torch_thread  # noqa: F401

NP_DTYPE = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 48, 2, 16), (1, 25, 40, 1, 64), (1, 8, 40, 2, 72),
                                   (1, 32, 24, 1, 64), (1, 1, 40, 2, 64)])
def test_frame_attention_matches_jax(shape, dtype):
    """tile_l=32 forces the reference to pad L (48 and 40 are not multiples
    of it); 25 frames at d = 64 is the SVD-XT case, 8 frames at d = 72 the
    factorized DiT-XL's; 32 frames is the most the TMA kernel takes, and one
    frame the least (a softmax over one key)."""
    rng = np.random.default_rng(11)
    arrs = [rng.standard_normal(shape).astype(NP_DTYPE[dtype]).astype(np.float32)
            for _ in range(3)]
    got = tak.frame_attention(*(torch.from_numpy(a).to(dtype) for a in arrs))
    want = jax_frame_attention(*(jnp.asarray(a, JNP_DTYPE[dtype]) for a in arrs), tile_l=32)
    assert got.dtype == dtype and tuple(got.shape) == shape
    want = np.asarray(want.astype(jnp.float32))
    top = np.abs(want).max()
    atol = 2e-6 if dtype == torch.float32 else float(np.spacing(np.float32(top))) * 2 ** 16
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert tak.launches == 0  # CPU tensors never launch the kernel


def test_frame_attention_wrapper_checks():
    q = torch.zeros(1, 3, 8, 2, 16)
    with pytest.raises(ValueError, match="one shape"):
        tak.frame_attention(q, torch.zeros(1, 4, 8, 2, 16), q)
    with pytest.raises(TypeError):
        tak.frame_attention(q.half(), q.half(), q.half())
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tak.frame_attention(meta, meta, meta)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 14, 40, 2, 16), (1, 40, 24, 1, 64)])
def test_frame_attention_matches_jax_at_any_head_dim_and_frame_count(shape, dtype):
    """d = 16 (the tiny configs', at the image->video app's 14 frames) and 40
    frames at d = 64, past the TMA kernel's 32: the reference takes any d and
    F (it pads only L), and so does the port's generic CUDA kernel; on the
    CPU both are held to the same arithmetic. Tolerances as above."""
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal(shape).astype(NP_DTYPE[dtype]).astype(np.float32)
            for _ in range(3)]
    got = tak.frame_attention(*(torch.from_numpy(a).to(dtype) for a in arrs))
    want = jax_frame_attention(*(jnp.asarray(a, JNP_DTYPE[dtype]) for a in arrs), tile_l=32)
    want = np.asarray(want.astype(jnp.float32))
    top = np.abs(want).max()
    atol = 2e-6 if dtype == torch.float32 else float(np.spacing(np.float32(top))) * 2 ** 16
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
