"""The port's fused GroupNorm+SiLU (``vdpp_tpu_torch.ops.norm_kernel``) against
the JAX package's (``vdpp_tpu.ops.norm_kernel.group_norm_silu_fused``, its
Pallas kernel in interpret mode on the CPU), mirroring
tests/test_norm_kernel.py, plus the true SVD-XT widths at small spatial
extents.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version in tests/test_torch_port_kernels.py.
Tolerances: bf16, one bf16 ulp at the largest output (both sides apply the
SiLU to the fp32 value and round once, and their fp32 statistics, summed in
other orders, flip a rounding at most once); fp32, 2e-6 x max|want| (a few
fp32 ulps of the normalised values).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vdpp_tpu.ops import norm_kernel as jnk
from vdpp_tpu.ops import normalization as jnorm

from vdpp_tpu_torch.ops import norm_kernel as nk
from vdpp_tpu_torch.ops import normalization as tnorm

from torch_port_helpers import one_torch_thread  # noqa: F401

NP_DTYPE = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16}
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _case(shape, dtype, seed=0, offset=0.0):
    """x (3 x N(0, 1) + offset, rounded to ``dtype``) and a norm whose scale
    and bias are moved off 1 and 0, as numpy arrays for both sides."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3.0 + offset).astype(NP_DTYPE[dtype]).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    norm = tnorm.Norm(c)
    norm.weight.copy_(torch.from_numpy(scale))
    norm.bias.copy_(torch.from_numpy(bias))
    jparams = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    return torch.from_numpy(x).to(dtype), jnp.asarray(x, JNP_DTYPE[dtype]), norm, jparams


def _check(got: torch.Tensor, want, dtype):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    if dtype == torch.bfloat16:
        atol = float(np.spacing(np.float32(top))) * 2 ** 16  # one bf16 ulp at max|want|
    else:
        atol = 2e-6 * top
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "shape,groups",
    [
        ((2, 24, 64), 32),
        ((3, 40, 128), 32),
        ((2, 8, 16, 320), 32),
        ((1, 16, 48), 8),
        ((2, 64, 256), 32),
        ((2, 16, 640), 32),
        ((1, 24, 1280), 32),
        ((2, 8, 2560), 32),
    ],
)
def test_fused_gn_silu_matches_jax(shape, groups, dtype):
    x, jx, norm, jp = _case(shape, dtype)
    got = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
    assert got.dtype == dtype and got.shape == shape
    _check(got, jnk.group_norm_silu_fused(jx, jp, groups, 1e-6), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_gn_bare_matches_jax(dtype):
    """``silu=False``: bare GroupNorm."""
    x, jx, norm, jp = _case((3, 40, 128), dtype, seed=1)
    _check(nk.group_norm_silu_fused(x, norm, 32, 1e-6, silu=False),
           jnk.group_norm_silu_fused(jx, jp, 32, 1e-6, silu=False), dtype)


def test_fused_gn_bf16_weights_match_jax():
    """``weight`` and ``bias`` stored in bf16, as the SVD-XT UNet holds its
    norms: both sides widen them to fp32 inside (the CUDA kernel reads them
    as stored, with no cast)."""
    x, jx, _, _ = _case((2, 24, 320), torch.bfloat16, seed=6)
    rng = np.random.default_rng(7)
    scale = (1.0 + 0.2 * rng.standard_normal(320)).astype(ml_dtypes.bfloat16)
    bias = (0.1 * rng.standard_normal(320)).astype(ml_dtypes.bfloat16)
    norm = tnorm.Norm(320, dtype=torch.bfloat16)
    norm.weight.copy_(torch.from_numpy(scale.astype(np.float32)))
    norm.bias.copy_(torch.from_numpy(bias.astype(np.float32)))
    jp = {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}
    got = nk.group_norm_silu_fused(x, norm, 32, 1e-6)
    assert got.dtype == torch.bfloat16
    _check(got, jnk.group_norm_silu_fused(jx, jp, 32, 1e-6), torch.bfloat16)


def test_fused_gn_plain_matches_jax_with_large_offset():
    """Statistics hold up under a large common-mode offset, where the
    one-pass E[x^2] - mean^2 shortcut fails. Both sides fold the affine into
    ``x * a + b``, which cancels ``x * a`` (about 64 / 3 = 21 here) against
    ``b``: each side's fp32 rounding lands at a few ulps of 21, so the bound
    is 5e-5 (the reference's own test allows 1e-4)."""
    x, jx, norm, jp = _case((2, 64, 128), torch.float32, seed=4, offset=64.0)
    got = nk.group_norm_silu_fused_plain(x, norm, 32, 1e-6, silu=False)
    want = jnk.group_norm_silu_fused(jx, jp, 32, 1e-6, silu=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 24, 64), (2, 12, 64), (3, 4, 4, 64)])
def test_group_norm_silu_dispatch_matches_jax(shape, dtype, monkeypatch):
    """``group_norm_silu(fused=True)`` makes the reference's choice: 12 rows
    have no 8-aligned chunking, so both sides keep the composition there."""
    x, jx, norm, jp = _case(shape, dtype, seed=5)
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return nk.group_norm_silu_fused(*args, **kwargs)

    monkeypatch.setattr(tnorm, "group_norm_silu_fused", spy)
    got = tnorm.group_norm_silu(x, norm, 8, 1e-6, fused=True)
    assert bool(calls) == (shape[1] != 12)
    _check(got, jnorm.group_norm_silu(jx, jp, 8, 1e-6, fused=True), dtype)


def test_row_chunk_matches_jax():
    grid = [(s, c) for s in range(1, 400, 7) for c in (4, 64, 320, 2560, 4096)]
    grid += [(9216, 320), (9216, 960), (230400, 320), (230400, 640), (3600, 1280),
             (144, 2560), (576, 1920), (24, 64), (12, 64)]
    for s, c in grid:
        assert nk._row_chunk(s, c) == jnk._row_chunk(s, c), (s, c)


def test_fused_gn_rejects_bad_shapes():
    norm = tnorm.Norm(64)
    with pytest.raises(ValueError, match="not divisible"):
        nk.group_norm_silu_fused(torch.zeros(2, 24, 64, dtype=torch.bfloat16), norm, 48)
    with pytest.raises(ValueError, match="8-aligned"):
        nk.group_norm_silu_fused(torch.zeros(2, 12, 64, dtype=torch.bfloat16), norm, 32)
    with pytest.raises(TypeError):
        nk.group_norm_silu_fused(torch.zeros(2, 24, 64, dtype=torch.float16), norm, 32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        nk.group_norm_silu_fused(torch.zeros(2, 24, 64, device="meta"), norm, 32)
    assert nk.launches == 0  # CPU tensors never launch the kernel
