"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels.py

Tolerances are relative to the largest output, max|got - ref| <= TOL *
max|ref|. Flash attention: the outputs are small (softmax-weighted means of
N(0, 1) values, std about sqrt(e / L)): fp32 1e-5 (the kernel and the plain
version sum fp32 in other orders); bf16 2e-2, 2.5 to 5 bf16 ulps of max|ref|
(a bf16 ulp is 2^-8 to 2^-7 of its value; the sums taken in other orders flip
the rounding of q', P or o by an ulp here and there). GroupNorm+SiLU and frame
attention compute in fp32 and round once: bf16 one ulp at max|ref|, fp32 1e-5.
"""

import math

import pytest
import torch

from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops import norm_kernel as nk
from vdpp_tpu_torch.ops import temporal_attention_kernel as tak
from vdpp_tpu_torch.ops.normalization import Norm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(device, b, l, h, d, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, l, h, d, generator=g, device=device).to(dtype) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("l", [64, 200, 576, 2304])
def test_flash_kernel_matches_plain(cuda, l, static_max, dtype):
    q, k, v = _qkv(cuda, 2, l, 5, 64, dtype, l)
    before = fa.launches
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
def test_flash_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fa, "flash_attention_plain", forbidden)
    q, k, v = _qkv(cuda, 1, 512, 2, 64, torch.bfloat16, 0)
    assert torch.isfinite(fa.flash_attention(q, k, v)).all()


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 1, 72, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=72"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


def _one_rounding_tol(ref: torch.Tensor) -> float:
    """bf16: one ulp at max|ref|; fp32: 1e-5 x max|ref|."""
    top = ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        return 2.0 ** (math.floor(math.log2(top)) - 7)
    return TOL[torch.float32] * top


@pytest.mark.gpu
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,l", [(2, 600), (1, 2048)])
def test_flash_d512_kernel_matches_plain(cuda, b, l, static_max):
    q, k, v = _qkv(cuda, b, l, 1, 512, torch.float32, l + 1)
    before = fa.launches
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max)
    err = (got - ref).abs().max().item()
    assert err <= TOL[torch.float32] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [((25, 576, 320), 32), ((1, 1800, 640), 32),
                                          ((4, 48, 2560), 32), ((2, 200, 90), 6)])
def test_group_norm_kernel_matches_plain(cuda, shape, groups, dtype):
    """(2, 200, 90): channels that no 16-byte vector divides."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    c = shape[-1]
    norm = Norm(c, device=cuda, dtype=dtype)
    norm.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g, device=cuda))
    norm.bias.copy_(0.1 * torch.randn(c, generator=g, device=cuda))
    x = (3.0 * torch.randn(shape, generator=g, device=cuda) + 1.0).to(dtype)
    for silu in (True, False):
        before = nk.launches
        got = nk.group_norm_silu_fused(x, norm, groups, 1e-6, silu=silu)
        torch.cuda.synchronize()
        assert nk.launches == before + 1
        ref = nk.group_norm_silu_fused_plain(x, norm, groups, 1e-6, silu=silu)
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= _one_rounding_tol(ref), (silu, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 25, 576, 20, 64), (2, 3, 40, 2, 64), (1, 32, 9, 1, 64)])
def test_frame_attention_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = tak.launches
    got = tak.frame_attention(q, k, v)
    torch.cuda.synchronize()
    assert tak.launches == before + 1
    ref = tak.frame_attention_plain(q, k, v)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _one_rounding_tol(ref), err


@pytest.mark.gpu
def test_new_kernels_never_take_the_plain_version(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(nk, "group_norm_silu_fused_plain", forbidden)
    monkeypatch.setattr(tak, "frame_attention_plain", forbidden)
    monkeypatch.setattr(fa, "flash_attention_plain", forbidden)
    x = torch.randn(2, 64, 128, device=cuda, dtype=torch.bfloat16)
    norm = Norm(128, device=cuda, dtype=x.dtype)
    norm.reset_parameters(None)
    assert torch.isfinite(nk.group_norm_silu_fused(x, norm, 32)).all()
    q = torch.randn(1, 25, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    assert torch.isfinite(tak.frame_attention(q, q, q)).all()
    q = torch.randn(1, 512, 1, 512, device=cuda)
    assert torch.isfinite(fa.flash_attention(q, q, q)).all()


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 8, 2, 72, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=72"):
        tak.frame_attention(q, q, q)
    q = torch.zeros(1, 33, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 32 frames"):
        tak.frame_attention(q, q, q)
    q = torch.zeros(1, 16, 1, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=512"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(2, 24, 8192, device=cuda)
    with pytest.raises(ValueError, match="C <= 4096"):
        nk.group_norm_silu_fused(x, Norm(8192, device=cuda), 32)
