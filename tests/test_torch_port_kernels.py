"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_kernels.py

Tolerances are relative to the largest output, max|got - ref| <= TOL *
max|ref|, because the outputs are small (softmax-weighted means of N(0, 1)
values, std about sqrt(e / L)): fp32 1e-5 (the kernel and the plain version
sum fp32 in other orders); bf16 2e-2, 2.5 to 5 bf16 ulps of max|ref| (a bf16
ulp is 2^-8 to 2^-7 of its value; the sums taken in other orders flip the
rounding of q', P or o by an ulp here and there).
"""

import pytest
import torch

from vdpp_tpu_torch.ops import flash_attention as fa

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
