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
    q = torch.zeros(1, 16, 1, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=80"):
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,lq,lk", [
    (2, 600, 600),      # ragged: the last query and key tiles part-filled
    (1, 2048, 2048),
    (2, 201, 201),      # ragged, nine keys past the last full tile
    (1, 9216, 9216),    # the last chunk of a 25-frame SVD decode
    (4, 2560, 2560),    # the DiT decode's chunks (40 x 64 latent positions)
    (1, 1000, 70),      # L_q != L_k, the keys in two tiles, the second part-filled
    (1, 64, 1000),      # L_q != L_k, one query tile over many key tiles
    (4, 9216, 9216),    # the SVD decode's chunks: several waves of the 132 SMs
])
def test_flash_d512_kernel_matches_plain(cuda, b, lq, lk, static_max, dtype):
    """The VAE mid-block's head dim: fp32 (the register-tiled SIMT kernel)
    and bf16 (``VAEConfig.svd(torch.bfloat16)``, the wgmma + TMA kernel)."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk + 1)
    q = torch.randn(b, lq, 1, 512, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, lk, 1, 512, generator=g, device=cuda).to(dtype) for _ in range(2))
    before = fa.launches
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [True, False])
def test_flash_d512_kernel_leaves_rows_past_lq_alone(cuda, static_max, dtype):
    """The d = 512 kernels store no query row past L_q: called through the C
    entry into a buffer 70 rows longer than L_q = 201, they leave those rows
    as they were and write rows 0 .. 200 as the plain version does."""
    lq, extra = 201, 70
    q, k, v = _qkv(cuda, 1, lq, 1, 512, dtype, 512)
    buf = torch.full((1, lq + extra, 1, 512), 7.0, device=cuda, dtype=dtype)
    lib = fa._kernel_lib()
    rc = lib.vdpp_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), int(dtype == torch.bfloat16),
        1, 1, lq, lq, 512, int(static_max), fa.LOG2E / math.sqrt(512),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert (buf[:, lq:] == 7.0).all()
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (buf[:, :lq].float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [((25, 576, 320), 32), ((1, 1800, 640), 32),
                                          ((4, 48, 2560), 32), ((2, 200, 90), 6),
                                          ((3, 1000, 320), 32), ((25, 144, 2560), 32)])
def test_group_norm_kernel_matches_plain(cuda, shape, groups, dtype, wdtype):
    """(2, 200, 90): channels that no 16-byte vector divides; (3, 1000, 320):
    rows that are no whole number of the kernel's chunks; (25, 144, 2560): the
    UNet's level-3 skip concatenation, 25 frames. ``wdtype``: the norm's
    weight and bias as stored (the UNet's are bf16), read without a cast."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    c = shape[-1]
    norm = Norm(c, device=cuda, dtype=wdtype)
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
def test_group_norm_kernel_repeats_its_bits(cuda):
    """The merge order of the statistics depends on the shape alone (no float
    atomics): two calls on one input give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    norm = Norm(320, device=cuda, dtype=torch.bfloat16)
    norm.weight.copy_(1.0 + 0.2 * torch.randn(320, generator=g, device=cuda))
    norm.bias.copy_(0.1 * torch.randn(320, generator=g, device=cuda))
    x = (3.0 * torch.randn(1, 25 * 576, 320, generator=g, device=cuda)).to(torch.bfloat16)
    first = nk.group_norm_silu_fused(x, norm, 32, 1e-6)
    second = nk.group_norm_silu_fused(x, norm, 32, 1e-6)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


# (shape, input scale). The kernel's tile is 4 items at F > 16 and 8 at
# F <= 16: L*H = 21, 39 and 33 leave a ragged last tile; B = 2 makes the
# frame map cross a batch boundary; F = 1, 16, 25 and 32; inputs scaled by
# 10 give logits of about a hundred, which overflow exp unless the row max is
# taken over exactly the right keys.
FRAME_CASES = [((1, 25, 576, 20, 64), 1.0), ((2, 3, 40, 2, 64), 1.0), ((1, 32, 9, 1, 64), 1.0),
               ((1, 25, 7, 3, 64), 1.0), ((1, 16, 13, 3, 64), 1.0), ((1, 1, 24, 2, 64), 1.0),
               ((2, 25, 11, 3, 64), 1.0), ((2, 25, 11, 3, 64), 10.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,scale", FRAME_CASES)
def test_frame_attention_kernel_matches_plain(cuda, shape, scale, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    q, k, v = ((scale * torch.randn(shape, generator=g, device=cuda)).to(dtype)
               for _ in range(3))
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
    q = torch.zeros(1, 4, 8, 2, 80, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=80"):
        tak.frame_attention(q, q, q)
    q = torch.zeros(1, 33, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 32 frames"):
        tak.frame_attention(q, q, q)
    q = torch.zeros(1, 16, 1, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d=128"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(2, 24, 8192, device=cuda)
    with pytest.raises(ValueError, match="C <= 4096"):
        nk.group_norm_silu_fused(x, Norm(8192, device=cuda), 32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,l,h", [(1, 600, 3), (8, 640, 16), (1, 5120, 16)])
def test_flash_d72_kernel_matches_plain(cuda, b, l, h, static_max, dtype):
    """DiT-XL's head dim: a ragged 600 keys, the factorized spatial site and
    the joint3d site (8 frames x 640 tokens)."""
    q, k, v = _qkv(cuda, b, l, h, 72, dtype, l + 72)
    before = fa.launches
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,scale", [((1, 8, 640, 16, 72), 1.0), ((2, 3, 40, 2, 72), 1.0),
                                         ((1, 25, 7, 3, 72), 1.0), ((1, 1, 24, 2, 72), 1.0),
                                         ((2, 32, 5, 3, 72), 1.0), ((2, 8, 13, 3, 72), 10.0)])
def test_frame_attention_d72_kernel_matches_plain(cuda, shape, scale, dtype):
    """The factorized DiT-XL's temporal blocks: F = 8, L = 640, 16 heads;
    then ragged tiles, F = 1, 25 and 32, B = 2 and large logits as at d = 64."""
    g = torch.Generator(device=cuda).manual_seed(shape[2] + 72)
    q, k, v = ((scale * torch.randn(shape, generator=g, device=cuda)).to(dtype)
               for _ in range(3))
    before = tak.launches
    got = tak.frame_attention(q, k, v)
    torch.cuda.synchronize()
    assert tak.launches == before + 1
    ref = tak.frame_attention_plain(q, k, v)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _one_rounding_tol(ref), err


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,lq,lk,h", [
    (1, 600, 600, 2),    # neither length a multiple of the 128-row/128-key tiles
    (2, 201, 201, 3),    # one key past a tile
    (1, 50, 50, 2),      # under one tile
    (2, 1000, 70, 2),    # L_q != L_k, the keys under one tile
    (1, 64, 1000, 2),    # L_q != L_k, many key tiles for one short query tile
    (4, 256, 256, 100),  # 800 CTAs: several waves of the card's 132 SMs
])
def test_flash_wgmma_kernel_matches_plain(cuda, d, static_max, b, lq, lk, h):
    """The bf16 wgmma + TMA kernel (head dims 64 and 72) at ragged, short and
    unequal lengths and at a grid of several waves."""
    g = torch.Generator(device=cuda).manual_seed(lq + lk + d)
    q = torch.randn(b, lq, h, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, lk, h, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    before = fa.launches
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[torch.bfloat16] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72])
def test_flash_wgmma_kernel_large_logits(cuda, d):
    """As tests/test_ops.py's static-max cases: with queries x 8 (log2-logits
    up to about 40) both modes match their plain versions and each other;
    with queries x 64 the static clip engages, so the two modes differ, each
    still matching its own plain version and finite."""
    q, k, v = _qkv(cuda, 1, 512, 2, d, torch.bfloat16, d)
    for scale in (8.0, 64.0):
        qs = (q.float() * scale).bfloat16()
        outs = {}
        for static_max in (True, False):
            got = fa.flash_attention(qs, k, v, static_max=static_max).float()
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(qs, k, v, static_max).float()
            top = ref.abs().max().item()
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= TOL[torch.bfloat16] * top, (scale, static_max)
            outs[static_max] = got
        apart = (outs[True] - outs[False]).abs().max().item()
        if scale == 8.0:
            assert apart <= TOL[torch.bfloat16] * top, apart
        else:
            assert apart > 0.1 * top, apart
