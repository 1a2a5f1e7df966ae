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

import ctypes
import functools
import math

import pytest
import torch

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
from vdpp_tpu_torch.ops import flash_attention as fa
from vdpp_tpu_torch.ops import norm_kernel as nk
from vdpp_tpu_torch.ops import temporal_attention_kernel as tak
from vdpp_tpu_torch.ops.normalization import Norm
from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

import torch_port_helpers as helpers

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
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches.total() == before + 1
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
    """What the wrapper still refuses: mismatched shapes and dtypes. A head
    dim above 512 and a transposed (B, L, H, D) view, refused before the
    kernels took every head dim and strided operands, now agree with the
    plain version, the view read in place (no copy)."""
    q = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(TypeError, match="bf16 or all fp32"):
        fa.flash_attention(q, q.float(), q)
    g = torch.Generator(device=cuda).manual_seed(640)
    for q in (torch.randn(1, 16, 1, 640, generator=g, device=cuda).to(torch.bfloat16),
              torch.randn(1, 2, 16, 64, generator=g, device=cuda).to(torch.bfloat16)
              .transpose(1, 2)):
        copies = fa.copies
        got = fa.flash_attention(q, q, q)
        torch.cuda.synchronize()
        assert fa.copies == copies
        ref = fa.flash_attention_plain(q, q, q).float()
        err = (got.float() - ref).abs().max().item()
        assert err <= TOL[torch.bfloat16] * ref.abs().max().item(), err


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
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches.total() == before + 1
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
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    rc = lib.vdpp_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), None,
        (ctypes.c_longlong * 9)(*strides), int(dtype == torch.bfloat16), 1, 1, lq, lq, 512,
        int(static_max), 0, fa.LOG2E / math.sqrt(512), torch.cuda.current_stream().cuda_stream)
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
    """Frame counts whose scores outgrow shared memory stay refused, and a
    row count with no 8-aligned chunking (the reference's rule). Flash at
    d = 1024 and GroupNorm at C = 8192, refused before this port took every
    head dim and channel count, now agree with their plain versions."""
    q = torch.zeros(1, 20000, 1, 1, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="frames"):
        tak.frame_attention(q, q, q)
    with pytest.raises(ValueError, match="8-aligned"):
        nk.group_norm_silu_fused(torch.zeros(2, 7, 64, device=cuda), Norm(64, device=cuda), 32)
    g = torch.Generator(device=cuda).manual_seed(1024)
    q = torch.randn(1, 16, 1, 1024, generator=g, device=cuda).to(torch.bfloat16)
    got = fa.flash_attention(q, q, q)
    ref = fa.flash_attention_plain(q, q, q).float()
    assert (got.float() - ref).abs().max().item() <= TOL[torch.bfloat16] * ref.abs().max().item()
    x = torch.randn(2, 24, 8192, generator=g, device=cuda)
    norm = Norm(8192, device=cuda)
    norm.reset_parameters(None)
    got = nk.group_norm_silu_fused(x, norm, 32)
    ref = nk.group_norm_silu_fused_plain(x, norm, 32)
    assert (got - ref).abs().max().item() <= _one_rounding_tol(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,l,h", [(1, 600, 3), (8, 640, 16), (1, 5120, 16)])
def test_flash_d72_kernel_matches_plain(cuda, b, l, h, static_max, dtype):
    """DiT-XL's head dim: a ragged 600 keys, the factorized spatial site and
    the joint3d site (8 frames x 640 tokens)."""
    q, k, v = _qkv(cuda, b, l, h, 72, dtype, l + 72)
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches.total() == before + 1
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
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches.total() == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[torch.bfloat16] * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("b,lq,lk,h", [
    (2, 4608, 9216, 5),   # seq 2, level 0 of SVD-XT at 72x128: local queries, gathered keys
    (2, 1152, 2304, 10),  # seq 2, level 1
    (2, 2304, 9216, 5),   # seq 4, level 0
    (2, 576, 2304, 10),   # seq 4, level 1
    (1, 1001, 2304, 3),   # a ragged local length against whole key tiles
])
def test_flash_wgmma_kernel_at_seq_sharded_lengths(cuda, d, static_max, b, lq, lk, h):
    """The bf16 wgmma + TMA kernel at the (Lq, Lk) that sequence sharding
    gives the UNet's self-attention (Lq = L / shards, Lk = L), and a ragged
    Lq, against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(lq + 3 * lk + d)
    q = torch.randn(b, lq, h, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, lk, h, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches.total() == before + 1
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


def _pipeline_against_single_device(cuda, devices, steps: int, samples: int,
                                    solver: str = "euler", **wrapper_kw) -> None:
    """A small fp32 UNet whose level 0 has 512 tokens at head dim 64, so the
    flash kernel runs, for ``steps`` CFG steps of ``solver`` (and
    ``wrapper_kw``: DeepCache) of ``samples`` samples, one stage process on
    each of ``devices``: the last rank's payloads equal the single-device run
    on ``cuda`` bit for bit (as words: the cache lanes may hold any bits)."""
    cfg = SVDUNetConfig(block_out_channels=(128, 256), num_attention_heads=(2, 4),
                        layers_per_block=1, cross_attention_dim=64, addition_time_embed_dim=8,
                        projection_class_embeddings_input_dim=24, norm_num_groups=8,
                        dtype=torch.float32)
    state = SVDUNet(cfg, device="cpu").init_weights(torch.Generator().manual_seed(0)).state_dict()
    cond = make_dummy_conditioning(torch.Generator().manual_seed(1), 1, 3, 16, 32, cross_dim=64,
                                   guidance_scale=3.0)
    x = 80.0 * torch.randn(samples, 1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(2))
    build = functools.partial(helpers.svd_build, cfg, solver, steps, None, state, cond,
                              **wrapper_kw)
    x = StableVideoUNet(cfg, num_steps=steps, solver=solver, device="cpu",
                        **wrapper_kw).pack_initial(x)
    mesh = make_pipeline_mesh(devices=devices)
    got = run_stages(mesh, helpers.pipeline_cases, [(solver, build, x, steps, False)],
                     timeout=600)[-1][solver]
    step_fn, params = build(cuda)
    fa.launches.clear()
    want = run_reference_single_device(step_fn, params, x.to(cuda), steps)
    # 3 sites at 512 tokens (level 0: 1 down, 2 up; a cache step at split 1
    # runs all three) x 2 CFG forwards a step
    assert fa.launches[64] == 3 * 2 * steps * samples
    assert got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.cpu().view(torch.int32))


@pytest.mark.gpu
def test_step_pipeline_on_a_shared_card_matches_single_device(cuda, monkeypatch):
    """Two stage processes sharing the card over gloo (the hand-off through
    host memory), 2 steps of 2 samples."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    assert make_pipeline_mesh(devices=[cuda, cuda]).host_handoff
    _pipeline_against_single_device(cuda, [cuda, cuda], steps=2, samples=2)


@pytest.mark.gpu
def test_step_pipeline_over_nccl_matches_single_device(cuda, monkeypatch):
    """A stage process on each card (up to 4) over NCCL, the hand-off card
    to card, 4 steps of 3 samples."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("NCCL between stages needs two cards")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [f"cuda:{i}" for i in range(min(count, 4))]
    mesh = make_pipeline_mesh(devices=devices)
    assert mesh.backend == "nccl" and not mesh.host_handoff
    _pipeline_against_single_device(cuda, devices, steps=4, samples=3)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler_a", "dpmpp2m"])
def test_deepcache_pipeline_over_nccl_matches_single_device(cuda, monkeypatch, solver):
    """DeepCache-2 (full and cache steps alternate, so the stages alternate
    too) with euler_a (its noise from the port's generator on each card) or
    dpmpp2m: a stage process on each card (up to 4) over NCCL, the cache
    lanes crossing each hand-off, 4 steps of 3 samples; on one card, two
    ranks sharing it over gloo."""
    count = torch.cuda.device_count()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    devices = [f"cuda:{i}" for i in range(min(count, 4))] if count >= 2 else [cuda, cuda]
    _pipeline_against_single_device(cuda, devices, steps=4, samples=3, solver=solver,
                                    deepcache_interval=2, sampler_seed=11)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static_max", [True, False])
@pytest.mark.parametrize("l", [31, 200, 600])
@pytest.mark.parametrize("d", [8, 16, 24, 33, 40, 80, 128, 136, 200, 256, 264, 320, 504])
def test_flash_generic_kernel_matches_plain(cuda, d, l, static_max, dtype):
    """The generic kernels (every head dim up to 512 without a kernel of its
    own: bf16 on wgmma, fp32 register-tiled), at their routing edges (both
    sides of each width class and of the bf16 switch from one warpgroup's
    columns to two past 256; d = 33 comes in padded rows): ragged lengths, a
    part-filled last key tile, Lq != Lk."""
    q, k, v = _qkv(cuda, 2, l, 3, d, dtype, d + l)
    k, v = k[:, : l - 7].contiguous(), v[:, : l - 7].contiguous()
    before = fa.launches[d]
    got = fa.flash_attention(q, k, v, static_max=static_max)
    torch.cuda.synchronize()
    assert fa.launches[d] == before + 1
    ref = fa.flash_attention_plain(q, k, v, static_max).float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), (err, ref.abs().max().item())


# VDPP_FLASH_EXP=bf16, on inputs whose every row has its largest score at key
# 0, so that the kernel's running max is the plain version's global max from
# the first key tile on and both round the same s - m. fp32 then agrees to
# fp32 sums in other orders, and EXP_TOL_FP32 lies below the flag's own effect
# (about 1e-3 x max|ref| on these inputs), which the test checks. In bf16 the
# flag's effect is about one ulp of the output, so the limit is TOL's; the
# output with the flag must differ from the output without it, and in fewer
# elements from the plain version's with the flag than from its without.
EXP_TOL_FP32 = 1e-4


def _exp_qkv(device, b, l, h, d, dtype, seed):
    q, k, v = _qkv(device, b, l, h, d, torch.float32, seed)
    q[..., 0] = 1.0
    k[..., 0] = 0.0
    k[:, 0] = 0.0
    k[:, 0, :, 0] = 8.0 * math.sqrt(d)  # s_0 = 8 against N(0, 1) scores
    q, k, v = (t.to(dtype) for t in (q, k, v))
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    assert (s[..., 0] > s[..., 1:].amax(dim=-1)).all()
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,l,h", [(16, 600, 3), (64, 600, 3), (64, 2304, 10), (72, 640, 4),
                                   (512, 2560, 1)])
def test_flash_exp_bf16_kernel_matches_plain(cuda, d, l, h, dtype, monkeypatch):
    """``VDPP_FLASH_EXP=bf16`` in running-max mode on every kernel that has
    that mode, held tighter than the flag's own effect in fp32 and changing
    the kernel's output in both types; static max ignores it."""
    monkeypatch.setenv("VDPP_FLASH_EXP", "bf16")
    q, k, v = _exp_qkv(cuda, 1, l, h, d, dtype, d)
    before = fa.exp_bf16_launches[d]
    got = fa.flash_attention(q, k, v, static_max=False)
    torch.cuda.synchronize()
    assert fa.exp_bf16_launches[d] == before + 1
    ref = fa.flash_attention_plain(q, k, v, False, True).float()
    ref_max = ref.abs().max().item()
    tol = EXP_TOL_FP32 if dtype == torch.float32 else TOL[dtype]
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref_max, (err, ref_max)
    assert not torch.equal(got, fa.flash_attention(q, k, v, static_max=False, exp_bf16=False))
    ref_without = fa.flash_attention_plain(q, k, v, False, False)
    if dtype == torch.float32:
        effect = (ref_without.float() - ref).abs().max()
        assert effect.item() > tol * ref_max, (effect.item(), ref_max)
    else:
        off_with = (got != ref.to(dtype)).float().mean().item()
        off_without = (got != ref_without).float().mean().item()
        assert off_with < off_without, (off_with, off_without)
    assert torch.equal(fa.flash_attention(q, k, v, static_max=True),
                       fa.flash_attention(q, k, v, static_max=True, exp_bf16=False))
    assert fa.exp_bf16_launches[d] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 14, 40, 2, 16), (2, 14, 24, 3, 40), (1, 48, 40, 2, 64),
                                   (1, 40, 24, 1, 72), (1, 3, 40, 2, 96), (1, 8, 8, 1, 520),
                                   (1, 25, 24, 2, 33)])
def test_frame_attention_generic_kernel_matches_plain(cuda, shape, dtype):
    """The generic frame-attention kernel: other head dims (with d > 256, a
    second pass of columns), more than 32 frames, and F d odd (in bf16 a
    warp's staged rows are then 2 mod 4 bytes long)."""
    g = torch.Generator(device=cuda).manual_seed(shape[1] + shape[-1])
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = tak.launches
    got = tak.frame_attention(q, k, v)
    torch.cuda.synchronize()
    assert tak.launches == before + 1
    ref = tak.frame_attention_plain(q, k, v)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _one_rounding_tol(ref), err


# ---- int8 (ops/quant.py) and the expert axis (ops/moe.py) on the card ---- #


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 64, 1152), (16, 1152, 4608), (17, 72, 40), (5, 36, 20),
                                   (300, 2880, 320)])
def test_int8_dot_on_the_card_bit_equal_to_the_cpu(cuda, m, k, n):
    """``int8_dot`` (per-row activation quantization, ``torch._int_mm``, the
    two scales) on the card gives the CPU's bits: the int32 product is exact,
    and the divisions and products are IEEE's on both. So does
    ``quantize_weight`` (the benchmark quantizes on the card). Rows of 16 or
    fewer (the timestep MLP at batch 1) and inner or outer extents that 8 does
    not divide are padded with zeros for ``_int_mm``; each call is one
    ``_int_mm``."""
    from vdpp_tpu_torch.ops import quant as tq

    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g) * 3.0
    w = torch.randn(n, k, generator=g) / math.sqrt(k)
    q8, scale = tq.quantize_weight(w)
    on_card = tq.quantize_weight(w.to(cuda))
    assert torch.equal(on_card[0].cpu(), q8) and torch.equal(on_card[1].cpu(), scale)
    want = tq.int8_dot(x, q8, scale)
    before = tq.int_mm_calls
    got = tq.int8_dot(x.to(cuda), q8.to(cuda), scale.to(cuda))
    torch.cuda.synchronize()
    assert tq.int_mm_calls == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_expert_slice_frees_its_memory(cuda):
    """``shard_experts`` leaves a rank of an expert axis of 2 half of each
    stack, int8 tensors and scales included, and the card's allocator gets
    the other half back: what the module holds on the card falls by half the
    stacks' bytes."""
    from vdpp_tpu_torch.ops import moe as tmoe
    from vdpp_tpu_torch.ops import quant as tq
    from vdpp_tpu_torch.parallel.collectives import Axis

    for int8 in (False, True):
        moe = tmoe.MoEFF(1152, 4, 4608, device=cuda, dtype=torch.bfloat16)
        moe.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
        if int8:
            tq.quantize_model(moe)
        stacks = sum(p.numel() * p.element_size() for p in moe._parameters.values())
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda)
        tmoe.shard_experts(moe, Axis("expert", 2, 1, (0, 1), group=None))
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated(cuda)
        assert freed == stacks // 2, (int8, freed, stacks)
        del moe
        torch.cuda.empty_cache()


def _flash_close(got: torch.Tensor, ref: torch.Tensor, dtype) -> None:
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static_max,exp_bf16", [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("d", [520, 640, 768, 1000, 1024, 1536])
def test_flash_wide_kernel_matches_plain(cuda, d, static_max, exp_bf16, dtype):
    """Head dims above 512 (``flash_fwd_wide`` and ``flash_fwd_wide_f32``: O
    in slabs of 512 columns, a CTA a slab, each recomputing the full-width
    scores; 520, 1000 and 1536 end in a ragged slab): a ragged L = 600
    (the last query and key tiles part-filled), B * H = 2, both softmax
    modes and the bf16 exponent (on inputs whose rows peak at key 0, held in
    fp32 to EXP_TOL_FP32 as the other kernels' exponent cases are)."""
    q, k, v = (_exp_qkv if exp_bf16 else _qkv)(cuda, 1, 600, 2, d, dtype, d)
    before, wide = fa.launches[d], fa.variant_launches["wide"]
    got = fa.flash_attention(q, k, v, static_max=static_max, exp_bf16=exp_bf16)
    torch.cuda.synchronize()
    assert fa.launches[d] == before + 1
    assert fa.variant_launches["wide"] == wide + 1
    ref = fa.flash_attention_plain(q, k, v, static_max, exp_bf16).float()
    tol = EXP_TOL_FP32 if exp_bf16 and dtype == torch.float32 else TOL[dtype]
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,l", [(64, torch.bfloat16, 40), (512, torch.float32, 12),
                                       (16, torch.bfloat16, 40), (136, torch.bfloat16, 24),
                                       (24, torch.float32, 24), (520, torch.bfloat16, 12)])
def test_flash_kernels_past_65535_heads(cuda, d, dtype, l):
    """B * H = 65,536 + 70 (past grid y's limit, which the kernels no longer
    use): the wgmma kernel at d = 64, the fp32 d = 512 kernel, the generic
    ones at d = 16 and 136 (bf16) and 24 (fp32) and the one above 512 at
    d = 520, every (b, h) against the plain version."""
    q, k, v = _qkv(cuda, 2, l, 32803, d, dtype, d + 1)
    before = fa.variant_launches["many_heads"]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.variant_launches["many_heads"] == before + 1
    ref = fa.flash_attention_plain(q, k, v)
    for h0 in range(0, 32803, 8192):  # the error per block of heads, the last ones included
        _flash_close(got[:, :, h0:h0 + 8192], ref[:, :, h0:h0 + 8192], dtype)


def _fused_qkv(device, b, l, h, d, dtype, seed):
    """q, k, v as ``VDPP_FUSE_QKV=1`` leaves them: chunks of one (b, l, 3 h d)
    projection, each reshaped to (b, l, h, d) with token stride 3 h d."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * d, generator=g, device=device).to(dtype)
    return [t.reshape(b, l, h, d) for t in qkv.chunk(3, dim=-1)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,l,h", [
    (64, torch.bfloat16, 576, 5),     # the UNet's wgmma kernel
    (72, torch.bfloat16, 640, 16),    # DiT-XL's
    (512, torch.bfloat16, 600, 1),    # the VAE mid-block's, bf16 and fp32
    (512, torch.float32, 600, 1),
    (64, torch.float32, 200, 3),      # fp32 static max, SIMT
    (16, torch.bfloat16, 600, 3),     # the generic kernels: one warpgroup's columns,
    (128, torch.bfloat16, 600, 3),
    (136, torch.bfloat16, 200, 2),
    (264, torch.bfloat16, 200, 2),    # two warpgroups' columns,
    (200, torch.float32, 200, 2),     # fp32
    (640, torch.float32, 200, 2),     # above 512
    (1000, torch.bfloat16, 100, 2),
])
def test_flash_kernel_reads_fused_qkv_in_place(cuda, d, dtype, l, h):
    """The fused projection's strided chunks go to the kernels as they are
    (no copy) and give the bits the contiguous operands give; a view whose
    head dim is strided is copied, counted, and agrees too."""
    q, k, v = _fused_qkv(cuda, 2, l, h, d, dtype, d + l)
    assert not q.is_contiguous()
    copies = fa.copies
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.copies == copies
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    _flash_close(got, fa.flash_attention_plain(q, k, v), dtype)
    wide = torch.cat([q, q], dim=-1)[..., ::2]  # head dim at stride 2
    got = fa.flash_attention(wide, k, v)
    assert fa.copies == copies + 1
    _flash_close(got, fa.flash_attention_plain(wide, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype,shape", [
    (64, torch.bfloat16, (1, 25, 144, 5)),  # the TMA + mma.sync kernel, F = 25
    (72, torch.bfloat16, (2, 8, 40, 4)),    # d = 72, F = 8, two batches
    (64, torch.float32, (1, 14, 24, 3)),    # fp32 SIMT
    (16, torch.bfloat16, (1, 14, 24, 2)),   # the generic kernel
])
def test_frame_attention_reads_fused_qkv_in_place(cuda, d, dtype, shape):
    """temporal_self_attention's fused chunks: (B*F, L, 3C) projected, each
    chunk reshaped to (B, F, L, H, D) with token stride 3 C, read in place
    and bit-equal to the contiguous operands."""
    b, f, l, h = shape
    g = torch.Generator(device=cuda).manual_seed(d + f)
    qkv = torch.randn(b * f, l, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = (t.reshape(b, f, l, h, d) for t in qkv.chunk(3, dim=-1))
    copies = tak.copies
    got = tak.frame_attention(q, k, v)
    torch.cuda.synchronize()
    assert tak.copies == copies
    want = tak.frame_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    ref = tak.frame_attention_plain(q, k, v)
    assert (got.float() - ref.float()).abs().max().item() <= _one_rounding_tol(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", [
    ((2, 576, 5120), 32),    # two tiles of 2560 channels (16 whole groups each)
    ((2, 576, 5120), 512),   # G past 256
    ((1, 1024, 8192), 512),  # two tiles of 4096
    ((2, 64, 8192), 1),      # one group of 8192: each tile holds half of it
    ((70000, 8, 64), 32),    # N past grid y's 65,535
])
def test_group_norm_kernel_past_its_old_limits(cuda, shape, groups, dtype):
    """C > 4096 (channel tiles), G > 256 and N > 65,535 against the plain
    version, bf16 weights as the UNet stores them; the same bits on a second
    call (the merges' order depends on the shape alone)."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1] + groups)
    c = shape[-1]
    norm = Norm(c, device=cuda, dtype=torch.bfloat16)
    norm.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g, device=cuda))
    norm.bias.copy_(0.1 * torch.randn(c, generator=g, device=cuda))
    x = (3.0 * torch.randn(shape, generator=g, device=cuda) + 1.0).to(dtype)
    before, wide = nk.launches, nk.wide_launches
    got = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
    again = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
    torch.cuda.synchronize()
    assert nk.launches == before + 2
    assert nk.wide_launches == wide + 2  # each case passes one of the old limits
    assert torch.equal(got, again)
    ref = nk.group_norm_silu_fused_plain(x, norm, groups, 1e-6)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _one_rounding_tol(ref), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [7, 33, 1003])
def test_flash_kernel_pads_head_dims_off_16_bytes(cuda, d, dtype):
    """A head dim that is no whole number of 16-byte words (here odd) reaches
    the kernels in rows padded with zeros: three copies, counted, and the
    result of the plain version on the unpadded operands."""
    q, k, v = _qkv(cuda, 2, 200, 3, d, dtype, d)
    copies, before = fa.copies, fa.launches[d]
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.copies == copies + 3
    assert fa.launches[d] == before + 1
    _flash_close(got, fa.flash_attention_plain(q, k, v), dtype)
