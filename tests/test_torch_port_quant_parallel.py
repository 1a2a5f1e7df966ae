"""int8 weights and W8A8 over spawned ranks: the step pipeline, FSDP, and the
seq and frame axes of the tiny SVD UNet (port of the parallel cases of
``tests/test_quant.py``), fp32 on the CPU. The single-process parity with
JAX is ``tests/test_torch_port_quant.py``'s.

What is held, and how closely, all within the port (the one-process run is
the oracle, as in the JAX package's tests):

* two stages over int8 and over W8A8 weights, and FSDP over int8 weights:
  bit for bit;
* the W8A8 ``conv2d_halo`` (the activation scale a max over the seq axis,
  the int8 halo) at stride 1 and 2, and a W8A8 conv whose rows are split
  over a frame axis (the scale a max over it): bit for bit the unsplit conv;
* the W8A8 model over seq 2 and frame 2: the split statistics and gathered
  attention differ from the one-process run at the ulp level, which a
  dynamic quantization can turn into one quantization step, so JAX's bound
  (``tests/test_quant.py::_assert_quant_step_bounded``: relative L2 < 0.06,
  cosine > 0.999).

Every spawned run starts at once in one fixture: a 2-rank gloo group laid out
in turn as 2 stages, seq 2 and frame 2, and a 2-rank data mesh for FSDP.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.ops import conv as tconv
from vdpp_tpu_torch.ops import quant as tq
from vdpp_tpu_torch.parallel.mesh import make_data_mesh, make_pipeline_mesh, run_stages
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.utils.memory import params_bytes_per_device

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

STEPS, F, HW = 4, 4, 16


def _unet(act_int8: bool) -> SVDUNet:
    """The tiny UNet (``random_state_dict``'s weights) in int8, W8A8 with
    ``act_int8``."""
    unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu")
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in helpers.random_state_dict(
        unet, 0, mix_base=0.5).items()})
    return tq.quantize_model(unet, act_int8=act_int8)


def _case(state: dict):
    """``(build, packed inputs)`` of 2 samples, CFG 3, 4 Euler steps."""
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal((1, 1, 48)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((1, F, HW, HW, 4)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 1, F, HW, HW, 4)).astype(np.float32))
    model = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=STEPS, device="cpu")
    build = functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), "euler", STEPS, None,
                              state, make_conditioning(emb, img, F, guidance_scale=3.0))
    return build, noise * model.init_noise_sigma


def _a8_conv() -> tconv.Conv2d:
    conv = tconv.Conv2d(64, 64, 3, device="cpu")
    conv.load_state_dict({k: torch.from_numpy(v) for k, v in helpers.random_state_dict(
        conv, 9).items()})
    return tq.quantize_model(conv, act_int8=True)


def _op(name, layout, op, x, state, **kw):
    return (name, layout, "op", (op, x, state, kw))


@pytest.fixture(scope="module")
def runs():
    int8, w8a8 = _unet(False).state_dict(), _unet(True).state_dict()
    build_q, inputs = _case(int8)
    build_a8, _ = _case(w8a8)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 8, 8, 64))
                         .astype(np.float32))
    conv_state = _a8_conv().state_dict()
    cases = [("stage2_int8", {}, "pipeline", (build_q, inputs, STEPS)),
             ("stage2_w8a8", {}, "pipeline", (build_a8, inputs, STEPS)),
             ("seq2_w8a8", {"seq": 2}, "pipeline", (build_a8, inputs[:1], STEPS)),
             ("frame2_w8a8", {"frame": 2}, "pipeline", (build_a8, inputs[:1], STEPS)),
             _op("halo_stride1", {"seq": 2}, "conv2d_halo", x, conv_state, out=64, stride=1),
             _op("halo_stride2", {"seq": 2}, "conv2d_halo", x, conv_state, out=64, stride=2),
             _op("rows_frame2", {"frame": 2}, "conv2d_rows", x, conv_state, out=64)]
    fsdp = [("fsdp_int8", "fsdp", build_q, inputs[:1], STEPS)]
    with ThreadPoolExecutor(2) as pool:
        intra = pool.submit(run_stages, make_pipeline_mesh(2, device="cpu"),
                            helpers.intra_cases, cases, threads=1, timeout=600)
        data = pool.submit(run_stages, make_data_mesh(2, device="cpu"), helpers.runner_cases,
                           fsdp, threads=1, timeout=600)
        single = {}
        for mode, build in (("int8", build_q), ("w8a8", build_a8)):
            step_fn, params = build("cpu")
            single[mode] = run_reference_single_device(step_fn, params, inputs, STEPS)
        results = intra.result()[-1]
        results.update(data.result()[0])
    return results, single, x, conv_state


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_quantized_pipeline_equals_single_device(runs, mode):
    """Two stages over int8 and over W8A8 weights: bit for bit the
    one-process run of every step (``tests/test_quant.py::test_pipeline_
    runs_quantized``, ``::test_a8_model_forward_close_and_pipeline_oracle_
    equal``), finite."""
    results, single = runs[:2]
    got = results[f"stage2_{mode}"][0]
    assert torch.isfinite(got).all()
    assert torch.equal(got, single[mode])


def test_fsdp_over_int8_equals_single_device(runs):
    """FSDP over the int8 weights (``tests/test_quant.py::test_fsdp_composes_
    with_int8``): the int8 tensors split and gathered by the one rule, bit
    for bit the one-process run; each rank holds less than the int8 model,
    and nothing gathered outlives the run."""
    results, single = runs[:2]
    out, held, still_gathered = results["fsdp_int8"]
    assert torch.equal(out, single["int8"][:1])
    assert held < params_bytes_per_device(_unet(False))
    assert still_gathered == []


@pytest.mark.parametrize("case", ["halo_stride1", "halo_stride2", "rows_frame2"])
def test_w8a8_split_conv_bit_equal_to_unsplit(runs, case):
    """The W8A8 conv under a W split (``conv2d_halo``) at stride 1 and at the
    downsample's stride 2, and under a row (frame) split with the scale's max
    over the frame axis, bit for bit the unsplit conv (``tests/test_quant.py::
    test_a8_conv2d_halo_bitexact_vs_unsharded``, ``::test_a8_conv2d_frame_
    sharded_bitexact``)."""
    results, _, x, state = runs
    conv = tconv.Conv2d(64, 64, 3, device="cpu")
    tq.load_int8_forms(conv, state)
    conv.load_state_dict(state)
    assert tq.is_a8(conv)
    stride = 2 if case == "halo_stride2" else 1
    kw = {"padding": ((1, 1), (1, 1))} if stride == 2 else {}
    assert torch.equal(results[case], tconv.conv2d(x, conv, stride=stride, **kw))


@pytest.mark.parametrize("axis", ["seq2", "frame2"])
def test_w8a8_seq_and_frame_within_quant_step_bound(runs, axis):
    """The W8A8 model over seq 2 and frame 2 (every spatial conv's scale a max
    over both axes) against the one-process W8A8 run: JAX's quantization-step
    bound (``tests/test_quant.py::test_w8a8_model_seq_parallel_quant_
    bounded``, ``::test_w8a8_model_frame_parallel_quant_bounded``)."""
    results, single = runs[:2]
    got = results[f"{axis}_w8a8"][0]
    assert torch.isfinite(got).all()
    helpers.assert_quant_step_bounded(got.numpy(), single["w8a8"][:1].numpy())
