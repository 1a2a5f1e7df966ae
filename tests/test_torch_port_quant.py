"""The port's int8 weights and W8A8 at the op level (``vdpp_tpu_torch/ops/
quant.py`` and its sites in ``ops/linear.py``, ``ops/conv.py`` and
``ops/attention.py``), on the DiTs, and through the benchmark mode, against
the JAX package's (``vdpp_tpu/ops/quant.py``, ``tests/test_quant.py``), fp32
on the CPU.

What is held, and how closely:

* ``quantize_model`` against ``quantize_tree`` on the tiny DiT and
  ``moe_tiny``: the same tensors quantized, the same W8A8 marks, the int8
  values and scales bit for bit (the port's layouts turned back to JAX's by
  ``from_jax_dit_params``). JAX's ``quantize_tree`` runs eagerly, as its
  benchmark runs it (under ``jit`` XLA may turn ``amax / 127`` into a
  product with the reciprocal, which is not the same bits).
* ``quantize_activation`` and ``int8_dot``: bit for bit (the int32 product
  is exact; the scales are the same divisions and products in one order).
  So are a W8A8 linear and a W8A8 conv at equal inputs; a weight-only one is
  held within fp32 summation order (1e-6 for a linear, 1e-5 for a conv).

The SVD UNet's quantization and forwards are ``tests/test_torch_port_quant_
model.py``'s, the runs over spawned ranks ``tests/test_torch_port_quant_
parallel.py``'s.
"""

import functools
import logging
import logging.handlers

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models import dit as jdit
from vdpp_tpu.modes import benchmark as jax_bench
from vdpp_tpu.ops import conv as jconv
from vdpp_tpu.ops import quant as jq
from vdpp_tpu.ops.attention import _qkv_fused as jax_qkv_fused
from vdpp_tpu.ops.linear import linear as jax_linear

from vdpp_tpu_torch.models import dit as tdit
from vdpp_tpu_torch.modes import benchmark
from vdpp_tpu_torch.ops import attention as tattn
from vdpp_tpu_torch.ops import conv as tconv
from vdpp_tpu_torch.ops import quant as tq
from vdpp_tpu_torch.ops.linear import Linear
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.utils.weights import from_jax_dit_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

QUANT_KW = {"weight_only": {}, "w8a8": {"act_int8": True},
            "w8a8_min256": {"act_int8": True, "min_size": 256},
            "w8a8_linears": {"act_int8": True, "a8_convs": False}}


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@functools.cache
def _dit_params(preset: str):
    return helpers.dit_jax_params(getattr(jdit.DiTVideoConfig, preset)(), 1)


@pytest.mark.parametrize("mode", list(QUANT_KW))
@pytest.mark.parametrize("preset", ["tiny", "moe_tiny"])
def test_quantize_model_matches_quantize_tree(preset, mode):
    """The tensors ``quantize_tree`` quantizes (its ``w``, ``w_in`` and
    ``w_out`` leaves of at least ``min_size`` elements: at the defaults the
    32-wide DiTs' small gates and heads stay float), the ``q8`` marks (none:
    a mark needs 64 or more channels each way, and never goes on an MoE
    stack), and each int8 tensor and scale, bit for bit."""
    params = _dit_params(preset)
    jqp = jq.quantize_tree(jax.tree_util.tree_map(jnp.asarray, params), **QUANT_KW[mode])
    port = tdit.DiTVideo(getattr(tdit.DiTVideoConfig, preset)(), device="cpu")
    port.load_state_dict(from_jax_dit_params(params))
    tq.quantize_model(port, **QUANT_KW[mode])
    forms = helpers.assert_quantized_like_jax(port, jax.tree_util.tree_map(np.asarray, jqp),
                                              from_jax_dit_params)
    assert forms["q"] and not forms["q8"]  # 32 wide: no site has 64 channels each way


def test_quantize_activation_and_int8_dot_bit_equal():
    """Per-row and per-tensor activation quantization (a zero row and a zero
    tensor get scale 1) and ``int8_dot`` against JAX, bit for bit
    (``tests/test_quant.py::test_int8_dot_matches_manual``)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 96)) * 3.0).astype(np.float32)
    x[1, 2] = 0.0
    for per_row in (True, False):
        for arr in (x, np.zeros_like(x)):
            jqx, js = jq.quantize_activation(jnp.asarray(arr), per_row=per_row)
            tqx, ts = tq.quantize_activation(torch.from_numpy(arr), per_row=per_row)
            np.testing.assert_array_equal(_np(tqx), np.asarray(jqx))
            np.testing.assert_array_equal(_np(ts), np.asarray(js))
    w = (rng.standard_normal((96, 72)) / 10).astype(np.float32)  # JAX's (in, out)
    jw = jq.quantize_weight(jnp.asarray(w), a8=True)
    q8, scale = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(_np(q8), np.asarray(jw["q8"]).T)
    np.testing.assert_array_equal(_np(scale).reshape(-1), np.asarray(jw["scale"]))
    before = tq.int_mm_calls
    got = tq.int8_dot(torch.from_numpy(x), q8, scale)
    assert tq.int_mm_calls == before + 1
    np.testing.assert_array_equal(_np(got), np.asarray(jq.int8_dot(jnp.asarray(x), jw)))


@pytest.mark.parametrize("form", ["q", "q8"])
def test_linear_dispatch_matches_jax(form):
    """A Linear holding an int8 weight against JAX's ``linear`` on the same
    quantized dict: weight-only (dequantized, then the float product) within
    1e-6; W8A8 (the int8 product) bit for bit."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((64, 80)) / 8).astype(np.float32)
    b = (rng.standard_normal(80) / 10).astype(np.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jp = {"w": jq.quantize_weight(jnp.asarray(w), a8=form == "q8"), "b": jnp.asarray(b)}
    lin = Linear(64, 80, device="cpu")
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()), "bias": torch.from_numpy(b)})
    tq.quantize_model(lin, min_size=0, act_int8=form == "q8")
    assert tq.int8_forms(lin) == {"weight": form}
    want = np.asarray(jax_linear(jnp.asarray(x), jp))
    got = lin(torch.from_numpy(x)).numpy()
    if form == "q8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


CONV_CASES = {  # name: (kernel, stride, padding, hw, in, out)
    "3x3_same": (3, 1, "SAME", 9, 64, 64),
    "3x3_stride2_explicit": (3, 2, ((1, 1), (1, 1)), 8, 64, 96),
    "3x3_stride2_same": (3, 2, "SAME", 12, 64, 64),
    "1x1_shortcut": (1, 1, "SAME", 8, 96, 64),
}


def _conv_pair(kernel, cin, cout, seed, a8=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((kernel, kernel, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) / 10).astype(np.float32)
    conv = tconv.Conv2d(cin, cout, kernel, device="cpu")
    conv.load_state_dict({"weight": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                          "bias": torch.from_numpy(b)})
    tq.quantize_model(conv, min_size=0, act_int8=a8)
    return {"w": jq.quantize_weight(jnp.asarray(w), a8=a8), "b": jnp.asarray(b)}, conv


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_a8_conv_matches_jax(case):
    """The W8A8 conv (one activation scale a tensor, im2col in (row, column,
    channel) order, the int8 product) against JAX's ``_conv2d_int8``, bit for
    bit, at stride 1 and 2, SAME and explicit padding, odd and even sizes and
    the 1x1 shortcut; the weight-only conv within 1e-5 (fp32 sums of up to
    864 products in two orders)."""
    k, stride, padding, hw, cin, cout = CONV_CASES[case]
    x = np.random.default_rng(4).standard_normal((2, hw, hw, cin)).astype(np.float32)
    for a8 in (True, False):
        jp, conv = _conv_pair(k, cin, cout, 5, a8)
        want = np.asarray(jconv.conv2d(jnp.asarray(x), jp, stride=stride, padding=padding))
        got = tconv.conv2d(torch.from_numpy(x), conv, stride=stride, padding=padding).numpy()
        if a8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_a8_conv_geometry_exact_against_float_conv():
    """Integer-valued activations and weights whose amax is 127 quantize
    losslessly, so the W8A8 conv equals the float conv exactly (``tests/
    test_quant.py::test_a8_conv_geometry_exact_against_float_conv``): the
    patch order, the padding split and the stride grid."""
    rng = np.random.default_rng(6)
    for stride, hw in [(1, 9), (1, 8), (2, 8), (2, 12)]:
        x = rng.integers(-127, 128, (2, hw, hw, 64)).astype(np.float32)
        x.reshape(-1)[0] = 127.0
        w = rng.integers(-127, 128, (64, 64, 3, 3)).astype(np.float32)
        w[:, 0, 0, 0] = 127.0
        b = rng.standard_normal(64).astype(np.float32)
        ref = tconv.Conv2d(64, 64, 3, device="cpu")
        ref.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
        conv = tconv.Conv2d(64, 64, 3, device="cpu")
        conv.load_state_dict(ref.state_dict())
        tq.quantize_model(conv, min_size=0, act_int8=True)
        xt = torch.from_numpy(x)
        assert torch.equal(tconv.conv2d(xt, conv, stride=stride),
                           tconv.conv2d(xt, ref, stride=stride)), (stride, hw)


def test_temporal_a8_refused_and_fused_qkv_declines_int8(monkeypatch):
    """A hand-made W8A8 mark on a temporal conv is refused by both packages
    rather than dequantized (``vdpp_tpu/ops/conv.py:239-250``, ``:278-287``);
    ``VDPP_FUSE_QKV=1`` falls back to the three projections when one is
    held in int8, as JAX's ``_qkv_fused`` returns None there, so the
    attention equals the unfused one bit for bit."""
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((3, 1, 1, 64, 64)) / 14).astype(np.float32)
    jp = {"w": jq.quantize_weight(jnp.asarray(w), a8=True), "b": jnp.zeros(64)}
    tc = tconv.ConvTemporal(64, 64, 3, device="cpu")
    tc.load_state_dict({"weight": torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()),
                        "bias": torch.zeros(64)})
    q, scale = tq.quantize_weight(tc.weight.detach())
    tq.set_int8(tc, "weight", q, scale, "q8")
    x = torch.zeros(1, 4, 2, 2, 64)
    axis = Axis("frame", 2, 0, (0, 1), group=None)
    for run in (lambda: jconv.conv_temporal(jnp.asarray(x.numpy()), jp),
                lambda: jconv.conv_temporal_halo(jnp.asarray(x.numpy()), jp, "frame"),
                lambda: tconv.conv_temporal(x, tc),
                lambda: tconv.conv_temporal_halo(x, tc, axis)):
        with pytest.raises(NotImplementedError, match="a8"):
            run()

    attn = tattn.Attention(64, qkv_bias=True, device="cpu")
    for name, t in attn.state_dict().items():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) / 8))
    tq.quantize_model(attn.to_q, min_size=0)
    xa = torch.from_numpy(rng.standard_normal((1, 6, 64)).astype(np.float32))
    monkeypatch.setenv("VDPP_FUSE_QKV", "1")
    fused_flag = tattn.attention(xa, attn, heads=4)
    monkeypatch.setenv("VDPP_FUSE_QKV", "0")
    assert torch.equal(fused_flag, tattn.attention(xa, attn, heads=4))
    jparams = {"to_q": {"w": jq.quantize_weight(jnp.ones((64, 64))), "b": jnp.zeros(64)},
               "to_k": {"w": jnp.ones((64, 64)), "b": jnp.zeros(64)},
               "to_v": {"w": jnp.ones((64, 64)), "b": jnp.zeros(64)}}
    assert jax_qkv_fused(jnp.zeros((1, 6, 64)), jparams) is None


SVD_TINY = ["--device", "cpu", "--model", "svd_tiny", "--guidance-scale", "3", "--num-stages",
            "1", "--total-steps", "2", "--num-samples", "1", "--warmup-samples", "0",
            "--latent-shape", "1", "4", "2", "16", "16"]


@functools.cache
def _float_record() -> dict:
    """The ``BENCHMARK_JSON`` record of the same run without int8."""
    records: list = []
    saved = benchmark.emit_benchmark_json
    benchmark.emit_benchmark_json = records.append
    try:
        assert benchmark.main(SVD_TINY) == 0
    finally:
        benchmark.emit_benchmark_json = saved
    return records[0]


@pytest.mark.parametrize("flag", ["--weights-int8", "--weights-w8a8"])
def test_benchmark_cli_int8_flags(flag):
    """``modes.benchmark.main`` with the int8 flags (one stage, in this
    process): the JAX log line ``int8 weights[ + a8 activations]: X -> Y MB of
    parameters`` with Y about a quarter of X (fp32 -> int8 and fp32 scales),
    and a ``BENCHMARK_JSON`` line with the float run's keys. The dummy model
    is refused with JAX's message (one check for both flags)."""
    records: list = []
    saved = benchmark.emit_benchmark_json
    benchmark.emit_benchmark_json = records.append
    log = logging.handlers.BufferingHandler(100)
    benchmark.LOGGER.addHandler(log)
    try:
        assert benchmark.main(SVD_TINY + [flag]) == 0
    finally:
        benchmark.emit_benchmark_json = saved
        benchmark.LOGGER.removeHandler(log)
    (line,) = [r.getMessage() for r in log.buffer if "int8 weights" in r.getMessage()]
    assert ("a8 activations" in line) == (flag == "--weights-w8a8")
    before, after = (float(v) for v in line.split(": ")[1].split(" MB")[0].split(" -> "))
    assert 0.2 * before < after < 0.35 * before
    (quantized,) = records
    assert quantized.keys() == _float_record().keys()
    assert quantized["mode"] == "pipeline" and quantized["avg_sample_time_s"] > 0
    if flag == "--weights-int8":  # both flags meet the one check
        return
    with pytest.raises(SystemExit) as want:
        jax_bench.main(["--backend", "cpu", "--model", "dummy", flag])
    with pytest.raises(SystemExit) as got:
        benchmark.main(["--device", "cpu", "--model", "dummy", flag])
    assert str(got.value) == str(want.value)
