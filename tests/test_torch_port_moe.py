"""The port's MoE feed-forward and expert axis (``vdpp_tpu_torch/ops/moe.py``,
the MoE blocks of ``models/dit.py``) against the JAX package's
(``vdpp_tpu/ops/moe.py``, ``tests/test_moe.py``), fp32 on the CPU.

The same weights on both sides: every leaf of the JAX tree drawn from a
numpy seed (biases off 0, which would hide a misplaced one), carried to the
port by name (the gate transposed to ``(E, D)``, the stacks as they are).

Tolerance: 1e-5, JAX's own for the MoE (``tests/test_moe.py``). The dense
form adds one expert's output and zeros for each token, so every split of
the experts sums to the same bits; within the port the expert-split runs
are held to the one-process run bit for bit. The DiT forwards are held to
1e-4 x max|ref|, as ``tests/test_torch_port_dit.py`` holds the dense DiT.

The expert axis runs over spawned gloo ranks (one 4-rank group, laid out as
expert 2 and expert 4 in turn); JAX's single-device results are computed in
this thread meanwhile.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vdpp_tpu.models import dit as jdit
from vdpp_tpu.ops import moe as jmoe
from vdpp_tpu.ops.quant import quantize_tree

from vdpp_tpu_torch.models import dit as tdit
from vdpp_tpu_torch.ops import moe as tmoe
from vdpp_tpu_torch.ops.quant import int8_forms, load_int8_forms, quantize_model
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
from vdpp_tpu_torch.utils.weights import from_jax_dit_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

DIM, EXPERTS, INNER = 16, 4, 32
TOL = 1e-5
DIT_REL_TOL = 1e-4
# capacity factor -> the dispatch form: None dense, else gather at that factor
DISPATCH = {"dense": None, "gather_full": float(EXPERTS), "gather_2": 2.0, "gather_1": 1.0,
            "gather_quarter": 0.25}


def _moe_params():
    """The JAX MoE tree (numpy leaves) from a numpy seed."""
    rng = np.random.default_rng(0)
    shapes = {"w_in": (EXPERTS, DIM, INNER), "b_in": (EXPERTS, INNER),
              "w_out": (EXPERTS, INNER, DIM), "b_out": (EXPERTS, DIM)}
    p = {k: (rng.standard_normal(s) / (np.sqrt(s[1]) if len(s) == 3 else 10.0)
             ).astype(np.float32) for k, s in shapes.items()}
    p["gate"] = {"w": (rng.standard_normal((DIM, EXPERTS)) / np.sqrt(DIM)).astype(np.float32)}
    return p


def _port_moe(params) -> tmoe.MoEFF:
    m = tmoe.MoEFF(DIM, EXPERTS, INNER, device="cpu")
    m.load_state_dict(_moe_state(params))
    return m


def _moe_state(params) -> dict:
    sd = {"gate.weight": torch.from_numpy(np.asarray(params["gate"]["w"]).T.copy())}
    sd.update({k: torch.from_numpy(np.asarray(params[k])) for k in ("w_in", "b_in", "w_out",
                                                                    "b_out")})
    return sd


PARAMS = _moe_params()
TOKENS = np.random.default_rng(1).standard_normal((2, 12, DIM)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=2)
def _jax_ff_jit(params, x, cf):
    if cf is None:
        return jmoe.moe_ff(params, x, EXPERTS)
    return jmoe.moe_ff_gather(params, x, EXPERTS, capacity_factor=cf)


def _jax_ff(params, cf):
    return np.asarray(_jax_ff_jit(params, jnp.asarray(TOKENS), cf))


def _port_ff(moe, cf, axis=None):
    x = torch.from_numpy(TOKENS)
    if cf is None:
        return tmoe.moe_ff(moe, x, axis)
    return tmoe.moe_ff_gather(moe, x, axis, capacity_factor=cf)


def _int8_pair():
    """The MoE quantized on both sides (every weight, ``min_size=0``, the
    gate too): JAX's tree, the port's state dict."""
    m = _port_moe(PARAMS)
    quantize_model(m, min_size=0)
    return _jax_quantized(PARAMS), m.state_dict()


def _jax_quantized(params):
    """JAX's ``quantize_tree(min_size=0)`` of a numpy tree, run eagerly as the
    JAX benchmark runs it (under ``jit`` the scales need not be the same
    bits)."""
    return quantize_tree(jax.tree_util.tree_map(jnp.asarray, params), min_size=0)


# ---- the expert axis over spawned ranks ---- #


EP_CASES = {  # name: (expert ranks, dispatch, int8)
    "ep2_dense": (2, "dense", False), "ep4_dense": (4, "dense", False),
    "ep2_gather_full": (2, "gather_full", False), "ep4_gather_1": (4, "gather_1", False),
    "ep2_int8": (2, "dense", True), "ep4_int8_gather_2": (4, "gather_2", True),
}


@pytest.fixture(scope="module")
def expert_runs():
    """Each EP_CASES case on a 4-rank gloo group (expert 2 leaves 2 stages of
    2; every rank computes the whole output), the tokens whole on every rank;
    beside it, JAX's single-device result of each."""
    jq, tq_state = _int8_pair()
    cases = [(name, {"expert": n}, "op",
              ("moe", torch.from_numpy(TOKENS), tq_state if q else _moe_state(PARAMS),
               {"experts": EXPERTS, "inner": INNER, "capacity": DISPATCH[d]}))
             for name, (n, d, q) in EP_CASES.items()]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_stages, make_pipeline_mesh(4, device="cpu"),
                            helpers.intra_cases, cases, threads=1, timeout=300)
        jax_out = {name: _jax_ff(jq if q else PARAMS, DISPATCH[d])
                   for name, (n, d, q) in EP_CASES.items()}
        return ranks.result()[-1], jax_out, tq_state


@pytest.mark.parametrize("dispatch", list(DISPATCH))
def test_moe_ff_matches_jax(dispatch):
    """``moe_ff`` and ``moe_ff_gather`` at capacity factors 4 (nothing drops),
    2, 1 and 0.25 against JAX on the same weights and tokens, within 1e-5;
    the tokens that drop (all-zero output rows) are the same on both sides,
    which holds the sort, the capacity and the clamped window to JAX's."""
    cf = DISPATCH[dispatch]
    want = _jax_ff(PARAMS, cf)
    got = _port_ff(_port_moe(PARAMS), cf).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    dropped = lambda a: set(map(tuple, np.argwhere(np.all(a == 0, axis=-1))))  # noqa: E731
    assert dropped(got) == dropped(want)
    if dispatch in ("gather_1", "gather_quarter"):
        assert dropped(want)  # these capacities do drop tokens


def test_gather_equals_dense_at_full_capacity():
    """At a capacity factor of at least the expert count nothing drops and the
    gather form equals the dense one (``tests/test_moe.py::test_gather_
    dispatch_matches_dense_at_full_capacity``); below it, it differs."""
    moe = _port_moe(PARAMS)
    dense = _port_ff(moe, None)
    torch.testing.assert_close(_port_ff(moe, float(EXPERTS)), dense, rtol=TOL, atol=TOL)
    assert not torch.allclose(_port_ff(moe, 0.25), dense)


BF16_D, BF16_I, BF16_L = 256, 1024, 512
BF16_SHARE = 0.01  # of the output elements that may differ, each by one ulp at most
# The ulp of a value under 1/8 is taken at 1/8 (2^-10): such outputs are
# cancellations in the fp32 sums, whose last bits follow the summation order,
# which differs between XLA's dot and the port's.
BF16_ULP_FLOOR = 2.0 ** -3


def _bf16_pair():
    """JAX's bf16 MoE tree and the port's MoEFF holding the same values (the
    stacks N(0, 1) over the square root of their fan-in, the biases a tenth
    of N(0, 1), the fp32 gate over sqrt(D)) and the tokens ``(1, L, D)``,
    unscaled, in bf16."""
    rng = np.random.default_rng(0)
    e, d, i = EXPERTS, BF16_D, BF16_I
    p = {"w_in": rng.standard_normal((e, d, i)) / np.sqrt(d),
         "b_in": 0.1 * rng.standard_normal((e, i)),
         "w_out": rng.standard_normal((e, i, d)) / np.sqrt(i),
         "b_out": 0.1 * rng.standard_normal((e, d))}
    gate = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((1, BF16_L, d)).astype(np.float32)
    jparams = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jparams["gate"] = {"w": jnp.asarray(gate)}
    moe = tmoe.MoEFF(d, e, i, device="cpu", dtype=torch.bfloat16)
    sd = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
          for k, v in jparams.items() if k != "gate"}
    sd["gate.weight"] = torch.from_numpy(gate.T.copy())
    moe.load_state_dict(sd)
    return jparams, moe, x


@pytest.mark.parametrize("dispatch", ["dense", "gather_full"])
def test_bf16_expert_products_match_jax(dispatch):
    """The bf16 MoE against JAX on the same bf16 weights and tokens (D = 256,
    I = 1024, E = 4, L = 512, one torch thread): JAX takes each expert
    product in fp32 (``preferred_element_type``), so a port that rounds the
    product to bf16 before its bias, GELU and combine differs in most
    elements. At most 1 % of the elements may differ, each by at most one
    bf16 ulp of JAX's value (at ``BF16_ULP_FLOOR`` for smaller values)."""
    jparams, moe, x = _bf16_pair()
    cf = DISPATCH[dispatch]
    xj = jnp.asarray(x, jnp.bfloat16)
    if cf is None:
        want = jax.jit(functools.partial(jmoe.moe_ff, num_experts=EXPERTS))(jparams, xj)
    else:
        want = jax.jit(functools.partial(jmoe.moe_ff_gather, num_experts=EXPERTS,
                                         capacity_factor=cf))(jparams, xj)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.inference_mode():
        got = (tmoe.moe_ff(moe, xt) if cf is None
               else tmoe.moe_ff_gather(moe, xt, capacity_factor=cf))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), BF16_ULP_FLOOR))) - 7)
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    share = float(np.mean(diff > 0))
    assert share <= BF16_SHARE, share


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_axis_matches_jax_single_device(expert_runs, case):
    """The experts split over 2 and 4 gloo ranks (each rank keeps its share
    of the stacks, int8 tensors and scales included; one sum over the axis)
    against JAX's single-device result, dense and gather, float and int8
    (``tests/test_moe.py::test_expert_parallel_equals_single_device``,
    ``::test_expert_parallel_composes_with_int8``); bit for bit against the
    port's own one-process run."""
    results, jax_out, tq_state = expert_runs
    n, dispatch, q = EP_CASES[case]
    got = results[case]
    np.testing.assert_allclose(got.numpy(), jax_out[case], rtol=TOL, atol=TOL)
    moe = tmoe.MoEFF(DIM, EXPERTS, INNER, device="cpu")
    if q:
        load_int8_forms(moe, tq_state)
    moe.load_state_dict(tq_state if q else _moe_state(PARAMS))
    assert torch.equal(got, _port_ff(moe, DISPATCH[dispatch]))
    if q:  # int8 changed the math (the quantization took)
        assert not np.allclose(jax_out[case], _jax_ff(PARAMS, DISPATCH[dispatch]))


def _jax_path_name(path) -> str:
    """A JAX leaf path as the port's state-dict name: ``w`` of a linear is
    ``weight``, an int8 leaf ``<name>_q`` / ``_q8`` / ``_scale``."""
    keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
    if keys[-1] in ("q", "q8", "scale"):
        parent = "weight" if keys[-2] == "w" else keys[-2]
        return ".".join(keys[:-2] + [f"{parent}_{keys[-1]}"])
    return ".".join(keys[:-1] + ["weight" if keys[-1] == "w" else keys[-1]])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_shard_keeps_the_leaves_expert_param_spec_targets(int8):
    """``shard_experts`` cuts to E / 2 on their first axis exactly the tensors
    JAX's ``expert_param_spec`` gives ``P(expert)`` in the MoE DiT: the four
    stacks of every MoE block, and under int8 their int8 tensors and
    per-(expert, channel) scales, never a gate (``tests/test_moe.py::
    test_expert_param_spec_targets_expert_leaves``), and leaves every other
    tensor as it was."""
    jcfg = jdit.DiTVideoConfig.moe_tiny()
    params = helpers.dit_jax_params(jcfg, 2)
    model = tdit.DiTVideo(tdit.DiTVideoConfig.moe_tiny(), device="cpu")
    model.load_state_dict(from_jax_dit_params(params))
    if int8:
        params = _jax_quantized(params)
        quantize_model(model, min_size=0)
    spec = jmoe.expert_param_spec(params, "expert")
    want = {_jax_path_name(path) for path, leaf in
            jax.tree_util.tree_flatten_with_path(spec, is_leaf=lambda s: isinstance(s, P))[0]
            if leaf == P("expert")}
    assert want and all(".moe." in k and ".gate." not in k for k in want)
    before = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tmoe.shard_experts(model, Axis("expert", 2, 1, (0, 1), group=None))
    after = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert after.keys() == before.keys()
    assert {k for k in after if after[k] != before[k]} == want
    assert all(after[k] == (before[k][0] // 2, *before[k][1:]) for k in want)


def test_partial_stack_without_axis_raises():
    """A rank's share of the experts used with no expert axis: both packages
    raise, naming the expert count (``tests/test_moe.py::test_gather_
    dispatch_rejects_partial_params_without_axis``)."""
    sliced = dict(PARAMS, w_in=PARAMS["w_in"][:2])
    x = jnp.asarray(TOKENS)
    moe = tmoe.shard_experts(_port_moe(PARAMS), Axis("expert", 2, 0, (0, 1), group=None))
    for run in (lambda: jmoe.moe_ff_gather(sliced, x, EXPERTS),
                lambda: jmoe.moe_ff(sliced, x, EXPERTS),
                lambda: _port_ff(moe, 2.0), lambda: _port_ff(moe, None)):
        with pytest.raises(ValueError, match="all 4 experts"):
            run()


MOE_CFGS = {"joint3d": "moe_tiny",
            # tests/test_moe.py::test_factorized_mode_moe_activates's config
            "factorized": dict(hidden_size=32, depth=8, num_heads=2, cross_attention_dim=16,
                               num_experts=4)}


def _configs(mode: str):
    spec = MOE_CFGS[mode]
    if isinstance(spec, str):
        return getattr(jdit.DiTVideoConfig, spec)(), getattr(tdit.DiTVideoConfig, spec)()
    return (jdit.DiTVideoConfig(**spec, dtype=jnp.float32),
            tdit.DiTVideoConfig(**spec, dtype=torch.float32))


@pytest.mark.parametrize("mode", list(MOE_CFGS))
def test_moe_dit_forward_matches_jax(mode):
    """The MoE DiT's forward against JAX's, joint3d (``moe_tiny``: MoE in
    blocks 1 and 3) and factorized (depth 8: the phase counts the spatial
    blocks, so MoE lands in blocks 2 and 6, not never); the presets' fields
    equal JAX's."""
    jcfg, tcfg = _configs(mode)
    jd = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    assert jd == {k: v for k, v in dataclasses.asdict(tcfg).items() if k != "dtype"}
    params = helpers.dit_jax_params(jcfg, 3)
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(from_jax_dit_params(params))
    want_blocks = [i for i, b in enumerate(params["blocks"]) if "moe" in b]
    assert want_blocks == ([1, 3] if mode == "joint3d" else [2, 6])
    assert [i for i, b in enumerate(model.blocks) if hasattr(b, "moe")] == want_blocks
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 16)).astype(np.float32)
    want = np.asarray(jax.jit(jdit.DiTVideo(jcfg).apply)(params, jnp.asarray(lat), 0.3,
                                                         jnp.asarray(ctx)))
    with torch.inference_mode():
        got = model(torch.from_numpy(lat), 0.3, torch.from_numpy(ctx)).numpy()
    assert np.abs(got - want).max() <= DIT_REL_TOL * np.abs(want).max()


def test_dispatch_switches_are_read_at_init(monkeypatch):
    """``VDPP_MOE_DISPATCH`` and ``VDPP_MOE_CAPACITY`` bind when the wrapper
    is built, as in the reference (``tests/test_moe.py::test_dit_moe_gather_
    dispatch_in_model``): a wrapper built before the switch keeps dense; one
    built after takes gather at capacity 4, equal to dense and to JAX's
    gather wrapper step."""
    jcfg, tcfg = jdit.DiTVideoConfig.moe_tiny(), tdit.DiTVideoConfig.moe_tiny()
    params = helpers.dit_jax_params(jcfg, 5)
    model = tdit.DiTVideo(tcfg, device="cpu")
    model.load_state_dict(from_jax_dit_params(params))
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 2, 16)).astype(np.float32)
    dense_wrapper = tdit.DiTVideoWrapper(tcfg, num_steps=2, device="cpu")
    monkeypatch.setenv("VDPP_MOE_DISPATCH", "gather")
    monkeypatch.setenv("VDPP_MOE_CAPACITY", "4")
    gather_wrapper = tdit.DiTVideoWrapper(tcfg, num_steps=2, device="cpu")
    jax_gather = jdit.DiTVideoWrapper(jcfg, num_steps=2)
    assert (dense_wrapper.moe_dispatch, gather_wrapper.moe_dispatch) == ("dense", "gather")
    assert gather_wrapper.moe_capacity == jax_gather.moe_capacity == 4.0
    with torch.inference_mode():
        dense = dense_wrapper.step(model, torch.from_numpy(lat), 0, torch.from_numpy(ctx))
        gather = gather_wrapper.step(model, torch.from_numpy(lat), 0, torch.from_numpy(ctx))
    torch.testing.assert_close(gather, dense, rtol=TOL, atol=TOL)
    want = np.asarray(jax.jit(lambda p, x, c: jax_gather.step(p, x, 0, c))(
        params, jnp.asarray(lat), jnp.asarray(ctx)))
    assert np.abs(gather.numpy() - want).max() <= DIT_REL_TOL * np.abs(want).max()
    assert int8_forms(model.blocks[1].moe) == {}  # nothing here was quantized
