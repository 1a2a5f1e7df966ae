"""The MoE DiT's expert axis through the step pipeline and the benchmark mode
(``StepPipeline(param_spec=ops.moe.expert_layout)``,
``modes.benchmark --model dit3d_moe_tiny --expert-parallel 2``) against the
JAX package's (``tests/test_moe.py``, ``tests/test_modes.py``), fp32 on the
CPU.

``moe_tiny`` (joint3d, 4 experts in blocks 1 and 3) holds the same weights
on both sides, every leaf of the JAX tree drawn from a numpy seed and
carried over by ``from_jax_dit_params``; a CFG ramp to 5 over 4 frames of an
8x8 latent, as JAX's tests run it. JAX's oracle is its single-device run of
every step.

Tolerances, JAX's own: the (stage 2, expert 2) pipeline within 2e-5; the
(stage 2, seq 2, expert 2) mesh, where the token split reorders attention's
sums and top-1 routing may flip a near-tied token, more than 99 % of the
elements within 2e-5 and all within 1e-2.

Every spawned run starts at once in one fixture (a 4- and an 8-rank gloo
group, and the benchmark's 4 ranks); JAX's oracles run meanwhile in this
thread.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models import dit as jdit
from vdpp_tpu.models.svd_wrapper import make_guidance_ramp as jax_ramp
from vdpp_tpu.parallel.pipeline import run_reference_single_device as jax_run

from vdpp_tpu_torch.modes import benchmark
from vdpp_tpu_torch.models import dit as tdit
from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
from vdpp_tpu_torch.ops.moe import MoEFF
from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
from vdpp_tpu_torch.utils.weights import from_jax_dit_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

B, F, H, W, GUIDANCE = 1, 4, 8, 8, 5.0
STEPS = 4
CASES = {"stage2_expert2": {"expert": 2}, "stage2_seq2_expert2": {"seq": 2, "expert": 2}}
BENCH = ["--device", "cpu", "--model", "dit3d_moe_tiny", "--expert-parallel", "2",
         "--guidance-scale", "5.0", "--num-stages", "2", "--total-steps", "4",
         "--num-samples", "2", "--warmup-samples", "0", "--latent-shape", "1", "4", "4", "16",
         "16"]


@functools.cache
def _draws():
    """``(JAX params, port state dict, context, noise (2, B, F, H, W, 4) x
    init sigma)`` from numpy seeds."""
    jcfg = jdit.DiTVideoConfig.moe_tiny()
    params = helpers.dit_jax_params(jcfg, 8)
    rng = np.random.default_rng(9)
    ctx = rng.standard_normal((B, 2, 16)).astype(np.float32)
    sigma = jdit.DiTVideoWrapper(jcfg, num_steps=STEPS).init_noise_sigma
    noise = rng.standard_normal((2, B, F, H, W, 4)).astype(np.float32) * sigma
    return params, from_jax_dit_params(params), ctx, noise


def jax_oracle() -> np.ndarray:
    params, _, ctx, noise = _draws()
    wrapper = jdit.DiTVideoWrapper(jdit.DiTVideoConfig.moe_tiny(), num_steps=STEPS)
    step = jax.jit(wrapper.pipeline_step_fn())
    bundle = (params, jnp.asarray(ctx), jax_ramp(GUIDANCE, F))
    return np.asarray(jax_run(step, bundle, jnp.asarray(noise), STEPS))


def _case(name: str):
    _, state, ctx, noise = _draws()
    build = functools.partial(helpers.dit_build, tdit.DiTVideoConfig.moe_tiny(), STEPS, state,
                              torch.from_numpy(ctx), make_guidance_ramp(GUIDANCE, F))
    return (name, CASES[name], "pipeline", (build, torch.from_numpy(noise), STEPS))


@pytest.fixture(scope="module")
def runs():
    records: list = []
    saved = benchmark.emit_benchmark_json
    benchmark.emit_benchmark_json = records.append
    try:
        with ThreadPoolExecutor(3) as pool:
            spawned = {n: pool.submit(run_stages, make_pipeline_mesh(4 * len(CASES[n]),
                                                                     device="cpu"),
                                      helpers.intra_cases, [_case(n)], threads=1, timeout=600)
                       for n in CASES}
            bench = pool.submit(benchmark.main, BENCH)
            oracle = jax_oracle()
            results = {n: f.result()[-1][n] for n, f in spawned.items()}
            assert bench.result() == 0
    finally:
        benchmark.emit_benchmark_json = saved
    return results, oracle, records


def test_stage_x_expert_matches_jax_oracle(runs):
    """A (stage 2, expert 2) mesh of 4 ranks through ``StepPipeline`` with the
    expert layout, 2 samples of 4 steps, against JAX's single-device oracle
    within 2e-5 (``tests/test_moe.py::test_dit_moe_pipeline_on_stage_x_
    expert_mesh``); each MoE block's output is one sum over the axis (two
    MoE blocks, two forwards a step, two steps a stage, two samples), and the
    last rank holds half of each expert stack."""
    results, oracle, _ = runs
    got, counts, held = results["stage2_expert2"]
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-5, atol=2e-5)
    assert counts == {"sum": 2 * 2 * 2 * 2}
    full = tdit.DiTVideo(tdit.DiTVideoConfig.moe_tiny(), device="meta")
    stacks = sum(p.numel() * p.element_size() for m in full.modules() if isinstance(m, MoEFF)
                 for p in m._parameters.values())
    total = sum(p.numel() * p.element_size() for p in full.parameters())
    assert held == total - stacks // 2


def test_stage_x_seq_x_expert_within_jax_bound(runs):
    """The (stage 2, seq 2, expert 2) mesh of 8 ranks, 2 samples of 4 steps
    (``tests/test_moe.py::test_dit_moe_pipeline_seq_and_expert_axes``): top-1
    routing is discontinuous and the token split reorders attention's sums,
    so JAX's bound: more than 99 % of the elements within 2e-5 of its
    oracle, every one within 1e-2."""
    results, oracle, _ = runs
    got, counts, _ = results["stage2_seq2_expert2"]
    out, ref = got.numpy(), oracle
    close = np.isclose(out, ref, rtol=2e-5, atol=2e-5)
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    assert counts["sum"] and counts["all_gather"]


def test_benchmark_cli_expert_parallel_contract(runs):
    """``modes.benchmark.main --model dit3d_moe_tiny --expert-parallel 2
    --num-stages 2``: the mode ``pipeline_x_ep2``, ``world_size`` counting
    the stages only (``tests/test_modes.py::test_benchmark_expert_parallel_
    contract``), a peak per rank; ``--expert-parallel`` on a model without
    experts exits naming MoE, as JAX's does (``::test_benchmark_expert_
    parallel_needs_moe_model``)."""
    _, _, records = runs
    (res,) = records
    assert res["mode"] == "pipeline_x_ep2" and res["model"] == "dit3d_moe_tiny"
    assert res["world_size"] == 2 and res["steps_per_gpu"] == 2
    assert len(res["peak_memory_gb_per_rank"]) == 4 and res["avg_sample_time_s"] > 0
    with pytest.raises(SystemExit, match="MoE"):
        benchmark.main(["--device", "cpu", "--model", "dit3d_tiny", "--expert-parallel", "2",
                        "--num-stages", "2", "--total-steps", "4"])
