"""The port's data-parallel baseline, FSDP and (stage, data) pipeline
(``vdpp_tpu_torch.parallel.data_parallel``, ``.sharding``, ``.mesh``), one
process per rank over gloo on the CPU, against the JAX package's
(``vdpp_tpu.parallel.data_parallel``, ``.sharding``, ``.pipeline`` on the
conftest's host devices), with ``tests/test_data_parallel.py`` as the model.

Tolerances: against JAX's runners and pipeline, ``rtol = atol = 2e-5`` as
``tests/test_data_parallel.py`` holds them to its oracle (fp32, convolutions
summed in other orders); within the port, bit for bit against the
single-device run (the same ops at one thread: FSDP's gathers are exact
copies, and data parallelism and the 2-D pipeline only move samples).
Sharding choices and bytes are integers and equal exactly.

Every spawning run starts at once in one fixture, beside the JAX runners: a
2-rank data mesh running the data-parallel and FSDP cases and a 2 x 2
(stage, data) mesh running the pipeline cases.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vdpp_tpu.models.dummy_unet import DummyUNet as JaxDummy
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning
from vdpp_tpu.parallel.data_parallel import DataParallelRunner as JaxDP
from vdpp_tpu.parallel.data_parallel import FSDPRunner as JaxFSDP
from vdpp_tpu.parallel.mesh import make_2d_mesh as jax_2d_mesh
from vdpp_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from vdpp_tpu.parallel.pipeline import PipelineConfig as JaxConfigP
from vdpp_tpu.parallel.pipeline import StepPipeline as JaxPipeline
from vdpp_tpu.parallel.sharding import fsdp_specs as jax_fsdp_specs
from vdpp_tpu.parallel.sharding import leaf_spec as jax_leaf_spec
from vdpp_tpu.parallel.sharding import sharded_size_bytes as jax_sharded_size_bytes
from vdpp_tpu.utils.weights import convert_unet_state_dict

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import make_conditioning
from vdpp_tpu_torch.parallel import mesh as tmesh
from vdpp_tpu_torch.parallel.data_parallel import DataParallelRunner, FSDPRunner
from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device
from vdpp_tpu_torch.parallel.sharding import (
    DEFAULT_MIN_SHARD_PARAMS,
    leaf_spec,
    sharded_size_bytes,
)
from vdpp_tpu_torch.utils.memory import params_bytes_per_device
from vdpp_tpu_torch.utils.weights import from_jax_dummy_params, from_jax_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

TOTAL_STEPS = 6  # tests/test_data_parallel.py's
LATENT = (1, 8, 2, 8, 8)
MODEL_KW = dict(channels=8, hidden_channels=16)
SVD_STEPS, SVD_F, SVD_HW = 2, 2, 8
PIPE_STEPS = 4


def _dummy_weights():
    """The JAX DummyUNet's parameters from a numpy seed and the port's state
    dict of the same weights."""
    rng = np.random.default_rng(3)
    c, h = MODEL_KW["channels"], MODEL_KW["hidden_channels"]

    def conv(out_ch, in_ch):
        bound = 1.0 / np.sqrt(in_ch * 27)
        return {"w": rng.uniform(-bound, bound, (out_ch, in_ch, 3, 3, 3)).astype(np.float32),
                "b": rng.uniform(-bound, bound, out_ch).astype(np.float32)}

    params = {"conv1": conv(h, c), "conv2": conv(c, h),
              "ln": {"w": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}}
    return params, from_jax_dummy_params(params)


def _svd_weights():
    """JAX's tiny UNet parameters and the port's state dict of the same
    weights (diffusers names drawn from a numpy seed, through each package's
    converter)."""
    sd = helpers.random_state_dict(SVDUNet(SVDUNetConfig.tiny(), device="cpu"), 4,
                                   mix_base=0.5)
    params = jax.tree_util.tree_map(np.asarray, convert_unet_state_dict(
        sd, num_levels=2, layers_per_block=1, dtype=jnp.float32))
    return params, from_jax_params(params)


def _svd_inputs():
    """(conditioning image embedding, image latents, noise for 2 samples)."""
    rng = np.random.default_rng(6)
    return (rng.standard_normal((1, 1, 48)).astype(np.float32),
            rng.standard_normal((1, SVD_F, SVD_HW, SVD_HW, 4)).astype(np.float32),
            rng.standard_normal((2, 1, SVD_F, SVD_HW, SVD_HW, 4)).astype(np.float32))


def _dummy_inputs(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *LATENT)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return {"dummy": _dummy_weights(), "svd": _svd_weights()}


def _port_case(weights, model: str):
    """(build, inputs, total steps) of a model on the port's side."""
    if model == "dummy":
        return (functools.partial(helpers.dummy_build, MODEL_KW, weights["dummy"][1]),
                torch.from_numpy(_dummy_inputs(1, 4)), TOTAL_STEPS)
    emb, img, noise = _svd_inputs()
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), SVD_F,
                             guidance_scale=3.0)
    return (functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), "euler", SVD_STEPS, None,
                              weights["svd"][1], cond),
            torch.from_numpy(noise), SVD_STEPS)


def _jax_runs(weights) -> dict:
    """JAX's data-parallel and FSDP runners on both models at D = 2, and its
    2 x 2 (stage, data) pipeline on the dummy. JAX's FSDP runner keeps its
    default threshold on the tiny UNet (every leaf under it, so replicated):
    its program with every leaf sharded takes twice as long to compile, and
    sharding does not change what it computes."""
    dummy = JaxDummy(**MODEL_KW)
    step = lambda p, x, s: dummy.apply(p, x, s)  # noqa: E731
    params = weights["dummy"][0]
    x = jnp.asarray(_dummy_inputs(1, 4))
    out = {"dummy_dp": JaxDP(jax_data_mesh(2), step, TOTAL_STEPS).run(params, x),
           "dummy_fsdp": JaxFSDP(jax_data_mesh(2), step, TOTAL_STEPS,
                                 min_shard_params=0).run(params, x[:2])}
    pipe = JaxPipeline(jax_2d_mesh(2, 2), step, JaxConfigP(PIPE_STEPS, 2))
    out["pipeline"] = pipe.run(params, jnp.asarray(_dummy_inputs(2, 4)))
    emb, img, noise = _svd_inputs()
    svd = JaxSVD(JaxConfig.tiny(), num_steps=SVD_STEPS)
    cond = jax_conditioning(jnp.asarray(emb), jnp.asarray(img), SVD_F, guidance_scale=3.0)
    bundle = (weights["svd"][0], cond)
    out["svd_dp"] = JaxDP(jax_data_mesh(2), svd.pipeline_step_fn(), SVD_STEPS).run(
        bundle, jnp.asarray(noise))
    out["svd_fsdp"] = JaxFSDP(jax_data_mesh(2), svd.pipeline_step_fn(), SVD_STEPS).run(
        bundle, jnp.asarray(noise))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(weights):
    """The spawned groups, started together beside the JAX runs: a data mesh
    of 2 ranks with the data-parallel and FSDP cases of both models, and a
    2 x 2 (stage, data) mesh with the dummy's pipeline cases. Returns
    ``{"data": [per rank], "grid": [per rank], "jax": {...}}``."""
    data_cases = [(f"{m}_{kind}", kind, *_port_case(weights, m))
                  for m in ("dummy", "svd") for kind in ("dp", "fsdp")]
    data_cases = [(n, k, b, x[:2] if k == "fsdp" else x, t) for n, k, b, x, t in data_cases]
    build = functools.partial(helpers.dummy_build, MODEL_KW, weights["dummy"][1])
    pipe_inputs = torch.from_numpy(_dummy_inputs(2, 4))
    grid_cases = [("pipeline", "pipeline", build, pipe_inputs, PIPE_STEPS),
                  ("ticked", "ticked", build, pipe_inputs, PIPE_STEPS)]
    with ThreadPoolExecutor(3) as pool:
        data = pool.submit(tmesh.run_stages, tmesh.make_data_mesh(2, device="cpu"),
                           helpers.runner_cases, data_cases, timeout=300)
        grid = pool.submit(tmesh.run_stages, tmesh.make_2d_mesh(2, 2, device="cpu"),
                           helpers.runner_cases, grid_cases, timeout=300)
        jax_out = pool.submit(_jax_runs, weights)
        return {"data": data.result(), "grid": grid.result(), "jax": jax_out.result()}


def _single_device(weights, model: str, n: int) -> torch.Tensor:
    build, inputs, total = _port_case(weights, model)
    step_fn, params = build("cpu")
    return run_reference_single_device(step_fn, params, inputs[:n], total)


@pytest.mark.parametrize("model", ["dummy", "svd"])
def test_data_parallel_matches_jax_and_single_device(weights, ranks, model):
    """Each rank's block, in rank order, is the single-device run bit for bit
    and JAX's DataParallelRunner within 2e-5 (the svd_tiny case with a CFG
    ramp to 3)."""
    got = torch.cat([r[f"{model}_dp"] for r in ranks["data"]])
    n = 4 if model == "dummy" else 2
    assert got.shape[0] == n
    assert torch.equal(got, _single_device(weights, model, n))
    np.testing.assert_allclose(got.numpy(), ranks["jax"][f"{model}_dp"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("model", ["dummy", "svd"])
def test_fsdp_matches_jax_and_single_device(weights, ranks, model):
    """Every rank's FSDP output is the single-device run bit for bit and JAX's
    FSDPRunner within 2e-5; each rank holds only its shards (half the bytes
    of every sharded tensor), and no gathered tensor outlives the run."""
    want = _single_device(weights, model, 2)
    state = weights[model][1]
    total = sum(t.numel() * t.element_size() for t in state.values())
    specs = {k: leaf_spec(tuple(t.shape), 2, 0) for k, t in state.items()}
    for out, held_bytes, held in (r[f"{model}_fsdp"] for r in ranks["data"]):
        assert torch.equal(out, want)
        np.testing.assert_allclose(out.numpy(), ranks["jax"][f"{model}_fsdp"], rtol=2e-5,
                                   atol=2e-5)
        assert held == []
        assert held_bytes == sharded_size_bytes(state, specs, 2) < total


def test_data_parallel_rejects_indivisible(weights):
    step_fn, params = helpers.dummy_build(MODEL_KW, weights["dummy"][1], "cpu")
    runner = DataParallelRunner(tmesh.Stage(tmesh.make_data_mesh(2, device="cpu"), 0), step_fn,
                                TOTAL_STEPS)
    with pytest.raises(ValueError, match="divisible"):
        runner.run(params, torch.from_numpy(_dummy_inputs(1, 3)))
    with pytest.raises(ValueError, match="one stage"):
        DataParallelRunner(tmesh.Stage(tmesh.make_pipeline_mesh(2, device="cpu"), 0), step_fn, 2)
    with pytest.raises(ValueError, match="one stage"):
        FSDPRunner(tmesh.Stage(tmesh.make_2d_mesh(2, 1, device="cpu"), 0), step_fn, 2)


def test_stage_by_data_pipeline_matches_single_device(weights, ranks):
    """S = 2 x D = 2 over 4 gloo ranks: column d's last stage (rank 2 + d)
    returns samples 2d, 2d + 1; together they are the single-device run bit
    for bit and JAX's (stage, data) pipeline within 2e-5; ``run_ticked`` runs
    3 ticks a column (2 samples, 2 stages) and gives the same outputs. The
    first stage of each column returns None."""
    grid = ranks["grid"]
    inputs = torch.from_numpy(_dummy_inputs(2, 4))
    step_fn, params = helpers.dummy_build(MODEL_KW, weights["dummy"][1], "cpu")
    want = run_reference_single_device(step_fn, params, inputs, PIPE_STEPS)
    assert grid[0]["pipeline"] is None and grid[1]["ticked"] is None
    got = torch.cat([grid[2]["pipeline"], grid[3]["pipeline"]])
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), ranks["jax"]["pipeline"], rtol=2e-5, atol=2e-5)
    for r in (2, 3):
        outputs, ticks = grid[r]["ticked"]
        assert len(ticks) == 3
        assert torch.equal(outputs, want[2 * (r - 2):2 * (r - 2) + 2])


def test_two_d_mesh_layout(monkeypatch):
    """Rank r = s * D + d is stage s of column d, as JAX lays out
    ``make_axes_mesh(stage=S, data=D)``; hand-offs stay in a column; the
    backend rule is the pipeline mesh's."""
    grid = tmesh.make_2d_mesh(2, 3, device="cpu")
    assert (grid.world_size, grid.num_stages, grid.num_data) == (6, 2, 3)
    jax_grid = jax_2d_mesh(2, 3)
    jax_ids = {d.id: (s, c) for (s, c), d in np.ndenumerate(jax_grid.devices)}
    for r in range(6):
        stage = tmesh.Stage(grid, r)
        assert (stage.index, stage.column) == jax_ids[jax_grid.devices.flat[r].id]
        assert stage.is_last == (r >= 3)
    data = tmesh.make_data_mesh(4, device="cpu")
    assert (data.num_stages, data.num_data, data.backend) == (1, 4, "gloo")
    assert tmesh.make_data_mesh(device="cpu").world_size == 1
    x = torch.arange(8)
    assert tmesh.Stage(grid, 4).column_shard(x[:6]).tolist() == [2, 3]
    with pytest.raises(ValueError, match="divisible"):
        tmesh.Stage(grid, 0).column_shard(x[:4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = tmesh.make_2d_mesh(2, 2)
    assert cards.backend == "nccl" and cards.devices == tuple(torch.device("cuda", i)
                                                              for i in range(4))
    assert tmesh.make_data_mesh().num_data == 4
    with pytest.raises(ValueError, match="only 4 devices"):
        tmesh.make_2d_mesh(2, 3)
    shared = tmesh.make_data_mesh(devices=["cuda:0", "cuda:0"])
    assert shared.backend == "gloo" and shared.num_data == 2


LEAF_CASES = [((2048, 1024), 8, 0), ((7, 9), 8, 0), ((64, 64), 8, 2**20),
              ((3, 3, 320, 320), 2, 0), ((320, 320, 3, 3), 2, 0), ((1280,), 8, 0),
              ((5, 5), 5, 0), ((4, 6), 2, 0), ((2**20,), 2, DEFAULT_MIN_SHARD_PARAMS)]


def _jax_axis(spec) -> int | None:
    axes = [i for i, a in enumerate(spec) if a is not None]
    return axes[0] if axes else None


@pytest.mark.parametrize("shape,axis_size,min_params", LEAF_CASES)
def test_leaf_spec_matches_jax(shape, axis_size, min_params):
    """``tests/test_data_parallel.py``'s cases and more: the axis the port
    shards is the one JAX's spec names (None: replicated)."""
    assert leaf_spec(shape, axis_size, min_params) == _jax_axis(
        jax_leaf_spec(shape, axis_size, "data", min_params))


@pytest.mark.parametrize("min_params", [0, DEFAULT_MIN_SHARD_PARAMS])
def test_fsdp_bytes_match_jax_on_the_tiny_unet(weights, min_params):
    """Every leaf of JAX's ``SVDUNetConfig.tiny()`` parameters gets the same
    choice from both rules, at D = 2 and 8; and the parameter bytes each port
    rank holds after ``FSDPRunner.shard_params`` at D = 2 equal JAX's
    ``sharded_size_bytes`` on the same weights. Every JAX leaf is one port
    tensor (``utils/weights.py::from_jax_params`` maps them one to one, conv
    kernels transposed), so the bytes agree whatever the axis order."""
    params, state = weights["svd"]
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(state)
    for leaf in leaves:
        for d in (2, 8):
            assert leaf_spec(leaf.shape, d, min_params) == _jax_axis(
                jax_leaf_spec(leaf.shape, d, "data", min_params))
    mesh = jax_data_mesh(2)
    want = jax_sharded_size_bytes(params, jax_fsdp_specs(params, mesh, "data", min_params), mesh)
    for rank in (0, 1):
        stage = tmesh.Stage(tmesh.make_data_mesh(2, device="cpu"), rank)
        unet = SVDUNet(SVDUNetConfig.tiny(), device="cpu")
        unet.load_state_dict(state)
        FSDPRunner(stage, None, 1, min_shard_params=min_params).shard_params(unet)
        assert params_bytes_per_device(unet) == want
