"""The port's step pipeline (``vdpp_tpu_torch.parallel``: one process per
stage over gloo on the CPU), its DummyUNet and the simulator, against the
JAX package's (``vdpp_tpu.parallel.pipeline``, ``vdpp_tpu.models.dummy_unet``).

The invariant is the one of ``tests/test_pipeline.py``: the pipelined run
equals the single-device run of every step, for any stage count. Within the
port both sides run the same PyTorch ops on the CPU at one thread, so they
must be equal bit for bit; against the JAX ``StepPipeline`` (on the conftest's
host devices) the tolerance is ``tests/test_pipeline.py``'s 2e-5. The
DummyUNet forward is held to JAX's to 1e-5 * max|ref| (fp32, 3-D convolutions
summed in other orders).

The stage processes are spawned once for the module, all runs started
together: a 2-rank and a 4-rank group, each running every case of its stage
count (``torch_port_helpers.pipeline_cases``), a group whose ranks fail, and
the simulator twice. One stage needs no process group (its ``Stage`` makes
no collective call), so that case runs here.
"""

import functools
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.dummy_unet import DummyUNet as JaxDummy
from vdpp_tpu.parallel.mesh import make_pipeline_mesh as jax_mesh
from vdpp_tpu.parallel.pipeline import PipelineConfig as JaxConfig
from vdpp_tpu.parallel.pipeline import StepPipeline as JaxPipeline

from vdpp_tpu_torch.models.dummy_unet import DummyUNet
from vdpp_tpu_torch.modes import simulator
from vdpp_tpu_torch.parallel import mesh as tmesh
from vdpp_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    StepPipeline,
    run_reference_single_device,
)
from vdpp_tpu_torch.utils.weights import from_jax_dummy_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

TOTAL_STEPS = 8
LATENT = (1, 8, 3, 8, 8)  # (B, C, F, H, W)
MODEL_KW = dict(channels=8, hidden_channels=16)
# (T, S, N) of tests/test_pipeline.py::test_schedule_invariance_matrix with S <= 4
MATRIX = [(6, 2, 1), (12, 4, 5), (24, 4, 7)]


def _inputs(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *LATENT)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """The JAX DummyUNet's parameters, drawn from a numpy seed as its
    ``init`` draws them (uniform over +-1/sqrt(fan_in)), the LayerNorm moved
    off 1 and 0, and the same weights as the port's state dict."""
    rng = np.random.default_rng(0)
    c, h = MODEL_KW["channels"], MODEL_KW["hidden_channels"]

    def conv(out_ch, in_ch):
        bound = 1.0 / np.sqrt(in_ch * 27)
        return {"w": rng.uniform(-bound, bound, (out_ch, in_ch, 3, 3, 3)).astype(np.float32),
                "b": rng.uniform(-bound, bound, out_ch).astype(np.float32)}

    params = {"conv1": conv(h, c), "conv2": conv(c, h),
              "ln": {"w": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}}
    return params, from_jax_dummy_params(params)


def _step(p, x, k):
    return p(x, k)


def _oracle(state, inputs: np.ndarray, total: int) -> torch.Tensor:
    return run_reference_single_device(_step, helpers.dummy_build(MODEL_KW, state, "cpu")[1],
                                       torch.from_numpy(inputs), total)


def _jax_pipeline(params, inputs: np.ndarray, total: int, stages: int) -> np.ndarray:
    model = JaxDummy(**MODEL_KW)
    pipe = JaxPipeline(jax_mesh(stages), lambda p, x, s: model.apply(p, x, s),
                       JaxConfig(total, stages))
    return np.asarray(pipe.run(params, jnp.asarray(inputs)))


SIM_ARGS = ["--device", "cpu", "--latent-shape", "1", "8", "2", "8", "8"]


def _simulate(argv: list[str], **kw) -> tuple[int, list[str]]:
    """``simulator.main(argv)``'s exit code and the lines it logged from this
    thread (two of these run at once)."""
    lines: list[str] = []
    me = threading.get_ident()
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage()) if r.thread == me else None
    logger = logging.getLogger("vdpp_torch.simulator")
    logger.addHandler(handler)
    try:
        return simulator.main(SIM_ARGS + argv, **kw), lines
    finally:
        logger.removeHandler(handler)


@pytest.fixture(scope="module")
def ranks(weights):
    """Every run that spawns stage processes, started together: a 2-rank
    and a 4-rank gloo group running every multi-stage case of their stage
    count (``{(stages, name): last rank's result}``), a 1-rank group whose
    rank fails (``"failed"``: the exception), the simulator at 4 stages and
    at 2 with a rank-dependent model call (``"simulator"``, ``"mismatch"``:
    exit code and log lines)."""
    build = functools.partial(helpers.dummy_build, MODEL_KW, weights[1])
    cases = {2: [("run", build, torch.from_numpy(_inputs(42, 3)), TOTAL_STEPS, False)],
             4: [("run", build, torch.from_numpy(_inputs(42, 3)), TOTAL_STEPS, False),
                 ("ticked", build, torch.from_numpy(_inputs(42, 3)), TOTAL_STEPS, True)]}
    for t, s, n in MATRIX:
        cases[s].append((f"matrix{t}", build, torch.from_numpy(_inputs(t * 100 + s, n)), t,
                         False))

    def launch(stages, job_cases):
        mesh = tmesh.make_pipeline_mesh(stages, device="cpu")
        return tmesh.run_stages(mesh, helpers.pipeline_cases, job_cases, timeout=300)

    def fails():
        try:
            launch(1, [("bad", None, None, 2, False)])  # build None: the rank raises
        except RuntimeError as e:
            return e
        return None

    logger = logging.getLogger("vdpp_torch.simulator")
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        with ThreadPoolExecutor(5) as pool:
            runs = {s: pool.submit(launch, s, c) for s, c in cases.items()}
            failed = pool.submit(fails)
            sim = pool.submit(_simulate, ["--num-stages", "4", "--total-steps", "28"])
            mismatch = pool.submit(_simulate, ["--num-stages", "2", "--total-steps", "4"],
                                   step=helpers.rank_skewed_step)
            out = {"failed": failed.result(), "simulator": sim.result(),
                   "mismatch": mismatch.result()}
            for stages, run in runs.items():
                per_rank = run.result()
                assert all(r == {c[0]: None for c in cases[stages]} for r in per_rank[:-1])
                out.update({(stages, name): res for name, res in per_rank[-1].items()})
    finally:
        logger.setLevel(level)
    return out


def test_dummy_unet_matches_jax(weights):
    params, state = weights
    x = _inputs(1, 1)[0]
    model = DummyUNet(**MODEL_KW, device="cpu")
    model.load_state_dict(state)
    apply = jax.jit(JaxDummy(**MODEL_KW).apply)
    for step in (0, 5, 27):
        want = np.asarray(apply(params, jnp.asarray(x), step))
        got = model(torch.from_numpy(x), step).detach().numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    no_ln = JaxDummy(**MODEL_KW, use_layernorm=False)
    p2 = {k: v for k, v in params.items() if k != "ln"}
    model2 = DummyUNet(**MODEL_KW, use_layernorm=False, device="cpu")
    model2.load_state_dict(from_jax_dummy_params(p2))
    want = np.asarray(jax.jit(no_ln.apply)(p2, jnp.asarray(x), 3))
    got = model2(torch.from_numpy(x), 3).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("num_stages", [1, 2, 4])
def test_stage_count_invariance(weights, ranks, num_stages):
    """Pipelined == the port's single-device run, bit for bit, and == the
    JAX StepPipeline at the same stage count within 2e-5."""
    params, state = weights
    inputs = _inputs(42, 3)
    if num_stages == 1:
        stage = tmesh.Stage(tmesh.make_pipeline_mesh(1, device="cpu"), 0)
        model = helpers.dummy_build(MODEL_KW, state, "cpu")[1]
        got = StepPipeline(stage, _step, PipelineConfig(TOTAL_STEPS, 1)).run(
            model, torch.from_numpy(inputs))
    else:
        got = ranks[(num_stages, "run")]
    assert got.shape == inputs.shape
    assert torch.equal(got, _oracle(state, inputs, TOTAL_STEPS))
    np.testing.assert_allclose(got.numpy(), _jax_pipeline(params, inputs, TOTAL_STEPS,
                                                          num_stages), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("total_steps,num_stages,num_samples", MATRIX)
def test_schedule_invariance_matrix(weights, ranks, total_steps, num_stages, num_samples):
    got = ranks[(num_stages, f"matrix{total_steps}")]
    want = _oracle(weights[1], _inputs(total_steps * 100 + num_stages, num_samples), total_steps)
    assert torch.equal(got, want)


def test_run_ticked(weights, ranks):
    """4 stages, 3 samples: 6 ticks; ``on_sample`` fires for samples 0, 1, 2
    in order, each with its finished latent."""
    outputs, ticks, seen = ranks[(4, "ticked")]
    assert ticks == PipelineConfig(TOTAL_STEPS, 4).num_ticks(3) == 6
    assert [i for i, _ in seen] == [0, 1, 2]
    want = _oracle(weights[1], _inputs(42, 3), TOTAL_STEPS)
    assert torch.equal(outputs, want)
    assert all(torch.equal(x, want[i]) for i, x in seen)


def test_one_stage_runs_in_process(weights):
    """One stage makes no collective call: ``run_ticked`` and
    ``broadcast_object`` work with no process group, and the run equals the
    single-device one."""
    stage = tmesh.Stage(tmesh.make_pipeline_mesh(1, device="cpu"), 0)
    assert stage.broadcast_object(obj := {"a": 1}) is obj
    model = helpers.dummy_build(MODEL_KW, weights[1], "cpu")[1]
    seen = []
    outputs, ticks = StepPipeline(stage, _step, PipelineConfig(TOTAL_STEPS, 1)).run_ticked(
        model, torch.from_numpy(_inputs(7, 2)), on_sample=lambda i, x: seen.append(i))
    assert len(ticks) == 2 and seen == [0, 1]
    assert torch.equal(outputs, _oracle(weights[1], _inputs(7, 2), TOTAL_STEPS))


def test_pipeline_config_errors():
    with pytest.raises(ValueError):
        PipelineConfig(total_steps=30, num_stages=7)  # non-divisible
    with pytest.raises(ValueError):
        PipelineConfig(total_steps=0, num_stages=1)
    cfg = PipelineConfig(total_steps=28, num_stages=7)
    assert cfg.steps_per_stage == 4
    assert cfg.num_ticks(16) == 22
    assert cfg.bubble_fraction(16) == pytest.approx(6 / 22)
    assert cfg.bubble_fraction(1) == pytest.approx(6 / 7)
    stage = tmesh.Stage(tmesh.make_pipeline_mesh(2, device="cpu"), 0)
    with pytest.raises(ValueError, match="stage axis"):
        StepPipeline(stage, _step, PipelineConfig(8, 4))
    with pytest.raises(TypeError, match="param_spec"):  # a layout function since A15
        StepPipeline(stage, _step, PipelineConfig(8, 2), param_spec=object())
    one = StepPipeline(tmesh.Stage(tmesh.make_pipeline_mesh(1, device="cpu"), 0),
                       lambda p, x, k: x[..., :4], PipelineConfig(2, 1))
    with pytest.raises(ValueError, match="payload"):  # a step must keep the payload's shape
        one.run(None, torch.zeros(1, 2, 8))
    # The resume arguments, refused until A11 was ported: a start past the
    # last tick, a buffer of the wrong shape, a hook after every tick.
    out, ticks = one.run_ticked(None, torch.zeros(1, 4), start_tick=1)
    assert out.shape == (0, 4) and ticks == []
    with pytest.raises(ValueError, match="initial_buf shape"):
        one.run_ticked(None, torch.zeros(1, 4), initial_buf=torch.zeros(1))
    seen = []
    one.run_ticked(None, torch.zeros(1, 4), on_tick=lambda t, buf: seen.append((t, buf.shape)))
    assert seen == [(0, (1, 4))]
    # The streaming executor, refused until A16 was ported: a one-rank
    # pipeline streams in this process, a larger mesh through StreamRanks.
    stream = one.stream(None, (1, 4))
    assert torch.equal(stream.submit(torch.ones(1, 4)).result(timeout=60), torch.ones(1, 4))
    stream.close()
    with pytest.raises(ValueError, match="StreamRanks"):
        StepPipeline(stage, _step, PipelineConfig(8, 2)).stream(None, (4,))
    two_d = tmesh.make_2d_mesh(2, 2, device="cpu")  # the (stage, data) mesh, since A11
    assert (two_d.num_stages, two_d.num_data, two_d.world_size) == (2, 2, 4)


def test_mesh_layouts(monkeypatch):
    """The backend follows the layout. CPU: gloo, any stage count, 1 by
    default. Cards: one a stage over NCCL, all of them by default, no more
    stages than cards; a shared card only when asked for by a device list,
    and then over gloo with the hand-off through host memory."""
    cpu = tmesh.make_pipeline_mesh(device="cpu")
    assert cpu.num_stages == 1 and cpu.backend == "gloo"
    four = tmesh.make_pipeline_mesh(4, device="cpu")
    assert four.devices == (torch.device("cpu"),) * 4 and four.backend == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = tmesh.make_pipeline_mesh()
    assert cards.num_stages == 3 and cards.backend == "nccl" and not cards.host_handoff
    assert cards.devices == tuple(torch.device("cuda", i) for i in range(3))
    with pytest.raises(ValueError, match="only 3 devices"):
        tmesh.make_pipeline_mesh(4)
    shared = tmesh.make_pipeline_mesh(devices=["cuda:0", "cuda:0"])
    assert shared.backend == "gloo" and shared.host_handoff and shared.num_stages == 2
    partly = tmesh.make_pipeline_mesh(devices=["cuda:0", "cuda:1", "cuda:1"])
    assert partly.backend == "gloo" and partly.host_handoff
    own = tmesh.make_pipeline_mesh(devices=["cuda:2", "cuda:0"])
    assert own.backend == "nccl" and own.devices == (torch.device("cuda", 2),
                                                     torch.device("cuda", 0))
    with pytest.raises(ValueError, match="visible"):
        tmesh.make_pipeline_mesh(devices=["cuda:0", "cuda:3"])


def test_simulator_verifies_four_stages(ranks):
    rc, lines = ranks["simulator"]
    assert rc == 0
    assert "stage-count invariance verified (4 stages)" in lines


def test_simulator_catches_a_mismatch(ranks):
    """A model call that differs on rank 1 makes the pipelined result differ
    from the single-device run, and the simulator exit 1."""
    rc, lines = ranks["mismatch"]
    assert rc == 1
    assert "MISMATCH: pipeline is not stage-count invariant" in lines


def test_a_failing_rank_fails_the_run(ranks):
    """A rank that raises fails ``run_stages`` with its traceback."""
    assert isinstance(ranks["failed"], RuntimeError)
    assert "stage rank 0 of 1 failed" in str(ranks["failed"])
    assert "TypeError" in str(ranks["failed"])
