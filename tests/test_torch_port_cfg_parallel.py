"""The port's CFG (branch-axis) parallelism for the SVD UNet against the JAX
package, fp32 on the CPU: ``CFGParallelRunner`` on cfg 2 and the step
pipeline on stage 2 x cfg 2 against JAX's single-device oracle
(``torch_port_intra.jax_oracle``), the production mode with
``--cfg-parallel --ticked --state-path ... --resume``, and the inputs both
packages refuse under the intra-sample axes.

Tolerance: ``rtol = atol = 2e-5`` against JAX, the JAX package's own
(``tests/test_cfg_parallel.py:56``). Within the port: cfg 2 equals the
sequential-CFG run bit for bit (each rank computes its branch as the
sequential run does, and both blend the same two outputs), DeepCache-2
included (the refreshed caches swapped with the outputs); stage 2 x cfg 2
equals cfg 2 at one stage; the resumed production run emits the uncut
run's remaining sample bit for bit.

One fixture spawns a 2-rank gloo group and, beside it, the production runs
(4 ranks: 2 stages x cfg 2, uncut then resumed), whose uncut run is the
stage 2 x cfg 2 case; JAX's oracle runs meanwhile in this thread.
"""

import dataclasses
import functools
import logging
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNet as JaxUNet
from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.modes import benchmark as jax_benchmark
from vdpp_tpu.modes import production as jax_production
from vdpp_tpu.parallel.cfg_parallel import CFGParallelRunner as JaxCFGRunner
from vdpp_tpu.parallel.mesh import make_axes_mesh as jax_axes_mesh
from vdpp_tpu.parallel.pipeline import PipelineConfig as JaxPipelineConfig
from vdpp_tpu.parallel.pipeline import StepPipeline as JaxPipeline

from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.modes import benchmark, production
from vdpp_tpu_torch.parallel.collectives import Axis
from vdpp_tpu_torch.parallel.mesh import Stage, make_axes_mesh, make_pipeline_mesh
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline

import torch_port_intra as intra
from torch_port_helpers import one_torch_thread  # noqa: F401

DEEPCACHE_EULER = {"deepcache_interval": 2}
PROD_ARGV = ["--device", "cpu", "--preset", "tiny", "--num-stages", "2", "--total-steps",
             str(intra.STEPS), "--num-samples", str(intra.SAMPLES), "--latent-shape", "1", "4",
             str(intra.F), str(intra.H), str(intra.W), "--guidance-scale", str(intra.GUIDANCE),
             "--cfg-parallel", "--ticked"]


def _production(argv: list[str], lines: list) -> dict:
    """``production.run`` of ``PROD_ARGV + argv`` on the module's draws, and
    the messages it logged from this thread into ``lines``."""
    _, state, emb, img, noise = intra.draws()
    args = production.build_parser().parse_args(PROD_ARGV + argv)
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), intra.F,
                             guidance_scale=intra.GUIDANCE)
    sigma = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=intra.STEPS,
                            device="cpu").init_noise_sigma
    logger = logging.getLogger("vdpp_torch.production")
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        return production.run(args, state=state, cond=cond,
                              inputs=torch.from_numpy(noise) * sigma)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _production_runs(path: str) -> dict:
    """The uncut run snapshotting after tick 1 (``--state-every 2`` of 3
    ticks), then the run resumed from it."""
    ticked = ["--state-path", path, "--state-every", "2"]
    lines = {"full": [], "resumed": []}
    full = _production(ticked, lines["full"])
    resumed = _production(ticked + ["--resume"], lines["resumed"])
    return {"full": full, "resumed": resumed, "lines": lines}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    build, inputs = intra.port_case()
    build_dc, inputs_dc = intra.port_case(**DEEPCACHE_EULER)
    cases = [("cfg2", {"cfg": 2}, "cfg_runner", (build, inputs, intra.STEPS)),
             ("cfg2_deepcache", {"cfg": 2}, "cfg_runner", (build_dc, inputs_dc[:1], intra.STEPS))]
    path = str(tmp_path_factory.mktemp("production") / "state.npz")
    with ThreadPoolExecutor(2) as pool:
        spawned = pool.submit(intra.spawn, 2, cases)
        prod = pool.submit(_production_runs, path)
        oracle = intra.jax_oracle()
        sequential = intra.port_single_device()
        sequential_dc = intra.port_single_device(**DEEPCACHE_EULER)[:1]
        results, production = spawned.result(), prod.result()
    # production's uncut run: the euler steps of both samples on 2 stages x cfg 2
    results["stage2_cfg2"] = (production["full"]["out"], None)
    return {"results": results, "oracle": oracle, "sequential": sequential,
            "sequential_dc": sequential_dc, "production": production}


@pytest.mark.parametrize("name", ["cfg2", "stage2_cfg2"])
def test_cfg_parallel_matches_jax_oracle(runs, name):
    """4 Euler steps of both samples, the uncond branch on one rank and the
    cond branch on the other (each stage a pair in stage2_cfg2, the
    production run), one swap a forward, against the JAX single-device
    oracle."""
    got, counts = runs["results"][name]
    intra.assert_oracle(got, runs["oracle"])
    if counts is not None:
        assert counts == {"swap": intra.STEPS * len(got)}


def test_cfg_parallel_is_bit_equal_to_sequential_cfg(runs):
    res = runs["results"]
    assert torch.equal(res["cfg2"][0], runs["sequential"])
    assert torch.equal(res["stage2_cfg2"][0], res["cfg2"][0])


def test_cfg_parallel_deepcache_is_bit_equal_to_sequential(runs):
    """DeepCache-2: each rank refreshes its branch's cache on the full steps
    and both caches ride the swap, so the whole payload (the two cache
    lanes included) is the sequential run's."""
    got, counts = runs["results"]["cfg2_deepcache"]
    assert torch.equal(got, runs["sequential_dc"])
    assert counts == {"swap": 2 * intra.STEPS}


def test_production_cfg_parallel_ticked_resume(runs):
    """``production.run`` on 2 stages x cfg 2 (4 ranks), ticked, snapshotting
    after tick 1: the JAX oracle within 2e-5; resumed from the snapshot at
    tick 2, sample 1 bit-equal to the uncut run's."""
    prod = runs["production"]
    full, resumed = prod["full"], prod["resumed"]
    want = runs["oracle"]
    intra.assert_oracle(full["out"], want)
    assert len(full["ticks"]) == 3 and [s["tick"] for s in full["snapshots"]] == [1]
    assert len(full["launches"]) == 4
    assert resumed["first_sample"] == 1 and len(resumed["ticks"]) == 1
    assert torch.equal(resumed["out"], full["out"][1:])
    assert any(m.startswith("resuming at tick 2") for m in prod["lines"]["resumed"])


# ---- refusals: each case runs both packages on the same inputs ---- #


def _unet_inputs():
    x = intra.x_of(21, 1, intra.F, intra.H, intra.W, 8)
    ctx, ids = intra.x_of(22, 1, 1, 48), np.array([[5.0, 127.0, 0.02]], np.float32)
    return x, ctx, ids


def _forward(fused: bool, seq: int = 1, frame: int = 1):
    """Both UNet forwards of one sharded call: ``(jax_call, port_call)``."""
    params = intra.draws()[0]
    x, ctx, ids = _unet_inputs()
    junet = JaxUNet(dataclasses.replace(JaxConfig.tiny(), fused_groupnorm=fused))
    tunet = SVDUNet(dataclasses.replace(SVDUNetConfig.tiny(), fused_groupnorm=fused),
                    device="cpu")
    tunet.load_state_dict(intra.draws()[1])
    jkw = dict(seq_axis="seq" if seq > 1 else None, seq_shards=seq,
               frame_axis="frame" if frame > 1 else None, frame_shards=frame)
    tkw = dict(seq_axis=Axis("seq", seq, 0, tuple(range(seq)), group=None) if seq > 1 else None,
               frame_axis=(Axis("frame", frame, 0, tuple(range(frame)), group=None)
                           if frame > 1 else None))
    return (lambda: junet.apply(params, jnp.asarray(x), 0.5, jnp.asarray(ctx), jnp.asarray(ids),
                                **jkw),
            lambda: tunet(torch.from_numpy(x), 0.5, torch.from_numpy(ctx),
                          torch.from_numpy(ids), **tkw))


def _deepcache_pipeline(num_steps: int, pad: int | None):
    """Both step pipelines of 2 stages over DeepCache-2 x seq 2."""
    jmodel = JaxSVD(JaxConfig.tiny(), num_steps=num_steps, deepcache_interval=2,
                    pad_steps_to=pad)
    tmodel = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=num_steps, deepcache_interval=2,
                             pad_steps_to=pad, device="cpu")
    seq = Axis("seq", 2, 0, (0, 1), group=None)
    return (lambda: JaxPipeline(jax_axes_mesh(stage=2, seq=2),
                                jmodel.pipeline_step_fn(seq_axis="seq", seq_shards=2),
                                JaxPipelineConfig(jmodel.num_steps, 2)),
            lambda: StepPipeline(Stage(make_pipeline_mesh(2, device="cpu"), 0),
                                 tmodel.pipeline_step_fn(seq_axis=seq),
                                 PipelineConfig(tmodel.num_steps, 2)))


BENCH = ["--model", "svd_tiny", "--latent-shape", "1", "4", "2", "8", "8"]


def _jax_benchmark_unbuilt(argv: list[str]):
    """The JAX benchmark's ``main`` with its model build (``_build_model``,
    which jits the model's init) replaced by a stub of the same returns: its
    refusal of ``--data-parallel-size`` with an inner axis comes after the
    build and reads only the flags."""
    build = jax_benchmark._build_model
    jax_benchmark._build_model = lambda args, _: (None, None, (1, 2, 8, 8, 4), None,
                                                  args.model)
    try:
        return jax_benchmark.main(argv)
    finally:
        jax_benchmark._build_model = build


def _mains(main_pair, argv: list[str]):
    jax_main, port_main = main_pair
    return (lambda: jax_main(["--backend", "cpu", *argv]),
            lambda: port_main(["--device", "cpu", *argv]))


REFUSALS = {
    "fused_groupnorm_x_seq": (ValueError, lambda: _forward(True, seq=2)),
    "fused_groupnorm_x_frame": (ValueError, lambda: _forward(True, frame=2)),
    "width_not_divisible": (ValueError, lambda: _forward(False, seq=3)),
    "frames_not_divisible": (ValueError, lambda: _forward(False, frame=3)),
    "deepcache_seq_steps_off_cadence": (ValueError, lambda: _deepcache_pipeline(6, None)),
    "deepcache_seq_padded_schedule": (ValueError, lambda: _deepcache_pipeline(3, 2)),
    "cfg_parallel_without_guidance": (SystemExit, lambda: _mains(
        (jax_production.main, production.main),
        ["--preset", "tiny", "--latent-shape", "1", "4", "2", "16", "16", "--cfg-parallel"])),
    "data_parallel_with_an_inner_axis": (SystemExit, lambda: _mains(
        (_jax_benchmark_unbuilt, benchmark.main),
        [*BENCH, "--data-parallel-size", "2", "--frame-parallel", "2"])),
    "cfg_axis_not_of_size_2": (ValueError, lambda: (
        lambda: JaxCFGRunner(jax_axes_mesh(cfg=4), None, 2),
        lambda: make_axes_mesh(cfg=4, device="cpu"))),
}


@functools.cache
def _refused(case: str, side: int) -> tuple[type, str]:
    """The exception that one side (0: JAX, 1: the port) of a refusal case
    raises, and its message."""
    exc, pair = REFUSALS[case]
    with pytest.raises(exc) as info:
        pair()[side]()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", list(REFUSALS))
def test_both_packages_refuse(runs, case):
    """``fused_groupnorm`` with seq or frame, a width the seq shards do not
    split evenly at every level, frames the frame shards do not divide,
    DeepCache x seq over 2 stages off the cadence or on a padded schedule,
    ``--cfg-parallel`` without guidance, ``--data-parallel-size`` with an
    inner axis, and a cfg axis not of 2: both packages raise the same
    exception, a SystemExit with the same message."""
    want, got = _refused(case, 0), _refused(case, 1)
    assert got[0] == want[0]
    if want[0] is SystemExit:
        assert got[1] == want[1]
