"""The port's production mode (``vdpp_tpu_torch.modes.production``) against
the JAX package's production sequence (``vdpp_tpu/modes/production.py``: the
wrapper, the conditioning, noise x ``init_noise_sigma`` packed for the
solver, the step pipeline's ``run_ticked``, ``unpack_final``) composed from
the JAX functions with the same weights, conditioning and noise, and its
flags against tests/test_modes.py's production cases.

``--preset tiny``, latent (1, 4, 2, 16, 16), 2 stages over gloo, 4 steps,
CFG 3, 2 samples. The port's run: 1e-4 x max|JAX| (fp32 both sides, the
tiny UNet held as tests/test_torch_port_model.py holds it). Its resume: the
remaining sample bit-equal to the uncut run's.

The port's two spawned runs (uncut with a snapshot, then resumed from it)
go one after the other in one fixture, beside the JAX run in a thread.
"""

import argparse
import logging
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.svd_unet import SVDUNetConfig as JaxConfig
from vdpp_tpu.models.svd_wrapper import StableVideoUNet as JaxSVD
from vdpp_tpu.models.svd_wrapper import make_conditioning as jax_conditioning
from vdpp_tpu.parallel.mesh import make_pipeline_mesh as jax_mesh
from vdpp_tpu.parallel.pipeline import PipelineConfig as JaxPipelineConfig
from vdpp_tpu.parallel.pipeline import StepPipeline as JaxPipeline

from vdpp_tpu_torch.models.svd_wrapper import make_conditioning
from vdpp_tpu_torch.modes import production

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

BASE = ["--device", "cpu", "--preset", "tiny", "--num-stages", "2", "--total-steps", "4",
        "--num-samples", "2", "--latent-shape", "1", "4", "2", "16", "16",
        "--guidance-scale", "3"]


def _draws():
    """The tiny weights, the conditioning's arrays and the noise, from numpy."""
    params, state = helpers.tiny_svd_weights(7)
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((1, 1, 48)).astype(np.float32)
    img = rng.standard_normal((1, 2, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 1, 2, 16, 16, 4)).astype(np.float32)
    return params, state, emb, img, noise


def _jax_sequence(params, emb, img, noise) -> np.ndarray:
    """The reference's production.py:199-333 for these flags, from the JAX
    functions: the wrapper, make_conditioning, noise x init_noise_sigma,
    pack_initial, StepPipeline.run_ticked, unpack_final."""
    model = JaxSVD(JaxConfig.tiny(), num_steps=4, cfg_mode="sequential", solver="euler")
    cond = jax_conditioning(jnp.asarray(emb), jnp.asarray(img), 2, guidance_scale=3.0)
    inputs = model.pack_initial(jnp.asarray(noise) * model.init_noise_sigma)
    pipe = JaxPipeline(jax_mesh(2), model.pipeline_step_fn(), JaxPipelineConfig(4, 2))
    out, _ = pipe.run_ticked((params, cond), inputs)
    return np.asarray(model.unpack_final(out))


def _port(argv, state, emb, img, noise, lines):
    """``production.run`` of ``BASE + argv`` with the test's draws, and the
    messages it logged (from this thread) into ``lines``."""
    args = production.build_parser().parse_args(BASE + argv)
    cond = make_conditioning(torch.from_numpy(emb), torch.from_numpy(img), 2, guidance_scale=3.0)
    sigma = production.StableVideoUNet(production.SVDUNetConfig.tiny(), num_steps=4,
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX sequence (in a thread), and the port's ticked run snapshotting
    after tick 1 (``--state-every 2``: ticks 0 .. 2, so only tick 1), then
    the same run with ``--resume``."""
    params, state, emb, img, noise = _draws()
    path = str(tmp_path_factory.mktemp("production") / "state.npz")
    ticked = ["--ticked", "--state-path", path, "--state-every", "2"]
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(_jax_sequence, params, emb, img, noise)
        lines = {"full": [], "resumed": []}
        full = _port(ticked, state, emb, img, noise, lines["full"])
        resumed = _port(ticked + ["--resume"], state, emb, img, noise, lines["resumed"])
        return {"want": want.result(), "full": full, "resumed": resumed, "lines": lines,
                "path": path, "draws": (state, emb, img, noise), "ticked": ticked}


def test_production_tiny_matches_jax_sequence(runs):
    got, want = runs["full"]["out"], runs["want"]
    assert tuple(got.shape) == want.shape == (2, 1, 2, 16, 16, 4)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert len(runs["full"]["ticks"]) == 3
    assert [s["tick"] for s in runs["full"]["snapshots"]] == [1]
    assert any("sample 1 final latent norm" in m for m in runs["lines"]["full"])
    assert any(m.startswith("2 samples in") and "bubble 33.3%" in m
               for m in runs["lines"]["full"])


def test_production_resume_emits_the_remaining_sample(runs):
    """``--resume`` starts at tick 2 from the tick-1 snapshot and emits
    sample 1, bit-equal to the uncut run's; it logs "resuming at tick"."""
    res = runs["resumed"]
    assert res["first_sample"] == 1 and len(res["ticks"]) == 1
    assert torch.equal(res["out"], runs["full"]["out"][1:])
    assert any(m.startswith("resuming at tick 2 (samples 1.. remain") for m in
               runs["lines"]["resumed"])
    assert any("sample 1 final latent norm" in m for m in runs["lines"]["resumed"])


def test_production_resume_refuses_another_configuration(runs):
    """A snapshot resumed under another --num-samples is refused, naming the
    key, before any rank starts."""
    argv = BASE + runs["ticked"] + ["--resume"]
    argv[argv.index("--num-samples") + 1] = "3"
    with pytest.raises(SystemExit, match="different run configuration.*num_samples"):
        production.run(production.build_parser().parse_args(argv))


@pytest.mark.parametrize("flags,message", [
    (["--ticked", "--resume"], "--resume needs --state-path"),
    (["--state-path", "never.npz"], "--state-path needs --ticked"),
    (["--state-every", "2"], "--state-every needs --state-path"),
    (["--latent-shape", "1", "8", "2", "16", "16"], "C must be 4"),
])
def test_production_mode_resume_flag_consistency(flags, message, monkeypatch):
    """tests/test_modes.py::test_production_mode_resume_flag_consistency:
    the argument checks fire before any model is built."""
    def no_model(*args, **kwargs):
        raise AssertionError("a model was built before the argument checks")

    monkeypatch.setattr(production, "SVDUNet", no_model)
    monkeypatch.setattr(production, "StableVideoUNet", no_model)
    argv = ["--device", "cpu", "--preset", "tiny", "--latent-shape", "1", "4", "2", "16", "16"]
    with pytest.raises(SystemExit, match=message):
        production.main(argv + flags)


@pytest.mark.parametrize("flags", [["--auto-topology", "latency"],
                                   ["--auto-topology", "throughput"],
                                   ["--auto-topology", "latency", "--guidance-scale", "3"],
                                   ["--auto-topology", "throughput", "--deepcache", "2"]])
def test_production_unported_axes_raise_naming_a13(flags):
    """The mesh planner (ROADMAP A13 part 2, now ported) sets the stage count,
    the axes and the schedule padding from the JAX planner's top plan for
    the two devices, in the argument checks, before any model is built
    (tests/test_torch_port_topology.py runs it)."""
    from vdpp_tpu.parallel.topology import plan_topology as jax_plan

    argv = ["--device", "cpu", "--preset", "tiny", "--latent-shape", "1", "4", "2", "16", "16",
            "--devices", "cpu", "cpu"]
    args = production.build_parser().parse_args(argv + flags)
    production.check_flags(args)
    best = jax_plan(2, total_steps=args.total_steps, frames=2, latent_w=16,
                    num_samples=args.num_samples, seq_min_divisor_unit=2,
                    guidance=args.guidance_scale is not None, objective=args.auto_topology,
                    deepcache_interval=args.deepcache)[0]
    assert (args.num_stages, args.seq_parallel, args.frame_parallel, args.cfg_parallel) == (
        best.stage, best.seq, best.frame, best.cfg == 2)
    assert args.pad_schedule == (best.padded_steps != args.total_steps)


def test_production_run_meta_has_the_reference_keys():
    """The snapshot's metadata carries the JAX package's 15 keys, so a
    snapshot of either package resumes in the other under the same flags."""
    args = production.build_parser().parse_args(BASE)
    meta = production.run_meta(args, 4, 2)
    assert set(meta) == {"total_steps", "requested_steps", "pad_schedule", "stages",
                         "num_samples", "seed", "solver", "sampler_seed", "deepcache",
                         "deepcache_split", "latent_shape", "guidance_scale", "cfg_mode",
                         "preset", "checkpoint"}
    assert isinstance(args, argparse.Namespace) and meta["latent_shape"] == [1, 4, 2, 16, 16]
