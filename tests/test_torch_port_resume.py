"""Snapshot and resume of the port's ticked step pipeline
(``vdpp_tpu_torch.utils.resume``, ``StepPipeline.run_ticked``'s
``start_tick``, ``initial_buf``, ``on_tick`` and ``on_tick_every``) on two
gloo ranks, mirroring tests/test_resume.py, and held against the JAX package's
(``vdpp_tpu.utils.resume``, its ``run_ticked`` on the conftest's CPU mesh).

Within the port a resumed run must emit the remaining samples bit for bit as
the uncut run does (both sides are the same PyTorch ops on the CPU at one
thread). Against JAX the tolerance is tests/test_pipeline.py's 2e-5 (the
DummyUNet's fp32 3-D convolutions summed in other orders): the live slots of
the port's gathered buffer against the JAX ring after the same tick, and the
remaining samples of a snapshot written by one package and resumed by the
other against the writer's own uncut run.

The two ranks are spawned once for the module, running every case in order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu.models.dummy_unet import DummyUNet as JaxDummy
from vdpp_tpu.parallel.mesh import make_pipeline_mesh as jax_mesh
from vdpp_tpu.parallel.pipeline import PipelineConfig as JaxConfig
from vdpp_tpu.parallel.pipeline import StepPipeline as JaxPipeline
from vdpp_tpu.utils import resume as jax_resume

from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_conditioning
from vdpp_tpu_torch.parallel import mesh as tmesh
from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
from vdpp_tpu_torch.utils import resume
from vdpp_tpu_torch.utils.weights import from_jax_dummy_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

STAGES, TOTAL, N = 2, 8, 4
MODEL_KW = dict(channels=8, hidden_channels=16)
LATENT = (1, 8, 4, 8, 8)  # (B, C, F, H, W)
TICKS = N + STAGES - 1
JAX_TICK = 1  # the JAX package's snapshot is taken after this tick
TOL = 2e-5


def _dummy_params():
    """The JAX DummyUNet's parameters from a numpy seed (uniform over
    +-1/sqrt(fan_in), the LayerNorm moved off 1 and 0) and the same weights
    as the port's state dict."""
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


def _dpm_case():
    """tests/test_resume.py's packed-payload case: ``SVDUNetConfig.tiny()``
    with dpmpp2m (8 payload channels: x and x0_hat), 4 steps, CFG 3 over 3
    frames of 16x16, 2 samples; weights, conditioning and noise from numpy."""
    _, state = helpers.tiny_svd_weights(5)
    rng = np.random.default_rng(6)
    cond = make_conditioning(torch.from_numpy(rng.standard_normal((1, 1, 48)).astype(np.float32)),
                             torch.from_numpy(rng.standard_normal((1, 3, 16, 16, 4))
                                              .astype(np.float32)), 3, guidance_scale=3.0)
    wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=4, solver="dpmpp2m", device="cpu")
    noise = torch.from_numpy(rng.standard_normal((2, 1, 3, 16, 16, 4)).astype(np.float32))
    build = functools.partial(helpers.svd_build, SVDUNetConfig.tiny(), "dpmpp2m", 4, None, state,
                              cond)
    return build, wrapper.pack_initial(noise * wrapper.init_noise_sigma)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run (its ring after every tick, its uncut outputs, a snapshot
    after :data:`JAX_TICK`), then one 2-rank group running every port case in
    order, then the JAX package resuming from the port's tick-1 snapshot."""
    tmp = tmp_path_factory.mktemp("resume")
    params, state = _dummy_params()
    inputs = np.random.default_rng(1).standard_normal((N, *LATENT)).astype(np.float32)

    model = JaxDummy(**MODEL_KW)
    jpipe = JaxPipeline(jax_mesh(STAGES), lambda p, x, s: model.apply(p, x, s),
                        JaxConfig(TOTAL, STAGES))
    rings = {}

    def on_tick(t, buf):
        rings[t] = np.asarray(buf)
        if t == JAX_TICK:
            jax_resume.save_pipeline_state(str(tmp / "jax.npz"), t, buf, meta={"from": "jax"})

    jfull, _ = jpipe.run_ticked(params, jnp.asarray(inputs), on_tick=on_tick)

    build = functools.partial(helpers.dummy_build, MODEL_KW, state)
    x = torch.from_numpy(inputs)
    dpm_build, dpm_x = _dpm_case()
    cases = [
        ("full", build, x, TOTAL, {}),
        ("snap", build, x, TOTAL, {"snap_path": str(tmp / "port%d.npz")}),
        ("resume1", build, x, TOTAL, {"resume_path": str(tmp / "port1.npz")}),
        ("resume2", build, x, TOTAL, {"resume_path": str(tmp / "port2.npz")}),
        ("past_end", build, x, TOTAL,
         {"start_tick": TICKS, "initial_buf": np.zeros((STAGES, *LATENT), np.float32)}),
        ("from_jax", build, x, TOTAL, {"resume_path": str(tmp / "jax.npz")}),
        ("every2", build, x, TOTAL, {"gather": True, "on_tick_every": 2}),
        ("dpm_full", dpm_build, dpm_x, 4, {}),
        ("dpm_snap", dpm_build, dpm_x, 4, {"snap_path": str(tmp / "dpm%d.npz")}),
        ("dpm_resume", dpm_build, dpm_x, 4, {"resume_path": str(tmp / "dpm1.npz")}),
    ]
    ranks = tmesh.run_stages(tmesh.make_pipeline_mesh(STAGES, device="cpu"),
                             helpers.resume_cases, cases, timeout=300)
    assert ranks[0] == {name: None for name, *_ in cases}
    port_tick, port_buf, _ = resume.load_pipeline_state(str(tmp / "port1.npz"))
    jrest, jticks = jpipe.run_ticked(params, jnp.asarray(inputs), start_tick=port_tick + 1,
                                     initial_buf=jnp.asarray(port_buf))
    return {"port": ranks[-1], "rings": rings, "jfull": np.asarray(jfull),
            "jrest": (np.asarray(jrest), len(jticks)), "tmp": tmp}


def _already(tick: int) -> int:
    """Samples emitted by ticks 0 .. tick."""
    return max(tick + 1 - (STAGES - 1), 0)


@pytest.mark.parametrize("tick", [1, 2])
def test_resume_emits_identical_remaining_samples(runs, tick):
    full = runs["port"]["full"][0]
    rest, nticks, _ = runs["port"][f"resume{tick}"]
    assert nticks == TICKS - (tick + 1)
    assert torch.equal(rest, full[_already(tick):])


def test_resume_with_packed_solver_state(runs):
    """dpmpp2m's payload (x and its x0_hat) survives the disk round trip and
    the resumed remainder is bit-equal, compared as words."""
    full = runs["port"]["dpm_full"][0]
    rest, _, _ = runs["port"]["dpm_resume"]
    assert full.shape[-1] == 8 and rest.shape[0] == full.shape[0] - _already(1)
    assert torch.equal(rest.view(torch.int32), full[_already(1):].view(torch.int32))


def test_resume_past_end_returns_empty(runs):
    out, nticks, _ = runs["port"]["past_end"]
    assert out.shape == (0, *LATENT) and nticks == 0


def test_gathered_ring_matches_jax(runs):
    """After every tick t the last rank's buffer holds, in slot s >= 1, the
    payload stage s steps next (sample t + 1 - s) where that sample exists,
    equal to the JAX ring's slot within 2e-5, and zeros elsewhere (slot 0
    and the fill and drain slots, where the JAX ring holds values nothing
    reads). ``on_tick_every=2`` gathers after ticks 1 and 3 only."""
    seen = runs["port"]["snap"][2]
    assert [t for t, _ in seen] == list(range(TICKS))
    for t, buf in seen:
        assert buf.shape == (STAGES, *LATENT) and buf.device.type == "cpu"
        for s in range(STAGES):
            if s >= 1 and 0 <= t + 1 - s < N:
                np.testing.assert_allclose(buf[s].numpy(), runs["rings"][t][s], atol=TOL, rtol=0)
            else:
                assert not buf[s].any()
    every2 = runs["port"]["every2"][2]
    assert [t for t, _ in every2] == [1, 3]
    assert all(torch.equal(buf, seen[t][1]) for t, buf in every2)


def test_jax_snapshot_resumes_in_the_port(runs):
    rest, nticks, _ = runs["port"]["from_jax"]
    assert nticks == TICKS - (JAX_TICK + 1)
    np.testing.assert_allclose(rest.numpy(), runs["jfull"][_already(JAX_TICK):], atol=TOL,
                               rtol=0)


def test_port_snapshot_resumes_in_jax(runs):
    jrest, nticks = runs["jrest"]
    assert nticks == TICKS - 2
    np.testing.assert_allclose(jrest, runs["port"]["full"][0][_already(1):].numpy(), atol=TOL,
                               rtol=0)


def test_save_is_atomic_and_validated(tmp_path):
    """tests/test_resume.py's case, and the file read by the other package's
    loader both ways."""
    path = str(tmp_path / "s.npz")
    buf = np.arange(12, dtype=np.float32).reshape(3, 4)
    resume.save_pipeline_state(path, 5, buf, meta={"a": 1})
    t, b, m = resume.load_pipeline_state(path)
    assert t == 5 and m == {"a": 1}
    np.testing.assert_array_equal(b, buf)
    resume.save_pipeline_state(path, 6, torch.from_numpy(buf + 1))  # the overwrite path
    t2, b2, _ = resume.load_pipeline_state(path)
    assert t2 == 6
    np.testing.assert_array_equal(b2, buf + 1)
    assert [p.name for p in tmp_path.iterdir()] == ["s.npz"]  # no temporary left behind
    t3, b3, m3 = jax_resume.load_pipeline_state(path)
    assert (t3, m3) == (6, {}) and np.array_equal(b3, buf + 1)
    jax_resume.save_pipeline_state(path, 7, buf, meta={"b": 2})
    t4, b4, m4 = resume.load_pipeline_state(path)
    assert (t4, m4) == (7, {"b": 2}) and np.array_equal(b4, buf)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, magic=np.array("nope"), x=np.zeros(1))
    with pytest.raises(ValueError, match="state file"):
        resume.load_pipeline_state(bad)


def test_bad_buffer_and_data_mesh_are_refused():
    """An ``initial_buf`` not of shape ``(S, *payload)`` raises ValueError;
    resume arguments on a (stage, data) mesh raise NotImplementedError, as
    the JAX package's ``run_ticked`` refuses a data axis."""
    _, state = _dummy_params()
    step_fn, model = helpers.dummy_build(MODEL_KW, state, "cpu")
    x = torch.zeros(2, *LATENT)
    stage = tmesh.Stage(tmesh.make_pipeline_mesh(1, device="cpu"), 0)
    pipe = StepPipeline(stage, step_fn, PipelineConfig(TOTAL, 1))
    with pytest.raises(ValueError, match="initial_buf shape"):
        pipe.run_ticked(model, x, start_tick=1, initial_buf=np.zeros((2, *LATENT), np.float32))
    out, ticks = pipe.run_ticked(model, x, on_tick=lambda t, buf: None)
    assert out.shape == x.shape and len(ticks) == 2
    stage2 = tmesh.Stage(tmesh.make_2d_mesh(1, 2, device="cpu"), 0)
    with pytest.raises(NotImplementedError, match="data"):
        StepPipeline(stage2, step_fn, PipelineConfig(TOTAL, 1)).run_ticked(model, x,
                                                                         start_tick=1)
