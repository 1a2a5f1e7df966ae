"""The port's streaming executor (``vdpp_tpu_torch/parallel/pipeline.py``:
``PipelineStream``, ``StreamRanks``; ``parallel/mesh.py::RankGroup``) and its
compatibility layer (``vdpp_tpu_torch/compat.py``) against the JAX
package's (``tests/test_pipeline_stream.py``, ``tests/test_compat.py``).

The stream runs over a 4-stage gloo group of spawned CPU ranks, started once
for the module, with the port's DummyUNet holding the JAX DummyUNet's
weights (drawn from a numpy seed). Every streamed output is held to JAX's
``run_reference_single_device`` on the same inputs within 1e-5, JAX's own
tolerance; the tick counts are the controller's, counted from the ranks'
acknowledgements, so they are deterministic. The group's ranks wait on
their command channels in polls of 0.2 s, so that the idle case outlasts
several. The case whose step fails on one rank poisons the group and runs
last.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdpp_tpu import compat as jcompat
from vdpp_tpu.models.dummy_unet import DummyUNet as JaxDummy
from vdpp_tpu.parallel.pipeline import run_reference_single_device as jax_reference

from vdpp_tpu_torch import compat
from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh
from vdpp_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    StepPipeline,
    StreamRanks,
    run_reference_single_device,
)
from vdpp_tpu_torch.utils.weights import from_jax_dummy_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

TOTAL_STEPS = 8
STAGES = 4
LATENT = (1, 4, 2, 8, 8)  # DummyUNet keeps the (B, C, F, H, W) layout
MODEL_KW = dict(channels=4, hidden_channels=8)
COMPAT_KW = dict(channels=8, hidden_channels=16)
COMPAT_LATENT = (1, 8, 2, 8, 8)
TOL = 1e-5
POLL_SECONDS = 0.2
TESTS = os.path.dirname(os.path.abspath(__file__))


def _dummy_params(kw: dict, seed: int) -> dict:
    """A JAX DummyUNet tree drawn from a numpy seed (uniform over
    +-1/sqrt(fan_in), the LayerNorm off 1 and 0)."""
    rng = np.random.default_rng(seed)
    c, h = kw["channels"], kw["hidden_channels"]

    def conv(out_ch, in_ch):
        bound = 1.0 / np.sqrt(in_ch * 27)
        return {"w": rng.uniform(-bound, bound, (out_ch, in_ch, 3, 3, 3)).astype(np.float32),
                "b": rng.uniform(-bound, bound, out_ch).astype(np.float32)}

    return {"conv1": conv(h, c), "conv2": conv(c, h),
            "ln": {"w": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}}


PARAMS = _dummy_params(MODEL_KW, 0)
STATE = from_jax_dummy_params(PARAMS)
COMPAT_PARAMS = _dummy_params(COMPAT_KW, 1)


def _inputs(seed: int, n: int, shape=LATENT) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)


def _jax_oracle(inputs: np.ndarray, params=PARAMS, kw=MODEL_KW, timesteps=None) -> np.ndarray:
    model = JaxDummy(**kw)
    ts = None if timesteps is None else jnp.asarray(timesteps)
    step = ((lambda p, x, s: model.apply(p, x, s)) if ts is None
            else (lambda p, x, s: model.apply(p, x, ts[s])))
    return np.asarray(jax_reference(step, jax.tree_util.tree_map(jnp.asarray, params),
                                    jnp.asarray(inputs), TOTAL_STEPS))


def _port_model(kw=MODEL_KW, params=PARAMS):
    return helpers.dummy_build(kw, from_jax_dummy_params(params), "cpu")[1]


def _compat_runs() -> dict:
    """The port's pipelined compat calls over spawned ranks (world 4, and 2
    with descending timesteps), run at once."""
    model = _port_model(COMPAT_KW, COMPAT_PARAMS)
    single = torch.from_numpy(_inputs(11, 1, COMPAT_LATENT)[0])
    many = torch.from_numpy(_inputs(12, 3, COMPAT_LATENT))
    ts = list(range(TOTAL_STEPS - 1, -1, -1))
    with ThreadPoolExecutor(2) as pool:
        one = pool.submit(compat.run_single_latent, helpers.dummy_step, params=model,
                          total_steps=TOTAL_STEPS, world_size=4, input_latent=single,
                          device="cpu")
        desc = pool.submit(compat.run_pipeline_latents, helpers.dummy_step, params=model,
                           total_steps=TOTAL_STEPS, world_size=2, num_samples=3,
                           input_supplier=lambda i: many[i], timesteps=ts, device="cpu")
        return {"single": (single, one.result()), "descending": (many, ts, desc.result())}


def _alive(pid: int) -> bool:
    """The process exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


class Group:
    """What the module's cases share: the 4-stage stream group, a server
    stand-in holding a 2-rank group (to be killed), the compat runs."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [TESTS, os.path.dirname(TESTS), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        self.holder = subprocess.Popen(
            [sys.executable, "-c", "import torch_port_helpers as h; h.hold_stream_ranks()"],
            cwd=TESTS, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.pool = ThreadPoolExecutor(1)
        self.compat = self.pool.submit(_compat_runs)
        self.ranks = StreamRanks(make_pipeline_mesh(STAGES, device="cpu"),
                                 helpers.stream_dummy_job, MODEL_KW, STATE, TOTAL_STEPS,
                                 threads=1, poll_seconds=POLL_SECONDS)

    def close(self):
        self.ranks.close()
        if self.holder.poll() is None:
            self.holder.kill()
        self.holder.wait()
        self.pool.shutdown()


@pytest.fixture(scope="module")
def group():
    g = Group()
    yield g
    g.close()


def _submit_all(stream, inputs: np.ndarray) -> list[np.ndarray]:
    futures = [stream.submit(torch.from_numpy(x)) for x in inputs]
    return [f.result(timeout=120).numpy() for f in futures]


def test_stream_matches_single_device_oracle(group):
    """Three requests through the 4-stage stream, each within 1e-5 of JAX's
    single-device run of every step."""
    stream = group.ranks.stream(None, LATENT)
    try:
        inputs = _inputs(1, 3)
        outs = _submit_all(stream, inputs)
        want = _jax_oracle(inputs)
        for got, ref in zip(outs, want):
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    finally:
        stream.close()


def test_stream_overlapping_requests_share_the_pipeline(group):
    """Two requests submitted together take about S + 1 ticks, not 2S (one
    idle-slip tick allowed)."""
    stream = group.ranks.stream(None, LATENT)
    try:
        start = stream.ticks_run
        a = stream.submit(torch.from_numpy(_inputs(2, 1)[0]))
        b = stream.submit(torch.from_numpy(_inputs(3, 1)[0]))
        a.result(timeout=120)
        b.result(timeout=120)
        ticks = stream.ticks_run - start
        assert ticks <= STAGES + 2, ticks
        assert ticks < 2 * STAGES
    finally:
        stream.close()


def test_stream_second_request_completes_one_tick_after_first(group):
    """With both requests in flight their completion ticks differ by one
    (two at most, as JAX's test allows)."""
    stream = group.ranks.stream(None, LATENT)
    completion = {}
    try:
        a = stream.submit(torch.from_numpy(_inputs(4, 1)[0]))
        b = stream.submit(torch.from_numpy(_inputs(5, 1)[0]))
        a.add_done_callback(lambda f: completion.setdefault("a", stream.ticks_run))
        b.add_done_callback(lambda f: completion.setdefault("b", stream.ticks_run))
        a.result(timeout=120)
        b.result(timeout=120)
        assert completion["b"] - completion["a"] <= 1 + 1
    finally:
        stream.close()


def test_stream_rejects_wrong_shape(group):
    stream = group.ranks.stream(None, LATENT)
    try:
        with pytest.raises(ValueError, match="latent shape"):
            stream.submit(torch.zeros(2, 4, 2, 8, 8))
    finally:
        stream.close()


def test_stream_rejects_wrong_dtype_and_submit_after_close(group):
    stream = group.ranks.stream(None, LATENT)
    try:
        with pytest.raises(ValueError, match="dtype"):
            stream.submit(torch.zeros(LATENT, dtype=torch.bfloat16))
    finally:
        stream.close()
    with pytest.raises(RuntimeError, match="closed"):
        stream.submit(torch.zeros(LATENT))


def test_cancelled_future_does_not_poison_the_stream(group):
    """A client that cancels its future leaves the stream serving: the other
    request of the same ticks and a later one still equal JAX's run."""
    stream = group.ranks.stream(None, LATENT)
    try:
        inputs = _inputs(6, 3)
        a = stream.submit(torch.from_numpy(inputs[0]))
        b = stream.submit(torch.from_numpy(inputs[1]))
        a.cancel()
        got_b = b.result(timeout=120).numpy()
        got_c = stream.submit(torch.from_numpy(inputs[2])).result(timeout=120).numpy()
        assert not stream.unusable
        want = _jax_oracle(inputs)
        np.testing.assert_allclose(got_b, want[1], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_c, want[2], rtol=TOL, atol=TOL)
    finally:
        stream.close()


def test_idle_stream_outlasts_the_command_wait(group):
    """A stream left idle for five of its ranks' 0.2 s command waits, and a
    second stream opened beside it, still answer, each within 1e-5 of JAX:
    idle ranks wait on their channels, in no collective."""
    first = group.ranks.stream(None, LATENT)
    second = group.ranks.stream(None, LATENT)
    try:
        inputs = _inputs(7, 2)
        got = first.submit(torch.from_numpy(inputs[0])).result(timeout=120).numpy()
        time.sleep(5 * POLL_SECONDS)
        got2 = second.submit(torch.from_numpy(inputs[1])).result(timeout=120).numpy()
        want = _jax_oracle(inputs)
        np.testing.assert_allclose(got, want[0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got2, want[1], rtol=TOL, atol=TOL)
    finally:
        first.close()
        second.close()


def test_one_stage_stream_runs_in_process():
    """``StepPipeline.stream`` on a one-rank mesh: the controller thread in this
    process, one tick a request, within 1e-5 of JAX."""
    pipe = StepPipeline(Stage(make_pipeline_mesh(1, device="cpu"), 0), helpers.dummy_step,
                        PipelineConfig(TOTAL_STEPS, 1))
    stream = pipe.stream(_port_model(), LATENT)
    try:
        inputs = _inputs(8, 3)
        outs = _submit_all(stream, inputs)
        assert stream.ticks_run == 3
        for got, ref in zip(outs, _jax_oracle(inputs)):
            np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    finally:
        stream.close()
    with pytest.raises(RuntimeError, match="closed"):
        stream.submit(torch.zeros(LATENT))


def test_concurrent_submitters_each_get_their_own_sample():
    """More submitting threads than cores on one in-process stream, with the
    interpreter switching threads every microsecond: every future resolves
    to its own input's finished latent (bit-equal to every step run in this
    process), and the controller counts one tick a request (one stage)."""
    threads, per_thread = 16, 4
    model = _port_model()
    pipe = StepPipeline(Stage(make_pipeline_mesh(1, device="cpu"), 0), helpers.dummy_step,
                        PipelineConfig(TOTAL_STEPS, 1))
    stream = pipe.stream(model, LATENT)
    inputs = torch.from_numpy(_inputs(9, threads * per_thread))
    want = run_reference_single_device(helpers.dummy_step, model, inputs, TOTAL_STEPS)
    got = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def submit(t):
            futs = {i: stream.submit(inputs[i]) for i in range(t, len(inputs), threads)}
            got.update({i: f.result(timeout=120) for i, f in futs.items()})

        workers = [threading.Thread(target=submit, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
        stream.close()
    assert sorted(got) == list(range(len(inputs)))
    assert all(torch.equal(got[i], want[i]) for i in got)
    assert stream.ticks_run == len(inputs)


def test_ranks_leave_when_the_server_is_killed(group):
    """A server killed with SIGKILL leaves no rank behind: each rank's
    command channel reaches EOF and it exits within 10 s."""
    line = group.holder.stdout.readline()
    assert line.startswith("PIDS"), (line, group.holder.stderr.read()[-2000:])
    pids = [int(p) for p in line.split()[1:]]
    assert len(pids) == 2 and all(_alive(p) for p in pids)
    group.holder.send_signal(signal.SIGKILL)
    group.holder.wait()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(p) for p in pids), [p for p in pids if _alive(p)]


# ---- compat.py against vdpp_tpu.compat (tests/test_compat.py) ---- #


def test_resolve_backend_semantics(monkeypatch):
    """The same order in both packages (argument, VDPP_BACKEND, default), the
    JAX package's tpu being the port's cuda."""
    monkeypatch.delenv("VDPP_BACKEND", raising=False)
    assert compat.resolve_backend(simulator=True) == jcompat.resolve_backend(simulator=True)
    assert (jcompat.resolve_backend(simulator=False), compat.resolve_backend(simulator=False)) \
        == ("tpu", "cuda")
    assert compat.resolve_backend("cpu") == jcompat.resolve_backend("cpu") == "cpu"
    monkeypatch.setenv("VDPP_BACKEND", "cpu")
    assert compat.resolve_backend() == jcompat.resolve_backend() == "cpu"
    for bad in ("nccl", "tpu"):
        with pytest.raises(ValueError, match="cuda"):
            compat.resolve_backend(bad)
    with pytest.raises(ValueError):
        jcompat.resolve_backend("nccl")


def test_latent_spec_empty():
    spec, jspec = compat.LatentSpec((1, 8, 2, 4, 4)), jcompat.LatentSpec((1, 8, 2, 4, 4))
    x = spec.empty()
    assert tuple(x.shape) == tuple(jspec.empty().shape) == (1, 8, 2, 4, 4)
    assert x.dtype == torch.float32 and float(x.abs().sum()) == 0.0


def test_run_single_latent_matches_jax(group):
    """A 4-stage ``run_single_latent`` over spawned ranks against JAX's, and
    against JAX's single-device oracle, within 2e-5 (JAX's test's bound)."""
    latent, got = group.compat.result()["single"]
    model = JaxDummy(**COMPAT_KW)
    step = lambda p, x, s: model.apply(p, x, s)  # noqa: E731
    jparams = jax.tree_util.tree_map(jnp.asarray, COMPAT_PARAMS)
    want = jcompat.run_single_latent(step, params=jparams, total_steps=TOTAL_STEPS, world_size=4,
                                     input_latent=jnp.asarray(latent.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    ref = _jax_oracle(latent.numpy()[None], COMPAT_PARAMS, COMPAT_KW)[0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_run_pipeline_latents_with_descending_timesteps(group):
    """Three samples on 2 spawned stages with the model fed timesteps T-1 ..
    0 (the simulator's semantics) against JAX's call and its oracle."""
    many, ts, got = group.compat.result()["descending"]
    model = JaxDummy(**COMPAT_KW)
    step = lambda p, x, s: model.apply(p, x, s)  # noqa: E731
    jparams = jax.tree_util.tree_map(jnp.asarray, COMPAT_PARAMS)
    want = jcompat.run_pipeline_latents(step, params=jparams, total_steps=TOTAL_STEPS,
                                        world_size=2, num_samples=3,
                                        input_supplier=lambda i: jnp.asarray(many[i].numpy()),
                                        timesteps=ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    ref = _jax_oracle(many.numpy(), COMPAT_PARAMS, COMPAT_KW, timesteps=ts)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_run_pipeline_latents_rejects_bad_samples():
    for run, zeros in ((compat.run_pipeline_latents, torch.zeros),
                       (jcompat.run_pipeline_latents, jnp.zeros)):
        with pytest.raises(ValueError, match="positive"):
            run(lambda p, x, s: x, params={}, total_steps=4, world_size=2, num_samples=0,
                input_supplier=lambda i: zeros((1,)))


# ---- last: a failure poisons the group ---- #


def test_stream_failure_fails_all_waiters_and_rejects_new_submits(group):
    """A step that raises on one rank (stage 2 of 4) fails every in-flight
    and queued future with that rank's traceback, and poisons the group:
    its streams refuse further submits ("stream failed") and turn unusable,
    and its ranks are stopped."""
    bystander = group.ranks.stream(None, LATENT)
    stream = group.ranks.stream(("fail", 2), LATENT)
    futs = [stream.submit(torch.zeros(LATENT)) for _ in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="injected tick failure"):
            f.result(timeout=120)
    with pytest.raises(RuntimeError, match="stream failed"):
        stream.submit(torch.zeros(LATENT))
    assert stream.unusable and bystander.unusable and group.ranks.failed
    deadline = time.monotonic() + 30
    pids = group.ranks.pids
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(p) for p in pids)
