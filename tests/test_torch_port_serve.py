"""The port's serving mode (``vdpp_tpu_torch/modes/serve.py``) against the JAX
package's (``vdpp_tpu/modes/serve.py``, ``tests/test_serve.py``).

In process, ``_Engine.generate`` at the tiny presets is held to the calls
JAX's ``_Engine.generate`` makes: the denoise of the JAX wrapper's step (the
JAX stream's tick, at one stage every step in turn, which JAX's own tests
hold equal to ``run_reference_single_device``), eager around a jitted model
call, then ``decode_chunked``; building JAX's engine would compile its
model's init and its stream for about 50 s here. Both sides hold the same
weights: JAX trees drawn from numpy seeds, written with JAX's
``save_params`` and read by the port's ``--checkpoint``; the T5 weights
through ``from_jax_t5_params``. JAX's noise, SVD dummy conditioning and T5
are patched into the port's seams (``draw_noise``, ``dummy_conditioning``,
``load_t5``). The video is held to 1e-4 x max|JAX| (the image->video app's
bound, ``tests/test_torch_port_app.py``).

Over HTTP, the 14 cases of ``tests/test_serve.py`` run against port server
subprocesses on the CPU (``--device cpu``, one torch thread a process), all
started at once for the module: SVD at ``--num-stages 2 --decode-devices 1``,
the DiT at 2 stages, SVD at ``--num-stages 2 --frame-parallel 2``, and SVD at
one stage, which the last case drains. Two more: requests with one seed give
the same y4m bytes, in the same ticks and across layouts. Only the
in-process cases need JAX (imported there, kept on the CPU, skipped without
it), so ``python -m pytest --noconftest tests/test_torch_port_serve.py`` runs
on the card's machine too.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from collections import OrderedDict

import numpy as np
import pytest
import torch

from vdpp_tpu_torch.models.svd_wrapper import SVDConditioning
from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig, T5TextEncoder
from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig
from vdpp_tpu_torch.modes import serve
from vdpp_tpu_torch.utils.weights import from_jax_t5_params

import torch_port_helpers as helpers
from torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, HW, STEPS = 2, (8, 8), 4
BASE = ["--preset", "tiny", "--steps", str(STEPS), "--num-frames", str(FRAMES),
        "--latent-hw", *map(str, HW)]
REL_TOL = 1e-4
SERVERS = {
    "svd": ["--num-stages", "2", "--decode-devices", "1"],
    "text": ["--model", "dit3d", "--num-stages", "2", "--guidance-scale", "5.0"],
    "frame_parallel": ["--num-stages", "2", "--frame-parallel", "2"],
    "one_stage": ["--num-stages", "1"],
}
DRAIN_FRAMES = 32  # the drained request's frames: long enough to be in flight


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Server:
    def __init__(self, name: str, extra: list[str], log_dir):
        self.name = name
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = log_dir / f"{name}.log"
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        self.log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vdpp_tpu_torch.modes.serve", "--device", "cpu", *BASE,
             "--port", str(self.port), *extra],
            cwd=REPO, env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def text(self) -> str:
        return self.log_path.read_text()

    def ready(self) -> bool:
        if self.proc.poll() is not None:
            raise RuntimeError(f"{self.name} server died:\n{self.text()[-3000:]}")
        try:
            with urllib.request.urlopen(self.base + "/healthz", timeout=2) as r:
                return r.status == 200
        except (OSError, urllib.error.URLError):
            return False

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self.log.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Every server of the module, started at once (the in-process cases run
    while they warm up); each must answer /healthz within 240 s."""
    log_dir = tmp_path_factory.mktemp("serve_logs")
    started = {name: Server(name, extra, log_dir) for name, extra in SERVERS.items()}
    yield started
    for s in started.values():
        s.stop()


def _wait_ready(servers, name: str) -> str:
    server = servers[name]
    deadline = time.time() + 240
    while not server.ready():
        if time.time() > deadline:
            raise TimeoutError(f"{name} server not ready in 240 s:\n{server.text()[-3000:]}")
        time.sleep(0.5)
    return server.base


@pytest.fixture(scope="module")
def server(servers):
    return _wait_ready(servers, "svd")


@pytest.fixture(scope="module")
def server_text(servers):
    return _wait_ready(servers, "text")


@pytest.fixture(scope="module")
def server_frame_parallel(servers):
    return _wait_ready(servers, "frame_parallel")


@pytest.fixture(scope="module")
def server_one_stage(servers):
    return _wait_ready(servers, "one_stage")


def _post(base: str, body: dict, timeout: float = 120):
    req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _fetch(base: str, body: dict) -> bytes:
    with _post(base, body) as r:
        return r.read()


def _code(base: str, body: dict) -> int:
    try:
        with _post(base, body, timeout=60):
            return 200
    except urllib.error.HTTPError as e:
        return e.code


# ---- in process: _Engine.generate against the JAX calls ---- #


def _jax():
    """The JAX package's pieces these cases use (skipped without JAX), JAX
    on the CPU as the repo's tests run it (``tests/conftest.py``; under
    ``--noconftest`` on a machine with a card JAX would take the card at its
    default, reduced, matmul precision)."""
    pytest.importorskip("jax")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from vdpp_tpu.models import dit
    from vdpp_tpu.models import t5_encoder as t5
    from vdpp_tpu.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu.models.svd_wrapper import (
        StableVideoUNet,
        make_dummy_conditioning,
        make_guidance_ramp,
    )
    from vdpp_tpu.models.vae import TemporalVAEDecoder, VAEConfig
    from vdpp_tpu.modes import serve as jserve
    from vdpp_tpu.utils import weights

    return types.SimpleNamespace(**locals())


def _tree(sd: dict, convert, **kw):
    j = _jax()
    return j.jax.tree_util.tree_map(np.asarray, convert(sd, **kw))


@pytest.fixture(scope="module")
def weights(tmp_path_factory, servers):
    """JAX trees of the tiny UNet, DiT, T5 and VAE decoder drawn from numpy
    seeds, and a checkpoint directory of JAX ``save_params`` files for each
    model family."""
    j = _jax()
    t5_cfg = T5EncoderConfig.tiny()
    dit_j = j.dit.DiTVideoConfig.joint3d_tiny()
    dit_j = type(dit_j)(**{**dit_j.__dict__, "cross_attention_dim": t5_cfg.d_model})
    sd_vae = helpers.random_state_dict(TemporalVAEDecoder(VAEConfig.tiny(), device="meta"), 1,
                                       mix_base=0.5)
    sd_t5 = helpers.random_state_dict(T5TextEncoder(t5_cfg, device="meta"), 3)
    p = {"unet": helpers.tiny_svd_weights(0)[0],
         "vae_decoder": _tree(sd_vae, j.weights.convert_vae_decoder_state_dict, num_levels=2,
                              layers_per_block=1),
         "dit": j.jax.tree_util.tree_map(np.asarray, helpers.dit_jax_params(dit_j, 2)),
         "t5": _tree(sd_t5, j.weights.convert_t5_encoder_state_dict,
                     num_layers=t5_cfg.num_layers,
                     gated=t5_cfg.feed_forward_proj == "gated-gelu")}
    dirs = {}
    for family, model in (("svd", "unet"), ("dit3d", "dit")):
        d = tmp_path_factory.mktemp(f"ckpt_{family}")
        j.weights.save_params(p[model], str(d / f"{model}.npz"))
        j.weights.save_params(p["vae_decoder"], str(d / "vae_decoder.npz"))
        dirs[family] = str(d)
    return p, dirs, dit_j


def _jax_noise(seed: int, shape) -> torch.Tensor:
    jax = _jax().jax
    return torch.from_numpy(np.array(jax.random.normal(jax.random.key(seed), shape)))


def _jax_video(model, bundle, noise, p_vae):
    """JAX ``_Engine.generate``'s math after the stream lookup: the wrapper's
    steps on the packed noise, unpack, the chunked decode of the latent over
    the scaling factor."""
    j = _jax()
    step = model.pipeline_step_fn()
    x = model.pack_initial(j.jnp.asarray(noise.numpy()) * model.init_noise_sigma)
    for k in range(STEPS):
        x = step(bundle, x, k)
    dec = j.TemporalVAEDecoder(j.VAEConfig.tiny())
    lat = model.unpack_final(x) / dec.config.scaling_factor
    return np.asarray(j.jax.jit(lambda p, z: dec.decode_chunked(p, z))(p_vae, lat))[0]


def _assert_video_close(got, want) -> None:
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err = np.abs(got - want).max()
    print(f"video: max|port - JAX| {err:.3e}, max|JAX| {np.abs(want).max():.3e}")
    assert err <= REL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def _engine(argv: list[str]):
    return serve._Engine(serve.build_parser().parse_args(["--device", "cpu", *BASE, *argv]))


def test_engine_generate_matches_jax_svd(weights, monkeypatch):
    """SVD tiny, 2 frames of 8x8, 4 steps, CFG 3, at one stage: the video
    (float, and its uint8 bytes) within 1e-4 x max|JAX| of JAX's."""
    j = _jax()
    p, dirs, _ = weights
    guidance, seed = 3.0, 5
    jcond = j.make_dummy_conditioning(
        j.jax.random.key(serve._SEED_OFFSET["conditioning"]), 1, FRAMES, *HW,
        cross_dim=j.SVDUNetConfig.tiny().cross_attention_dim, guidance_scale=guidance)
    cond = SVDConditioning(**{k: None if v is None else torch.from_numpy(np.array(v))
                              for k, v in vars(jcond).items()})
    monkeypatch.setattr(serve, "draw_noise", _jax_noise)
    monkeypatch.setattr(serve, "dummy_conditioning", lambda args, f, g: cond)
    engine = _engine(["--num-stages", "1", "--guidance-scale", str(guidance),
                      "--checkpoint", dirs["svd"]])
    try:
        video, seconds = engine.generate(seed, FRAMES, guidance)
        frames, _ = engine.generate(seed, FRAMES, guidance, as_uint8=True)
        assert seconds > 0 and engine.metrics()["requests_served"] == 2
    finally:
        engine.close()
    model = j.StableVideoUNet(j.SVDUNetConfig.tiny(), num_steps=STEPS)
    model.unet.apply = j.jax.jit(j.SVDUNet(j.SVDUNetConfig.tiny()).apply,
                                 static_argnames=("seq_axis", "seq_shards", "frame_axis",
                                                  "frame_shards"))
    want = _jax_video(model, (p["unet"], jcond), _jax_noise(seed, (1, FRAMES, *HW, 4)),
                      p["vae_decoder"])
    _assert_video_close(video, want)
    assert frames.dtype == np.uint8 and np.array_equal(frames, serve.frames_to_uint8(video))


@pytest.mark.parametrize("negative", [None, "blurry, dark"], ids=["prompt", "negative_prompt"])
def test_engine_generate_matches_jax_dit3d(weights, monkeypatch, negative):
    """The tiny joint3d DiT, a prompt at guidance 5 (with and without a
    negative prompt), at one stage: the T5 context from JAX's engine's own
    ``_text_context`` on the same T5 weights, the video within 1e-4 x
    max|JAX| of JAX's."""
    j = _jax()
    p, dirs, dit_j = weights
    guidance, seed, prompt = 5.0, 7, "a red panda"
    t5_cfg = T5EncoderConfig.tiny()

    def port_t5(args, device):
        t5 = T5TextEncoder(t5_cfg, device=device)
        t5.load_state_dict(from_jax_t5_params(p["t5"]))
        return t5

    monkeypatch.setattr(serve, "draw_noise", _jax_noise)
    monkeypatch.setattr(serve, "load_t5", port_t5)
    engine = _engine(["--model", "dit3d", "--num-stages", "1", "--guidance-scale",
                      str(guidance), "--checkpoint", dirs["dit3d"]])
    try:
        video, _ = engine.generate(seed, FRAMES, guidance, prompt, negative)
    finally:
        engine.close()
    jt5_cfg = j.t5.T5EncoderConfig.tiny()
    fake = types.SimpleNamespace(lock=threading.Lock(), _ctx_cache=OrderedDict(),
                                 max_ctx_cache=32, t5=j.t5.T5TextEncoder(jt5_cfg),
                                 t5_params=p["t5"], t5_cfg=jt5_cfg, jax=j.jax, jnp=j.jnp)
    ctx = j.jserve._Engine._text_context(fake, prompt, negative)
    model = j.dit.DiTVideoWrapper(dit_j, num_steps=STEPS)
    model.model.apply = j.jax.jit(model.model.apply, static_argnames=(
        "seq_axis", "seq_shards", "expert_axis", "moe_dispatch", "moe_capacity"))
    want = _jax_video(model, (p["dit"], ctx, j.make_guidance_ramp(guidance, FRAMES)),
                      _jax_noise(seed, (1, FRAMES, *HW, 4)), p["vae_decoder"])
    _assert_video_close(video, want)


def test_engine_restarts_failed_ranks():
    """A stage rank that dies poisons its group: the cached stream turns
    unusable, and the next request starts a new group and is served, the
    same video as before."""
    engine = _engine(["--num-stages", "2"])
    try:
        video, _ = engine.generate(3, FRAMES, None)
        old = engine.ranks
        os.kill(old.pids[1], signal.SIGKILL)
        deadline = time.monotonic() + 30
        while not old.failed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert old.failed and all(s.unusable for s in engine._streams.values())
        again, _ = engine.generate(3, FRAMES, None)
        assert engine.ranks is not old and not engine.ranks.failed
        assert np.array_equal(again, video)
    finally:
        engine.close()


def test_native_writer_first_use_from_concurrent_requests(tmp_path, monkeypatch):
    """Concurrent requests' handlers reach the native y4m writer at once, the
    first time while it is still being compiled: every one must wait for the
    library and write its bytes, none fall back to numpy, whose chroma sums
    round a few bytes otherwise (checked here first)."""
    from vdpp_tpu_torch.utils import native

    frames = np.random.default_rng(0).integers(0, 256, (2, 576, 1024, 3), dtype=np.uint8)
    want = open(native.write_y4m(str(tmp_path / "native.y4m"), frames), "rb").read()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)  # no library: the numpy writer
    assert open(native.write_y4m(str(tmp_path / "numpy.y4m"), frames), "rb").read() != want
    monkeypatch.setattr(native, "_tried", False)  # a fresh build, at first use
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "libvideopack-test.so")
    start = threading.Barrier(4)

    def write(i):
        start.wait()
        native.write_y4m(str(tmp_path / f"{i}.y4m"), frames)

    workers = [threading.Thread(target=write, args=(i,)) for i in range(4)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    assert not any(w.is_alive() for w in workers) and native._lib is not None
    assert all(open(tmp_path / f"{i}.y4m", "rb").read() == want for i in range(4))


def test_draining_engine_answers_503():
    """While draining, /healthz is 503 {"status": "draining"} and /generate
    is refused with 503 (the handler, on a stand-in engine)."""
    engine = types.SimpleNamespace(draining=True, args=None)
    httpd = serve._DrainingServer(("127.0.0.1", 0), serve._make_handler(engine, 7))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e.value.code == 503 and json.loads(e.value.read()) == {"status": "draining"}
        assert _code(base, {"seed": 1}) == 503
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---- over HTTP: tests/test_serve.py's cases ---- #


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=10) as r:
        data = json.loads(r.read())
    assert data["status"] == "ok"
    assert data["stages"] == 2
    assert data["decode_devices"] == 1


def test_generate_gif(server):
    with _post(server, {"seed": 7, "format": "gif"}) as r:
        body = r.read()
        assert r.headers["Content-Type"] == "image/gif"
        assert float(r.headers["X-Generation-Seconds"]) > 0
    assert body[:6] in (b"GIF87a", b"GIF89a")


def test_generate_y4m_and_determinism(server):
    a = _fetch(server, {"seed": 3, "format": "y4m"})
    b = _fetch(server, {"seed": 3, "format": "y4m"})
    c = _fetch(server, {"seed": 4, "format": "y4m"})
    assert a.startswith(b"YUV4MPEG2")
    assert a == b  # same seed -> same video
    assert a != c  # different seed -> different video


def _concurrent(base: str, bodies: dict) -> dict:
    results = {}

    def fetch(name, body):
        try:
            with _post(base, body) as r:
                results[name] = (r.status, float(r.headers["X-Generation-Seconds"]), r.read())
        except Exception as e:  # recorded for the main thread's asserts
            results[name] = repr(e)

    threads = [threading.Thread(target=fetch, args=item) for item in bodies.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


def test_concurrent_requests_share_the_pipeline(server):
    """Overlapping requests ride one stream and both succeed (the tick-level
    proof is in tests/test_torch_port_stream.py)."""
    results = _concurrent(server, {"a": {"seed": 11, "format": "gif"},
                                   "b": {"seed": 12, "format": "gif"}})
    assert results["a"][0] == 200 and results["b"][0] == 200, results
    assert results["a"][1] > 0 and results["b"][1] > 0


def test_same_seed_in_the_same_ticks_gives_the_same_bytes(server):
    """Two concurrent requests with one seed, which share ticks, give
    byte-equal y4m."""
    results = _concurrent(server, {"a": {"seed": 21, "format": "y4m"},
                                   "b": {"seed": 21, "format": "y4m"}})
    assert results["a"][0] == results["b"][0] == 200, results
    assert results["a"][2].startswith(b"YUV4MPEG2") and results["a"][2] == results["b"][2]


def test_unknown_path_404(server):
    req = urllib.request.Request(server + "/nope", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 404


def test_generate_from_prompt(server_text):
    def fetch(prompt, seed=5):
        return _fetch(server_text, {"seed": seed, "prompt": prompt, "format": "y4m"})

    a = fetch("a red panda")
    b = fetch("a red panda")
    c = fetch("a blue whale")
    assert a.startswith(b"YUV4MPEG2")
    assert a == b  # same prompt + seed -> same video
    assert a != c  # the prompt conditions the DiT


def test_generate_with_negative_prompt(server_text):
    def fetch(body):
        return _fetch(server_text, {"seed": 7, "format": "y4m", **body})

    plain = fetch({"prompt": "a red panda"})
    neg1 = fetch({"prompt": "a red panda", "negative_prompt": "blurry, dark"})
    neg2 = fetch({"prompt": "a red panda", "negative_prompt": "blurry, dark"})
    assert neg1.startswith(b"YUV4MPEG2")
    assert neg1 == neg2  # deterministic
    assert neg1 != plain  # the negative prompt changes the uncond branch


def test_negative_prompt_on_svd_is_a_400(server):
    assert _code(server, {"seed": 1, "format": "gif", "negative_prompt": "blurry"}) == 400


def test_negative_prompt_without_cfg_is_a_400(server_text):
    assert _code(server_text, {"seed": 1, "format": "gif", "prompt": "a red panda",
                               "negative_prompt": "blurry", "guidance_scale": 1.0}) == 400


def test_metrics_endpoint(server):
    with urllib.request.urlopen(server + "/metrics", timeout=10) as r:
        data = json.loads(r.read())
    assert data["requests_served"] >= 0
    assert data["active_streams"] >= 0
    lat = data["latency_s"]
    assert set(lat) == {"mean", "p50", "p95", "max"}
    assert lat["p95"] >= lat["p50"] >= 0.0
    assert 0 <= data["window"] <= 512


def test_generate_on_frame_parallel_mesh(server_frame_parallel):
    with _post(server_frame_parallel, {"seed": 3, "format": "gif"}) as r:
        body = r.read()
        assert r.status == 200
    assert body.startswith(b"GIF8")


def test_out_of_range_num_frames_is_a_400(server):
    for bad in (0, -3, 10_000):
        assert _code(server, {"seed": 1, "num_frames": bad}) == 400, bad


def test_indivisible_num_frames_is_a_400(server_frame_parallel):
    assert _code(server_frame_parallel, {"seed": 1, "num_frames": 3}) == 400


def test_layouts_give_the_same_bytes(server, server_one_stage):
    """One stage in the server process, and two stage ranks with a decode
    rank, give byte-equal y4m for one seed."""
    body = {"seed": 9, "format": "y4m"}
    one = _fetch(server_one_stage, body)
    assert one.startswith(b"YUV4MPEG2") and one == _fetch(server, body)


def test_sigterm_drains_and_exits_zero(servers, server_one_stage):
    """SIGTERM with a request in flight: the server logs the drain before it
    answers the request (200), then exits 0."""
    proc = servers["one_stage"].proc
    results = {}

    def fetch():
        try:
            with _post(server_one_stage, {"seed": 7, "format": "gif",
                                          "num_frames": DRAIN_FRAMES}) as r:
                results["status"] = r.status
                results["body"] = r.read()[:6]
        except Exception as e:  # recorded for the main-thread assert
            results["error"] = repr(e)

    t = threading.Thread(target=fetch)
    t.start()
    time.sleep(0.3)  # let the request be accepted into a handler thread
    proc.send_signal(signal.SIGTERM)
    t.join(timeout=120)
    assert not t.is_alive(), "in-flight request never returned"
    assert results.get("status") == 200, results
    assert results["body"] in (b"GIF87a", b"GIF89a")
    assert proc.wait(timeout=60) == 0
    log = servers["one_stage"].text()
    assert log.index("signal 15: draining") < log.rindex('"POST /generate HTTP/1.1" 200')
    assert "drained; exiting" in log
